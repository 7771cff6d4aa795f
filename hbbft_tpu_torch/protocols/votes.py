"""Era-scoped vote buffer/counter for validator-set changes.

The port's own copy of ``hbbft_tpu/protocols/votes.py``, whole, with its
wire names.  Reference: ``src/dynamic_honey_badger/votes.rs`` (303
LoC).  Each validator holds one active vote; a later vote (higher
``num``) supersedes it.  Pending votes ride inside HoneyBadger contributions and
only *committed* (batch-ordered) votes are counted, so every node counts
the identical sequence.  A change wins at > f committed votes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

from ..core.fault import FaultKind, FaultLog
from ..core.network_info import NetworkInfo
from ..core.serialize import dumps, wire
from .change import Change


@wire("Vote")
@dataclasses.dataclass(frozen=True)
class Vote:
    change: Change
    era: int  # epoch at which the current era began
    num: int  # higher numbers supersede earlier votes by the same voter


@wire("SignedVote")
@dataclasses.dataclass(frozen=True)
class SignedVote:
    vote: Vote
    voter: Any
    sig: Any

    @property
    def era(self) -> int:
        return self.vote.era


def _well_formed(signed_vote) -> bool:
    """Structural sanity for a vote received off the wire: the decoder
    will happily build a ``SignedVote`` whose fields are the wrong types
    (non-``Vote`` vote, unhashable voter/change, non-int era/num), and
    any of those would raise out of the dict/comparison operations the
    counters run — a remote-triggered crash instead of a ``Fault``."""
    if not isinstance(signed_vote, SignedVote):
        return False
    vote = signed_vote.vote
    if not isinstance(vote, Vote) or not isinstance(vote.change, Change):
        return False
    if not isinstance(vote.era, int) or isinstance(vote.era, bool):
        return False
    if not isinstance(vote.num, int) or isinstance(vote.num, bool):
        return False
    try:
        hash(signed_vote.voter)
        hash(vote.change)
    except TypeError:
        return False
    return True


class VoteCounter:
    def __init__(self, netinfo: NetworkInfo, era: int):
        self.netinfo = netinfo
        self.era = era
        self.pending: Dict[Any, SignedVote] = {}
        self.committed: Dict[Any, Vote] = {}

    # -- signing + buffering ----------------------------------------------

    def sign_vote_for(self, change: Change) -> SignedVote:
        """Create, sign and buffer our own vote (reference ``:45-61``)."""
        voter = self.netinfo.our_id
        prev = self.pending.get(voter)
        vote = Vote(change, self.era, prev.vote.num + 1 if prev else 0)
        sig = self.netinfo.secret_key.sign(dumps(vote))
        signed = SignedVote(vote, voter, sig)
        self.pending[voter] = signed
        return signed

    def add_pending_vote(self, sender_id, signed_vote: SignedVote) -> FaultLog:
        """Buffer a vote received off-chain (reference ``:64-85``)."""
        faults = FaultLog()
        if not _well_formed(signed_vote):
            faults.add(sender_id, FaultKind.INVALID_VOTE_SIGNATURE)
            return faults
        prev = self.pending.get(signed_vote.voter)
        if signed_vote.vote.era != self.era or (
            prev is not None and prev.vote.num >= signed_vote.vote.num
        ):
            return faults  # obsolete or already present
        if not self._validate(signed_vote):
            faults.add(sender_id, FaultKind.INVALID_VOTE_SIGNATURE)
            return faults
        self.pending[signed_vote.voter] = signed_vote
        return faults

    def pending_votes(self) -> Iterator[SignedVote]:
        """Pending votes newer than their voter's committed vote."""
        for voter in sorted(self.pending, key=str):
            sv = self.pending[voter]
            committed = self.committed.get(voter)
            if committed is None or committed.num < sv.vote.num:
                yield sv

    # -- committed votes ---------------------------------------------------

    def add_committed_votes(self, proposer_id, signed_votes) -> FaultLog:
        faults = FaultLog()
        for sv in signed_votes:
            faults.merge(self.add_committed_vote(proposer_id, sv))
        return faults

    def add_committed_vote(self, proposer_id, signed_vote: SignedVote) -> FaultLog:
        faults = FaultLog()
        if not _well_formed(signed_vote):
            faults.add(proposer_id, FaultKind.INVALID_VOTE_SIGNATURE)
            return faults
        prev = self.committed.get(signed_vote.voter)
        if prev is not None and prev.num >= signed_vote.vote.num:
            return faults  # obsolete
        if signed_vote.vote.era != self.era or not self._validate(signed_vote):
            faults.add(proposer_id, FaultKind.INVALID_VOTE_SIGNATURE)
            return faults
        self.committed[signed_vote.voter] = signed_vote.vote
        return faults

    def compute_winner(self) -> Optional[Change]:
        """The change with > f committed votes, if any (reference
        ``:137-148``)."""
        counts: Dict[Change, int] = {}
        for voter in sorted(self.committed, key=str):
            change = self.committed[voter].change
            counts[change] = counts.get(change, 0) + 1
            if counts[change] > self.netinfo.num_faulty:
                return change
        return None

    def _validate(self, signed_vote: SignedVote) -> bool:
        pk = self.netinfo.public_key(signed_vote.voter)
        if pk is None:
            return False
        try:
            return pk.verify(signed_vote.sig, dumps(signed_vote.vote))
        except Exception:
            return False
