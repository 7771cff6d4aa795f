"""HoneyBadger — epochs of threshold-encrypted Common Subset.

The port's own copy of ``hbbft_tpu/protocols/honey_badger.py``
(reference ``src/honey_badger/``).  Per epoch, every validator
serializes its contribution, encrypts it to the master threshold key
with ``self.rng`` and inputs the ciphertext into that epoch's
``CommonSubset``.  When the subset is decided, each node multicasts a
decryption share per accepted proposer; at > f verified shares a
contribution is decrypted, and when all accepted contributions decrypt,
the epoch's ``Batch`` is output.  Shares are checked through
``netinfo.ops.verify_dec_share``: under
``harness.batching.BatchingBackend`` the checks of a whole network settle
in one flush, whose G1 aggregate runs on the card.

The reference's options carry over: messages inside
``[epoch, epoch+max_future_epochs]`` are handled at once and later ones
queued (capped per sender); ``speculative=True`` combines the lowest f+1
shares unverified and falls back to per-share checks on a mismatch;
``reveal_mode="ordered"`` emits an :class:`OrderedBatch` the moment the
subset decides and reveals the plaintext :class:`Batch` later, with
ordering stalled at ``max_outstanding_reveals`` pending reveals;
``fast_forward`` installs transferred batches; ``gc_epochs`` prunes past
epochs.  The reference's ``HBBFT_TPU_ORDERED_COMMIT`` environment
default is not carried over (the keyword is the one switch), nor are its
trace events.  Wire names are the reference's, so a batch or a message
``dumps`` to the same bytes in both packages.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Optional, Set

from ..core.algorithm import DistAlgorithm, UnknownSenderError
from ..core.fault import FaultKind, FaultLog
from ..core.network_info import NetworkInfo
from ..core.serialize import SerializationError, dumps, loads, wire
from ..core.step import Step
from ..crypto.hashing import sha256
from .common_subset import CommonSubset

# Bounded future-message queue: queueing is capped per sender and per
# horizon; what exceeds either cap is dropped, and the repeat offender
# attributed every ``_FUTURE_FAULT_EVERY`` drops.
_FUTURE_HORIZON = 64  # queue at most this many epochs past the window
_FUTURE_MAX_PER_SENDER = 64  # queued future messages per sender
_FUTURE_FAULT_EVERY = 32  # attribute every Nth drop per sender


@wire("HbBatch")
@dataclasses.dataclass(frozen=True)
class Batch:
    """One epoch's output: the agreed, decrypted contributions
    (reference ``batch.rs:7-10``)."""

    epoch: int
    contributions: Dict[Any, Any]

    def tx_iter(self):
        for _, contrib in sorted(self.contributions.items(), key=lambda kv: str(kv[0])):
            yield from contrib

    def __len__(self) -> int:
        return sum(len(c) for c in self.contributions.values())

    def is_empty(self) -> bool:
        return all(len(c) == 0 for c in self.contributions.values())


@wire("HbOrderedBatch")
@dataclasses.dataclass(frozen=True)
class OrderedBatch:
    """The ordered-commit record (``reveal_mode="ordered"``): emitted
    the moment epoch ``epoch``'s common subset decides.  ``seq`` is the
    node-local monotonic commit sequence number, ``digest`` pins the
    agreed ciphertext batch (canonical serialization, so every correct
    node derives the same digest), ``proposers`` the accepted subset.
    The plaintext :class:`Batch` for the same epoch follows once
    decryption shares arrive."""

    epoch: int
    seq: int
    digest: bytes
    proposers: Any  # tuple of accepted proposer ids, canonical order


def ordered_batch_digest(epoch: int, ciphertexts: Dict[Any, Any]) -> bytes:
    """The digest an :class:`OrderedBatch` pins: a hash over the epoch
    and the canonical serialization of each accepted ciphertext, in
    proposer order.  Deterministic across nodes — the common subset
    fixed exactly these bytes."""
    parts = [dumps(epoch)]
    for pid in sorted(ciphertexts, key=str):
        parts.append(dumps(pid))
        parts.append(dumps(ciphertexts[pid]))
    return sha256(b"hbbft_tpu ordered batch v1" + b"".join(parts))


@wire("HbCs")
@dataclasses.dataclass(frozen=True)
class HbCommonSubset:
    msg: Any


@wire("HbDec")
@dataclasses.dataclass(frozen=True)
class HbDecryptionShare:
    proposer_id: Any
    share: Any


@wire("HbMsg")
@dataclasses.dataclass(frozen=True)
class HoneyBadgerMessage:
    epoch: int
    content: Any


class HoneyBadger(DistAlgorithm):
    """An instance of the Honey Badger BFT consensus algorithm."""

    def __init__(
        self,
        netinfo: NetworkInfo,
        max_future_epochs: int = 3,
        rng: Optional[random.Random] = None,
        speculative: bool = False,
        reveal_mode: str = "inline",
        max_outstanding_reveals: int = 4,
    ):
        self.netinfo = netinfo
        self.epoch = 0
        self.has_input_flag = False
        self.common_subsets: Dict[int, CommonSubset] = {}
        self.max_future_epochs = max_future_epochs
        self.incoming_queue: Dict[int, List] = {}
        # epoch -> proposer -> sender -> share
        self.received_shares: Dict[int, Dict[Any, Dict[Any, Any]]] = {}
        # epoch -> proposer -> decrypted contribution bytes
        self.decrypted_contributions: Dict[int, Dict[Any, bytes]] = {}
        # epoch -> proposer -> ciphertext
        self.ciphertexts: Dict[int, Dict[Any, Any]] = {}
        # order-then-reveal (see module doc): "inline" reproduces the
        # reference (decrypt before the batch outputs); "ordered" emits
        # an OrderedBatch at ACS completion and reveals asynchronously.
        if not isinstance(reveal_mode, str):
            # the reference's environment default (reveal_mode=None) is
            # not part of the port: the keyword is the one switch
            raise TypeError(f"reveal_mode must be a str, not {reveal_mode!r}")
        if reveal_mode not in ("inline", "ordered"):
            raise ValueError(f"unknown reveal_mode {reveal_mode!r}")
        self.reveal_mode = reveal_mode
        self.max_outstanding_reveals = max(1, int(max_outstanding_reveals))
        # epoch -> ordered seq, for ordered-but-unrevealed epochs; their
        # ciphertexts/received_shares stay pinned until the reveal
        self._pending_reveals: Dict[int, int] = {}
        self._ordered_seq = 0
        # speculative combine-first decryption (arXiv:2407.12172):
        # store shares unverified, combine the lowest f+1 at decrypt
        # time and validate the combined result once; per-share
        # verification runs only as the mismatch fallback (fault
        # attribution unchanged — see _try_decrypt_speculative).
        # Faults found by that deferred fallback accumulate here until
        # the next Step leaves this instance.
        self.speculative = speculative
        self._spec_hits = 0
        self._spec_misses = 0
        self._pending_faults = FaultLog()
        # future-queue accounting (bounded-memory long runs): how many
        # messages each sender has queued beyond the window, and how
        # many we have dropped on them (for periodic attribution)
        self._future_queued: Dict[Any, int] = {}
        self._future_drops: Dict[Any, int] = {}
        # deterministic per-node default (NetworkInfo.default_rng) —
        # replayable and co-simulation-stable; the seed folds in our
        # secret key so the ciphertext randomness stays unpredictable
        self.rng = rng if rng is not None else netinfo.default_rng("honey_badger")

    # -- DistAlgorithm -----------------------------------------------------

    def handle_input(self, contribution) -> Step:
        return self.propose(contribution)

    def handle_message(self, sender_id, message) -> Step:
        if not self.netinfo.is_node_validator(sender_id):
            raise UnknownSenderError(f"unknown sender {sender_id!r}")
        if not isinstance(message, HoneyBadgerMessage):
            return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
        epoch = message.epoch
        # a deserialized message can carry anything in the epoch slot;
        # comparing/queueing a non-int would raise instead of faulting
        if not isinstance(epoch, int) or isinstance(epoch, bool):
            return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
        if epoch > self.epoch + self.max_future_epochs:
            queued = self._future_queued.get(sender_id, 0)
            if (
                epoch > self.epoch + self.max_future_epochs + _FUTURE_HORIZON
                or queued >= _FUTURE_MAX_PER_SENDER
            ):
                return self._drop_future(sender_id, epoch)
            self._future_queued[sender_id] = queued + 1
            self.incoming_queue.setdefault(epoch, []).append(
                (sender_id, message.content)
            )
            return Step()
        if epoch < self.epoch:
            if epoch in self._pending_reveals:
                # ordered-but-unrevealed epoch: late decryption shares
                # (and subset stragglers) must still flow to the reveal
                return self._handle_message_content(
                    sender_id, epoch, message.content
                )
            return Step()  # obsolete
        return self._handle_message_content(sender_id, epoch, message.content)

    def _drop_future(self, sender_id, epoch: int) -> Step:
        """A future-epoch message we will not queue: count it and
        attribute the sender on every Nth drop (one drop can be clock
        skew; a stream of them is a flood)."""
        drops = self._future_drops.get(sender_id, 0) + 1
        self._future_drops[sender_id] = drops
        if drops % _FUTURE_FAULT_EVERY == 0:
            return Step.from_fault(sender_id, FaultKind.EPOCH_OUT_OF_RANGE)
        return Step()

    def _dec_future(self, sender_id) -> None:
        n = self._future_queued.get(sender_id, 0)
        if n <= 1:
            self._future_queued.pop(sender_id, None)
        else:
            self._future_queued[sender_id] = n - 1

    def terminated(self) -> bool:
        return False  # HoneyBadger runs forever

    def our_id(self):
        return self.netinfo.our_id

    # -- proposing ---------------------------------------------------------

    def propose(self, contribution) -> Step:
        if not self.netinfo.is_validator:
            return Step()
        epoch = self.epoch
        cs = self._common_subset(epoch)
        ser = dumps(contribution)
        ciphertext = self.netinfo.public_key_set.public_key().encrypt(
            ser, self.rng
        )
        self.has_input_flag = True
        cs_step = cs.handle_input(dumps(ciphertext))
        return self._process_output(cs_step, epoch)

    def has_input(self) -> bool:
        return not self.netinfo.is_validator or self.has_input_flag

    def received_proposals(self) -> int:
        cs = self.common_subsets.get(self.epoch)
        return cs.received_proposals() if cs else 0

    # -- message handling --------------------------------------------------

    def _common_subset(self, epoch: int) -> CommonSubset:
        cs = self.common_subsets.get(epoch)
        if cs is None:
            cs = CommonSubset(self.netinfo, epoch)
            self.common_subsets[epoch] = cs
        return cs

    def _handle_message_content(self, sender_id, epoch, content) -> Step:
        if isinstance(content, HbCommonSubset):
            return self._handle_common_subset_message(
                sender_id, epoch, content.msg
            )
        if isinstance(content, HbDecryptionShare):
            return self._handle_decryption_share_message(
                sender_id, epoch, content.proposer_id, content.share
            )
        return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)

    def _handle_common_subset_message(self, sender_id, epoch, cs_msg) -> Step:
        if epoch < self.epoch and epoch not in self.common_subsets:
            return Step()  # epoch already terminated
        cs = self._common_subset(epoch)
        cs_step = cs.handle_message(sender_id, cs_msg)
        step = self._process_output(cs_step, epoch)
        self._remove_terminated()
        return step

    def _handle_decryption_share_message(
        self, sender_id, epoch, proposer_id, share
    ) -> Step:
        # an unhashable proposer id (e.g. a decoded list) could never key
        # received_shares/ciphertexts — reject before any dict lookup
        try:
            known = self.netinfo.is_node_validator(proposer_id)
        except TypeError:
            return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)
        if not known:
            return Step.from_fault(sender_id, FaultKind.UNEXPECTED_PROPOSER)
        ciphertext = self.ciphertexts.get(epoch, {}).get(proposer_id)
        if ciphertext is not None and not self.speculative:
            if not self._verify_decryption_share(
                sender_id, share, ciphertext
            ):
                return Step.from_fault(
                    sender_id, FaultKind.INVALID_DECRYPTION_SHARE
                )
        # store (unverified if the ciphertext is not yet known; it will be
        # checked in _verify_pending_decryption_shares)
        self.received_shares.setdefault(epoch, {}).setdefault(
            proposer_id, {}
        )[sender_id] = share
        if epoch == self.epoch or epoch in self._pending_reveals:
            return self._try_output_batches()
        return Step()

    def _verify_decryption_share(self, sender_id, share, ciphertext) -> bool:
        pk = self.netinfo.public_key_share(sender_id)
        if pk is None:
            return False
        try:
            return self.netinfo.ops.verify_dec_share(pk, share, ciphertext)
        except Exception:
            return False

    # -- decryption + batch output ----------------------------------------

    def _process_output(self, cs_step, epoch: int) -> Step:
        step: Step = Step()
        cs_outputs = step.extend_with(
            cs_step,
            lambda m: HoneyBadgerMessage(epoch, HbCommonSubset(m)),
        )
        for cs_output in cs_outputs[:1]:
            step.extend(self._send_decryption_shares(cs_output, epoch))
        return step

    def _send_decryption_shares(self, cs_output, epoch: int) -> Step:
        step: Step = Step()
        ciphertexts: Dict[Any, Any] = {}
        for proposer_id in sorted(cs_output):
            ser_ct = cs_output[proposer_id]
            try:
                ciphertext = loads(ser_ct)
            except (SerializationError, Exception):
                step.add_fault(proposer_id, FaultKind.INVALID_CIPHERTEXT)
                continue
            try:
                valid = ciphertext.verify()
            except Exception:
                valid = False
            if not valid:
                step.add_fault(proposer_id, FaultKind.INVALID_CIPHERTEXT)
                continue
            if not self.speculative:
                incorrect, faults = self._verify_pending_decryption_shares(
                    proposer_id, ciphertext, epoch
                )
                self._remove_incorrect_decryption_shares(
                    proposer_id, incorrect, epoch
                )
                step.fault_log.merge(faults)
            if self.netinfo.is_validator:
                step.extend(
                    self._send_decryption_share(proposer_id, ciphertext, epoch)
                )
            ciphertexts[proposer_id] = ciphertext
        self.ciphertexts[epoch] = ciphertexts
        if epoch == self.epoch:
            step.extend(self._try_output_batches())
        return step

    def _send_decryption_share(self, proposer_id, ciphertext, epoch) -> Step:
        share = self.netinfo.secret_key_share.decrypt_share_no_verify(
            ciphertext
        )
        self.received_shares.setdefault(epoch, {}).setdefault(
            proposer_id, {}
        )[self.netinfo.our_id] = share
        step: Step = Step()
        step.send_all(
            HoneyBadgerMessage(epoch, HbDecryptionShare(proposer_id, share))
        )
        return step

    def _verify_pending_decryption_shares(
        self, proposer_id, ciphertext, epoch
    ):
        from ..core.fault import Fault, FaultLog

        incorrect: Set = set()
        faults = FaultLog()
        shares = self.received_shares.get(epoch, {}).get(proposer_id, {})
        # dict order is share-arrival order, which differs per schedule
        # — walk canonically so the fault log (and every downstream
        # message emission) is schedule-independent
        for sender_id, share in sorted(
            shares.items(), key=lambda kv: repr(kv[0])
        ):
            if not self._verify_decryption_share(
                sender_id, share, ciphertext
            ):
                faults.add(sender_id, FaultKind.INVALID_DECRYPTION_SHARE)
                incorrect.add(sender_id)
        return incorrect, faults

    def _remove_incorrect_decryption_shares(
        self, proposer_id, incorrect, epoch
    ) -> None:
        shares = self.received_shares.get(epoch, {}).get(proposer_id, {})
        for sender_id in sorted(incorrect, key=repr):
            shares.pop(sender_id, None)

    def _try_output_batches(self) -> Step:
        step: Step = Step()
        while True:
            progressed = False
            while True:
                new_step = self._try_output_batch()
                if new_step is None:
                    break
                progressed = True
                step.extend(new_step)
            if self.reveal_mode == "ordered":
                revealed = self._try_reveal_batches(step)
                if revealed:
                    # a completed reveal may have unstalled backpressured
                    # ordering — retry the commit loop
                    progressed = True
                    continue
            break
        if not self._pending_faults.is_empty():
            # faults found by the speculative-combine fallback: surface
            # them on whichever Step leaves the instance next (the eager
            # path reports at share arrival; the set is identical)
            step.fault_log.merge(self._pending_faults)
            self._pending_faults = FaultLog()
        return step

    def _try_output_batch(self) -> Optional[Step]:
        cts = self.ciphertexts.get(self.epoch)
        if cts is None:
            return None
        if self.reveal_mode == "ordered":
            return self._try_ordered_commit(cts)
        if not all(
            self._try_decrypt_proposer_contribution(pid, self.epoch)
            for pid in sorted(cts)
        ):
            return None
        step = self._assemble_batch(self.epoch)
        step.extend(self._update_epoch())
        return step

    def _try_ordered_commit(self, cts) -> Optional[Step]:
        """Ordered-commit: seal the epoch's agreed ciphertext batch the
        moment ACS output lands and advance to the next epoch without
        waiting for decryption.  Per-epoch state stays pinned until the
        reveal.  At ``max_outstanding_reveals`` pending epochs, ordering
        stalls (backpressure) until the oldest reveal completes."""
        if len(self._pending_reveals) >= self.max_outstanding_reveals:
            return None
        epoch = self.epoch
        seq = self._ordered_seq
        self._ordered_seq += 1
        self._pending_reveals[epoch] = seq
        step: Step = Step()
        step.output.append(
            OrderedBatch(
                epoch=epoch,
                seq=seq,
                digest=ordered_batch_digest(epoch, cts),
                proposers=tuple(sorted(cts, key=str)),
            )
        )
        step.extend(self._update_epoch(retain=True))
        return step

    def _try_reveal_batches(self, step: Step) -> bool:
        """Reveal pending ordered epochs, oldest first, extending
        ``step`` in place.  Reveals are delivered in epoch order (the
        ordered log's order), so the loop stops at the first epoch
        still short of decryption shares.  Returns whether any epoch
        revealed."""
        revealed = False
        for epoch in sorted(self._pending_reveals):
            new_step = self._try_reveal_batch(epoch)
            if new_step is None:
                break
            revealed = True
            step.extend(new_step)
        return revealed

    def _try_reveal_batch(self, epoch: int) -> Optional[Step]:
        cts = self.ciphertexts.get(epoch)
        if cts is None:  # state-transfer jumped past it
            self._pending_reveals.pop(epoch, None)
            return None
        if not all(
            self._try_decrypt_proposer_contribution(pid, epoch)
            for pid in sorted(cts)
        ):
            return None
        step = self._assemble_batch(epoch)
        self._pending_reveals.pop(epoch, None)
        self.ciphertexts.pop(epoch, None)
        self.received_shares.pop(epoch, None)
        return step

    def _assemble_batch(self, epoch: int) -> Step:
        """Deserialize epoch ``epoch``'s decrypted contributions into
        its plaintext :class:`Batch` (shared by the inline commit and
        the deferred reveal — byte-identical output by construction)."""
        step: Step = Step()
        contributions: Dict[Any, Any] = {}
        decrypted = self.decrypted_contributions.pop(epoch, {})
        for proposer_id, ser in sorted(decrypted.items(), key=lambda kv: str(kv[0])):
            try:
                contributions[proposer_id] = loads(ser)
            except (SerializationError, Exception):
                step.add_fault(
                    proposer_id, FaultKind.BATCH_DESERIALIZATION_FAILED
                )
        batch = Batch(epoch, contributions)
        step.output.append(batch)
        if self.speculative:
            self._spec_hits = 0
            self._spec_misses = 0
        return step

    def _try_decrypt_proposer_contribution(self, proposer_id, epoch) -> bool:
        if proposer_id in self.decrypted_contributions.get(epoch, {}):
            return True
        shares = self.received_shares.get(epoch, {}).get(proposer_id)
        if not shares or len(shares) <= self.netinfo.num_faulty:
            return False
        ciphertext = self.ciphertexts[epoch][proposer_id]
        if self.speculative:
            return self._try_decrypt_speculative(
                proposer_id, ciphertext, shares, epoch
            )
        shares_by_idx = {
            self.netinfo.node_index(nid): share
            for nid, share in shares.items()
        }
        try:
            contrib = self.netinfo.public_key_set.combine_decryption_shares(
                shares_by_idx, ciphertext
            )
            self.decrypted_contributions.setdefault(epoch, {})[
                proposer_id
            ] = contrib
        except Exception:
            # All shares were verified; failure here means the proposer's
            # ciphertext was malformed in a way verify() missed.  The
            # contribution is skipped (reference logs and continues,
            # ``honey_badger.rs:344-346``).
            pass
        return True

    def _try_decrypt_speculative(
        self, proposer_id, ciphertext, shares, epoch
    ) -> bool:
        """Combine-first decryption: combine the lowest f+1 received
        shares *unverified* and validate the combined result with one
        check.  Only on mismatch (a bad share inside the window) run
        the exact eager ``_verify_pending_decryption_shares`` sweep —
        the same senders are faulted with ``INVALID_DECRYPTION_SHARE``
        (deferred to the next outgoing Step), the bad shares are
        dropped, and the combine retries from what survives."""
        combine = getattr(
            self.netinfo.public_key_set,
            "combine_and_check_decryption_shares",
            None,
        )
        if combine is not None:
            shares_by_idx = {
                self.netinfo.node_index(nid): share
                for nid, share in shares.items()
            }
            sub_idxs = sorted(shares_by_idx)[: self.netinfo.num_faulty + 1]
            try:
                contrib = combine(
                    {i: shares_by_idx[i] for i in sub_idxs}, ciphertext
                )
            except Exception:
                contrib = None
            if contrib is not None:
                self._spec_hits += 1
                self.decrypted_contributions.setdefault(epoch, {})[
                    proposer_id
                ] = contrib
                return True
            self._spec_misses += 1
        # fallback: the eager path, verbatim — verify every pending
        # share, fault + drop the bad ones, recombine from the rest
        incorrect, faults = self._verify_pending_decryption_shares(
            proposer_id, ciphertext, epoch
        )
        self._remove_incorrect_decryption_shares(
            proposer_id, incorrect, epoch
        )
        self._pending_faults.merge(faults)
        shares = self.received_shares.get(epoch, {}).get(proposer_id)
        if not shares or len(shares) <= self.netinfo.num_faulty:
            return False
        shares_by_idx = {
            self.netinfo.node_index(nid): share
            for nid, share in shares.items()
        }
        try:
            contrib = self.netinfo.public_key_set.combine_decryption_shares(
                shares_by_idx, ciphertext
            )
            self.decrypted_contributions.setdefault(epoch, {})[
                proposer_id
            ] = contrib
        except Exception:
            pass  # see the eager branch above
        return True

    def _update_epoch(self, retain: bool = False) -> Step:
        if not retain:
            self.ciphertexts.pop(self.epoch, None)
            self.received_shares.pop(self.epoch, None)
        self.epoch += 1
        self.has_input_flag = False
        max_epoch = self.epoch + self.max_future_epochs
        step: Step = Step()
        for sender_id, content in self.incoming_queue.pop(max_epoch, []):
            self._dec_future(sender_id)
            step.extend(
                self._handle_message_content(sender_id, max_epoch, content)
            )
        step.extend(self._try_output_batches())
        return step

    def _remove_terminated(self) -> None:
        for epoch in [
            e
            for e, cs in self.common_subsets.items()
            if e < self.epoch and cs.terminated()
        ]:
            del self.common_subsets[epoch]

    # -- state transfer + bounded-memory GC --------------------------------

    def fast_forward(self, upto_epoch: int, batches: List[Any]) -> Step:
        """Install a quorum-verified snapshot: output the transferred
        batches for epochs ``[self.epoch, upto_epoch]`` and jump to
        ``upto_epoch + 1``, exactly as if this node had decided those
        epochs itself.  The caller (``recover/transfer.py``) has
        already digest-verified the batches against f+1 peers.

        In-flight per-epoch state for the skipped window is discarded
        (those epochs are decided — the batch IS the decision); queued
        future messages that land inside the new window are
        re-dispatched, ones behind it are dropped."""
        if upto_epoch < self.epoch:
            return Step()
        step: Step = Step()
        by_epoch: Dict[int, Any] = {}
        for b in batches:
            ep = getattr(b, "epoch", None)
            if (
                isinstance(b, Batch)
                and isinstance(ep, int)
                and not isinstance(ep, bool)
                and self.epoch <= ep <= upto_epoch
            ):
                by_epoch[ep] = b
        for ep in sorted(by_epoch):
            step.output.append(by_epoch[ep])
        for d in (self.common_subsets, self.received_shares, self.ciphertexts):
            for ep in [e for e in d if e <= upto_epoch]:
                del d[ep]
        self.decrypted_contributions = {}
        # ordered-but-unrevealed epochs inside the jump are decided by
        # the transferred batches — the pending reveals are moot
        for ep in [e for e in self._pending_reveals if e <= upto_epoch]:
            del self._pending_reveals[ep]
        self._pending_faults = FaultLog()
        self.epoch = upto_epoch + 1
        self.has_input_flag = False
        # re-dispatch queued messages now inside the window; drop the
        # ones the jump made obsolete
        window_hi = self.epoch + self.max_future_epochs
        for ep in sorted([e for e in self.incoming_queue if e <= window_hi]):
            for sender_id, content in self.incoming_queue.pop(ep, []):
                self._dec_future(sender_id)
                if ep >= self.epoch:
                    step.extend(
                        self._handle_message_content(sender_id, ep, content)
                    )
        step.extend(self._try_output_batches())
        return step

    def gc_epochs(self) -> int:
        """Prune per-epoch state for epochs before the current one —
        a node calls this after each durable checkpoint, so a
        long-running node's dicts stay bounded by the live window.
        (``_remove_terminated`` already drops *terminated* past subset
        instances; this also reclaims ones wedged by a faulty peer.)"""
        dropped = 0
        for d in (self.common_subsets, self.received_shares, self.ciphertexts):
            for ep in [
                e
                for e in d
                if e < self.epoch and e not in self._pending_reveals
            ]:
                del d[ep]
                dropped += 1
        for ep in [e for e in self.incoming_queue if e < self.epoch]:
            for sender_id, _ in self.incoming_queue.pop(ep):
                self._dec_future(sender_id)
            dropped += 1
        return dropped


class HoneyBadgerBuilder:
    """Builder mirroring the reference's configuration surface
    (``honey_badger/builder.rs:13-57``)."""

    def __init__(self, netinfo: NetworkInfo):
        self.netinfo = netinfo
        self._max_future_epochs = 3
        self._rng: Optional[random.Random] = None
        self._speculative = False
        self._reveal_mode = "inline"
        self._max_outstanding_reveals = 4

    def max_future_epochs(self, value: int) -> "HoneyBadgerBuilder":
        self._max_future_epochs = value
        return self

    def rng(self, rng: random.Random) -> "HoneyBadgerBuilder":
        self._rng = rng
        return self

    def speculative(self, value: bool = True) -> "HoneyBadgerBuilder":
        """Combine-first decryption: one combined check per
        contribution instead of per-share verifies (fallback on
        mismatch keeps fault attribution)."""
        self._speculative = value
        return self

    def reveal_mode(self, value: str) -> "HoneyBadgerBuilder":
        """``"inline"`` (reference semantics) or ``"ordered"``
        (order-then-reveal: OrderedBatch at ACS completion, plaintext
        Batch asynchronously)."""
        self._reveal_mode = value
        return self

    def ordered(self, value: bool = True) -> "HoneyBadgerBuilder":
        """Shorthand for ``reveal_mode("ordered")``."""
        self._reveal_mode = "ordered" if value else "inline"
        return self

    def max_outstanding_reveals(self, value: int) -> "HoneyBadgerBuilder":
        """Backpressure bound for ``reveal_mode="ordered"``: ordering
        stalls once this many epochs are ordered but unrevealed."""
        self._max_outstanding_reveals = value
        return self

    def build(self) -> HoneyBadger:
        return HoneyBadger(
            self.netinfo,
            max_future_epochs=self._max_future_epochs,
            rng=self._rng,
            speculative=self._speculative,
            reveal_mode=self._reveal_mode,
            max_outstanding_reveals=self._max_outstanding_reveals,
        )
