"""SyncKeyGen — dealerless distributed key generation (Pedersen-style).

The port's own copy of ``hbbft_tpu/protocols/sync_key_gen.py`` (reference
``src/sync_key_gen.rs``).  Each validator deals a random symmetric
bivariate polynomial of degree t, publishing a G2 commitment and one
encrypted row per node (``Part``); receivers check their row against the
commitment and answer with encrypted evaluations (``Ack``); values are
verified against the commitment (``commit.evaluate(i, j) == val·P₂``).
A Part is *complete* at 2t+1 Acks; the DKG is *ready* when > t parts
are complete; ``generate()`` sums the complete parts' zero-row
commitments and interpolates own column values (lowest t+1 sender
indices) into the secret share.

Each ``Part`` also carries the dealer's master-secret commitment in G1
(``master_g1``), pairing-checked against the G2 commitment, because
threshold encryption needs the master key in G1.  A mock dealing path
mirrors the message flow for fast protocol tests.  All nodes must handle
the identical message sequence, which ``DynamicHoneyBadger`` guarantees
by committing Parts and Acks on-chain.  The checks here run item by item
on the host (native G2 MSMs and pairings); the vectorized DKG
(``harness/dkg.py``) is the fused path on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Set, Tuple

from ..core.fault import FaultKind, FaultLog
from ..core.serialize import SerializationError, dumps, loads, wire
from ..crypto import fields as F
from ..crypto import mock as M
from ..crypto import threshold as T
from ..crypto.curve import G1, G1_GEN, G2_GEN
from ..crypto.hashing import sha256
from ..crypto.pairing import pairing_check
from ..crypto.poly import BivarCommitment, BivarPoly, Commitment, Poly, interpolate_at_zero


@wire("DkgPart")
@dataclasses.dataclass(frozen=True)
class Part:
    """Commitment + per-node encrypted rows (+ G1 master commitment)."""

    commit: Any  # BivarCommitment (real) | bytes commitment (mock)
    rows: Tuple  # encrypted row per node (real) | plain seed (mock)
    master_g1: Any  # G1 (real) | None (mock)


@wire("DkgAck")
@dataclasses.dataclass(frozen=True)
class Ack:
    proposer_idx: int
    values: Tuple  # encrypted value per node (real) | plain seed (mock)


class _ProposalState:
    """Tracks one dealer's sharing process (reference ``ProposalState``,
    ``sync_key_gen.rs:206-229``)."""

    def __init__(self, commit, master_g1):
        self.commit = commit
        self.master_g1 = master_g1
        self.values: Dict[int, int] = {}  # sender_idx+1 -> Fr value
        self.acks: Set[int] = set()
        self.mock_seed: Optional[bytes] = None

    def is_complete(self, threshold: int) -> bool:
        return len(self.acks) > 2 * threshold


class SyncKeyGen:
    """One DKG session over a fixed candidate validator set."""

    def __init__(self, our_id, sec_key, pub_keys: Dict[Any, Any], threshold: int, rng):
        """Returns the instance; the ``Part`` to multicast is in
        ``self.our_part`` (None for observers)."""
        self.our_id = our_id
        self.sec_key = sec_key
        self.pub_keys = dict(pub_keys)
        self.threshold = threshold
        self.node_ids = sorted(pub_keys)
        self.our_idx: Optional[int] = (
            self.node_ids.index(our_id) if our_id in pub_keys else None
        )
        self.parts: Dict[int, _ProposalState] = {}
        self.mock = isinstance(sec_key, M.MockSecretKey)
        self.our_part: Optional[Part] = None
        if self.our_idx is None:
            return  # observer: deals nothing
        if self.mock:
            seed = rng.randrange(2**256).to_bytes(32, "big")
            self.our_part = Part(sha256(b"DKGSEED" + seed), (seed,) * len(self.node_ids), None)
        else:
            bivar = BivarPoly.random(threshold, rng)
            commit = bivar.commitment()
            rows = []
            for i, nid in enumerate(self.node_ids):
                row = bivar.row(i + 1)
                rows.append(self.pub_keys[nid].encrypt(dumps(row), rng))
            master_g1 = G1_GEN * bivar.evaluate(0, 0)
            self.our_part = Part(commit, tuple(rows), master_g1)
            self._rng = rng

    def node_index(self, nid) -> Optional[int]:
        try:
            return self.node_ids.index(nid)
        except ValueError:
            return None

    # -- Part --------------------------------------------------------------

    def handle_part(self, sender_id, part: Part, rng=None):
        """Returns (Ack | None, FaultLog).  All participants must handle
        the identical Part sequence (including their own)."""
        faults = FaultLog()
        sender_idx = self.node_index(sender_id)
        if sender_idx is None:
            return None, faults
        if sender_idx in self.parts:
            return None, faults  # ignore duplicate parts (reference :315)
        if self.mock:
            return self._handle_part_mock(sender_id, sender_idx, part, faults)
        if not self._part_well_formed(part):
            faults.add(sender_id, FaultKind.INVALID_PART)
            return None, faults
        self.parts[sender_idx] = _ProposalState(part.commit, part.master_g1)
        if self.our_idx is None:
            return None, faults  # observer: no Ack
        commit_row = part.commit.row(self.our_idx + 1)
        ser_row = self.sec_key.decrypt(part.rows[self.our_idx])
        if ser_row is None:
            faults.add(sender_id, FaultKind.INVALID_PART)
            return None, faults
        try:
            row = loads(ser_row)
            assert isinstance(row, Poly) and row.degree == self.threshold
        except (SerializationError, AssertionError, Exception):
            faults.add(sender_id, FaultKind.INVALID_PART)
            return None, faults
        if row.commitment() != commit_row:
            faults.add(sender_id, FaultKind.INVALID_PART)
            return None, faults
        # row is valid: encrypt one evaluation for every node
        rng = rng if rng is not None else self._rng
        values = tuple(
            self.pub_keys[nid].encrypt(dumps(row.evaluate(j + 1)), rng)
            for j, nid in enumerate(self.node_ids)
        )
        return Ack(sender_idx, values), faults

    def _part_well_formed(self, part: Part) -> bool:
        if not isinstance(part, Part) or not isinstance(part.commit, BivarCommitment):
            return False
        if part.commit.degree != self.threshold or not part.commit.is_symmetric():
            return False
        if len(part.rows) != len(self.node_ids):
            return False
        if not isinstance(part.master_g1, G1):
            return False
        # consistency of the G1 master commitment with the G2 one:
        # e(A, P₂) == e(P₁, C(0,0))
        return pairing_check(
            [(part.master_g1, G2_GEN), (-G1_GEN, part.commit.evaluate(0, 0))]
        )

    def _handle_part_mock(self, sender_id, sender_idx, part, faults):
        seed = part.rows[self.our_idx if self.our_idx is not None else 0]
        if sha256(b"DKGSEED" + seed) != part.commit:
            faults.add(sender_id, FaultKind.INVALID_PART)
            return None, faults
        st = _ProposalState(part.commit, None)
        st.mock_seed = seed
        self.parts[sender_idx] = st
        if self.our_idx is None:
            return None, faults
        return Ack(sender_idx, (seed,) * len(self.node_ids)), faults

    # -- Ack ---------------------------------------------------------------

    def handle_ack(self, sender_id, ack: Ack) -> FaultLog:
        faults = FaultLog()
        sender_idx = self.node_index(sender_id)
        if sender_idx is None:
            return faults
        err = self._handle_ack_or_err(sender_idx, ack)
        if err is not None:
            faults.add(sender_id, FaultKind.INVALID_ACK)
        return faults

    def _handle_ack_or_err(self, sender_idx: int, ack: Ack) -> Optional[str]:
        if not isinstance(ack, Ack):
            return "malformed ack"
        if len(ack.values) != len(self.node_ids):
            return "wrong node count"
        if not isinstance(ack.proposer_idx, int) or isinstance(
            ack.proposer_idx, bool
        ):
            # the wire can carry anything here — an unhashable
            # proposer_idx would TypeError the dict lookup below
            return "malformed proposer index"
        part = self.parts.get(ack.proposer_idx)
        if part is None:
            return "sender does not exist"
        if sender_idx in part.acks:
            return "duplicate ack"
        part.acks.add(sender_idx)
        if self.our_idx is None:
            return None  # observer: nothing to decrypt
        if self.mock:
            if ack.values[self.our_idx] != part.mock_seed:
                part.acks.discard(sender_idx)
                return "wrong value"
            return None
        ser_val = self.sec_key.decrypt(ack.values[self.our_idx])
        if ser_val is None:
            part.acks.discard(sender_idx)
            return "value decryption failed"
        try:
            val = loads(ser_val)
            assert isinstance(val, int)
        except (SerializationError, AssertionError, Exception):
            part.acks.discard(sender_idx)
            return "deserialization failed"
        # the exact check of sync_key_gen.rs:449, in G2
        if part.commit.evaluate(self.our_idx + 1, sender_idx + 1) != G2_GEN * val:
            part.acks.discard(sender_idx)
            return "wrong value"
        part.values[sender_idx + 1] = val % F.R
        return None

    # -- readiness + generation -------------------------------------------

    def count_complete(self) -> int:
        return sum(
            1 for p in self.parts.values() if p.is_complete(self.threshold)
        )

    def is_node_ready(self, proposer_id) -> bool:
        idx = self.node_index(proposer_id)
        part = self.parts.get(idx) if idx is not None else None
        return part is not None and part.is_complete(self.threshold)

    def is_ready(self) -> bool:
        return self.count_complete() > self.threshold

    def generate(self):
        """Returns (public_key_set, secret_key_share | None).

        Only secure if ``is_ready()``; all participants must have handled
        the identical Part/Ack sequence."""
        complete = [
            (idx, p)
            for idx, p in sorted(self.parts.items())
            if p.is_complete(self.threshold)
        ]
        if self.mock:
            seed = sha256(
                b"DKGGROUP"
                + b"".join(
                    idx.to_bytes(4, "big") + p.mock_seed for idx, p in complete
                )
            )
            pk_set = M.MockPublicKeySet(seed, self.threshold)
            sks = (
                M.MockSecretKeyShare(seed, self.our_idx)
                if self.our_idx is not None
                else None
            )
            return pk_set, sks
        pk_commit = Commitment([])
        master_g1 = G1.infinity()
        sk_val: Optional[int] = 0 if self.our_idx is not None else None
        for idx, part in complete:
            pk_commit = pk_commit + part.commit.row(0)
            master_g1 = master_g1 + part.master_g1
            if sk_val is not None:
                pts = sorted(part.values.items())[: self.threshold + 1]
                if len(pts) <= self.threshold:
                    raise ValueError(
                        "not enough verified values to reconstruct the share"
                    )
                sk_val = (sk_val + interpolate_at_zero(pts)) % F.R
        pk_set = T.PublicKeySet(pk_commit, master_g1)
        sks = T.SecretKeyShare(sk_val) if sk_val is not None else None
        return pk_set, sks

    def into_network_info(self, ops=None):
        """Builds the post-DKG NetworkInfo (reference
        ``sync_key_gen.rs:416-420``)."""
        from ..core.network_info import NetworkInfo

        pk_set, sks = self.generate()
        return NetworkInfo(
            self.our_id, sks, self.sec_key, pk_set, self.pub_keys, ops=ops
        )
