"""Reliable Broadcast (RBC) — erasure-coded, Merkle-authenticated.

The port's own copy of ``hbbft_tpu/protocols/broadcast.py`` (reference
``src/broadcast.rs``): the proposer Reed-Solomon-encodes its value into
N shards (N−2f data + 2f parity), commits to them in a SHA-256 Merkle
tree and sends each node its shard + inclusion proof.  Three-phase
Value → Echo → Ready protocol:

- Echo on first valid ``Value`` from the proposer;
- Ready after N−f Echos with one root;
- Ready-amplification at f+1 Readys;
- decode + output at ≥ 2f+1 Readys ∧ ≥ N−2f Echos, re-building the
  Merkle tree from the reconstructed shards to detect an equivocating
  proposer.

The RS codec and the Merkle trees come from ``netinfo.ops``
(``rs_codec``, ``merkle_tree``): the host codecs of
``crypto.backend.CpuBackend``, or ``CudaBackend``'s device codecs and
trees where its size rules send the work to the card.
``frame_into_shards`` / ``unframe_shards`` are shared with the
vectorized epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ..core.algorithm import DistAlgorithm, HbbftError
from ..core.fault import FaultKind
from ..core.network_info import NetworkInfo
from ..core.serialize import wire
from ..core.fault import log as _log
from ..core.step import Step
from ..crypto.merkle import MerkleProof


@wire("BcValue")
@dataclasses.dataclass(frozen=True)
class BroadcastValue:
    proof: MerkleProof


@wire("BcEcho")
@dataclasses.dataclass(frozen=True)
class BroadcastEcho:
    proof: MerkleProof


@wire("BcReady")
@dataclasses.dataclass(frozen=True)
class BroadcastReady:
    root_hash: bytes


BroadcastMessage = Any  # one of the three dataclasses above


def frame_into_shards(
    value: bytes, data_shard_num: int, symbol: int = 1
) -> List[bytes]:
    """Length-prefix + pad + split into equal data shards (reference
    ``send_shards``, ``broadcast.rs:341-363``), for the proposer path and
    the vectorized epoch's broadcast phase; shard lengths round up to a
    multiple of the codec's ``symbol`` width (2 for the GF(2^16) codec)."""
    payload = len(value).to_bytes(4, "big") + value
    shard_len = max(-(-len(payload) // data_shard_num), 1)
    shard_len = -(-shard_len // symbol) * symbol
    padded = payload.ljust(shard_len * data_shard_num, b"\x00")
    return [
        padded[i * shard_len : (i + 1) * shard_len]
        for i in range(data_shard_num)
    ]


def unframe_shards(shards: List[bytes], data_shard_num: int) -> Optional[bytes]:
    """Inverse of :func:`frame_into_shards`: join + strip the 4-byte
    length header (reference ``glue_shards``, ``broadcast.rs:697-707``).
    Returns None if the length header is inconsistent (a malformed
    proposal — the caller attributes the fault)."""
    payload = b"".join(shards[:data_shard_num])
    length = int.from_bytes(payload[:4], "big")
    if length > len(payload) - 4:
        return None
    return payload[4 : 4 + length]


class BroadcastError(HbbftError):
    pass


class InstanceCannotPropose(BroadcastError):
    pass


class Broadcast(DistAlgorithm):
    """One broadcast instance: ``proposer_id`` proposes, everyone delivers."""

    def __init__(self, netinfo: NetworkInfo, proposer_id):
        if not netinfo.is_node_validator(proposer_id):
            raise BroadcastError(f"unknown proposer {proposer_id!r}")
        self.netinfo = netinfo
        self.proposer_id = proposer_id
        self.parity_shard_num = 2 * netinfo.num_faulty
        self.data_shard_num = netinfo.num_nodes - self.parity_shard_num
        self.coding = netinfo.ops.rs_codec(
            self.data_shard_num, self.parity_shard_num
        )
        self.echo_sent = False
        self.ready_sent = False
        self.decided = False
        self.echos: Dict[Any, MerkleProof] = {}
        self.readys: Dict[Any, bytes] = {}

    # -- DistAlgorithm -----------------------------------------------------

    def handle_input(self, value: bytes) -> Step:
        if self.netinfo.our_id != self.proposer_id:
            raise InstanceCannotPropose(
                "only the proposer may input a value"
            )
        proof, step = self._send_shards(bytes(value))
        step.extend(self._handle_value(self.netinfo.our_id, proof))
        return step

    def handle_message(self, sender_id, message) -> Step:
        if not self.netinfo.is_node_validator(sender_id):
            raise BroadcastError(f"unknown sender {sender_id!r}")
        if isinstance(message, BroadcastValue):
            return self._handle_value(sender_id, message.proof)
        if isinstance(message, BroadcastEcho):
            return self._handle_echo(sender_id, message.proof)
        if isinstance(message, BroadcastReady):
            return self._handle_ready(sender_id, message.root_hash)
        return Step.from_fault(sender_id, FaultKind.INVALID_MESSAGE)

    def terminated(self) -> bool:
        return self.decided

    def our_id(self):
        return self.netinfo.our_id

    # -- proposer path -----------------------------------------------------

    def _send_shards(self, value: bytes):
        """RS-encode + Merkle-commit the value; unicast proof i to node i
        (reference ``send_shards``, ``broadcast.rs:332-404``)."""
        data = frame_into_shards(
            value, self.data_shard_num, getattr(self.coding, "symbol", 1)
        )
        shards = self.coding.encode(data)
        mtree = self.netinfo.ops.merkle_tree(shards)
        step: Step = Step()
        our_proof: Optional[MerkleProof] = None
        for idx, nid in enumerate(self.netinfo.all_ids):
            proof = mtree.proof(idx)
            if nid == self.netinfo.our_id:
                our_proof = proof
            else:
                step.send_to(nid, BroadcastValue(proof))
        assert our_proof is not None
        return our_proof, step

    # -- handlers ----------------------------------------------------------

    def _handle_value(self, sender_id, proof: MerkleProof) -> Step:
        if sender_id != self.proposer_id:
            return Step.from_fault(
                sender_id, FaultKind.RECEIVED_VALUE_FROM_NON_PROPOSER
            )
        if self.echo_sent:
            # A second Value is ignored (reference keeps this non-fatal,
            # ``broadcast.rs:418-427``).
            return Step()
        if not self._validate_proof(proof, self.netinfo.our_id):
            return Step.from_fault(sender_id, FaultKind.INVALID_PROOF)
        return self._send_echo(proof)

    def _handle_echo(self, sender_id, proof: MerkleProof) -> Step:
        if sender_id in self.echos:
            return Step()
        if not self._validate_proof(proof, sender_id):
            return Step.from_fault(sender_id, FaultKind.INVALID_PROOF)
        root = proof.root_hash
        self.echos[sender_id] = proof
        if self.ready_sent or self._count_echos(root) < self.netinfo.num_correct:
            return self._compute_output(root)
        # N − f Echos with this root ⇒ multicast Ready
        return self._send_ready(root)

    def _handle_ready(self, sender_id, root: bytes) -> Step:
        if sender_id in self.readys:
            return Step()
        self.readys[sender_id] = root
        step: Step = Step()
        if (
            self._count_readys(root) == self.netinfo.num_faulty + 1
            and not self.ready_sent
        ):
            step.extend(self._send_ready(root))
        step.extend(self._compute_output(root))
        return step

    # -- sending (observers send nothing) ---------------------------------

    def _send_echo(self, proof: MerkleProof) -> Step:
        self.echo_sent = True
        if not self.netinfo.is_validator:
            return Step()
        step: Step = Step()
        step.send_all(BroadcastEcho(proof))
        step.extend(self._handle_echo(self.netinfo.our_id, proof))
        return step

    def _send_ready(self, root: bytes) -> Step:
        self.ready_sent = True
        if not self.netinfo.is_validator:
            return Step()
        step: Step = Step()
        step.send_all(BroadcastReady(root))
        step.extend(self._handle_ready(self.netinfo.our_id, root))
        return step

    # -- output ------------------------------------------------------------

    def _compute_output(self, root: bytes) -> Step:
        if (
            self.decided
            or self._count_readys(root) <= 2 * self.netinfo.num_faulty
            or self._count_echos(root) < self.data_shard_num
        ):
            return Step()
        # ≥ 2f+1 Readys and ≥ N−2f Echos: reconstruct all shards.
        slots: List[Optional[bytes]] = [None] * self.netinfo.num_nodes
        for proof in self.echos.values():
            if proof.root_hash == root:
                slots[proof.index] = proof.value
        try:
            shards = self.coding.reconstruct(slots)
        except ValueError:
            return Step()
        # Re-root the tree: detects a proposer that equivocated between
        # shard sets (reference ``decode_from_shards``,
        # ``broadcast.rs:660-692``).
        mtree = self.netinfo.ops.merkle_tree(shards)
        if mtree.root_hash != root:
            return Step.from_fault(
                self.proposer_id, FaultKind.BROADCAST_DECODING_FAILED
            )
        value = unframe_shards(shards, self.data_shard_num)
        if value is None:
            return Step.from_fault(
                self.proposer_id, FaultKind.BROADCAST_DECODING_FAILED
            )
        self.decided = True
        _log.debug(
            "%r: broadcast from %r delivered (%d bytes)",
            self.netinfo.our_id, self.proposer_id, len(value),
        )
        return Step.with_output(value)

    # -- helpers -----------------------------------------------------------

    def _validate_proof(self, proof: MerkleProof, nid) -> bool:
        """Proof must verify and carry the shard index assigned to ``nid``
        (reference ``validate_proof``, ``broadcast.rs:555-575``)."""
        if not isinstance(proof, MerkleProof):
            return False
        idx = self.netinfo.node_index(nid)
        return (
            idx is not None
            and proof.index == idx
            and isinstance(proof.value, bytes)
            and proof.validate(self.netinfo.num_nodes)
        )

    def _count_echos(self, root: bytes) -> int:
        return sum(1 for p in self.echos.values() if p.root_hash == root)

    def _count_readys(self, root: bytes) -> int:
        return sum(1 for r in self.readys.values() if r == root)


def random_message(rng, n_nodes: int = 4):
    """Generate a random (garbage) broadcast message for fuzz adversaries
    (reference ``rand::Rand`` impl, ``broadcast.rs:210-229``)."""
    kind = rng.randrange(3)
    if kind == 2:
        return BroadcastReady(rng.randrange(2**256).to_bytes(32, "big"))
    proof = MerkleProof(
        value=bytes(rng.randrange(256) for _ in range(8)),
        index=rng.randrange(n_nodes),
        lemma=tuple(
            rng.randrange(2**256).to_bytes(32, "big")
            for _ in range(max(1, n_nodes - 1).bit_length())
        ),
        root_hash=rng.randrange(2**256).to_bytes(32, "big"),
    )
    return BroadcastValue(proof) if kind == 0 else BroadcastEcho(proof)
