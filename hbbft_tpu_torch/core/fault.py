"""Byzantine-fault evidence log — the kinds the DKG and the epoch report.

The port's own copy of ``FaultKind``, ``Fault`` and ``FaultLog`` from
``hbbft_tpu/core/fault.py`` (reference ``src/fault_log.rs``), trimmed to
the kinds the verified DKG and the vectorized HoneyBadger epoch
attribute: invalid DKG Parts and Acks; in an epoch, invalid decryption
and coin signature shares, invalid ciphertexts, undecryptable or
undeserializable contributions, invalid Merkle proofs and broadcasts
that cannot be reconstructed; in the dynamic layer, votes with invalid
signatures.  Names and texts are the reference's, so two
logs compare by ``(node_id, kind.name)``.  The reference's trace
telemetry is not carried over; faults are logged at DEBUG level.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from typing import Any, Iterator, List, Optional

log = logging.getLogger("hbbft_tpu_torch")


class FaultKind(enum.Enum):
    """Typed reasons a node can be flagged as faulty (DKG and epoch
    subset)."""

    INVALID_DECRYPTION_SHARE = "sent an invalid threshold-decryption share"
    INVALID_CIPHERTEXT = "proposed an invalid ciphertext"
    SHARE_DECRYPTION_FAILED = "contribution could not be decrypted from combined shares"
    BATCH_DESERIALIZATION_FAILED = "batch contribution failed to deserialize"
    INVALID_SIGNATURE_SHARE = "sent an invalid threshold-signature share"
    INVALID_PROOF = "sent an Echo or Value with an invalid Merkle proof"
    BROADCAST_DECODING_FAILED = "broadcast value could not be reconstructed"
    INVALID_PART = "committed an invalid DKG Part"
    INVALID_ACK = "committed an invalid DKG Ack"
    INVALID_VOTE_SIGNATURE = "sent a vote with an invalid signature"

    def __repr__(self) -> str:
        return f"FaultKind.{self.name}"


@dataclasses.dataclass(frozen=True)
class Fault:
    """One attributed protocol violation."""

    node_id: Any
    kind: FaultKind

    def compact(self) -> str:
        """``<node_id!r>:<KIND_NAME>``, the reference's stable form."""
        return f"{self.node_id!r}:{self.kind.name}"

    def __repr__(self) -> str:
        return f"Fault({self.compact()})"


class FaultLog:
    """Append-only list of :class:`Fault`."""

    __slots__ = ("_faults",)

    def __init__(self, faults: Optional[List[Fault]] = None):
        self._faults: List[Fault] = list(faults) if faults else []

    def append(self, fault: Fault) -> None:
        log.debug("fault: %s (%s)", fault.compact(), fault.kind.value)
        self._faults.append(fault)

    def add(self, node_id: Any, kind: FaultKind) -> None:
        self.append(Fault(node_id, kind))

    def merge(self, other: "FaultLog") -> None:
        """Drain ``other`` into self (reference ``merge_into``)."""
        self._faults.extend(other._faults)

    def is_empty(self) -> bool:
        return not self._faults

    def __len__(self) -> int:
        return len(self._faults)

    def __iter__(self) -> Iterator[Fault]:
        return iter(self._faults)

    def __repr__(self) -> str:
        return f"FaultLog({self._faults!r})"
