"""Byzantine-fault evidence log.

The port's own copy of ``FaultKind``, ``Fault`` and ``FaultLog`` from
``hbbft_tpu/core/fault.py`` (reference ``src/fault_log.rs``): every kind
of the reference, with its name, text and order, so two logs compare by
``(node_id, kind.name)`` and ``Fault.compact()`` gives the same string in
both packages.  Protocol handlers attribute each violation to its sender
and return it in their ``Step``; fault logs propagate up the protocol
stack unchanged.  The reference's trace telemetry is not carried over;
faults are logged at DEBUG level on the ``hbbft_tpu_torch`` logger.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from typing import Any, Iterator, List, Optional

log = logging.getLogger("hbbft_tpu_torch")


class FaultKind(enum.Enum):
    """Typed reasons a node can be flagged as faulty (reference
    ``src/fault_log.rs:10-49``)."""

    # Threshold decryption (HoneyBadger)
    UNVERIFIED_DECRYPTION_SHARE_SENDER = "sent a decryption share while we have no ciphertext to check it against"
    INVALID_DECRYPTION_SHARE = "sent an invalid threshold-decryption share"
    INVALID_CIPHERTEXT = "proposed an invalid ciphertext"
    SHARE_DECRYPTION_FAILED = "contribution could not be decrypted from combined shares"
    BATCH_DESERIALIZATION_FAILED = "batch contribution failed to deserialize"
    # Common coin
    UNVERIFIED_SIGNATURE_SHARE_SENDER = "sent a signature share before we could verify it"
    INVALID_SIGNATURE_SHARE = "sent an invalid threshold-signature share"
    # Broadcast
    INVALID_PROOF = "sent an Echo or Value with an invalid Merkle proof"
    RECEIVED_VALUE_FROM_NON_PROPOSER = "sent a Value although not the proposer"
    MULTIPLE_VALUES = "sent more than one Value"
    MULTIPLE_ECHOS = "sent more than one Echo"
    MULTIPLE_READYS = "sent more than one Ready"
    BROADCAST_DECODING_FAILED = "broadcast value could not be reconstructed"
    # Agreement
    DUPLICATE_BVAL = "sent a duplicate BVal"
    DUPLICATE_AUX = "sent a duplicate Aux"
    DUPLICATE_CONF = "sent a duplicate Conf"
    DUPLICATE_TERM = "sent a duplicate Term"
    AGREEMENT_EPOCH_BEHIND = "sent an Agreement message for an expired epoch"
    # Common subset
    UNEXPECTED_PROPOSER = "referred to an unknown proposer"
    # Dynamic honey badger / DKG
    INVALID_VOTE_SIGNATURE = "sent a vote with an invalid signature"
    INVALID_KEY_GEN_MESSAGE_SIGNATURE = "sent a key-gen message with an invalid signature"
    INVALID_PART = "committed an invalid DKG Part"
    INVALID_ACK = "committed an invalid DKG Ack"
    MULTIPLE_PARTS = "committed more than one DKG Part"
    UNEXPECTED_KEY_GEN_MESSAGE = "committed an unexpected key-gen message"
    KEY_GEN_MESSAGE_SPAM = "exceeded the key-gen message cap"
    # Generic protocol violations
    INVALID_MESSAGE = "sent a malformed or undecodable message"
    EPOCH_OUT_OF_RANGE = "sent a message for an epoch out of the accepted window"
    INVALID_SNAPSHOT = "served a forged or malformed state-transfer snapshot"

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

    @classmethod
    def init(cls, node_id: Any, kind: FaultKind) -> "FaultLog":
        fl = cls()
        fl.append(Fault(node_id, kind))
        return fl

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
