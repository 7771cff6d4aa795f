"""HoneyBadger batch records.

The port's own copy of the records of ``hbbft_tpu/protocols/
honey_badger.py`` that the vectorized epoch driver emits: the decrypted
``Batch`` of one epoch (reference ``batch.rs:7-10``), the
ordered-commit ``OrderedBatch`` and the digest it pins.  The sequential
``HoneyBadger`` state machine is not part of the port yet.  Wire names
are the reference's, so a batch ``dumps`` to the same bytes in both
packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from ..core.serialize import dumps, wire
from ..crypto.hashing import sha256


@wire("HbBatch")
@dataclasses.dataclass(frozen=True)
class Batch:
    """One epoch's output: the agreed, decrypted contributions."""

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
    """The ordered-commit record (``reveal_mode="ordered"``): epoch
    ``epoch``'s accepted ciphertexts, sequence-numbered (``seq``) and
    pinned by ``digest``, emitted before their plaintexts are
    revealed."""

    epoch: int
    seq: int
    digest: bytes
    proposers: Any  # tuple of accepted proposer ids, canonical order


def ordered_batch_digest(epoch: int, ciphertexts: Dict[Any, Any]) -> bytes:
    """The digest an :class:`OrderedBatch` pins: a hash over the epoch
    and the canonical serialization of each accepted ciphertext, in
    proposer order."""
    parts = [dumps(epoch)]
    for pid in sorted(ciphertexts, key=str):
        parts.append(dumps(pid))
        parts.append(dumps(ciphertexts[pid]))
    return sha256(b"hbbft_tpu ordered batch v1" + b"".join(parts))
