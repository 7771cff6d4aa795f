"""SHA-256 Merkle trees with per-leaf inclusion proofs.

The port's own copy of ``hbbft_tpu/crypto/merkle.py`` (same leaf and
node domain bytes, same proofs, byte for byte).  The reference
replaces the ``merkle`` crate (afck fork) + ``ring`` digest
(``Cargo.toml:21,27``; tree build ``broadcast.rs:381``, proof generation
``:390-392``, validation ``:556``, re-rooting after reconstruction
``:683-686``).

Design notes:
- Leaf hashes are domain-separated from interior nodes (0x00/0x01
  prefixes) and include the leaf *index*, which subsumes the reference's
  index-byte workaround for duplicate leaves (``broadcast.rs:371-377``)
  without mutating payloads.
- Odd levels duplicate the trailing hash (deterministic, balanced).
- The tree layout is breadth-first arrays, the layout the native
  builder (``native.merkle_levels``) returns.
"""

from __future__ import annotations

import dataclasses
from typing import List

from .hashing import sha256
from ..core.serialize import wire

_LEAF = b"\x00"
_NODE = b"\x01"


def leaf_hash(index: int, value: bytes) -> bytes:
    return sha256(_LEAF + index.to_bytes(8, "big") + value)


def node_hash(left: bytes, right: bytes) -> bytes:
    return sha256(_NODE + left + right)


@wire("MerkleProof")
@dataclasses.dataclass(frozen=True)
class MerkleProof:
    """Inclusion proof: (value, index, sibling lemma chain, root).

    Plays the role of the reference's ``proof::Proof`` carried in
    Broadcast ``Value``/``Echo`` messages.
    """

    value: bytes
    index: int
    lemma: tuple  # tuple of sibling hashes, leaf level upward
    root_hash: bytes

    def validate(self, n_leaves: int) -> bool:
        """Recompute the root from value+lemma (reference
        ``validate_proof``, ``broadcast.rs:555-575``)."""
        # a deserialized proof can carry arbitrary field types; a
        # non-int index / non-bytes value / non-sequence lemma must
        # fail validation, not raise
        if (
            not isinstance(self.index, int)
            or isinstance(self.index, bool)
            or not isinstance(self.value, bytes)
            or not isinstance(self.lemma, (tuple, list))
            or not isinstance(self.root_hash, bytes)
        ):
            return False
        if not 0 <= self.index < n_leaves:
            return False
        if len(self.lemma) != _tree_depth(n_leaves):
            return False
        h = leaf_hash(self.index, self.value)
        idx = self.index
        for sib in self.lemma:
            if not isinstance(sib, bytes) or len(sib) != 32:
                return False
            if idx & 1:
                h = node_hash(sib, h)
            else:
                h = node_hash(h, sib)
            idx >>= 1
        return h == self.root_hash


def _tree_depth(n_leaves: int) -> int:
    d = 0
    while (1 << d) < n_leaves:
        d += 1
    return d


class MerkleTree:
    """Breadth-first SHA-256 Merkle tree over a list of byte values.

    Uses the C++ native builder (``native/hbbft_native.cpp``) when the
    shared library is available; the pure-Python path below is the
    fallback and the semantics oracle."""

    def __init__(self, values: List[bytes]):
        if not values:
            raise ValueError("empty Merkle tree")
        self.values = list(values)
        from .. import native as _native

        if _native.available():
            self.levels: List[List[bytes]] = _native.merkle_levels(values)
            return
        level = [leaf_hash(i, v) for i, v in enumerate(values)]
        self.levels = [level]
        while len(level) > 1:
            if len(level) & 1:
                level = level + [level[-1]]
                self.levels[-1] = level
            nxt = [
                node_hash(level[i], level[i + 1])
                for i in range(0, len(level), 2)
            ]
            self.levels.append(nxt)
            level = nxt

    @property
    def root_hash(self) -> bytes:
        return self.levels[-1][0]

    def proof(self, index: int) -> MerkleProof:
        if not 0 <= index < len(self.values):
            raise IndexError(index)
        lemma = []
        idx = index
        for level in self.levels[:-1]:
            sib = idx ^ 1
            lemma.append(level[sib] if sib < len(level) else level[idx])
            idx >>= 1
        return MerkleProof(
            self.values[index], index, tuple(lemma), self.root_hash
        )
