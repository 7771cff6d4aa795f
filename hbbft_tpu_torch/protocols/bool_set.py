"""Tiny bool-set containers used by Binary Agreement.

The port's own copy of ``hbbft_tpu/protocols/bool_set.py`` (reference
``src/agreement/bool_set.rs``, a 2-bit set of booleans, and
``src/agreement/bool_multimap.rs``, a ``bool → set-of-nodes`` map), with
its wire name.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Set

from ..core.serialize import wire


@wire("BoolSet")
class BoolSet:
    """Subset of {False, True} encoded in two bits (NONE/FALSE/TRUE/BOTH)."""

    __slots__ = ("bits",)

    def __init__(self, bits: int = 0):
        if not 0 <= bits <= 3:
            raise ValueError("BoolSet bits out of range")
        self.bits = bits

    # constructors ---------------------------------------------------------

    @classmethod
    def none(cls) -> "BoolSet":
        return cls(0)

    @classmethod
    def both(cls) -> "BoolSet":
        return cls(3)

    @classmethod
    def single(cls, b: bool) -> "BoolSet":
        return cls(2 if b else 1)

    # operations -----------------------------------------------------------

    def insert(self, b: bool) -> bool:
        """Add ``b``; returns True if it was newly inserted."""
        bit = 2 if b else 1
        if self.bits & bit:
            return False
        self.bits |= bit
        return True

    def __contains__(self, b: bool) -> bool:
        return bool(self.bits & (2 if b else 1))

    def is_subset(self, other: "BoolSet") -> bool:
        return (self.bits & ~other.bits) == 0

    def definite(self) -> Optional[bool]:
        """The single contained value, if exactly one."""
        if self.bits == 1:
            return False
        if self.bits == 2:
            return True
        return None

    def __iter__(self) -> Iterator[bool]:
        if self.bits & 1:
            yield False
        if self.bits & 2:
            yield True

    def __len__(self) -> int:
        return bin(self.bits).count("1")

    def copy(self) -> "BoolSet":
        return BoolSet(self.bits)

    def __eq__(self, other) -> bool:
        return isinstance(other, BoolSet) and self.bits == other.bits

    def __hash__(self) -> int:
        return hash(("BoolSet", self.bits))

    def __repr__(self) -> str:
        return f"BoolSet({sorted(self)})"

    def _wire_fields(self):
        return (self.bits,)

    @classmethod
    def _from_wire(cls, bits):
        return cls(bits)


class BoolMultimap:
    """``bool → set of node ids`` (who sent BVal(b)/Aux(b))."""

    __slots__ = ("_sets",)

    def __init__(self):
        self._sets: Dict[bool, Set] = {False: set(), True: set()}

    def __getitem__(self, b: bool) -> Set:
        return self._sets[b]

    def __iter__(self):
        """Iterate (b, node_id) pairs, deterministically ordered."""
        for b in (False, True):
            for nid in sorted(self._sets[b]):
                yield b, nid

    def copy(self) -> "BoolMultimap":
        m = BoolMultimap()
        m._sets = {False: set(self._sets[False]), True: set(self._sets[True])}
        return m
