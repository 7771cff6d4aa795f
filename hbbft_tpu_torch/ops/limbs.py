"""Fixed-prime big-integer limb arithmetic on torch tensors.

The port of ``hbbft_tpu/ops/limbs.py``.  Same representation, same
schedule, so the limbs are bit-identical to the JAX reference (the
CUDA kernels' Montgomery field, ``csrc/bls_mont.cuh``, takes these limbs
in and writes canonical ones out):

- an element is ``L = 38`` limbs of ``LIMB_BITS = 11`` bits, little-
  endian, in ``int32`` — 418 bits of capacity, 37 bits of headroom
  above the 381-bit prime;
- limbs are redundant (invariant ``|limb| < 2^12``), so a 38-term
  schoolbook convolution sum stays below ``2^30`` and a fold sum below
  ``2^29``: no int32 intermediate overflows;
- values are lazily reduced: every limb at index ≥ B = 37 folds back
  through the ``2^(11·(B+i)) mod p`` table, two (carry, carry, fold)
  rounds and a closing carry pair (``normalize``).

The JAX fold is an int32 ``einsum``; CUDA has no int32 matmul, so here
it is a broadcast multiply and an int32 sum (exact: integer addition in
any order gives the same result below 2^31).  Every op takes
``[..., L]`` int32 tensors on any device and broadcasts; the constant
tables are host numpy arrays, moved to the operand's device once.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import numpy as np
import torch

LIMB_BITS = 11
LIMB_MASK = (1 << LIMB_BITS) - 1

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

FQ_LIMBS = 38  # 418-bit capacity for the 381-bit field


def int_to_limbs(x: int, nlimbs: int) -> np.ndarray:
    """Host-side: python int → little-endian limb vector."""
    if x < 0:
        raise ValueError("negative value")
    out = np.zeros(nlimbs, dtype=np.int32)
    for i in range(nlimbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("value does not fit in limbs")
    return out


def limbs_to_int(limbs) -> int:
    """Host-side: limb vector → python int (limbs may be unnormalised,
    even negative)."""
    arr = np.asarray(limbs)
    acc = 0
    for i in range(arr.shape[-1] - 1, -1, -1):
        acc = (acc << LIMB_BITS) + int(arr[..., i])
    return acc


def ints_to_limbs_batch(xs: Sequence[int], nlimbs: int) -> np.ndarray:
    """Vectorized :func:`int_to_limbs` over a batch (non-negative ints
    below 2^(11·nlimbs))."""
    n = len(xs)
    if not n:
        return np.zeros((0, nlimbs), dtype=np.int32)
    nbytes = (nlimbs * LIMB_BITS + 7) // 8
    buf = np.frombuffer(
        b"".join(int(x).to_bytes(nbytes, "little") for x in xs), dtype=np.uint8
    ).reshape(n, nbytes)
    bits = np.unpackbits(buf, axis=1, bitorder="little")[:, : nlimbs * LIMB_BITS]
    w = (1 << np.arange(LIMB_BITS, dtype=np.int64)).astype(np.int64)
    return (bits.reshape(n, nlimbs, LIMB_BITS).astype(np.int64) @ w).astype(np.int32)


def scalars_to_be_bytes(ks: Sequence[int], nbytes: int) -> np.ndarray:
    """[K, nbytes] uint8, big-endian, reduced mod r."""
    if not len(ks):
        return np.zeros((0, nbytes), dtype=np.uint8)
    return np.frombuffer(
        b"".join((int(k) % R).to_bytes(nbytes, "big") for k in ks), dtype=np.uint8
    ).reshape(len(ks), nbytes).copy()


def scalars_to_bits(ks: Sequence[int], nbits: int = 255) -> np.ndarray:
    """[K, nbits] msb-first bits of the scalars reduced mod r."""
    if not len(ks):
        return np.zeros((0, nbits), dtype=np.int32)
    nbytes = (nbits + 7) // 8
    bits = np.unpackbits(scalars_to_be_bytes(ks, nbytes), axis=1)
    return bits[:, nbytes * 8 - nbits :].astype(np.int32)


def _carry_round(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry round: [..., W] → [..., W+1].  Works on
    negative limbs too (``>>`` on int32 is an arithmetic shift)."""
    out = torch.nn.functional.pad(x & LIMB_MASK, (0, 1))
    out[..., 1:] += x >> LIMB_BITS
    return out


def _conv(a: torch.Tensor, b: torch.Tensor, L: int) -> torch.Tensor:
    """Schoolbook product [..., L] × [..., L] → [..., 2L−1].

    The [L, L] outer product is padded to [L, 2L] and re-viewed with a
    row stride of 2L−1, so row i reads shifted right by i (the padding
    zeros fill the gaps); summing the rows then gives every diagonal
    sum at once, with no copy beyond the padding.  Partial products
    < 2^24, sums < 2^30."""
    rows = a.unsqueeze(-1) * b.unsqueeze(-2)  # [..., L, L]
    padded = torch.nn.functional.pad(rows, (0, L))  # [..., L, 2L], contiguous
    batch = padded.shape[:-2]
    skew = padded.as_strided(
        batch + (L, 2 * L - 1), padded.stride()[:-2] + (2 * L - 1, 1)
    )
    return skew.sum(dim=-2, dtype=torch.int32)


class ModField:
    """Limb-vector arithmetic mod a fixed prime ``p`` (one instance per
    prime; ``fq()`` is the BLS12-381 base field)."""

    def __init__(self, p: int, nlimbs: int):
        self.p = p
        self.L = L = nlimbs
        self.B = B = nlimbs - 1  # fold boundary
        self.bits = LIMB_BITS * nlimbs
        if p.bit_length() > LIMB_BITS * B - 24:
            raise ValueError("need ≥24 bits of headroom above p for lazy fold")
        # fold[i] = limbs of 2^(11·(B+i)) mod p — reduces limb B+i; sized
        # for the widest intermediate (2L−1 product + carry limbs)
        nfold = L + 5
        self.fold = np.stack(
            [int_to_limbs(pow(2, LIMB_BITS * (B + i), p), B) for i in range(nfold)]
        )  # [nfold, B]
        # subtraction pad: smallest multiple of p ≥ 2^(11·B+2)
        pad = ((1 << (LIMB_BITS * B + 2)) // p + 1) * p
        self.sub_pad = int_to_limbs(pad, L + 1)
        # canon(): conditional subtraction of (2^k)·p, largest k first
        ks: List[int] = []
        k = 1
        while k * p < (1 << (self.bits + 2)):
            ks.append(k)
            k <<= 1
        self.canon_steps = np.stack([int_to_limbs(k * p, L + 1) for k in reversed(ks)])
        self.zero = np.zeros(L, dtype=np.int32)
        self.one = int_to_limbs(1, L)
        self._dev: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def consts(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The constant tables as int32 tensors on ``device`` (cached)."""
        got = self._dev.get(device)
        if got is None:
            got = {
                name: torch.as_tensor(getattr(self, name), dtype=torch.int32).to(device)
                for name in ("fold", "sub_pad", "canon_steps", "zero", "one")
            }
            self._dev[device] = got
        return got

    # -- host conversion ---------------------------------------------------

    def to_limbs(self, x: int) -> np.ndarray:
        return int_to_limbs(x % self.p, self.L)

    def from_limbs(self, limbs) -> int:
        return limbs_to_int(limbs) % self.p

    # -- normalisation -----------------------------------------------------

    def _fold_high(self, x: torch.Tensor) -> torch.Tensor:
        """[..., W] (W > B, limbs < 2^12) → [..., B]: fold every limb at
        index ≥ B back via its table row (broadcast multiply + int32 sum;
        each sum < 2^29)."""
        W = x.shape[-1]
        fold = self.consts(x.device)["fold"][: W - self.B]  # [H, B]
        high = x[..., self.B :].unsqueeze(-1)  # [..., H, 1]
        return x[..., : self.B] + (high * fold).sum(dim=-2, dtype=torch.int32)

    def normalize(self, wide: torch.Tensor, rounds: int = 2) -> torch.Tensor:
        """[..., W] limbs (W ≥ B, non-negative value) → [..., L] limbs
        < 2^12 each, value < 2^408 (same schedule as the reference)."""
        x = wide
        for _ in range(rounds):
            x = _carry_round(_carry_round(x))
            if x.shape[-1] > self.B:
                x = self._fold_high(x)
        x = _carry_round(_carry_round(x))
        return x[..., : self.L]

    # -- ring ops ----------------------------------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.normalize(a + b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        zpad = a.new_zeros(a.shape[:-1] + (1,))
        wide = (
            torch.cat([a, zpad], dim=-1)
            + self.consts(a.device)["sub_pad"]
            - torch.cat([b, zpad], dim=-1)
        )
        return self.normalize(wide)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        return self.normalize(_conv(a, b, self.L))

    def sq(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def mul_small(self, a: torch.Tensor, k: int) -> torch.Tensor:
        """Multiply by a small non-negative int (k ≤ ~2^17)."""
        return self.normalize(a * k)

    # -- canonical form (off the hot path) ---------------------------------

    def canon(self, a: torch.Tensor) -> torch.Tensor:
        """Unique canonical residue in [0, p): exact carry sweep, then a
        conditional-subtraction ladder over (2^k)·p, largest first — the
        reference's ``lax.scan`` loops written as loops over the limb
        axis."""
        zpad = a.new_zeros(a.shape[:-1] + (1,))
        x = torch.cat([a, zpad], dim=-1)  # [..., L+1]

        def sweep(d: torch.Tensor):
            """Exact borrow/carry propagation along the limb axis."""
            c = torch.zeros_like(d[..., 0])
            limbs = []
            for i in range(d.shape[-1]):
                t = d[..., i] + c
                c = t >> LIMB_BITS
                limbs.append(t & LIMB_MASK)
            return c, torch.stack(limbs, dim=-1)

        _, x = sweep(x)
        for kp in self.consts(a.device)["canon_steps"]:
            borrow, limbs = sweep(x - kp)
            x = torch.where((borrow < 0).unsqueeze(-1), x, limbs)
        return x[..., : self.L]

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (self.canon(a) == self.canon(b)).all(dim=-1)


@functools.lru_cache(maxsize=None)
def fq() -> ModField:
    return ModField(P, FQ_LIMBS)
