"""Batched BLS12-381 G1/G2 arithmetic on torch tensors — branchless.

The port of ``hbbft_tpu/ops/ec_jax.py``:

- **complete addition** (Renes–Costello–Batina 2015, Alg. 7 for a = 0)
  in homogeneous projective coordinates: one formula for every input —
  doubling, identity, mixed — so scalar-mul ladders and MSM trees need
  no branches.  Identity is (0 : 1 : 0);
- one point template over a field object: Fq for G1 (elements
  ``[..., L]``, 3·b = 12) and Fq2 = Fq[u]/(u²+1) for G2 (elements
  ``[..., 2, L]``, 3·b = 12(1+u));
- points are int32 limb tensors, G1 ``[..., 3, L]`` and G2
  ``[..., 3, 2, L]`` (X, Y, Z along the axis before the element axes),
  and every op broadcasts over leading batch dims;
- the host boundary (``g1_/g2_to_limbs``, ``g1_/g2_from_limbs``) is
  canonical.

Same field schedule as ``ops/limbs.py`` and the same Karatsuba order as
the reference, so every limb equals the reference's (asserted in
``tests/test_torch_ec.py`` and ``tests/test_torch_g2.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from . import limbs as LB
from ..crypto import fields as F
from ..crypto.curve import G1, G2


class Fq1Ops:
    """G1's field: Fq elements ``[..., L]``; 3·b = 12 (b = 4)."""

    el_ndim = 1

    def __init__(self, field: LB.ModField):
        self.f = field
        self.add = field.add
        self.sub = field.sub
        self.mul = field.mul

    def mul_b3(self, a: torch.Tensor) -> torch.Tensor:
        return self.f.mul_small(a, 12)

    def zero(self) -> np.ndarray:
        return self.f.zero

    def one(self) -> np.ndarray:
        return self.f.one


class Fq2Ops:
    """G2's field Fq2 = Fq[u]/(u²+1): elements ``[..., 2, L]`` (c0, c1);
    the mirror of ``ec_jax._fq2_ops`` (same Karatsuba, same
    3·b = 12(1+u) for the twist curve)."""

    el_ndim = 2

    def __init__(self, field: LB.ModField):
        self.f = field

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.f.add(a, b)  # limb add broadcasts over the u-axis

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.f.sub(a, b)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Karatsuba, the reference's: c0 = a0b0 − a1b1 and
        c1 = (a0+a1)(b0+b1) − a0b0 − a1b1; the three Fq products run as
        one batched ``f.mul``."""
        f = self.f
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        sa, sb = f.add(torch.stack([a0, b0]), torch.stack([a1, b1]))
        t0, t1, m = f.mul(torch.stack([a0, a1, sa]), torch.stack([b0, b1, sb]))
        d = f.sub(torch.stack([m, t0]), torch.stack([t0, t1]))  # m − t0, t0 − t1
        return torch.stack([d[1], f.sub(d[0], t1)], dim=-2)

    def mul_b3(self, a: torch.Tensor) -> torch.Tensor:
        # 3·b with b = 4(1+u): 12·(a0 − a1) + 12·(a0 + a1)·u
        f = self.f
        a0, a1 = a[..., 0, :], a[..., 1, :]
        return f.mul_small(torch.stack([f.sub(a0, a1), f.add(a0, a1)], dim=-2), 12)

    def zero(self) -> np.ndarray:
        return np.stack([self.f.zero, self.f.zero])

    def one(self) -> np.ndarray:
        return np.stack([self.f.one, self.f.zero])


class PointKernel:
    """Branchless projective point ops over a field object
    (:class:`Fq1Ops` for G1, :class:`Fq2Ops` for G2)."""

    # points per batched complete add (larger batches are chunked)
    ADD_CHUNK = 1 << 15

    def __init__(self, field):
        self.f = field
        self.ax = -1 - field.el_ndim  # the X/Y/Z axis

    def identity(
        self, batch_shape: Tuple[int, ...] = (), device="cpu"
    ) -> torch.Tensor:
        f = self.f
        pt = torch.as_tensor(np.stack([f.zero(), f.one(), f.zero()]), device=device)
        return pt.expand(tuple(batch_shape) + pt.shape).clone()

    def add(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Complete addition, valid for every (p, q) including p == q
        and identities (RCB 2015 Algorithm 7, a = 0, b3 = 3·b).  Batches
        of more than ``ADD_CHUNK`` points run in chunks, which bounds the
        torch temporaries of a large batch on the card."""
        p, q = torch.broadcast_tensors(p, q)
        pt_shape = p.shape[p.dim() + self.ax :]
        n = math.prod(p.shape[: p.dim() + self.ax])
        if n <= self.ADD_CHUNK:
            return self._add(p, q)
        pf, qf = p.reshape((n,) + pt_shape), q.reshape((n,) + pt_shape)
        step = self.ADD_CHUNK
        parts = [self._add(pf[i : i + step], qf[i : i + step]) for i in range(0, n, step)]
        return torch.cat(parts).reshape(p.shape)

    def _add(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """The reference's formula (``ec_jax.PointKernel.add``) with its
        independent field ops stacked into one call each: every limb is
        computed by the same integer operations as the reference's, so
        the output is bit-identical, in ~a third of the torch calls."""
        f = self.f
        P, Q = p.movedim(self.ax, 0), q.movedim(self.ax, 0)  # [3, ...]: X, Y, Z
        # X+Y, Y+Z, Z+X of both inputs
        sp, sq = f.add(torch.stack([P, Q]), torch.stack([P.roll(-1, 0), Q.roll(-1, 0)]))
        # t0 = X1·X2, t1 = Y1·Y2, t2 = Z1·Z2 and the three sum products
        t0, t1, t2, mxy, myz, mzx = f.mul(torch.cat([P, sp]), torch.cat([Q, sq]))
        a01, a12, a02, X3 = f.add(torch.stack([t0, t1, t0, t0]), torch.stack([t1, t2, t2, t0]))
        t3, t4, Y3 = f.sub(torch.stack([mxy, myz, mzx]), torch.stack([a01, a12, a02]))
        t0 = f.add(X3, t0)
        t2, Y3 = f.mul_b3(torch.stack([t2, Y3]))
        Z3 = f.add(t1, t2)
        t1 = f.sub(t1, t2)
        # X3 = t3·t1 − t4·Y3, Y3 = t1·Z3 + Y3·t0, Z3 = Z3·t4 + t0·t3
        pr = f.mul(torch.stack([t3, t4, t1, Y3, Z3, t0]), torch.stack([t1, Y3, Z3, t0, t4, t3]))
        X3 = f.sub(pr[0], pr[1])
        Y3, Z3 = f.add(pr[2::2], pr[3::2])
        return torch.stack([X3, Y3, Z3], dim=self.ax)

    def select(self, mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
        """where(mask, a, b) with mask broadcast over the point axes."""
        return torch.where(mask.reshape(mask.shape + (1,) * -self.ax), a, b)

    def tree_sum(self, pts: torch.Tensor) -> torch.Tensor:
        """Σ over the leading axis via a log₂ tree of complete adds
        (odd levels padded with the identity at the end)."""
        n = pts.shape[0]
        if n == 0:
            return self.identity(device=pts.device)
        while n > 1:
            if n % 2:
                pts = torch.cat([pts, self.identity((1,), pts.device)], dim=0)
                n += 1
            pts = self.add(pts[: n // 2], pts[n // 2 :])
            n = pts.shape[0]
        return pts[0]


@functools.lru_cache(maxsize=None)
def g1_kernel() -> PointKernel:
    return PointKernel(Fq1Ops(LB.fq()))


@functools.lru_cache(maxsize=None)
def g2_kernel() -> PointKernel:
    return PointKernel(Fq2Ops(LB.fq()))


# ---------------------------------------------------------------------------
# Host ↔ device conversion (canonical at the boundary)
# ---------------------------------------------------------------------------


def g1_to_limbs(points: Sequence[Any]) -> np.ndarray:
    """Host G1 points → [k, 3, L] projective limbs (affine, Z = 1;
    infinity = (0 : 1 : 0)), one shared batch inversion."""
    L = LB.FQ_LIMBS
    n = len(points)
    xs: List[int] = [0] * n
    ys: List[int] = [0] * n
    zs = np.zeros(n, dtype=np.int32)
    for i, aff in enumerate(G1.batch_affine(points)):
        if aff is None:
            ys[i] = 1
        else:
            xs[i], ys[i], zs[i] = aff[0], aff[1], 1
    out = np.zeros((n, 3, L), dtype=np.int32)
    out[:, 0, :] = LB.ints_to_limbs_batch(xs, L)
    out[:, 1, :] = LB.ints_to_limbs_batch(ys, L)
    out[:, 2, 0] = zs
    return out


def g2_to_limbs(points: Sequence[Any]) -> np.ndarray:
    """Host G2 points → [k, 3, 2, L] projective limbs (affine, Z = 1;
    infinity = (0 : 1 : 0)), one shared Fq2 batch inversion."""
    L = LB.FQ_LIMBS
    n = len(points)
    coords = [[0] * n for _ in range(4)]  # x0, x1, y0, y1
    zs = np.zeros(n, dtype=np.int32)
    for i, aff in enumerate(G2.batch_affine(points)):
        if aff is None:
            coords[2][i] = 1
        else:
            (coords[0][i], coords[1][i]), (coords[2][i], coords[3][i]) = aff
            zs[i] = 1
    out = np.zeros((n, 3, 2, L), dtype=np.int32)
    for c, vals in enumerate(coords):
        out[:, c // 2, c % 2, :] = LB.ints_to_limbs_batch(vals, L)
    out[:, 2, 0, 0] = zs
    return out


def _as_numpy(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    return np.asarray(arr)


def g1_from_limbs(arr) -> Any:
    """[3, L] projective limbs → host G1 point (exact, canonical)."""
    f = LB.fq()
    arr = _as_numpy(arr)
    X, Y, Z = (f.from_limbs(arr[i]) for i in range(3))
    if Z == 0:
        return G1.infinity()
    zinv = pow(Z, -1, F.P)
    return G1.from_affine((X * zinv % F.P, Y * zinv % F.P))


def g2_from_limbs(arr) -> Any:
    """[3, 2, L] projective limbs → host G2 point (exact, canonical)."""
    f = LB.fq()
    arr = _as_numpy(arr)
    X, Y, Z = ((f.from_limbs(arr[i, 0]), f.from_limbs(arr[i, 1])) for i in range(3))
    if Z == (0, 0):
        return G2.infinity()
    zinv = F.fq2_inv(Z)
    return G2.from_affine((F.fq2_mul(X, zinv), F.fq2_mul(Y, zinv)))
