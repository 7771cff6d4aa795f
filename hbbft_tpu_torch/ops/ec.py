"""Batched BLS12-381 G1 arithmetic on torch tensors — branchless.

The port of the G1 half of ``hbbft_tpu/ops/ec_jax.py``:

- **complete addition** (Renes–Costello–Batina 2015, Alg. 7 for a = 0)
  in homogeneous projective coordinates: one formula for every input —
  doubling, identity, mixed — so scalar-mul ladders and MSM trees need
  no branches.  Identity is (0 : 1 : 0);
- points are int32 limb tensors ``[..., 3, L]`` (X, Y, Z along axis
  −2) and every op broadcasts over leading batch dims;
- the host boundary (``g1_to_limbs`` / ``g1_from_limbs``) is canonical.

Same field schedule as ``ops/limbs.py``, so every limb equals the
reference's (asserted in ``tests/test_torch_ec.py``).  The G2 (Fq2)
instantiation is not part of this slice.
"""

from __future__ import annotations

import functools
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from . import limbs as LB
from ..crypto import fields as F
from ..crypto.curve import G1


class PointKernel:
    """Branchless projective G1 point ops over ``limbs.fq()``."""

    def __init__(self, field: LB.ModField):
        self.f = field

    def mul_b3(self, a: torch.Tensor) -> torch.Tensor:
        return self.f.mul_small(a, 12)  # 3·b, b = 4

    def identity(
        self, batch_shape: Tuple[int, ...] = (), device="cpu"
    ) -> torch.Tensor:
        pt = torch.zeros((3, self.f.L), dtype=torch.int32, device=device)
        pt[1, 0] = 1
        return pt.expand(tuple(batch_shape) + pt.shape).clone()

    def add(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Complete addition, valid for every (p, q) including p == q
        and identities (RCB 2015 Algorithm 7, a = 0, b3 = 3·b)."""
        f = self.f
        X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
        X2, Y2, Z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
        t0 = f.mul(X1, X2)
        t1 = f.mul(Y1, Y2)
        t2 = f.mul(Z1, Z2)
        t3 = f.mul(f.add(X1, Y1), f.add(X2, Y2))
        t3 = f.sub(t3, f.add(t0, t1))
        t4 = f.mul(f.add(Y1, Z1), f.add(Y2, Z2))
        t4 = f.sub(t4, f.add(t1, t2))
        X3 = f.mul(f.add(X1, Z1), f.add(X2, Z2))
        Y3 = f.sub(X3, f.add(t0, t2))
        X3 = f.add(t0, t0)
        t0 = f.add(X3, t0)
        t2 = self.mul_b3(t2)
        Z3 = f.add(t1, t2)
        t1 = f.sub(t1, t2)
        Y3 = self.mul_b3(Y3)
        X3 = f.sub(f.mul(t3, t1), f.mul(t4, Y3))
        Y3 = f.add(f.mul(t1, Z3), f.mul(Y3, t0))
        Z3 = f.add(f.mul(Z3, t4), f.mul(t0, t3))
        return torch.stack([X3, Y3, Z3], dim=-2)

    def select(self, mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
        """where(mask, a, b) with mask broadcast over the point axes."""
        return torch.where(mask[..., None, None], a, b)

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
    return PointKernel(LB.fq())


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


def g1_from_limbs(arr) -> Any:
    """[3, L] projective limbs → host G1 point (exact, canonical)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    f = LB.fq()
    arr = np.asarray(arr)
    X, Y, Z = (f.from_limbs(arr[i]) for i in range(3))
    if Z == 0:
        return G1.infinity()
    zinv = pow(Z, -1, F.P)
    return G1.from_affine((X * zinv % F.P, Y * zinv % F.P))
