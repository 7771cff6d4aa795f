"""The CUDA ops backend — drop-in for the port's ``CpuBackend``.

The port of ``hbbft_tpu/ops/backend_tpu.py`` for the share-verification
plane: the G1 MSMs of the fused flush run on the device (packed wires →
torch unpack → the ``win_g1`` CUDA kernel → complete-add trees), the G2
MSMs and the pairings stay on the host (native), as in the reference
(``backend_tpu.py:276`` routes G2 to the host).

Routing is two size rules, written here: a flat G1 MSM of fewer than
``G1_DEVICE_MIN`` points and a product-form one of fewer than
``G1_PRODUCT_DEVICE_MIN`` run on the host, every other one on the
device.  A device failure raises to the caller — there is no degrade
ladder, no silent host recompute.  ``CudaBackend()`` means the card and
raises when CUDA is absent; ``CudaBackend(device="cpu")`` runs the same
path with every kernel's plain PyTorch version (the CPU tests).

``CudaBackend(mesh=parallel.mesh.make_mesh(n))`` shards the device MSMs
over n ≥ 2 shards, as the reference's ``TpuBackend(mesh=...)``
(``_mesh_flush_active``, ``backend_tpu.py:162-172``): a uniform product
flush at or above ``G1_PRODUCT_DEVICE_MIN`` splits every group's points
over the shards and ring-reduces the group partials
(``parallel.mesh.sharded_product_msm``); a flat MSM at or above
``G1_DEVICE_MIN`` splits its rows (``sharded_packed_msm``); non-uniform
groups run on ``device``.  A 1-shard mesh is the single-device path.
The mesh is an argument only: no environment variable makes one, and a
mesh failure raises like any device failure.

The reliable-broadcast plane (``sha256_many``, ``merkle_tree``,
``rs_codec``) is inherited from ``CpuBackend`` and runs on the native
host, as on the reference's CPU backend: its TPU version is a jitted
XLA program (``ops/gf256_jax.py``, ``ops/sha256_jax.py``), not a Pallas
kernel, and its port to the card is still to come.  It is the host
path by design, not a fallback: nothing here tries the card first.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..crypto import threshold as T
from ..crypto.backend import CpuBackend, EagerFinalizer
from ..crypto.curve import G1, G2, G2_GEN
from ..crypto.pairing import pairing_check
from ..device import DeviceLike, resolve_device
from . import packed_msm


class CudaBackend(CpuBackend):
    """Batched PyTorch/CUDA ops backend (same results as ``CpuBackend``)."""

    name = "cuda"

    # G1 MSMs below these many points run native host Pippenger: the
    # card's fixed cost (wire copy, torch unpack, group trees, a one-wave
    # ladder of ~6 ms) is tens of ms at any K.  On an H100 the product
    # form (96-bit s-scalars on the card against a flat 255-bit host MSM)
    # and a flat MSM with 128-bit coefficients both lose at 1,024 points
    # and win from 4,096 (scripts/torch_g1_band.py; numbers in PERF.md).
    G1_DEVICE_MIN = 1 << 12
    G1_PRODUCT_DEVICE_MIN = 1 << 12

    def __init__(self, device: DeviceLike = None, mesh=None):
        self.device = resolve_device(device)
        if mesh is not None and mesh.devices[0].type != self.device.type:
            raise ValueError(f"a mesh on {mesh.devices[0]} for a backend on {self.device}")
        self.mesh = mesh
        # every shard's group sums of the last mesh product flush
        self.last_shard_sums: Optional[List[torch.Tensor]] = None

    def _mesh_flush_active(self) -> bool:
        """Whether device MSMs shard over the mesh: two or more shards."""
        return self.mesh is not None and self.mesh.size > 1

    def _active_mesh(self):
        return self.mesh if self._mesh_flush_active() else None

    @staticmethod
    def _on_host(k: int, minimum: int) -> bool:
        """Empty, or below the size rule: native host Pippenger."""
        return k == 0 or k < minimum

    # -- group MSMs --------------------------------------------------------

    def g1_msm(self, points: Sequence[G1], scalars: Sequence[int]) -> G1:
        return self.g1_msm_async(points, scalars)()

    def g1_msm_async(self, points, scalars):
        points, scalars = list(points), list(scalars)
        if self._on_host(len(points), self.G1_DEVICE_MIN):
            return EagerFinalizer(CpuBackend.g1_msm(self, points, scalars))
        return packed_msm.g1_msm_async(points, scalars, self.device, self._active_mesh())

    # -- product-form MSM (the fused flush's dominant shape) ---------------

    def g1_ship(self, points, group_sizes: Optional[Sequence[int]] = None):
        """Marshal the wires and copy them to the device; the returned
        device tensor goes to :meth:`g1_msm_product_async`."""
        points = list(points)
        if self._on_host(len(points), self.G1_PRODUCT_DEVICE_MIN):
            return points
        if self._mesh_flush_active() and group_sizes and packed_msm._uniform(group_sizes):
            return packed_msm.ship_shards(points, list(group_sizes), self.mesh)
        return packed_msm.ship_points(points, self.device)

    def g1_msm_product_async(self, points, s_coeffs, t_coeffs, group_sizes):
        if not isinstance(points, (torch.Tensor, packed_msm.ShardedWires)):
            points = list(points)
            if self._on_host(len(points), self.G1_PRODUCT_DEVICE_MIN):
                return super().g1_msm_product_async(
                    points, s_coeffs, t_coeffs, group_sizes
                )
        fin = packed_msm.g1_msm_product_async(
            points, s_coeffs, t_coeffs, group_sizes, self.device, self._active_mesh()
        )
        if getattr(fin, "shard_sums", None) is not None:
            self.last_shard_sums = fin.shard_sums
        return fin

    # -- batched share verification ---------------------------------------

    def batch_verify_shares(
        self,
        shares: Sequence[G1],
        pks: Sequence[G2],
        base: G1,
        context: bytes = b"",
    ) -> bool:
        """Identical math to ``threshold.batch_verify_shares`` with the G1
        MSM on the device: e(Σrᵢ·σᵢ, P₂)·e(−base, Σrᵢ·pkᵢ) == 1."""
        shares = list(shares)
        pks = list(pks)
        if not shares:
            return True
        coeffs = T._rlc_coeffs(
            context,
            [s.to_bytes() for s in shares] + [p.to_bytes() for p in pks],
        )[: len(shares)]
        agg_share_fin = self.g1_msm_async(shares, coeffs)
        u_pks, u_coeffs = T.aggregate_by_point(pks, coeffs)
        agg_pk = self.g2_msm(u_pks, u_coeffs)  # overlaps the device leg
        return pairing_check([(agg_share_fin(), G2_GEN), (-base, agg_pk)])
