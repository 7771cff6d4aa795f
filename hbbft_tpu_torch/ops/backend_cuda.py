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
``rs_codec``) is the port of ``backend_tpu.py:184-222``: batched SHA-256
and Merkle levels through the ``sha256`` and ``merkle_level`` kernels
(``ops/sha256.py``), Reed–Solomon products through ``gf_matmul``
(``ops/gf256.py``'s device codecs, GF(2^16) past 256 shards).  The
reference sends it to the device only where the native host library is
missing; here size rules measured on the card take that place
(``scripts/torch_rbc_band.py``), each a pure predicate of the call's
sizes: a uniform batch of at least ``SHA_DEVICE_MIN_ITEMS`` messages (never
below the reference's 8) and at most ``SHA_DEVICE_MAX_BYTES`` bytes in all
(:meth:`CudaBackend.sha_on_device`), a tree of at least
``MERKLE_DEVICE_MIN_LEAVES`` uniform leaves of at most
``MERKLE_DEVICE_MAX_BYTES`` bytes in all (:meth:`tree_on_device`), and a
codec product (the device codec asks per product, :meth:`gf_rule`)
of at least ``GF8_DEVICE_MIN`` / ``GF16_DEVICE_MIN`` symbol products
m·k·columns.  Below them the native host runs, as on ``CpuBackend``; a
codec without parity is the host codec.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..crypto import threshold as T
from ..crypto.backend import CpuBackend, EagerFinalizer
from ..crypto.curve import G1, G2, G2_GEN
from ..crypto.merkle import MerkleTree
from ..crypto.pairing import pairing_check
from ..device import DeviceLike, resolve_device
from . import gf256, packed_msm
from . import sha256 as SH

# the reference's _MIN_DEVICE_BATCH (backend_tpu.py:40): the floor of the
# item and leaf rules
RBC_MIN_ITEMS = 8


class _DeviceMerkleTree(MerkleTree):
    """MerkleTree whose levels were hashed on the device (same layout)."""

    def __init__(self, values: List[bytes], levels: List[List[bytes]]):
        self.values = list(values)
        self.levels = levels


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

    # The reliable-broadcast plane's rules (the module docstring): the
    # values that scripts/torch_rbc_band.py printed, the least total time
    # over its grid (ties to the host), on an H100 80GB HBM3 at 700 W
    # (PERF.md §5; card / host ms).  A batch of messages goes to the card
    # from 256 messages up to 4 MiB in all (1,024 × 11 B 0.47 / 0.58;
    # 4,096 × 1,024 B 5.57 / 9.18; past it the host's copies and padding
    # cost the card more than the hashing: 4,096 × 4,096 B 41.6 / 22.7,
    # 1,024 × 47,672 B 109.5 / 99.5); a tree from 1,024 leaves up to 1 MiB
    # (1,024 × 2 B 1.23 / 1.53; 1,024 × 47,663 B 95.7 / 82.9); a GF(2^8)
    # product from 2^21 symbol products (the 1 MB broadcast's parity, 44 M:
    # 0.92 / 3.51); a GF(2^16) product from 2^14 (the card at every shape
    # measured: the N = 1024 epoch's parity, 227 M, 1.10 / 163.1; its dead
    # rows, 17,100, 0.36 / 2.05).
    SHA_DEVICE_MIN_ITEMS = 1 << 8
    SHA_DEVICE_MAX_BYTES = 1 << 22
    MERKLE_DEVICE_MIN_LEAVES = 1 << 10
    MERKLE_DEVICE_MAX_BYTES = 1 << 20
    GF8_DEVICE_MIN = 1 << 21
    GF16_DEVICE_MIN = 1 << 14
    # every rule opened as far as it goes (chip_smoke.py's forced backends)
    RBC_FLOOR = dict(
        SHA_DEVICE_MIN_ITEMS=RBC_MIN_ITEMS, SHA_DEVICE_MAX_BYTES=1 << 62,
        MERKLE_DEVICE_MIN_LEAVES=RBC_MIN_ITEMS, MERKLE_DEVICE_MAX_BYTES=1 << 62,
        GF8_DEVICE_MIN=1, GF16_DEVICE_MIN=1,
    )

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

    # -- hashing / merkle / erasure coding (the broadcast plane) -----------

    @staticmethod
    def _uniform(items: List[bytes], min_items: int) -> bool:
        """At least ``min_items`` (and 8) items, all of one length."""
        return len(items) >= max(min_items, RBC_MIN_ITEMS) and len({len(i) for i in items}) == 1

    def sha_on_device(self, items: Sequence[bytes]) -> bool:
        """Whether the size rules send this batch of messages to the card."""
        return (self._uniform(items, self.SHA_DEVICE_MIN_ITEMS)
                and len(items) * len(items[0]) <= self.SHA_DEVICE_MAX_BYTES)

    def tree_on_device(self, values: Sequence[bytes]) -> bool:
        """Whether the size rules send the tree of ``values`` to the card."""
        return (self._uniform(values, self.MERKLE_DEVICE_MIN_LEAVES)
                and len(values) * len(values[0]) <= self.MERKLE_DEVICE_MAX_BYTES)

    def gf_rule(self, minimum: str) -> gf256.Rule:
        """The device codecs' rule: a product of m·k·columns symbol
        products at or above the class constant named ``minimum``."""
        return lambda m, k, columns: m * k * columns >= getattr(self, minimum)

    def sha256_many(self, items: Sequence[bytes]) -> List[bytes]:
        items = list(items)
        if not self.sha_on_device(items):
            return super().sha256_many(items)
        return SH.sha256_many(items, self.device)

    def merkle_tree(self, values: List[bytes]) -> MerkleTree:
        vals = list(values)
        if not self.tree_on_device(vals):
            return MerkleTree(vals)
        return _DeviceMerkleTree(vals, SH.merkle_levels_device(vals, self.device))

    def rs_codec(self, data_shards: int, parity_shards: int):
        if parity_shards == 0:
            return super().rs_codec(data_shards, parity_shards)
        if data_shards + parity_shards > 256:
            return gf256.ReedSolomonDevice16(data_shards, parity_shards, self.device,
                                             self.gf_rule("GF16_DEVICE_MIN"))
        return gf256.ReedSolomonDevice(data_shards, parity_shards, self.device,
                                       self.gf_rule("GF8_DEVICE_MIN"))

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
