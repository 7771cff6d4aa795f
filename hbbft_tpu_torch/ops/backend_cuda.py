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
through the ``sha256`` kernel, Merkle trees through the ``merkle_forest``
kernel (``ops/sha256.py``; :meth:`CudaBackend.merkle_trees`, the port's
batch form, builds a whole batch of trees in one launch, and
``merkle_tree`` is a forest of one), Reed–Solomon products through
``gf_matmul`` (``ops/gf256.py``'s device codecs, GF(2^16) past 256
shards).  The reference sends it to the device only where the native
host library is missing; here size rules measured on the card take that
place (``scripts/torch_rbc_band.py``), each a pure predicate of the
call's sizes: a uniform batch of at least ``SHA_DEVICE_MIN_ITEMS``
messages (never below the reference's 8) and at most
``SHA_DEVICE_MAX_BYTES`` bytes in all (:meth:`CudaBackend.sha_on_device`),
a forest of trees of one uniform shape, each of at least 8 leaves, of at
least ``MERKLE_DEVICE_MIN_LEAVES`` leaves and at most
``MERKLE_DEVICE_MAX_BYTES`` value bytes in all (:meth:`forest_on_device`),
and a codec product (the device codec asks per product, :meth:`gf_rule`)
of at least ``GF8_DEVICE_MIN`` / ``GF16_DEVICE_MIN`` symbol products
m·k·columns.  Below them the native host runs, as on ``CpuBackend``; a
codec without parity is the host codec.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
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
    """MerkleTree whose rows were hashed on the device: one tree's slice of a
    forest's host buffer (``rows``, R·32 bytes in ``MerkleTree.levels``'
    order).  ``values`` and ``levels`` are made on first read, and
    ``root_hash`` reads only the root's 32 bytes."""

    def __init__(self, values, rows: np.ndarray, n_leaves: int):
        self._values, self._rows, self._n = values, rows, n_leaves
        self._levels: Optional[List[List[bytes]]] = None

    @property
    def values(self) -> List[bytes]:
        if not isinstance(self._values, list):  # a [n, len] uint8 array
            self._values = [row.tobytes() for row in self._values]
        return self._values

    @property
    def levels(self) -> List[List[bytes]]:
        if self._levels is None:
            self._levels = SH.split_levels(self._rows.tobytes(), self._n)
        return self._levels

    @property
    def root_hash(self) -> bytes:
        return self._rows[-32:].tobytes()

    def levels_equal(self, levels: List[List[bytes]]) -> bool:
        """``levels == self.levels`` for the levels of a ``MerkleTree``
        (32-byte digests), compared as bytes against this tree's rows,
        without making its digests into objects: the same verdict, since
        equal level sizes split equal bytes into equal digests."""
        return ([len(level) for level in levels] == SH.level_sizes(self._n)
                and b"".join(b"".join(level) for level in levels) == self._rows.tobytes())


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

    # The reliable-broadcast plane's rules (the module docstring): the values
    # that scripts/torch_rbc_band.py printed, the least total time over its
    # grid (ties to the host), on an H100 80GB HBM3 at 700 W (PERF.md §5;
    # card / host ms, as a caller sees them).  A batch of messages goes to
    # the card from 64 messages up to 256 MiB in all, the grid's largest: the
    # card pads the raw bytes itself and wins at every batch of 1,024 or
    # more (1,024 × 11 B 0.339 / 0.621, 4,096 × 4,096 B 5.71 / 16.4, 16,384 ×
    # 4,096 B 39.2 / 85.5), at 256 from 65 B and at 64 at 47,672 B (1.74 /
    # 2.52), where the host's losses outweigh the card's below (64 × 11 B
    # 0.119 / 0.046); a forest of trees from 64 leaves in all up to 64 MiB,
    # the grid's largest (1 × 64 × 2 B 0.14 / 0.12, one 1,024-leaf tree 0.17
    # / 1.76, the N = 1024 epoch's 974 trees of 1,024 2-byte leaves 30.3 /
    # 1,810); a GF(2^8) product from 2^21 symbol products (the 1 MB
    # broadcast's parity, 44 M: 0.72 / 3.30); a GF(2^16) product from 2^14
    # (the card at every shape measured: the N = 1024 epoch's parity, 227 M,
    # 0.87 / 111.7; a proposer's dead rows, 17,100, 0.17 / 1.91).
    SHA_DEVICE_MIN_ITEMS = 1 << 6
    SHA_DEVICE_MAX_BYTES = 1 << 28
    MERKLE_DEVICE_MIN_LEAVES = 1 << 6
    MERKLE_DEVICE_MAX_BYTES = 1 << 26
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

    def forest_on_device(self, trees: int, leaves: int, leaf_bytes: int) -> bool:
        """Whether the size rules send a forest of ``trees`` trees of
        ``leaves`` leaves of ``leaf_bytes`` bytes each to the card: at least
        8 leaves a tree, ``MERKLE_DEVICE_MIN_LEAVES`` leaves and at most
        ``MERKLE_DEVICE_MAX_BYTES`` value bytes in all."""
        total = trees * leaves
        return (trees >= 1 and leaves >= RBC_MIN_ITEMS and total >= self.MERKLE_DEVICE_MIN_LEAVES
                and total * leaf_bytes <= self.MERKLE_DEVICE_MAX_BYTES)

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
        return self._trees([list(values)], False)[0]

    def merkle_trees(self, groups, roots_only: bool = False) -> list:
        """A tree per group of values (a sequence of byte-value lists, or a
        ``[T, n, len]`` uint8 array, a tree a row): one ``merkle_forest``
        launch for the whole batch where the trees have one shape and the
        size rules send it to the card (:meth:`forest_on_device`), the
        native host tree after tree otherwise.  With ``roots_only`` the
        roots (the card copies back nothing else)."""
        return self._trees(groups, roots_only)

    def _trees(self, groups, roots_only: bool) -> list:
        if not isinstance(groups, np.ndarray):
            groups = [list(g) for g in groups]
        shape = SH.forest_shape(groups)
        if shape is None or not self.forest_on_device(*shape):
            return CpuBackend.merkle_trees(self, groups, roots_only)
        T, n, ln = shape
        if isinstance(groups, np.ndarray):
            arr = groups
        else:
            arr = np.frombuffer(b"".join(b"".join(g) for g in groups), dtype=np.uint8)
            arr = arr.reshape(T, n, ln)
        raw = SH.merkle_forest_device(arr, self.device, roots_only)
        if roots_only:
            return [raw[t].tobytes() for t in range(T)]
        return [_DeviceMerkleTree(groups[t], raw[t], n) for t in range(T)]

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
