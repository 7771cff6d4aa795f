"""The ``CryptoBackend`` seam — the host half.

The port's own copy of ``CpuBackend`` and ``EagerFinalizer`` from
``hbbft_tpu/crypto/backend.py``: the group-MSM and share-verification
planes, and the reliable-broadcast plane (batched SHA-256, Merkle trees,
Reed–Solomon codecs) on the native host.  ``ops.backend_cuda.CudaBackend``
subclasses it and moves the G1 MSMs onto the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from . import fields as F
from . import threshold as T
from .curve import G1, G2, g1_multi_exp, g2_multi_exp
from .hashing import sha256
from .merkle import MerkleTree
from .rs import make_codec


def tree_values(groups) -> List[List[bytes]]:
    """The value lists of a batch of Merkle trees: ``groups`` is a sequence
    of byte-value lists, or a ``[T, n, len]`` uint8 array (a tree a row)."""
    if isinstance(groups, np.ndarray):
        return [[row.tobytes() for row in g] for g in groups]
    return [list(g) for g in groups]


class EagerFinalizer:
    """Finalizer over an already-computed result: every ``*_async``
    backend method returns a zero-arg callable yielding its result, and
    the host computes eagerly."""

    __slots__ = ("_result",)

    def __init__(self, result):
        self._result = result

    def __call__(self):
        return self._result


def check_product_shape(
    n_points: int, n_s: int, n_t: int, group_sizes: Sequence[int]
) -> None:
    """Raise unless a group-major product MSM's operands line up."""
    if not (sum(group_sizes) == n_points == n_s and n_t == len(group_sizes)):
        raise ValueError(
            "product MSM shape mismatch: "
            f"{n_points} points, {n_s} s-coeffs, {n_t} t-coeffs over "
            f"{len(group_sizes)} groups summing to {sum(group_sizes)}"
        )


def product_flat_scalars(
    s_coeffs: Sequence[int], t_coeffs: Sequence[int], group_sizes: Sequence[int]
) -> List[int]:
    """The flat coefficients ``sᵢ·t_g mod r`` of a group-major product
    MSM (shape already checked)."""
    flat: List[int] = []
    idx = 0
    for t, size in zip(t_coeffs, group_sizes):
        for _ in range(size):
            flat.append((s_coeffs[idx] * t) % F.R)
            idx += 1
    return flat


class CpuBackend:
    """Pure host-side ops backend (the correctness oracle)."""

    name = "cpu"

    # -- hashing / merkle / erasure coding (the broadcast plane) -----------

    def sha256_many(self, items: Sequence[bytes]) -> List[bytes]:
        from .. import native as NT

        if NT.available():
            return NT.sha256_many(list(items))
        return [sha256(b) for b in items]

    def merkle_tree(self, values: List[bytes]) -> MerkleTree:
        return MerkleTree(values)

    def merkle_trees(self, groups, roots_only: bool = False) -> list:
        """A tree per group of values (:func:`tree_values`), this class's
        ``merkle_tree`` tree after tree; with ``roots_only`` their roots.
        The port's batch form of ``merkle_tree`` (the reference has none):
        ``CudaBackend`` builds the trees as one forest on the card."""
        trees = [CpuBackend.merkle_tree(self, values) for values in tree_values(groups)]
        return [t.root_hash for t in trees] if roots_only else trees

    def rs_codec(self, data_shards: int, parity_shards: int):
        return make_codec(data_shards, parity_shards)

    # -- group MSMs --------------------------------------------------------

    def g1_msm(self, points: Sequence[G1], scalars: Sequence[int]) -> G1:
        return g1_multi_exp(points, scalars)

    def g1_msm_async(self, points: Sequence[G1], scalars: Sequence[int]):
        """Enqueue a G1 MSM, returning a zero-arg finalizer (the host
        computes eagerly)."""
        return EagerFinalizer(self.g1_msm(points, scalars))

    def g2_msm(self, points: Sequence[G2], scalars: Sequence[int]) -> G2:
        return g2_multi_exp(points, scalars)

    def g1_ship(
        self,
        points: Sequence[G1],
        group_sizes: Optional[Sequence[int]] = None,
    ):
        """Begin moving ``points`` toward the MSM engine; the returned
        handle is accepted by :meth:`g1_msm_product_async` in place of
        the point list.  The host has nothing to move."""
        return points

    def g1_msm_product_async(
        self,
        points,
        s_coeffs: Sequence[int],
        t_coeffs: Sequence[int],
        group_sizes: Sequence[int],
    ):
        """Async ``Σ_g t_g · (Σ_{i∈g} sᵢ · Pᵢ)`` over group-major
        ``points`` — equal to one flat MSM with coefficients
        ``sᵢ·t_g mod r`` on r-torsion points."""
        points = list(points)
        check_product_shape(
            len(points), len(s_coeffs), len(t_coeffs), group_sizes
        )
        flat = product_flat_scalars(s_coeffs, t_coeffs, group_sizes)
        return EagerFinalizer(self.g1_msm(points, flat))

    def verify_sig_share(self, pk_share, share, msg: bytes) -> bool:
        return pk_share.verify_signature_share(share, msg)

    def verify_dec_share(self, pk_share, share, ciphertext) -> bool:
        return pk_share.verify_decryption_share(share, ciphertext)

    def batch_verify_shares(
        self,
        shares: Sequence[G1],
        pks: Sequence[G2],
        base: G1,
        context: bytes = b"",
    ) -> bool:
        return T.batch_verify_shares(shares, pks, base, context)
