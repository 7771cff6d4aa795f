"""The port's G1 point arithmetic against ``hbbft_tpu.ops.ec_jax``.

Complete additions (including identity and doubling inputs, and the
redundant limb forms that chains of additions produce) must give the
reference's limbs exactly; the host converters must agree with the
reference's at the canonical boundary.
"""

import random

import numpy as np
import pytest
import torch

from hbbft_tpu.crypto import curve as RC
from hbbft_tpu.ops import ec_jax as RE
from hbbft_tpu_torch.crypto import curve as PC
from hbbft_tpu_torch.ops import ec as PE

# small tensors: intra-op threads only add contention beside the other
# test workers
torch.set_num_threads(1)


def _scalars(seed: int, n: int):
    rng = random.Random(seed)
    return [rng.randrange(1, 1 << 64) for _ in range(n)]


def _pair(ks):
    """The same points in both packages, plus their limbs from each."""
    ref_pts = [RC.G1_GEN * k for k in ks] + [RC.G1.infinity()]
    port_pts = [PC.G1_GEN * k for k in ks] + [PC.G1.infinity()]
    return ref_pts, port_pts, RE.g1_to_limbs(ref_pts), PE.g1_to_limbs(port_pts)


def test_g1_to_limbs_matches_reference():
    _, _, ref, port = _pair(_scalars(1, 5))
    assert port.dtype == np.int32 and port.shape == (6, 3, 38)
    assert np.array_equal(ref, port)


@pytest.mark.parametrize("case", ["distinct", "doubling", "identity"])
def test_point_add_exact(case):
    _, _, limbs, _ = _pair(_scalars(2, 5))
    p = limbs
    if case == "distinct":
        q = np.roll(limbs, 1, axis=0)
    elif case == "doubling":
        q = limbs
    else:
        q = np.broadcast_to(limbs[-1], limbs.shape).copy()  # the identity row
    ref = np.asarray(RE.g1_kernel().add(p, q))
    got = PE.g1_kernel().add(torch.from_numpy(p), torch.from_numpy(q)).numpy()
    assert np.array_equal(ref, got)
    # a second add on the redundant outputs stays exact
    ref2 = np.asarray(RE.g1_kernel().add(ref, p))
    got2 = PE.g1_kernel().add(torch.from_numpy(got), torch.from_numpy(p)).numpy()
    assert np.array_equal(ref2, got2)


def test_tree_sum_identity_select():
    """The tree reduction sums the batch (odd levels padded with the
    identity); the identity's limbs and ``select`` equal the
    reference's.  (The tree is
    built from the add checked exactly above; the reference's tree is
    not run here because every level is a fresh XLA compile.)"""
    ref_pts, _, limbs, _ = _pair(_scalars(3, 4))
    got = PE.g1_kernel().tree_sum(torch.from_numpy(limbs))
    want = ref_pts[0]
    for p in ref_pts[1:]:
        want = want + p
    assert PE.g1_from_limbs(got).to_bytes() == want.to_bytes()
    assert np.array_equal(
        np.asarray(RE.g1_kernel().identity((2,))), PE.g1_kernel().identity((2,)).numpy()
    )
    mask = np.array([True, False, True, False, False])
    other = limbs[::-1].copy()
    assert np.array_equal(
        np.asarray(RE.g1_kernel().select(mask, limbs, other)),
        PE.g1_kernel()
        .select(torch.from_numpy(mask), torch.from_numpy(limbs), torch.from_numpy(other))
        .numpy(),
    )


def test_g1_from_limbs_round_trip_matches_reference():
    ks = _scalars(4, 4)
    ref_pts, port_pts, limbs, _ = _pair(ks)
    summed = PE.g1_kernel().add(torch.from_numpy(limbs), torch.from_numpy(limbs))
    for i, (rp, pp) in enumerate(zip(ref_pts, port_pts)):
        # canonical affine limbs round-trip to the same point
        assert PE.g1_from_limbs(limbs[i]) == pp
        # redundant projective limbs (2·P) decode like the reference's
        got = PE.g1_from_limbs(summed[i])
        want = RE.g1_from_limbs(np.asarray(summed[i]))
        assert got.to_bytes() == want.to_bytes() == (rp + rp).to_bytes()
