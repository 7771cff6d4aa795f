"""The port's packed-wire device path against ``hbbft_tpu.ops.packed_msm``.

The wire → limb unpack, the scalar digits and the per-group trees must
give the reference's int32 values exactly; the product-form MSM (run on
the CPU, i.e. through the kernel's plain version) must equal the
reference host's flat MSM on r-torsion points, compared by wire bytes,
for uniform and non-uniform groups.
"""

import random

import jax
import numpy as np
import pytest
import torch

from hbbft_tpu import native as RN
from hbbft_tpu.crypto import curve as RC
from hbbft_tpu.crypto import fields as RF
from hbbft_tpu.ops import ec_jax as RE
from hbbft_tpu.ops import packed_msm as RP
from hbbft_tpu_torch import native as PN
from hbbft_tpu_torch.crypto import curve as PC
from hbbft_tpu_torch.ops import ec as PE
from hbbft_tpu_torch.ops import packed_msm as PP

# small tensors: intra-op threads only add contention beside the other
# test workers
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _same_points(seed: int, n: int, n_inf: int = 1):
    rng = random.Random(seed)
    ks = [rng.randrange(1, 1 << 64) for _ in range(n)]
    ref = [RC.G1_GEN * k for k in ks] + [RC.G1.infinity()] * n_inf
    port = [PC.G1_GEN * k for k in ks] + [PC.G1.infinity()] * n_inf
    return ref, port


def test_wires_and_unpack_match_reference():
    ref_pts, port_pts = _same_points(1, 5)
    wires = PP.g1_wires_batch(port_pts)
    assert np.array_equal(wires, RP.g1_wires_batch(ref_pts))
    assert not wires[-1].any()  # infinity is the all-zero row
    ref = np.asarray(RP._wire_points_g1(wires))
    got = PP._wire_points_g1(torch.from_numpy(wires)).numpy()
    assert got.dtype == np.int32 and np.array_equal(ref, got)
    assert np.array_equal(got, PE.g1_to_limbs(port_pts))


def test_scalar_digits_match_reference():
    rng = random.Random(2)
    ks = [rng.randrange(0, 1 << 96) for _ in range(9)] + [0]
    sc = PP.scalar_bytes_batch(ks, 12)
    assert np.array_equal(sc, RP.scalar_bytes_batch(ks, 12))
    ref = np.asarray(RP._scalar_digits(sc))
    got = PP._scalar_digits(torch.from_numpy(sc)).numpy()
    assert got.shape == (10, 24) and np.array_equal(ref, got)


def test_group_tree_matches_reference():
    """Two groups of three (padded to four with identities) — the
    reference tree jitted once."""
    ref_pts, _ = _same_points(3, 5)
    limbs = torch.from_numpy(RE.g1_to_limbs(ref_pts))
    # redundant limb forms, as the kernel emits (the add is exact vs the
    # reference: tests/test_torch_ec.py)
    prods = PE.g1_kernel().add(limbs, limbs)
    ref = np.asarray(jax.jit(RP._group_tree, static_argnums=(1,))(prods.numpy(), 2))
    got = PP._group_tree(prods, 2).numpy()
    assert got.shape == (2, 3, 38) and np.array_equal(ref, got)


def _product_case(seed: int, sizes):
    """r-torsion points (the product form equals the flat MSM only
    there) in both packages, and 96-bit s and t coefficients."""
    rng = random.Random(seed)
    k = sum(sizes)
    xs = [rng.randrange(1, RF.R) for _ in range(k)]
    wires = RN.g1_mul_many(RN.g1_wire(RC.G1_GEN), xs)
    ref_pts = [RN.g1_unwire(w, RC.G1) for w in wires]
    port_pts = [PN.g1_unwire(w, PC.G1) for w in wires]
    s = [rng.randrange(1, 1 << 96) | 1 for _ in range(k)]
    t = [rng.randrange(1, 1 << 96) | 1 for _ in sizes]
    return ref_pts, port_pts, s, t


@pytest.mark.parametrize("sizes", [[4, 4], [3, 1, 2]], ids=["uniform", "non_uniform"])
def test_product_msm_matches_reference_flat(sizes):
    ref_pts, port_pts, s, t = _product_case(4, sizes)
    port_pts[1] = PC.G1.infinity()  # an identity row rides along
    ref_pts[1] = RC.G1.infinity()
    flat, lo = [], 0  # the flat coefficients sᵢ·t_g mod r
    for g, n in enumerate(sizes):
        flat += [si * t[g] % RF.R for si in s[lo : lo + n]]
        lo += n
    want = RC.g1_multi_exp(ref_pts, flat)
    got = PP.g1_msm_product_async(port_pts, s, t, sizes, CPU)()
    assert got.to_bytes() == want.to_bytes()


def test_flat_msm_and_empty_cases():
    ref_pts, port_pts, s, _ = _product_case(5, [5])
    s[2] = 0
    want = RC.g1_multi_exp(ref_pts, s)
    assert PP.g1_msm_async(port_pts, s, CPU)().to_bytes() == want.to_bytes()
    assert PP.g1_msm_async([], [], CPU)().is_infinity()
    assert PP.g1_msm_product_async([], [], [], [], CPU)().is_infinity()
    with pytest.raises(ValueError):
        PP.g1_msm_product_async(port_pts, s[:4], [1], [5], CPU)
