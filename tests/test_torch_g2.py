"""The port's G2 arithmetic and ``win_g2``'s plain version against the reference.

- Fq2 ``mul``/``mul_b3`` and the G2 complete add give
  ``hbbft_tpu.ops.ec_jax``'s limbs exactly on numpy-seeded inputs;
- the host converters and the 192-byte wire unpack agree with the
  reference's;
- ``windowed_g2_plain`` (what ``win_g2`` runs on CPU tensors) gives k·P
  of the reference's host curve in wire bytes, and the packed-wire G2
  MSM on ``device="cpu"`` the reference's host MSM;
- slow: exact limbs against the Pallas kernel in interpret mode (its
  compile takes minutes on a CPU).
"""

import random

import numpy as np
import pytest
import torch

from hbbft_tpu import native as RNT
from hbbft_tpu.crypto import curve as RC
from hbbft_tpu.crypto.backend import CpuBackend as RefCpuBackend
from hbbft_tpu.ops import ec_jax as RE
from hbbft_tpu.ops import limbs as RL
from hbbft_tpu.ops import packed_msm as RPM
from hbbft_tpu.ops import pallas_ec as RPE
from hbbft_tpu_torch.crypto import curve as PC
from hbbft_tpu_torch.ops import cuda_ec, ec as PE, limbs as PL, packed_msm as PM

# small tensors: intra-op threads only add contention beside the other
# test workers
torch.set_num_threads(1)


def _fq2_elements(seed: int, n: int) -> np.ndarray:
    """[n, 2, L] canonical Fq2 limbs from a numpy-seeded stream."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "big") % PL.P for _ in range(2 * n)]
    return PL.ints_to_limbs_batch(vals, PL.FQ_LIMBS).reshape(n, 2, PL.FQ_LIMBS)


def _g2_points(seed: int, n: int):
    rng = random.Random(seed)
    ks = [rng.randrange(1, 1 << 64) for _ in range(n)]
    return [RC.G2_GEN * k for k in ks] + [RC.G2.infinity()]


def test_fq2_mul_and_mul_b3_exact():
    a, b = _fq2_elements(1, 6), _fq2_elements(2, 6)
    ref, port = RE._fq2_ops(), PE.g2_kernel().f
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    prod = port.mul(ta, tb)
    assert np.array_equal(np.asarray(ref.mul(a, b)), prod.numpy())
    # once more on the redundant (lazily reduced) outputs
    assert np.array_equal(
        np.asarray(ref.mul(np.asarray(ref.mul(a, b)), a)), port.mul(prod, ta).numpy()
    )
    assert np.array_equal(np.asarray(ref.mul_b3(a)), port.mul_b3(ta).numpy())
    assert np.array_equal(np.asarray(ref.add(a, b)), port.add(ta, tb).numpy())
    assert np.array_equal(np.asarray(ref.sub(a, b)), port.sub(ta, tb).numpy())


def test_g2_to_limbs_matches_reference():
    ref_pts = _g2_points(3, 4)
    port_pts = [PC.G2.from_affine(p.affine()) if not p.is_infinity() else PC.G2.infinity() for p in ref_pts]
    got = PE.g2_to_limbs(port_pts)
    assert got.dtype == np.int32 and got.shape == (5, 3, 2, 38)
    assert np.array_equal(np.asarray(RE.g2_to_limbs(ref_pts)), got)


@pytest.mark.parametrize("case", ["distinct", "doubling", "identity"])
def test_g2_point_add_exact(case):
    p = RE.g2_to_limbs(_g2_points(4, 4))
    if case == "distinct":
        q = np.roll(p, 1, axis=0)
    elif case == "doubling":
        q = p
    else:
        q = np.broadcast_to(p[-1], p.shape).copy()  # the identity row
    ref = np.asarray(RE.g2_kernel().add(p, q))
    got = PE.g2_kernel().add(torch.from_numpy(p), torch.from_numpy(q)).numpy()
    assert np.array_equal(ref, got)
    # redundant projective limbs decode like the reference's
    for i in range(p.shape[0]):
        assert PE.g2_from_limbs(got[i]).to_bytes() == RE.g2_from_limbs(ref[i]).to_bytes()


def test_g2_identity_select_tree_match_reference():
    pts = _g2_points(5, 3)
    limbs = RE.g2_to_limbs(pts)
    kern = PE.g2_kernel()
    assert np.array_equal(np.asarray(RE.g2_kernel().identity((2,))), kern.identity((2,)).numpy())
    mask = np.array([True, False, True, False])
    other = limbs[::-1].copy()
    assert np.array_equal(
        np.asarray(RE.g2_kernel().select(mask, limbs, other)),
        kern.select(torch.from_numpy(mask), torch.from_numpy(limbs), torch.from_numpy(other)).numpy(),
    )
    want = pts[0] + pts[1] + pts[2] + pts[3]
    assert PE.g2_from_limbs(kern.tree_sum(torch.from_numpy(limbs))).to_bytes() == want.to_bytes()


def test_wire_points_g2_matches_reference():
    pts = _g2_points(6, 5)
    pts.insert(2, RC.G2.infinity())
    wires = np.frombuffer(b"".join(RNT.g2_wire(p) for p in pts), dtype=np.uint8).reshape(-1, 192)
    ref = np.asarray(RPM._wire_points_g2(wires))
    got = PM._wire_points_g2(torch.from_numpy(wires.copy())).numpy()
    assert got.shape == (7, 3, 2, 38)
    assert np.array_equal(ref, got)


def test_windowed_g2_plain_matches_host_16bit():
    """4 windows (16-bit scalars), an identity row and a zero scalar:
    k·P in the reference's wire bytes.  CPU tensors count no launch."""
    rng = random.Random(7)
    pts = _g2_points(8, 5)
    ks = [rng.randrange(0, 1 << 16) for _ in pts]
    ks[1] = 0
    limbs = torch.from_numpy(np.asarray(RE.g2_to_limbs(pts)))
    before = dict(cuda_ec.LAUNCHES)
    out = cuda_ec.scalar_mul_windowed_g2(limbs, PL.scalars_to_bits(ks, 16))
    assert cuda_ec.LAUNCHES == before
    assert out.shape == (6, 3, 2, 38) and out.dtype == torch.int32
    for i, (p, k) in enumerate(zip(pts, ks)):
        assert RNT.g2_wire(PE.g2_from_limbs(out[i])) == RNT.g2_wire(p * k), i


def test_g2_msm_packed_wires_cpu_matches_host():
    """The packed-wire flat G2 MSM (192-byte wires in, wire out), K = 9
    with an infinity row, on CPU tensors: the reference's host MSM."""
    rng = random.Random(71)
    pts = [RC.G2_GEN * rng.randrange(1, 1 << 40) for _ in range(9)]
    pts[4] = RC.G2.infinity()
    scalars = [rng.getrandbits(16) for _ in range(9)]
    wires = [RNT.g2_wire(p) for p in pts]
    phases = {}
    got = PM.g2_msm_packed_wires(wires, scalars, torch.device("cpu"), phases, nbits=16)
    assert got == RNT.g2_wire(RefCpuBackend().g2_msm(pts, scalars))
    assert set(phases) == {"ship_unpack", "win_g2", "tree", "finalize"}
    assert PM.g2_msm_packed_wires([], [], torch.device("cpu"), {}) == bytes(192)


def test_win_g2_checks_its_inputs():
    pts = torch.zeros((2, 3, 2, 38), dtype=torch.int32)
    digits = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_ec.win_g2(pts.to(torch.int64), digits)
    with pytest.raises(ValueError):
        cuda_ec.win_g2(pts[:, :, 0], digits)  # a G1 shape
    with pytest.raises(ValueError):
        cuda_ec.win_g2(pts, torch.zeros((3, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_ec.win_g2(pts.to("meta"), digits.to("meta"))


@pytest.mark.slow
def test_windowed_g2_plain_exact_vs_pallas_interpret():
    """Exact limbs against the reference Pallas G2 kernel in interpret
    mode (16-bit scalars, as tests/test_pallas_ec.py runs it)."""
    rng = random.Random(9)
    pts = _g2_points(10, 5)
    ks = [rng.randrange(0, 1 << 16) for _ in pts]
    ks[0] = 0
    limbs = np.asarray(RE.g2_to_limbs(pts))
    bits = RL.scalars_to_bits(ks, 16)
    ref = np.asarray(RPE.scalar_mul_windowed_g2(limbs, bits, interpret=True))
    got = cuda_ec.scalar_mul_windowed_g2(torch.from_numpy(limbs), bits).numpy()
    assert np.array_equal(ref, got)
