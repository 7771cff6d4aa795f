"""The bit-serial G1 scalar multiplication of the port (``scan_g1``).

On the CPU ``cuda_ec.scan_g1`` runs its plain PyTorch version
(``scan_plain``), which must give ``ec_jax.g1_kernel().scalar_mul``'s
limbs exactly and the reference host curve's k·P in wire bytes; slow:
exact limbs against the Pallas kernel in interpret mode
(``pallas_ec.scalar_mul_pallas``; its compile takes minutes on a CPU).
"""

import random

import numpy as np
import pytest
import torch

from hbbft_tpu.crypto import curve as RC
from hbbft_tpu.ops import ec_jax as RE
from hbbft_tpu.ops import limbs as RL
from hbbft_tpu.ops import pallas_ec as RPE
from hbbft_tpu_torch.ops import cuda_ec, ec as PE, limbs as PL

# small tensors: intra-op threads only add contention beside the other
# test workers
torch.set_num_threads(1)


def _case(seed: int, n: int, bits: int):
    rng = random.Random(seed)
    pts = [RC.G1_GEN * rng.randrange(1, 1 << 64) for _ in range(n)] + [RC.G1.infinity()]
    ks = [rng.randrange(0, 1 << bits) for _ in pts]
    ks[1] = 0
    return pts, ks, np.asarray(RE.g1_to_limbs(pts))


def test_scan_plain_exact_vs_xla_scan_48bit():
    pts, ks, limbs = _case(1, 5, 48)
    bits = RL.scalars_to_bits(ks, 48)
    ref = np.asarray(RE.g1_kernel().scalar_mul(limbs, bits))
    before = dict(cuda_ec.LAUNCHES)
    got = cuda_ec.scan_g1(torch.from_numpy(limbs), torch.from_numpy(bits))
    assert cuda_ec.LAUNCHES == before  # CPU tensors never count a launch
    assert np.array_equal(ref, got.numpy())


def test_scalar_mul_scan_matches_host_64bit():
    pts, ks, limbs = _case(2, 6, 64)
    out = cuda_ec.scalar_mul_scan(torch.from_numpy(limbs), PL.scalars_to_bits(ks, 64))
    assert out.shape == (7, 3, 38) and out.dtype == torch.int32
    for i, (p, k) in enumerate(zip(pts, ks)):
        assert PE.g1_from_limbs(out[i]).to_bytes() == (p * k).to_bytes(), i


def test_any_nonzero_bit_selects_the_add():
    """The reference's select takes acc + P for any nonzero bit."""
    pts, _, limbs = _case(3, 2, 8)
    ones = torch.ones((3, 4), dtype=torch.int32)
    got = cuda_ec.scan_g1(torch.from_numpy(limbs), ones * 5)
    want = cuda_ec.scan_g1(torch.from_numpy(limbs), ones)
    assert torch.equal(got, want)
    assert PE.g1_from_limbs(got[0]).to_bytes() == (pts[0] * 15).to_bytes()


def test_scan_g1_checks_its_inputs():
    pts = torch.zeros((2, 3, 38), dtype=torch.int32)
    bits = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_ec.scan_g1(pts, bits.to(torch.int64))
    with pytest.raises(ValueError):
        cuda_ec.scan_g1(pts, bits[:1])
    with pytest.raises(ValueError):
        cuda_ec.scan_g1(pts[:, :2], bits)
    with pytest.raises(ValueError):
        cuda_ec.scan_g1(pts.to("meta"), bits.to("meta"))


@pytest.mark.slow
def test_scan_plain_exact_vs_pallas_interpret():
    """Exact limbs against the reference Pallas scan kernel in interpret
    mode (one tile, 8-bit scalars as in tests/test_pallas_ec.py)."""
    _, ks, limbs = _case(4, 6, 8)
    bits = RL.scalars_to_bits(ks, 8)
    ref = np.asarray(RPE.scalar_mul_pallas(limbs, bits, interpret=True))
    got = cuda_ec.scalar_mul_scan(torch.from_numpy(limbs), bits).numpy()
    assert np.array_equal(ref, got)
