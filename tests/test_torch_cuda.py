"""The port's CUDA kernels on the card (marker ``cuda``).

These tests need a CUDA card, ``nvcc`` and the native host library; on
a host without a card they skip.  They import only torch and the port,
so they run on the GPU machine as they are:
``python -m pytest tests/test_torch_cuda.py -q``.

``win_g1``, ``win_g2`` and ``scan_g1`` must equal their plain PyTorch
versions limb for limb (exact) and native ``hb_g1_mul`` / ``hb_g2_mul``
canonically, and count exactly one launch per call; a small DKG with
its fused MSM forced onto the card must give the CPU run's keys.
"""

import random

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("bits", [96, 255])
def test_win_g1_kernel_matches_plain_and_native(dev, bits):
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.curve import G1_GEN
    from hbbft_tpu_torch.ops import cuda_ec, ec, packed_msm as PM

    rng = random.Random(bits)
    k = 300  # not a multiple of the 128-thread block
    wires = NT.g1_mul_many(NT.g1_wire(G1_GEN), [rng.randrange(1, F.R) for _ in range(k)])
    wires[7] = bytes(96)  # an identity row
    arr = np.frombuffer(b"".join(wires), dtype=np.uint8).reshape(k, 96).copy()
    pts = PM._wire_points_g1(torch.from_numpy(arr).to(dev))
    scalars = [rng.randrange(0, 1 << bits) % F.R for _ in range(k)]
    scalars[3] = 0
    sc = torch.from_numpy(PM.scalar_bytes_batch(scalars, (bits + 7) // 8)).to(dev)
    digits = PM._scalar_digits(sc)
    before = cuda_ec.LAUNCHES["win_g1"]
    got = cuda_ec.win_g1(pts, digits)
    assert cuda_ec.LAUNCHES["win_g1"] == before + 1
    plain = cuda_ec.windowed_plain(pts, digits)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    host = got.cpu().numpy()
    for i in range(k):
        assert NT.g1_wire(ec.g1_from_limbs(host[i])) == NT.g1_mul(wires[i], scalars[i])


def _g2_case(dev, rng, k):
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.curve import G2_GEN
    from hbbft_tpu_torch.ops import packed_msm as PM

    ks = PM.scalar_bytes_batch([rng.randrange(1, F.R) for _ in range(k)], 32)
    raw = NT.g2_mul_many_raw(NT.g2_wire(G2_GEN), ks).reshape(k, 192)
    raw[7] = 0  # an identity row
    wires = [raw[i].tobytes() for i in range(k)]
    return wires, PM._wire_points_g2(torch.from_numpy(raw.copy()).to(dev))


def test_win_g2_kernel_matches_plain_and_native(dev):
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.ops import cuda_ec, ec, packed_msm as PM

    rng = random.Random(0x62)
    k = 300  # not a multiple of the 128-thread block
    wires, pts = _g2_case(dev, rng, k)
    scalars = [rng.randrange(0, F.R) for _ in range(k)]
    scalars[3] = 0
    digits = PM._scalar_digits(torch.from_numpy(PM.scalar_bytes_batch(scalars, 32)).to(dev))
    before = cuda_ec.LAUNCHES["win_g2"]
    got = cuda_ec.win_g2(pts, digits)
    assert cuda_ec.LAUNCHES["win_g2"] == before + 1
    plain = cuda_ec.windowed_g2_plain(pts, digits)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    host = got.cpu().numpy()
    for i in range(k):
        assert NT.g2_wire(ec.g2_from_limbs(host[i])) == NT.g2_mul(wires[i], scalars[i])


def test_scan_g1_kernel_matches_plain_and_native(dev):
    from hbbft_tpu_torch import native as NT
    from hbbft_tpu_torch.crypto import fields as F
    from hbbft_tpu_torch.crypto.curve import G1_GEN
    from hbbft_tpu_torch.ops import cuda_ec, ec, limbs as LB, packed_msm as PM

    rng = random.Random(0x5C)
    k = 300
    wires = NT.g1_mul_many(NT.g1_wire(G1_GEN), [rng.randrange(1, F.R) for _ in range(k)])
    wires[7] = bytes(96)
    arr = np.frombuffer(b"".join(wires), dtype=np.uint8).reshape(k, 96).copy()
    pts = PM._wire_points_g1(torch.from_numpy(arr).to(dev))
    scalars = [rng.randrange(0, F.R) for _ in range(k)]
    scalars[3] = 0
    bits = torch.from_numpy(LB.scalars_to_bits(scalars, 255)).to(dev)
    before = cuda_ec.LAUNCHES["scan_g1"]
    got = cuda_ec.scan_g1(pts, bits)
    assert cuda_ec.LAUNCHES["scan_g1"] == before + 1
    plain = cuda_ec.scan_plain(pts, bits)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    host = got.cpu().numpy()
    for i in range(k):
        assert NT.g1_wire(ec.g1_from_limbs(host[i])) == NT.g1_mul(wires[i], scalars[i])


def test_dkg_on_the_card_matches_cpu(dev):
    """A DKG small enough for the CPU, with the fused MSM forced onto the
    card: the same keys as the CPU run, and win_g2 launched."""
    from hbbft_tpu_torch.harness.dkg import VectorizedDkg
    from hbbft_tpu_torch.ops import cuda_ec

    card = VectorizedDkg(range(7), 2, random.Random(5))
    card.G2_DEVICE_MIN = 0
    before = cuda_ec.LAUNCHES["win_g2"]
    got = card.run(verify_honest=True)
    assert cuda_ec.LAUNCHES["win_g2"] == before + 1
    want = VectorizedDkg(range(7), 2, random.Random(5), device="cpu").run(verify_honest=True)
    assert got.fault_log.is_empty() and got.msm_points == 7 * 9
    assert got.pk_set.public_key().to_bytes() == want.pk_set.public_key().to_bytes()
    assert all(got.shares[i].scalar == want.shares[i].scalar for i in range(7))
