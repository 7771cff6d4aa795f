"""The port's CUDA kernels on the card (marker ``cuda``).

These tests need a CUDA card, ``nvcc`` and the native host library; on
a host without a card they skip.  They import only torch and the port,
so they run on the GPU machine as they are:
``python -m pytest tests/test_torch_cuda.py -q``.

``win_g1`` must equal its plain PyTorch version limb for limb (exact)
and native ``hb_g1_mul`` canonically, and count exactly one launch per
call.
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
