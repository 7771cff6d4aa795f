"""The port's GF(2^8) / GF(2^16) Reed–Solomon products and device codecs
(``ops/gf256.py``) against the reference's XLA programs and codecs
(``hbbft_tpu/ops/gf256_jax.py``), exactly.

The binary expansions (the plain version's constant operand, built from
the port's own ``crypto/rs.py`` tables) are held array-equal to the
reference's, and the kernel's constants ``M[i, j]·2^b`` to the columns
of those blocks.  The port runs its plain versions on CPU tensors; the
reference runs under ``JAX_PLATFORMS=cpu``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.rs import ReedSolomon as RefRS
from hbbft_tpu.crypto.rs import ReedSolomon16 as RefRS16
from hbbft_tpu.ops import gf256_jax as RG
from hbbft_tpu_torch.crypto import rs as PR
from hbbft_tpu_torch.ops import cuda_ec
from hbbft_tpu_torch.ops import gf256 as PG

torch.set_num_threads(1)


def _mat(rng, m, k, W):
    dtype = np.uint8 if W == 8 else np.uint16
    return np.array([[rng.randrange(1 << W) for _ in range(k)] for _ in range(m)], dtype=dtype)


def test_binary_matrix_matches_reference():
    rng = random.Random(1)
    mat = _mat(rng, 5, 7, 8)
    mat[0, 0], mat[1, 1] = 0, 1
    key = (5, 7, mat.tobytes())
    assert np.array_equal(PG._binary_matrix(key), RG._binary_matrix(key))
    for c in (0, 1, 2, 0x1D, 0xFF):
        assert np.array_equal(PG._gf_mul_table_bits(c), RG._gf_mul_table_bits(c))


def test_binary_matrix16_matches_reference():
    rng = random.Random(2)
    mat = _mat(rng, 4, 6, 16)
    mat[0, 0], mat[1, 1] = 0, 1
    key = (4, 6, mat.tobytes())
    assert np.array_equal(PG._binary_matrix16(key), RG._binary_matrix16(key))
    assert np.array_equal(PG._bits16_table()[[0, 1, 2, 0xFFFF, 0x1234]],
                          RG._bits16_table()[[0, 1, 2, 0xFFFF, 0x1234]])


@pytest.mark.parametrize("W", [8, 16])
def test_const_table_is_the_binary_blocks_columns(W):
    rng = random.Random(W)
    mat = _mat(rng, 3, 4, W)
    mat[2, 3] = 0
    key = (3, 4, mat.tobytes())
    binary = (RG._binary_matrix if W == 8 else RG._binary_matrix16)(key)
    table = PG.const_table(mat).astype(np.int64)  # [m, k, W]
    blocks = binary.reshape(3, W, 4, W).transpose(0, 2, 1, 3)  # [m, k, out bit, in bit]
    cols = (blocks.astype(np.int64) << np.arange(W)[None, None, :, None]).sum(axis=2)
    assert np.array_equal(table, cols)


def test_gf_matmul_device_matches_reference():
    # tests/test_ops.py:235-247's inputs
    rng = random.Random(3)
    m = np.array([[rng.randrange(256) for _ in range(6)] for _ in range(4)], dtype=np.uint8)
    d = np.array([[rng.randrange(256) for _ in range(50)] for _ in range(6)], dtype=np.uint8)
    want = np.asarray(RG.gf_matmul_device(m, jnp.asarray(d)))
    before = dict(cuda_ec.LAUNCHES)
    got = PG.gf_matmul_device(m, d, device="cpu")
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(PG.gf_matmul_device(m, torch.from_numpy(d)).numpy(), want)
    assert np.array_equal(want, PR.gf_matmul(m, d))
    assert cuda_ec.LAUNCHES == before  # CPU tensors never count a launch


def test_gf16_matmul_device_matches_reference():
    rng = random.Random(4)
    m = _mat(rng, 4, 6, 16)
    d = _mat(rng, 6, 50, 16)
    want = np.asarray(RG.gf16_matmul_device(m, jnp.asarray(d)))
    got = PG.gf16_matmul_device(m, d, device="cpu")
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy().view(np.uint16), want)
    assert np.array_equal(want, PR.gf16_matmul(m, d))


def test_gf_matmul_checks_its_operands():
    m8 = np.ones((2, 3), np.uint8)
    with pytest.raises(TypeError):
        PG.gf_matmul(m8, torch.zeros((3, 4), dtype=torch.int16))
    with pytest.raises(ValueError):
        PG.gf_matmul(m8, torch.zeros((4, 4), dtype=torch.uint8))
    with pytest.raises(TypeError):
        PG.gf_matmul(m8.astype(np.int32), torch.zeros((3, 4), dtype=torch.uint8))


@pytest.mark.parametrize("k,m", [(4, 2), (6, 3), (10, 2)])
def test_rs_encode_matches_reference(k, m):
    rng = random.Random(k * 10 + m)
    dev = PG.ReedSolomonDevice(k, m, device="cpu")
    data = [bytes(rng.randrange(256) for _ in range(64)) for _ in range(k)]
    assert dev.encode(data) == RG.ReedSolomonDevice(k, m).encode(data) == RefRS(k, m).encode(data)
    assert np.array_equal(dev._host.matrix, RefRS(k, m).matrix)


def test_rs_reconstruct_matches_reference():
    rng = random.Random(5)
    k, m = 5, 3
    dev = PG.ReedSolomonDevice(k, m, device="cpu")
    ref = RG.ReedSolomonDevice(k, m)
    data = [bytes(rng.randrange(256) for _ in range(48)) for _ in range(k)]
    full = dev.encode(data)
    slots = list(full)
    for i in (1, 4, 6):
        slots[i] = None
    assert dev.reconstruct(list(slots)) == ref.reconstruct(list(slots)) == full
    assert np.array_equal(dev.decode_matrix([0, 2, 3, 5, 7]), ref.decode_matrix([0, 2, 3, 5, 7]))


def test_rs16_device_matches_reference():
    # tests/test_rs16.py:101-115's inputs
    rng = random.Random(11)
    k, m = 90, 180
    host = RefRS16(k, m)
    dev = PG.ReedSolomonDevice16(k, m, device="cpu")
    data = [bytes(rng.randrange(256) for _ in range(16)) for _ in range(k)]
    h = host.encode(data)
    assert dev.encode(data) == h == RG.ReedSolomonDevice16(k, m).encode(data)
    slots = list(h)
    for i in rng.sample(range(k + m), m):
        slots[i] = None
    assert dev.reconstruct(list(slots)) == h


def test_codec_rule_routes_each_product():
    seen = []

    def rule(m, k, columns):
        seen.append((m, k, columns))
        return m * k * columns >= 100

    rng = random.Random(6)
    dev = PG.ReedSolomonDevice(6, 3, device="cpu", rule=rule)
    data = [bytes(rng.randrange(256) for _ in range(10)) for _ in range(6)]
    full = dev.encode(data)
    assert full == RefRS(6, 3).encode(data)
    slots = list(full)
    slots[0] = slots[8] = None
    assert dev.reconstruct(slots) == full
    # the parity product, the decode and the two missing rows
    assert seen == [(3, 6, 10), (6, 6, 10), (2, 6, 10)]


@pytest.mark.parametrize("W", [8, 16])
def test_abin_tiles_hold_the_reference_binary_expansion(W):
    """The kernel's operand (``abin_tiles``, built from ``const_table`` on
    the tensor's device) is the reference's ``_binary_matrix{,16}`` in
    tiles of 256 rows × 32 bits of k, core matrices of 8 rows × 16 bytes,
    zero padded."""
    rng = random.Random(20 + W)
    m, k = (37, 11) if W == 8 else (19, 7)
    mat = _mat(rng, m, k, W)
    mat[0, 0], mat[1, 1] = 0, 1
    table = PG.const_table(mat)
    tiles = PG.abin_tiles(torch.from_numpy(table if W == 8 else table.view(np.int16)), W)
    MT, KS = -(-W * m // 256), -(-W * k // 32)
    assert tuple(tiles.shape) == (MT, KS, 256 * 32) and tiles.dtype == torch.uint8
    flat = tiles.view(MT, KS, 32, 2, 8, 16).permute(0, 2, 4, 1, 3, 5).reshape(MT * 256, KS * 32)
    binary = (RG._binary_matrix if W == 8 else RG._binary_matrix16)((m, k, mat.tobytes()))
    assert np.array_equal(flat[: W * m, : W * k].numpy(), binary.astype(np.uint8))
    assert not flat[W * m :].any() and not flat[:, W * k :].any()


@pytest.mark.parametrize("columns", [1, 2, 3, 17])
def test_thin_products_match_reference(columns):
    """Thin products (a proposer's dead rows, a sequential engine's few
    symbols) through the wrapper's route on CPU tensors, against the
    reference's device products."""
    rng = random.Random(columns)
    m16, d16 = _mat(rng, 5, 12, 16), _mat(rng, 12, columns, 16)
    want16 = np.asarray(RG.gf16_matmul_device(m16, jnp.asarray(d16)))
    got16 = PG.gf_matmul(m16, torch.from_numpy(d16.view(np.int16)))
    assert np.array_equal(got16.numpy().view(np.uint16), want16)
    m8, d8 = _mat(rng, 3, 9, 8), _mat(rng, 9, columns, 8)
    want8 = np.asarray(RG.gf_matmul_device(m8, jnp.asarray(d8)))
    assert np.array_equal(PG.gf_matmul(m8, torch.from_numpy(d8)).numpy(), want8)
