"""The port's batched SHA-256 and Merkle trees (``ops/sha256.py``)
against the reference's XLA programs (``hbbft_tpu/ops/sha256_jax.py``),
``hashlib`` and ``MerkleTree``, exactly.

The port runs its plain versions on CPU tensors (``device="cpu"``); the
reference runs under ``JAX_PLATFORMS=cpu``.  Inputs come from a seed.
"""

import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.merkle import MerkleTree as RefMerkleTree
from hbbft_tpu.ops import sha256_jax as RS
from hbbft_tpu_torch.crypto.backend import CpuBackend
from hbbft_tpu_torch.crypto.merkle import MerkleTree
from hbbft_tpu_torch.ops import cuda_ec
from hbbft_tpu_torch.ops import sha256 as PS
from hbbft_tpu_torch.ops.backend_cuda import CudaBackend

torch.set_num_threads(1)

# tests/test_ops.py:216's lengths, and 119/120 (two and three blocks)
LENGTHS = [0, 1, 32, 55, 56, 64, 100, 119, 120, 200]


def _msgs(seed, n, length):
    rng = random.Random(seed)
    return [bytes(rng.randrange(256) for _ in range(length)) for _ in range(n)]


@pytest.mark.parametrize("length", LENGTHS)
def test_pad_messages_equal(length):
    msgs = _msgs(length, 5, length)
    assert np.array_equal(PS.pad_messages(msgs), RS.pad_messages(msgs))


def test_pad_messages_empty_batch_and_leaf_blocks():
    assert np.array_equal(PS.pad_messages([]), RS.pad_messages([]))
    # the forest's plain version pads its leaf messages as the reference does
    for length in (40, 55, 56, 0):
        vals = _msgs(3 + length, 9, length)
        leaves = [b"\x00" + i.to_bytes(8, "big") + v for i, v in enumerate(vals)]
        arr = torch.from_numpy(np.frombuffer(b"".join(vals) or b"", np.uint8).reshape(1, 9, length).copy())
        words = PS._leaf_words(arr).numpy().view(np.uint32)
        assert np.array_equal(words, RS.pad_messages(leaves))


@pytest.mark.parametrize("length", LENGTHS)
def test_sha256_device_matches_reference_and_hashlib(length):
    msgs = _msgs(100 + length, 9, length)
    blocks = PS.pad_messages(msgs)
    want = np.asarray(RS.sha256_device(jnp.asarray(blocks)))
    got = PS.sha256_device(torch.from_numpy(blocks.view(np.int32)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert PS.digests_to_bytes(got) == RS.digests_to_bytes(want)
    assert PS.sha256_many(msgs, device="cpu") == [hashlib.sha256(m).digest() for m in msgs]


# the raw-bytes entry's lengths: empty, one byte, the padding's edges at
# 55/56 and 63/64, the two-to-three-block edge at 119/120, and 1,000
RAW_LENGTHS = [0, 1, 55, 56, 63, 64, 119, 120, 1000]


@pytest.mark.parametrize("length", RAW_LENGTHS)
def test_sha256_bytes_plain_and_many_match_reference_and_hashlib(length):
    """``sha256_bytes`` on CPU rows (its plain version: the reference's
    padding as torch ops, then ``sha256_plain``) and ``sha256_many`` on the
    CPU against the reference's ``sha256_many`` and ``hashlib``; the torch
    padding equals ``pad_messages``'."""
    raw = np.random.default_rng(7000 + length).integers(0, 256, size=(6, length), dtype=np.uint8)
    msgs = [r.tobytes() for r in raw]
    want = [hashlib.sha256(m).digest() for m in msgs]
    assert RS.sha256_many(msgs) == want
    rows = torch.from_numpy(raw)
    assert np.array_equal(PS._message_words(rows).numpy().view(np.uint32), RS.pad_messages(msgs))
    before = dict(cuda_ec.LAUNCHES)
    got = PS.sha256_bytes(rows)
    assert got.dtype == torch.int32 and got.shape == (6, 8)
    assert torch.equal(got, PS.sha256_bytes_plain(rows))
    assert PS.digests_to_bytes(got) == want
    assert PS.sha256_many(msgs, device="cpu") == want
    assert cuda_ec.LAUNCHES == before  # CPU tensors never count a launch


def test_sha256_bytes_takes_rows_at_any_offset_and_writes_out():
    buf = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=3 * 57 + 1, dtype=np.uint8))
    rows = buf[1:].view(3, 57)  # a view one byte into its storage
    out = torch.zeros((3, 8), dtype=torch.int32)
    assert PS.sha256_bytes(rows, out=out) is out
    assert PS.digests_to_bytes(out) == [hashlib.sha256(r.numpy().tobytes()).digest() for r in rows]
    with pytest.raises(ValueError):
        PS.sha256_bytes(torch.zeros((3, 4), dtype=torch.int32))  # bytes only
    with pytest.raises(ValueError):
        PS.sha256_many([b"ab", b"abc"], device="cpu")  # one length a batch


def test_sha256_many_pads_nothing_on_the_host(monkeypatch):
    """``sha256_many`` hands the joined messages to ``sha256_bytes`` and
    never calls ``pad_messages``."""
    def no_padding(msgs):
        raise AssertionError("sha256_many padded on the host")

    monkeypatch.setattr(PS, "pad_messages", no_padding)
    monkeypatch.setattr(PS, "_be_words", no_padding)
    seen = []
    real = PS.sha256_bytes
    monkeypatch.setattr(PS, "sha256_bytes", lambda rows: seen.append(rows.shape) or real(rows))
    msgs = _msgs(11, 9, 47)
    assert PS.sha256_many(msgs, device="cpu") == [hashlib.sha256(m).digest() for m in msgs]
    assert seen == [(9, 47)]


def test_sha256_device_keeps_uint32_and_counts_no_cpu_launch():
    msgs = _msgs(7, 3, 20)
    blocks = torch.from_numpy(PS.pad_messages(msgs).view(np.int32)).view(torch.uint32)
    before = dict(cuda_ec.LAUNCHES)
    got = PS.sha256_device(blocks)
    assert got.dtype == torch.uint32
    assert PS.digests_to_bytes(got) == [hashlib.sha256(m).digest() for m in msgs]
    assert cuda_ec.LAUNCHES == before  # CPU tensors never count a launch


def test_merkle_level_plain_hashes_node_messages():
    words = torch.from_numpy(
        np.random.default_rng(1).integers(0, 2**32, size=(6, 8), dtype=np.uint32).view(np.int32))
    kids = PS.digests_to_bytes(words)
    want = [hashlib.sha256(b"\x01" + kids[i] + kids[i + 1]).digest() for i in range(0, 6, 2)]
    assert PS.digests_to_bytes(PS.merkle_level_plain(words)) == want
    # the forest builds its levels from it: two leaves' parent is the root
    vals = np.random.default_rng(2).integers(0, 256, size=(1, 2, 5), dtype=np.uint8)
    rows = PS.merkle_forest(torch.from_numpy(vals))
    assert torch.equal(rows[0, 2:], PS.merkle_level_plain(rows[0, :2]))
    with pytest.raises(ValueError):
        PS.merkle_forest(torch.zeros((1, 0, 5), dtype=torch.uint8))  # a tree needs a leaf


@pytest.mark.parametrize("leaves", [1, 2, 3, 11, 64])
def test_merkle_levels_device_matches_reference_and_tree(leaves):
    values = [bytes([i % 256]) * 40 for i in range(leaves)]
    got = PS.merkle_levels_device(values, device="cpu")
    assert got == RS.merkle_levels_device(values)
    assert got == MerkleTree(values).levels == RefMerkleTree(values).levels
    assert [len(level) for level in got] == PS.level_sizes(leaves)


def test_forced_backend_hashes_like_cpu_backend():
    import sys
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    from hbbft_tpu_torch.harness.rbc_probe import RbcProbe

    be = cs.forced(CudaBackend(device="cpu"))
    host = CpuBackend()
    with RbcProbe(be) as probe:
        for n, length in ((8, 33), (12, 70), (7, 10), (9, 0)):
            msgs = _msgs(n * 1000 + length, n, length)
            assert be.sha256_many(msgs) == host.sha256_many(msgs)
        mixed = _msgs(1, 4, 5) + _msgs(2, 5, 6)  # not uniform: the host
        assert be.sha256_many(mixed) == host.sha256_many(mixed)
        for n in (8, 13):
            vals = _msgs(n, n, 24)
            tree = be.merkle_tree(vals)
            assert type(tree).__name__ == "_DeviceMerkleTree"
            assert tree.levels == host.merkle_tree(vals).levels
            assert tree.root_hash == host.merkle_tree(vals).root_hash
            assert all(tree.proof(i).validate(n) for i in range(n))
        assert type(be.merkle_tree(_msgs(5, 5, 24))).__name__ == "MerkleTree"  # fewer than 8
        # the batches of 8, 12 and 9 hashes and the two trees (a forest of
        # one each) took the card's route
    assert probe.sent == {"sha256": 3, "merkle_forest": 2, "gf_matmul": 0}


def test_default_rules_keep_small_batches_on_the_host():
    from hbbft_tpu_torch.harness.rbc_probe import RbcProbe

    be = CudaBackend(device="cpu")
    with RbcProbe(be) as probe:
        be.sha256_many(_msgs(4, be.SHA_DEVICE_MIN_ITEMS - 1, 40))  # a message below the rule
        be.merkle_tree(_msgs(5, be.MERKLE_DEVICE_MIN_LEAVES - 1, 40))  # a leaf below the rule
    assert probe.sent == {"sha256": 0, "merkle_forest": 0, "gf_matmul": 0}
    n, most = be.SHA_DEVICE_MIN_ITEMS, be.SHA_DEVICE_MAX_BYTES // be.SHA_DEVICE_MIN_ITEMS
    assert not be.sha_on_device(_msgs(3, n - 1, 40))
    assert be.sha_on_device([b"\0" * most] * n)
    # past the batch's byte ceiling it stays on the host
    assert not be.sha_on_device([b"\0" * (most + 1)] * n)
    n, most = be.MERKLE_DEVICE_MIN_LEAVES, be.MERKLE_DEVICE_MAX_BYTES // be.MERKLE_DEVICE_MIN_LEAVES
    assert not be.forest_on_device(1, n - 1, 2)
    assert be.forest_on_device(1, n, 2)
    assert not be.forest_on_device(1, n, most + 1)
