"""The port's Merkle forest (``ops/sha256.merkle_forest``) against the
reference, tree by tree.

``merkle_forest_plain`` (the kernel's plain version, which the wrapper
runs on CPU tensors) builds T trees of n uniform leaves at once; every
tree's rows must equal the JAX package's ``MerkleTree.levels`` and, on a
subset whose compiles stay short, its XLA program ``merkle_levels_device``
(``hbbft_tpu/ops/sha256_jax.py:147``, under ``JAX_PLATFORMS=cpu``), and
the roots-only mode each tree's root.  The backends' batch form
(``merkle_trees``) and the lazy device tree are held to the host trees.
Inputs come from a seed.
"""

import numpy as np
import pytest
import torch

from hbbft_tpu.crypto.merkle import MerkleTree as RefMerkleTree
from hbbft_tpu.ops import sha256_jax as RS
from hbbft_tpu_torch.crypto.backend import CpuBackend
from hbbft_tpu_torch.ops import cuda_ec
from hbbft_tpu_torch.ops import sha256 as PS
from hbbft_tpu_torch.ops.backend_cuda import CudaBackend, _DeviceMerkleTree

torch.set_num_threads(1)

LEAVES = (1, 2, 3, 5, 10, 16, 64)
LENGTHS = (2, 11, 55, 56, 200)  # one block; the padding's edge at 55/56; four blocks
TREES = (1, 3, 7)


def _values(seed, T, n, length):
    return np.random.default_rng(seed).integers(0, 256, size=(T, n, length), dtype=np.uint8)


def _trees(values):
    return [[row.tobytes() for row in tree] for tree in values]


# every leaf count meets every length once, the forest's tree count cycling
GRID = [(TREES[(i + j) % 3], n, length)
        for i, n in enumerate(LEAVES) for j, length in enumerate(LENGTHS)]


@pytest.mark.parametrize("T,n,length", GRID)
def test_forest_plain_matches_reference_trees(T, n, length):
    values = _values(T * 100_000 + n * 1_000 + length, T, n, length)
    rows = PS.merkle_forest_plain(torch.from_numpy(values))
    assert rows.shape == (T, sum(PS.level_sizes(n)), 8) and rows.dtype == torch.int32
    for t, vals in enumerate(_trees(values)):
        levels = PS.split_levels(b"".join(PS.digests_to_bytes(rows[t])), n)
        assert levels == RefMerkleTree(vals).levels
    if T == 3:
        roots = PS.merkle_forest_plain(torch.from_numpy(values), roots_only=True)
        assert roots.shape == (T, 8)
        assert PS.digests_to_bytes(roots) == [RefMerkleTree(v).root_hash for v in _trees(values)]


@pytest.mark.parametrize("T,n,length", [(3, 1, 2), (1, 3, 2), (7, 10, 2), (1, 64, 2),
                                        (3, 10, 11), (3, 10, 55), (1, 10, 56), (3, 10, 200)])
def test_forest_plain_matches_reference_xla_levels(T, n, length):
    values = _values(n * 1_000 + length, T, n, length)
    got = PS.merkle_forest_device(values, device="cpu")
    roots = PS.merkle_forest_device(values, device="cpu", roots_only=True)
    for t, vals in enumerate(_trees(values)):
        want = RS.merkle_levels_device(vals)
        assert PS.split_levels(got[t].tobytes(), n) == want
        assert roots[t].tobytes() == want[-1][0]


def test_forest_wrapper_runs_the_plain_version_on_cpu_tensors():
    values = torch.from_numpy(_values(1, 3, 9, 7))
    before = dict(cuda_ec.LAUNCHES)
    assert torch.equal(PS.merkle_forest(values), PS.merkle_forest_plain(values))
    assert torch.equal(PS.merkle_forest(values, roots_only=True),
                       PS.merkle_forest_plain(values, roots_only=True))
    assert cuda_ec.LAUNCHES == before  # CPU tensors never count a launch
    for bad in (values.to(torch.int16), values[0], values[:, :0]):
        with pytest.raises(ValueError):
            PS.merkle_forest(bad)


def test_merkle_levels_device_is_a_forest_of_one():
    vals = _trees(_values(2, 1, 11, 5))[0]
    assert PS.merkle_levels_device(vals, device="cpu") == RefMerkleTree(vals).levels
    with pytest.raises(ValueError):
        PS.merkle_levels_device([b"ab", b"abc"], device="cpu")
    with pytest.raises(ValueError):
        PS.merkle_levels_device([], device="cpu")


def test_forest_shape():
    arr = _values(3, 4, 9, 5)
    assert PS.forest_shape(arr) == (4, 9, 5)
    assert PS.forest_shape(_trees(arr)) == (4, 9, 5)
    assert PS.forest_shape([[b"ab"] * 9, [b"ab"] * 8]) is None  # leaf counts differ
    assert PS.forest_shape([[b"ab"] * 9, [b"abc"] * 9]) is None  # lengths differ
    assert PS.forest_shape([]) is None and PS.forest_shape([[]]) is None


def test_forest_rule_is_a_pure_predicate_with_a_floor():
    be = CudaBackend(device="cpu")
    n, most = be.MERKLE_DEVICE_MIN_LEAVES, be.MERKLE_DEVICE_MAX_BYTES
    assert not be.forest_on_device(1, n - 1, 2)
    assert be.forest_on_device(1, n, 2)
    assert be.forest_on_device(n // 8, 8, 2)  # many small trees count together
    assert not be.forest_on_device(n, 7, 2)  # below the reference's 8 leaves a tree
    assert not be.forest_on_device(1, n, most // n + 1)
    forced = CudaBackend(device="cpu")
    for name, value in forced.RBC_FLOOR.items():
        setattr(forced, name, value)
    assert forced.forest_on_device(1, 8, 1 << 20) and not forced.forest_on_device(1, 7, 2)


def test_device_tree_reads_its_rows_lazily():
    values = _values(4, 2, 13, 6)
    raw = PS.merkle_forest_device(values, device="cpu")
    tree = _DeviceMerkleTree(values[1], raw[1], 13)
    ref = RefMerkleTree(_trees(values)[1])
    assert tree._levels is None and tree.root_hash == ref.root_hash and tree._levels is None
    assert tree.levels_equal(ref.levels)
    bad = [list(level) for level in ref.levels]
    bad[2][1] = bytes(32)
    assert not tree.levels_equal(bad)
    assert not tree.levels_equal(ref.levels[:-1])
    assert tree.levels == ref.levels and tree.values == _trees(values)[1]
    assert all(tree.proof(i).validate(13) for i in range(13))
    assert CpuBackend().merkle_trees(values, roots_only=True) == [
        RefMerkleTree(v).root_hash for v in _trees(values)]
