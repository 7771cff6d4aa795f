"""The port's Fq limb arithmetic against the JAX reference.

``hbbft_tpu_torch.ops.limbs`` must give the same int32 limbs as
``hbbft_tpu.ops.limbs`` for every op — tolerance: exact equality (this
is integer arithmetic with one schedule) — and ``canon`` must give the
canonical residue of the Python integer mod p.
"""

import numpy as np
import pytest
import torch

from hbbft_tpu.ops import limbs as RL
from hbbft_tpu_torch.ops import limbs as PL

# small tensors: intra-op threads only add contention beside the other
# test workers
torch.set_num_threads(1)

L = PL.FQ_LIMBS
BOUND = (1 << (PL.LIMB_BITS + 1)) - 1  # the redundant-limb invariant |limb| ≤ 2^12 − 1


def _redundant(seed: int, n: int = 24, lo: int = -BOUND) -> np.ndarray:
    return np.random.default_rng(seed).integers(lo, BOUND + 1, size=(n, L), dtype=np.int32)


def _both(op, *args):
    ref = np.asarray(getattr(RL.fq(), op)(*[np.asarray(a) for a in args]))
    got = getattr(PL.fq(), op)(*[torch.from_numpy(np.asarray(a)) for a in args])
    return ref, got.numpy()


def test_constants_match_reference():
    for name in ("fold", "sub_pad", "canon_steps", "one", "zero"):
        assert np.array_equal(getattr(RL.fq(), name), getattr(PL.fq(), name)), name


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_exact(op):
    a, b = _redundant(1), _redundant(2)
    ref, got = _both(op, a, b)
    assert got.dtype == np.int32 and got.shape == (24, L)
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("op", ["neg", "sq"])
def test_unary_ops_exact(op):
    ref, got = _both(op, _redundant(3))
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("k", [12, 7, (1 << 17) - 1])
def test_mul_small_exact(k):
    a = _redundant(4)
    ref = np.asarray(RL.fq().mul_small(a, k))
    got = PL.fq().mul_small(torch.from_numpy(a), k).numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("width", [L - 1, L, L + 1, 2 * L - 1])
def test_normalize_exact(width):
    """Wide non-negative inputs of every width the field ops produce
    (sums, differences with the pad, convolutions)."""
    rng = np.random.default_rng(width)
    wide = rng.integers(0, 1 << 29, size=(16, width), dtype=np.int32)
    ref = np.asarray(RL.fq().normalize(wide))
    got = PL.fq().normalize(torch.from_numpy(wide)).numpy()
    assert np.array_equal(ref, got)


def test_ops_are_field_ops_mod_p():
    a, b = _redundant(5, lo=0), _redundant(6, lo=0)
    f = PL.fq()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for i in range(a.shape[0]):
        x, y = PL.limbs_to_int(a[i]), PL.limbs_to_int(b[i])
        assert f.from_limbs(f.mul(ta, tb)[i].numpy()) == x * y % PL.P
        assert f.from_limbs(f.sub(ta, tb)[i].numpy()) == (x - y) % PL.P


def test_canon_matches_python_ints_and_reference():
    f = PL.fq()
    x = f.mul(torch.from_numpy(_redundant(7)), torch.from_numpy(_redundant(8)))
    # include 0, p − 1 and p itself in redundant (non-canonical) forms
    special = np.stack(
        [PL.int_to_limbs(0, L), PL.int_to_limbs(PL.P - 1, L), PL.int_to_limbs(PL.P, L)]
    )
    x = torch.cat([x, torch.from_numpy(special)])
    got = f.canon(x).numpy()
    for row, c in zip(x.numpy(), got):
        assert PL.limbs_to_int(c) == PL.limbs_to_int(row) % PL.P
        assert c.min() >= 0 and c.max() <= PL.LIMB_MASK
    assert np.array_equal(np.asarray(RL.fq().canon(x.numpy())), got)
    assert bool(f.eq(x[-1:], torch.from_numpy(special[:1])).item())
