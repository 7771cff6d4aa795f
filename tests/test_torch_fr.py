"""The port's Fr products (``hbbft_tpu_torch/ops/fr.py``) against the
reference's ``hbbft_tpu/ops/fr_jax.py`` and Python integers.

- The host conversions equal ``fr_jax``'s on seeded ints, with 0, 1,
  r − 1 and redundant limb values up to 2^264 − 1.
- The plain versions of the reference's device programs
  (``_matmul_limbs``, ``_add_limbs``, ``_reduce_digits``) equal
  ``fr_jax``'s, run jitted on the CPU, byte for byte: at small shapes
  and at the worst case (every limb 255, k = 971).
- ``fr_matmul`` on CPU tensors (the kernel's plain version) equals
  Python's Σ a·b mod r, with and without ``acc``, on ragged shapes, on
  zeros and on the worst cases at k = 971, the bound it takes; k past it
  raises.
- The sampler gives canonical values, the same ones for the same
  generator seed, equal to the reference layout's sampler on the same
  bytes.
- ``csrc/fr_words.cuh`` — the kernel's arithmetic — compiled for the
  host by the C++ compiler, equals Python integers on the same cases,
  its constants equal Python's, and its reduction is exact on the
  largest sums of k = 2^16 terms, far past the wrapper's bound.

Tolerance 0 throughout: all of it is integer arithmetic.
"""

import ctypes
import random
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from hbbft_tpu.ops import fr_jax as FJ
from hbbft_tpu_torch.ops import fr as FR
from hbbft_tpu_torch.ops import kernels

torch.set_num_threads(1)

R = FR.R
MAX256 = (1 << 256) - 1


def _words(vals, *shape):
    """Ints < 2^256 (not reduced) → int32 words shaped ``shape + (8,)``."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return torch.from_numpy(np.frombuffer(raw, dtype="<i4").copy()).reshape(*shape, 8)


def _want(A, B, p, ACC=None):
    m, k = len(A), len(B)
    return [
        ((ACC[i][j] if ACC else 0) + sum(A[i][t] * B[t][j] for t in range(k))) % R
        for i in range(m)
        for j in range(p)
    ]


def _mats(rng, m, k, p, draw):
    A = [[draw(rng) for _ in range(k)] for _ in range(m)]
    B = [[draw(rng) for _ in range(p)] for _ in range(k)]
    ACC = [[draw(rng) for _ in range(p)] for _ in range(m)]
    return A, B, ACC


def _flat(M):
    return [v for row in M for v in row]


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------


def test_conversions_match_reference():
    rng = random.Random(1)
    vals = [0, 1, R - 1, R, R + 5, MAX256] + [rng.randrange(1 << 300) for _ in range(6)]
    assert np.array_equal(FR.fr_to_limbs(vals), FJ.fr_to_limbs(vals))
    redundant = np.frombuffer(
        b"".join(v.to_bytes(33, "little") for v in [(1 << 264) - 1, R, 2 * R + 3, 0]),
        dtype=np.uint8,
    ).reshape(4, 33)
    for limbs in (FR.fr_to_limbs(vals), redundant):
        assert FR.limbs_to_fr(limbs) == FJ.limbs_to_fr(limbs)
        assert np.array_equal(FR.limbs_to_be32(limbs), FJ.limbs_to_be32(limbs))
        assert np.array_equal(
            FR.be32_to_limbs(FR.limbs_to_be32(limbs)), FJ.be32_to_limbs(FJ.limbs_to_be32(limbs))
        )
        # the kernel's layout: canonical words of the same values
        words = FR.limbs_to_words(torch.from_numpy(limbs.copy()))
        assert FR.words_to_fr(words) == FJ.limbs_to_fr(limbs)
        canonical = torch.from_numpy(FR.fr_to_limbs(FR.words_to_fr(words)))
        assert torch.equal(FR.words_to_limbs(words), canonical)
    assert FR.words_to_fr(torch.from_numpy(FR.fr_to_words(vals))) == [v % R for v in vals]


def test_fold_table_matches_reference():
    assert np.array_equal(FR._fold_table(32, 38), FJ._fold_table(32, 38))


# ---------------------------------------------------------------------------
# The reference's device programs, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "m,k,p,fill",
    [(3, 5, 4, None), (1, 7, 6, None), (2, 971, 2, 255)],
    ids=["3x5x4", "1x7x6", "worst-k971"],
)
def test_matmul_limbs_matches_fr_jax(m, k, p, fill):
    rs = np.random.default_rng(k)
    if fill is None:
        a = rs.integers(0, 256, (m, k, 33), dtype=np.uint8)
        b = rs.integers(0, 256, (k, p, 33), dtype=np.uint8)
    else:
        a = np.full((m, k, 33), fill, dtype=np.uint8)
        b = np.full((k, p, 33), fill, dtype=np.uint8)
    want = np.asarray(jax.jit(FJ._matmul_limbs)(a, b))
    got = FR._matmul_limbs(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_add_and_reduce_digits_match_fr_jax():
    rs = np.random.default_rng(7)
    a = rs.integers(0, 256, (5, 33), dtype=np.uint8)
    b = np.full((5, 33), 255, dtype=np.uint8)
    want = np.asarray(jax.jit(FJ._add_limbs)(a, b))
    assert np.array_equal(FR._add_limbs(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)
    # convolution digits up to the int32 peak of k = 971
    digits = rs.integers(0, 255 * 255 * 971 * 33, (4, 65), dtype=np.int32)
    digits[0] = 255 * 255 * 971 * 33
    want = np.asarray(jax.jit(FJ._reduce_digits)(digits))
    assert np.array_equal(FR._reduce_digits(torch.from_numpy(digits)).numpy(), want)


def test_matmul_limbs_contraction_bound():
    a = torch.zeros((1, FR._MAX_K + 1, 33), dtype=torch.uint8)
    b = torch.zeros((FR._MAX_K + 1, 1, 33), dtype=torch.uint8)
    with pytest.raises(ValueError):
        FR._matmul_limbs(a, b)


# ---------------------------------------------------------------------------
# fr_matmul on CPU tensors (the kernel's plain version)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "m,k,p",
    [(7, 5, 13), (1, 9, 4), (4, 1, 3), (3, 0, 2)],
    ids=["7x5x13", "lambda-row", "k1", "k0"],
)
def test_fr_matmul_matches_bigint(m, k, p):
    rng = random.Random(m * 100 + k)
    A, B, ACC = _mats(rng, m, k, p, lambda r: r.randrange(R))
    a, b, acc = _words(_flat(A), m, k), _words(_flat(B), k, p), _words(_flat(ACC), m, p)
    got = FR.fr_matmul(a, b)
    assert got.shape == (m, p, 8) and got.dtype == torch.int32
    assert FR.words_to_fr(got) == _want(A, B, p)
    assert FR.words_to_fr(FR.fr_matmul(a, b, acc)) == _want(A, B, p, ACC)


@pytest.mark.parametrize(
    "k,value,with_acc",
    [(971, R - 1, True), (971, MAX256, True), (971, R - 1, False), (1, MAX256, False), (5, 0, True)],
    ids=["r-1-k971", "max256-k971", "r-1-k971-noacc", "max256-k1", "zeros"],
)
def test_fr_matmul_worst_cases(k, value, with_acc):
    a = _words([value] * k, 1, k)
    b = _words([value] * (2 * k), k, 2)
    acc = _words([value] * 2, 1, 2) if with_acc else None
    want = ((value if with_acc else 0) + k * value * value) % R
    assert FR.words_to_fr(FR.fr_matmul(a, b, acc)) == [want, want]


def test_fr_matmul_bounds_raise():
    a = torch.zeros((1, FR._MAX_K + 1, 8), dtype=torch.int32)
    b = torch.zeros((FR._MAX_K + 1, 1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32-safe"):
        FR.fr_matmul(a, b)
    with pytest.raises(TypeError):
        FR.fr_matmul(torch.zeros((1, 2, 8), dtype=torch.int64), torch.zeros((2, 1, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        FR.fr_matmul(torch.zeros((1, 2, 8), dtype=torch.int32), torch.zeros((3, 1, 8), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def test_sampler_canonical_and_seeded():
    def draw(seed, n=12):
        return FR.words_to_fr(FR.sample_words(torch.Generator().manual_seed(seed), n))

    vals = draw(5)
    assert all(0 <= v < R for v in vals) and len(set(vals)) == len(vals)
    assert draw(5) == vals and draw(6) != vals
    # the same bytes through the reference layout's sampler
    limbs = FR._sample_limbs(torch.Generator().manual_seed(5), (12,))
    assert limbs.shape == (12, 33) and FR.limbs_to_fr(limbs.numpy()) == vals


# ---------------------------------------------------------------------------
# csrc/fr_words.cuh on the host
# ---------------------------------------------------------------------------

HEADER = kernels.CSRC / "fr_words.cuh"
# The header's sums are exact far past the wrapper's k ≤ 971: its carry
# counters hold k < 2^32 terms.  The host build is checked at 2^16, a
# worst case of milliseconds.
HEADROOM_K = 1 << 16

_HARNESS = r"""
#include <cstddef>
#define __constant__
#define __device__
#define __forceinline__ inline
#include "fr_words.cuh"
extern "C" {
// the kernel's per-output loop, one output after another
void h_fr_matmul(const uint32_t* A, const uint32_t* B, const uint32_t* ACC, uint32_t* OUT,
                 int M, int K, int P) {
  for (int m = 0; m < M; ++m)
    for (int p = 0; p < P; ++p) {
      FrSum s;
      fr_sum_init(s, ACC ? ACC + ((size_t)m * P + p) * FR_W : nullptr);
      for (int k = 0; k < K; ++k) {
        uint32_t a[FR_W], b[FR_W];
        for (int i = 0; i < FR_W; ++i) {
          a[i] = A[((size_t)m * K + k) * FR_W + i];
          b[i] = B[((size_t)k * P + p) * FR_W + i];
        }
        fr_sum_mac(s, a, b);
      }
      uint32_t o[FR_W];
      fr_sum_reduce(s, o);
      for (int i = 0; i < FR_W; ++i) OUT[((size_t)m * P + p) * FR_W + i] = o[i];
    }
}
// the reduction of a sum given as its 16 words and 8 carry counters
void h_fr_reduce(const uint32_t* w, const uint32_t* c, uint32_t* out) {
  FrSum s;
  for (int i = 0; i < 16; ++i) s.w[i] = w[i];
  for (int j = 0; j < 8; ++j) s.c[j] = c[j];
  uint32_t o[FR_W];
  fr_sum_reduce(s, o);
  for (int i = 0; i < FR_W; ++i) out[i] = o[i];
}
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the header with")
    d = tmp_path_factory.mktemp("fr_words_host")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "harness.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         "-I", str(kernels.CSRC), "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.h_fr_matmul.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.h_fr_reduce.argtypes = [p, p, p]
    return lib


def _u32(vals, n=8):
    return np.array([(v >> (32 * i)) & 0xFFFFFFFF for v in vals for i in range(n)], dtype=np.uint32)


def _ints(words):
    w = words.reshape(-1, 8)
    return [sum(int(x) << (32 * i) for i, x in enumerate(row)) for row in w]


def _host_matmul(lib, A, B, p, ACC):
    m, k = len(A), len(B)
    a, b = _u32(_flat(A)), _u32(_flat(B))
    acc = None if ACC is None else _u32(_flat(ACC))
    out = np.zeros(m * p * 8, dtype=np.uint32)
    lib.h_fr_matmul(a.ctypes.data, b.ctypes.data, None if acc is None else acc.ctypes.data,
                    out.ctypes.data, m, k, p)
    return _ints(out)


def test_header_constants():
    src = HEADER.read_text()

    def table(name):
        body = re.search(r"\b" + name + r"(?:\[\w*\])+\s*=\s*\{(.*?)\};", src, re.S).group(1)
        return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", body)]

    assert _ints(np.array(table("FR_R"), dtype=np.uint64)) == [R]
    folds = _ints(np.array(table("FR_FOLD"), dtype=np.uint64))
    assert folds == [pow(2, 32 * (8 + j), R) for j in range(9)]
    mu = int(re.search(r"FR_MU\s*=\s*0x([0-9a-f]+)ull", src).group(1), 16)
    assert mu == (1 << 314) // R


@pytest.mark.parametrize(
    "m,k,p,kind",
    [(7, 5, 13, "random"), (1, 33, 9, "random256"), (2, 971, 1, "r-1"), (1, 971, 2, "max256"),
     (1, HEADROOM_K, 1, "r-1"), (1, HEADROOM_K, 1, "max256"), (2, 3, 2, "zero"),
     (2, 0, 3, "random")],
)
def test_host_header_matches_bigint(host_lib, m, k, p, kind):
    rng = random.Random(k * 7 + m)
    draw = {
        "random": lambda r: r.randrange(R),
        "random256": lambda r: r.randrange(1 << 256),
        "r-1": lambda r: R - 1,
        "max256": lambda r: MAX256,
        "zero": lambda r: 0,
    }[kind]
    A, B, ACC = _mats(rng, m, k, p, draw)
    assert _host_matmul(host_lib, A, B, p, ACC) == _want(A, B, p, ACC)
    assert _host_matmul(host_lib, A, B, p, None) == _want(A, B, p)


def test_host_reduction_edges(host_lib):
    """The reduction alone, on sums the multiply-adds can leave (a
    counter grows by at most one a multiply-add, so it stays within
    ``HEADROOM_K`` for k ≤ ``HEADROOM_K``): every word at its maximum with every counter at
    the bound, values just below, at and above multiples of r, and
    random sums."""
    rng = random.Random(0xF00D)
    kmax = HEADROOM_K
    cases = [([0xFFFFFFFF] * 16, [kmax] * 8), ([0] * 16, [0] * 8)]
    for v in [R - 1, R, R + 1, 2 * R - 1, 2 * R, MAX256, (1 << 512) - 1, R * R, R << 288]:
        cases.append(([(v >> (32 * i)) & 0xFFFFFFFF for i in range(16)], [0] * 8))
    for _ in range(200):
        w = [rng.getrandbits(32) for _ in range(16)]
        cases.append((w, [rng.randrange(kmax + 1) for _ in range(8)]))
    for w, c in cases:
        out = np.zeros(8, dtype=np.uint32)
        wa, ca = np.array(w, dtype=np.uint32), np.array(c, dtype=np.uint32)
        host_lib.h_fr_reduce(wa.ctypes.data, ca.ctypes.data, out.ctypes.data)
        total = sum(x << (32 * i) for i, x in enumerate(w)) + sum(x << (32 * (9 + j)) for j, x in enumerate(c))
        assert _ints(out) == [total % R]


def test_plain_matches_host_header(host_lib):
    """The kernel's arithmetic and its plain version on the same random
    256-bit inputs (not reduced): the same canonical words."""
    rng = random.Random(11)
    m, k, p = 3, 17, 5
    A, B, ACC = _mats(rng, m, k, p, lambda r: r.randrange(1 << 256))
    got = FR.fr_matmul(_words(_flat(A), m, k), _words(_flat(B), k, p), _words(_flat(ACC), m, p))
    assert FR.words_to_fr(got) == _host_matmul(host_lib, A, B, p, ACC)
