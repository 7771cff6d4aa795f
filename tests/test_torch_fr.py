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
- The kernel's byte planes (``fr_planes``' plain version), read as the
  kernel's descriptors read them, their u8 product split into the
  tensor cores' accumulator registers, the kernel's sixteen lane
  rotations and the reducers' diagonal sums, emulated in numpy, equal
  Python's (acc + Σ a·b) mod r on random, zero, ragged multi-tile,
  paired-tile and worst-case inputs; every diagonal sum stays below
  2^31 at k = 971 with every byte 0xFF.
- ``csrc/fr_words.cuh`` — the kernel's arithmetic — compiled for the
  host by the C++ compiler, equals Python integers on the same cases
  (the byte products summed by diagonal in 32 bits, as the kernel sums
  them), its positions-to-words conversion on its extremes, its
  constants equal Python's, and its reduction is exact on sums with
  carry counters at 2^16, far past what the conversion leaves.

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
# The kernel's byte-plane arithmetic, emulated (csrc/fr_matmul.cu)
# ---------------------------------------------------------------------------

# The descriptors' strides: wgmma's K-major layout without swizzle reads
# byte (row, k) of a block at (row // 8)·SBO + (k // 16)·LBO + (row % 8)·16
# + k % 16.
_LBO, _SBO = 128, 256


def _read_block(block, rows):
    """One (tile, k-step) block of planes → [rows, 32] as wgmma reads it."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    return block[(r // 8) * _SBO + (k // 16) * _LBO + (r % 8) * 16 + k % 16]


def _registers(C):
    """A tile's [128, 256] product as the two consumer warpgroups hold it:
    [warp 8, lane 32, register 128] (wgmma's m64n256 accumulator layout:
    warp w of warpgroup g holds rows 64g + 16w + lane/4 + {0, 8}, register
    4c + 2h + e column 8c + 2·(lane % 4) + e of row offset 8h)."""
    w = np.arange(8)[:, None, None]
    lane = np.arange(32)[None, :, None]
    i = np.arange(128)[None, None, :]
    row = 64 * (w // 4) + 16 * (w % 4) + lane // 4 + 8 * ((i // 2) % 2)
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return C[row, col]


def _emulate_fr_matmul(a, b, acc):
    """The kernel on the CPU: (acc + a·b) mod r as ints, and the largest
    diagonal sum any step formed."""
    m, k = a.shape[:2]
    p = b.shape[1]
    pa, pb = FR.fr_planes(a, True).numpy(), FR.fr_planes(b, False).numpy()
    assert pa.shape[:2] == (-(-m // 4), max(1, -(-k // 32))) and pb.shape[:2] == (-(-p // 8), pa.shape[1])
    accs = FR.words_to_fr(acc) if acc is not None else [0] * (m * p)
    lane = np.arange(32)
    out, peak = {}, 0
    # m ≤ 2: paired tiles, both warpgroups on A's first 64 plane rows
    # against B tiles 2t and 2t + 1 (the second may lie past p)
    pair = m <= 2
    nbt = pb.shape[0]
    for mt in range(pa.shape[0]):
        for nt in range(-(-nbt // 2) if pair else nbt):
            A = np.concatenate([_read_block(pa[mt, s], 128) for s in range(pa.shape[1])], axis=1)

            def b_tile(bt):
                if bt >= nbt:
                    return np.zeros((256, A.shape[1]), dtype=np.uint8)
                return np.concatenate([_read_block(pb[bt, s], 256) for s in range(pb.shape[1])],
                                      axis=1)

            if pair:
                C = np.concatenate([A[:64].astype(np.int64) @ b_tile(2 * nt + w).astype(np.int64).T
                                    for w in (0, 1)], axis=0)
            else:
                C = A.astype(np.int64) @ b_tile(nt).astype(np.int64).T
            d = _registers(C)
            peak = max(peak, int(d.max()))
            S = np.zeros((2, 64, 32), dtype=np.int64)  # [u][position][output]
            for w in range(8):
                i4, u = 2 * (w // 4) + (w % 4 >> 1), w & 1
                for j in range(8):
                    every = np.zeros(32, dtype=np.int64)
                    hi = np.zeros(32, dtype=np.int64)
                    for v in range(16):
                        delta = 8 * (v >> 2) + 2 * ((v >> 1) & 1) + 4 * (v & 1)
                        x = d[w, (lane - delta) & 31, 16 * j + v]
                        every += x
                        hi += np.where(lane < delta, x, 0)
                    assert not hi[30:].any()
                    S[u, lane + u, i4 * 8 + j] = every - hi
                    S[u, lane[:30] + 32 + u, i4 * 8 + j] = hi[:30]
            peak = max(peak, int(S.max()))
            pos = np.zeros((64, 32), dtype=np.int64)
            pos[:62] += S[0, :62]
            pos[1:63] += S[1, 1:63]
            peak = max(peak, int(pos.max()))
            for o in range(32):
                wg, i = o >> 4, (o >> 3) & 1
                i = mt * 4 + (i if pair else 2 * wg + i)
                j = ((2 * nt + wg) if pair else nt) * 8 + (o & 7)
                if i < m and j < p:
                    total = accs[i * p + j] + sum(int(v) << (8 * q) for q, v in enumerate(pos[:, o]))
                    out[i * p + j] = total % R
    return [out[x] for x in range(m * p)], peak


@pytest.mark.parametrize(
    "m,k,p,kind",
    [(7, 5, 13, "random"), (5, 40, 17, "random256"), (1, 2, 9, "random"), (3, 33, 8, "zero"),
     (4, 0, 3, "random"), (2, 33, 25, "random256"), (1, 3, 8, "random")],
    ids=["7x5x13", "multi-tile", "sampler-shape", "zeros", "k0", "paired", "paired-one-tile"],
)
def test_kernel_arithmetic_emulated(m, k, p, kind):
    rng = random.Random(m * 1000 + k * 10 + p)
    draw = {"random": lambda r: r.randrange(R), "random256": lambda r: r.randrange(1 << 256),
            "zero": lambda r: 0}[kind]
    A, B, ACC = _mats(rng, m, k, p, draw)
    a, b, acc = _words(_flat(A), m, k), _words(_flat(B), k, p), _words(_flat(ACC), m, p)
    assert _emulate_fr_matmul(a, b, acc)[0] == _want(A, B, p, ACC)
    assert _emulate_fr_matmul(a, b, None)[0] == _want(A, B, p)


def test_kernel_arithmetic_worst_case_k971():
    """Every byte 0xFF at the wrapper's bound: exact, and every diagonal
    sum below 2^31 (the s32 accumulators' and the header's bound)."""
    k = FR._MAX_K
    a, b = _words([MAX256] * k, 1, k), _words([MAX256] * (2 * k), k, 2)
    acc = _words([MAX256] * 2, 1, 2)
    got, peak = _emulate_fr_matmul(a, b, acc)
    assert got == [(MAX256 + k * MAX256 * MAX256) % R] * 2
    assert peak == 32 * 255 * 255 * k < 1 << 31


def test_planes_layout():
    """Plane bytes land where the kernel's tile math expects them: A's byte
    x = 4g + 2h + u at plane row 16u + 8h + g, B's byte y = t + 8c + 4e
    at plane row 8c + 2t + e, zero past the edges."""
    m, k, p = 5, 37, 11
    rng = random.Random(3)
    a = _words([rng.randrange(1 << 256) for _ in range(m * k)], m, k)
    b = _words([rng.randrange(1 << 256) for _ in range(k * p)], k, p)
    ab, bb = a.view(torch.uint8).numpy(), b.view(torch.uint8).numpy()
    pa, pb = FR.fr_planes(a, True).numpy(), FR.fr_planes(b, False).numpy()
    assert pa.shape == (2, 2, 4096) and pb.shape == (2, 2, 8192)
    for i, kk, x in [(0, 0, 0), (4, 36, 31), (3, 17, 9), (1, 32, 16)]:
        row = 32 * (i % 4) + 16 * (x & 1) + 8 * ((x >> 1) & 1) + (x >> 2)
        assert _read_block(pa[i // 4, kk // 32], 128)[row, kk % 32] == ab[i, kk, x]
    for kk, j, y in [(0, 0, 0), (36, 10, 31), (20, 3, 13)]:
        t, e, c = y & 3, (y >> 2) & 1, y >> 3
        row = 32 * (j % 8) + 8 * c + 2 * t + e
        assert _read_block(pb[j // 8, kk // 32], 256)[row, kk % 32] == bb[kk, j, y]
    assert not _read_block(pa[1, 1], 128)[32:].any()  # rows past m
    assert not _read_block(pa[0, 1], 128)[:, 5:].any()  # k past 37
    assert not _read_block(pb[1, 0], 256)[96:].any()  # columns past p


def test_fr_walls_split_patches_apply():
    """scripts/torch_fr_walls.py's --split variants patch copies of
    csrc/fr_matmul.cu by text: every anchor must be in the source once."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_fr_walls", kernels.PKG_DIR.parent / "scripts" / "torch_fr_walls.py")
    walls = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(walls)
    src = (kernels.CSRC / "fr_matmul.cu").read_text()
    for label, patches in walls.VARIANTS.items():
        for old, _ in patches:
            assert src.count(old) == 1, (label, old)


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
# The header's reduction takes sums with carry counters; the host build
# checks it with every counter at 2^16, far past the one word the
# positions conversion leaves there.
HEADROOM_K = 1 << 16
# The largest k whose diagonal sums, at most 32·255²·k, stay below 2^31:
# the header's own bound, past the wrapper's k ≤ 971.
POSITIONS_K = (1 << 31) // (32 * 255 * 255)

_HARNESS = r"""
#include <cstddef>
#define __constant__
#define __device__
#define __forceinline__ inline
#include "fr_words.cuh"
extern "C" {
// the kernel's arithmetic, one output after another: the byte products of
// the planes summed by diagonal in 32 bits, then the 17 words and the
// reduction
void h_fr_matmul(const uint32_t* A, const uint32_t* B, const uint32_t* ACC, uint32_t* OUT,
                 int M, int K, int P) {
  for (int m = 0; m < M; ++m)
    for (int p = 0; p < P; ++p) {
      uint32_t S[FR_POS] = {0};
      for (int k = 0; k < K; ++k) {
        const uint8_t* a = (const uint8_t*)(A + ((size_t)m * K + k) * FR_W);
        const uint8_t* b = (const uint8_t*)(B + ((size_t)k * P + p) * FR_W);
        for (int x = 0; x < 32; ++x)
          for (int y = 0; y < 32; ++y) S[x + y] += (uint32_t)a[x] * b[y];
      }
      FrSum s;
      fr_sum_positions(s, S, ACC ? ACC + ((size_t)m * P + p) * FR_W : nullptr);
      uint32_t o[FR_W];
      fr_sum_reduce(s, o);
      for (int i = 0; i < FR_W; ++i) OUT[((size_t)m * P + p) * FR_W + i] = o[i];
    }
}
// the positions conversion and the reduction of one output
void h_fr_positions(const uint32_t* S, const uint32_t* acc, uint32_t* out) {
  uint32_t pos[FR_POS];
  for (int q = 0; q < FR_POS; ++q) pos[q] = S[q];
  FrSum s;
  fr_sum_positions(s, pos, acc);
  uint32_t o[FR_W];
  fr_sum_reduce(s, o);
  for (int i = 0; i < FR_W; ++i) out[i] = o[i];
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
    lib.h_fr_positions.argtypes = [p, p, p]
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
     (1, POSITIONS_K, 1, "r-1"), (1, POSITIONS_K, 1, "max256"), (2, 3, 2, "zero"),
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
    """The reduction alone, on sums with carry counters up to
    ``HEADROOM_K`` (the positions conversion leaves one, word 16, below
    2^10): every word at its maximum with every counter at the bound,
    values just below, at and above multiples of r, and random sums."""
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


@pytest.mark.parametrize(
    "kind,with_acc",
    [("max-k971", True), ("max-k971", False), ("random", True), ("zero", True), ("zero", False)],
    ids=["max-k971-acc", "max-k971", "random-acc", "zero-acc", "zeros"],
)
def test_host_positions_to_words(host_lib, kind, with_acc):
    """``fr_sum_positions`` and ``fr_sum_reduce`` against Python on the
    positions' extremes: the diagonal sums of every byte 0xFF at k = 971
    (the largest the kernel forms), random sums below 2^31, zeros; acc
    2^256 − 1 (every acc word at its maximum) or none."""
    k = FR._MAX_K
    if kind == "max-k971":
        S = [min(q + 1, 63 - q) * 255 * 255 * k if q < 63 else 0 for q in range(64)]
        assert max(S) < 1 << 31
    elif kind == "random":
        rng = random.Random(0x505)
        S = [rng.randrange(1 << 31) for _ in range(64)]
    else:
        S = [0] * 64
    acc = MAX256 if with_acc else 0
    sa = np.array(S, dtype=np.uint32)
    aa = _u32([acc]) if with_acc else None
    out = np.zeros(8, dtype=np.uint32)
    host_lib.h_fr_positions(sa.ctypes.data, None if aa is None else aa.ctypes.data, out.ctypes.data)
    assert _ints(out) == [(acc + sum(v << (8 * q) for q, v in enumerate(S))) % R]


def test_plain_matches_host_header(host_lib):
    """The kernel's arithmetic and its plain version on the same random
    256-bit inputs (not reduced): the same canonical words."""
    rng = random.Random(11)
    m, k, p = 3, 17, 5
    A, B, ACC = _mats(rng, m, k, p, lambda r: r.randrange(1 << 256))
    got = FR.fr_matmul(_words(_flat(A), m, k), _words(_flat(B), k, p), _words(_flat(ACC), m, p))
    assert FR.words_to_fr(got) == _host_matmul(host_lib, A, B, p, ACC)
