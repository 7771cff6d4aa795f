"""The Montgomery field of the scalar-mul kernels (``csrc/bls_mont.cuh``).

The kernels run only on the card, so their arithmetic is held here in
three ways, each in seconds on the CPU:

1. the header's constants (p's words, −p⁻¹ mod 2^32, R mod p, R² mod p,
   the entry bias and the entry table 2^(11i)·R² mod p) against Python
   integers;
2. a word-level Python model of the header's routines — 32-bit words,
   explicit carries, the same steps — that asserts every intermediate
   fits the width the header gives it (the overflow argument, made
   executable), checked with hypothesis and fixed edge cases against
   ``a·b·R⁻¹ mod p`` and friends, over the whole entry domain (every
   limb in [−2^12, 2^12], negative values included);
3. the header itself, compiled for the host by the C++ compiler (the
   CUDA qualifiers defined away, and ``win_g2``'s lane pair run as two
   coroutines that meet at every shuffle), running the ladders of
   ``win_g1``, ``win_g2`` and ``scan_g1`` against the plain PyTorch
   versions at canonical values, its field routines against the model
   word for word, and its square and doubling against its product and
   complete addition.
"""

import ctypes
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from hbbft_tpu_torch.crypto import curve as PC, fields as F
from hbbft_tpu_torch.ops import cuda_ec, ec as PE, kernels, limbs as PL

torch.set_num_threads(1)

P = PL.P
NW = 12
R = 1 << 384
W = 1 << 32
MASK32 = W - 1
LIMBS = 38
HEADER = kernels.CSRC / "bls_mont.cuh"


# ---------------------------------------------------------------------------
# 1. the header's constants
# ---------------------------------------------------------------------------


def _header_table(name: str) -> np.ndarray:
    src = HEADER.read_text()
    body = re.search(r"\b" + name + r"(?:\[\w*\])+\s*=\s*\{(.*?)\};", src, re.S).group(1)
    return np.array([int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", body)], dtype=np.uint64)


def _header_scalar(name: str) -> int:
    m = re.search(r"\b" + name + r"\s*=\s*([^;]+);", HEADER.read_text())
    expr = m.group(1).strip()
    if expr.startswith("0x"):
        return int(expr.rstrip("u"), 16)
    a, b = re.fullmatch(r"(\d+)\s*<<\s*(\d+)", expr).groups()
    return int(a) << int(b)


def _words(x: int, n: int = NW):
    return [(x >> (32 * i)) & MASK32 for i in range(n)]


def _int(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


PINV = _header_scalar("PINV")
ENTRY_BIAS = _header_scalar("ENTRY_BIAS")
P_W = [int(w) for w in _header_table("P_W")]
ONE_W = [int(w) for w in _header_table("ONE_W")]
BIAS_W = [int(w) for w in _header_table("BIAS_W")]
TO_MONT = _header_table("TO_MONT").reshape(LIMBS, NW)


def test_header_constants_match_field():
    assert _int(P_W) == P
    assert (PINV * P) % W == W - 1  # −p⁻¹ mod 2^32
    assert _int(ONE_W) == R % P
    assert _int(_header_table("R2_W")) == R * R % P
    assert ENTRY_BIAS == 1 << 12
    c0 = ENTRY_BIAS * sum(1 << (11 * i) for i in range(LIMBS))
    assert _int(BIAS_W) == c0 * R % P
    for i in range(LIMBS):
        assert _int(TO_MONT[i]) == (1 << (11 * i)) * R * R % P, i
    # the no-carry CIOS form needs p's top word below (2^32 − 1)/2 − 1
    assert P_W[-1] < (W - 1) // 2 - 1


def test_windowed_sources_include_the_header():
    """All three scalar-mul kernels include the Montgomery header, the
    only Fq field header: the limb field's bls_fq.cuh is gone.  The other
    headers are fr_matmul's Fr arithmetic, which only it includes, the
    SHA-256 compression of sha256 and merkle_forest, and the wgmma pieces
    of fr_matmul and gf_matmul; none of those kernels includes the field."""
    for name in ("win_g1", "win_g2", "scan_g1"):
        src = kernels.SOURCES[name].read_text()
        assert '#include "bls_mont.cuh"' in src and "bls_fq.cuh" not in src, name
        assert "fr_words.cuh" not in src, name
    assert sorted(p.name for p in kernels.CSRC.glob("*.cuh")) == [
        "bls_mont.cuh", "fr_words.cuh", "sha256.cuh", "wgmma_u8.cuh"]
    fr_src = kernels.SOURCES["fr_matmul"].read_text()
    assert '#include "fr_words.cuh"' in fr_src and "bls_mont.cuh" not in fr_src
    for name in ("sha256", "merkle", "gf_matmul"):
        assert "bls_mont.cuh" not in kernels.SOURCES[name].read_text(), name
    assert "scan_ladder" in kernels.SOURCES["scan_g1"].read_text()


# ---------------------------------------------------------------------------
# 2. the word-level model
# ---------------------------------------------------------------------------


def _u64(x: int) -> int:
    assert 0 <= x < 1 << 64, "uint64 overflow"
    return x


def m_reduce_once(s):
    """fe_reduce_once: s < 2p → s mod p."""
    assert _int(s) < 2 * P
    d, br = [], 0
    for i in range(NW):
        t = s[i] - P_W[i] + br
        assert -(1 << 33) < t < 1 << 32  # fits int64; >> 32 is 0 or −1
        d.append(t & MASK32)
        br = t >> 32
    return list(s) if br else d


def m_add(a, b):
    s, c = [], 0
    for i in range(NW):
        c = _u64(c + a[i] + b[i])
        s.append(c & MASK32)
        c >>= 32
    assert c == 0  # a + b < 2p < 2^382
    return m_reduce_once(s)


def m_sub(a, b):
    d, br = [], 0
    for i in range(NW):
        t = a[i] - b[i] + br
        d.append(t & MASK32)
        br = t >> 32
    mask = MASK32 if br else 0
    r, c = [], 0
    for i in range(NW):
        c = _u64(c + d[i] + (P_W[i] & mask))
        r.append(c & MASK32)
        c >>= 32
    return r


def m_mul(a, b):
    """fe_mul: CIOS, no-carry form."""
    assert _int(a) < P and _int(b) < P
    t = [0] * NW
    for i in range(NW):
        bi = b[i]
        x = _u64(a[0] * bi + t[0])
        c = x >> 32
        t0 = x & MASK32
        m = (t0 * PINV) & MASK32
        y = _u64(m * P_W[0] + t0)
        assert y & MASK32 == 0
        c2 = y >> 32
        for j in range(1, NW):
            x = _u64(a[j] * bi + t[j] + c)
            c = x >> 32
            y = _u64(m * P_W[j] + (x & MASK32) + c2)
            c2 = y >> 32
            t[j - 1] = y & MASK32
        assert c + c2 < W  # the top word takes the two carries
        t[NW - 1] = c + c2
    return m_reduce_once(t)


def m_sqr(a):
    """fe_sqr: fe_mul's rows, row i adding a_i² and a_i times the words of
    2a above word i (the word just above i doubled without a_i's top
    bit), then one word of reduction; t stays below 4p."""
    assert _int(a) < P
    d = [((a[j] << 1) | (a[j - 1] >> 31 if j else 0)) & MASK32 for j in range(NW)]
    assert _int(d) == 2 * _int(a)  # 2a fits 12 words
    t = [0] * NW
    for i in range(NW):
        x = _u64(a[i] * a[i] + t[i])
        t[i] = x & MASK32
        c = x >> 32
        for j in range(i + 1, NW):
            e = (a[j] << 1) & MASK32 if j == i + 1 else d[j]
            x = _u64(a[i] * e + t[j] + c)
            t[j] = x & MASK32
            c = x >> 32
        m = (t[0] * PINV) & MASK32
        y = _u64(m * P_W[0] + t[0])
        assert y & MASK32 == 0
        c2 = y >> 32
        for j in range(1, NW):
            y = _u64(m * P_W[j] + t[j] + c2)
            t[j - 1] = y & MASK32
            c2 = y >> 32
        assert c + c2 < W  # the top word takes the two carries
        t[NW - 1] = c + c2
        assert _int(t) < 4 * P
    assert _int(t) < 2 * P
    return m_reduce_once(t)


def m_redc13(s):
    """fe_redc13: 13 words, value < p·R → value·R⁻¹ mod p."""
    assert len(s) == NW + 1 and _int(s) < P * R
    t = list(s)
    for i in range(NW):
        m = (t[0] * PINV) & MASK32
        y = _u64(m * P_W[0] + t[0])
        c = y >> 32
        for j in range(1, NW):
            y = _u64(m * P_W[j] + t[j] + c)
            t[j - 1] = y & MASK32
            c = y >> 32
        y = _u64(t[NW] + c)
        t[NW - 1] = y & MASK32
        t[NW] = y >> 32
    assert t[NW] == 0
    return m_reduce_once(t[:NW])


def m_from_limbs(limbs):
    """fe_from_limbs: 38 limbs in [−2^12, 2^12] → v·R mod p."""
    assert len(limbs) == LIMBS
    col = [0] * NW
    for i in range(LIMBS):
        assert -ENTRY_BIAS <= limbs[i] <= ENTRY_BIAS, "outside the entry domain"
        l = limbs[i] + ENTRY_BIAS
        for j in range(NW):
            col[j] = _u64(col[j] + l * int(TO_MONT[i][j]))
    assert max(col) < 1 << 51
    s, c = [], 0
    for j in range(NW):
        c = _u64(c + col[j])
        s.append(c & MASK32)
        c >>= 32
    s.append(c)
    assert _int(s) < 1 << 400
    return m_sub(m_redc13(s), BIAS_W)


def m_to_limbs(x):
    """fe_to_limbs: x·R⁻¹ mod p as 38 limbs of 11 bits."""
    v = _int(m_redc13(list(x) + [0]))
    assert v < P
    return [(v >> (11 * i)) & 0x7FF for i in range(LIMBS)]


def m_mul12(a):
    a2 = m_add(a, a)
    a4 = m_add(a2, a2)
    return m_add(m_add(a4, a4), a4)


def mont(v: int):
    return _words(v * R % P)


def val(words) -> int:
    return _int(words) * pow(R, -1, P) % P


field = st.integers(min_value=0, max_value=P - 1)
EDGES = [0, 1, 2, P - 1, P - 2, R % P, (R * R) % P, (1 << 381) % P, P // 2]


@settings(max_examples=150, deadline=None)
@given(field, field)
def test_model_mul_add_sub(a, b):
    ma, mb = mont(a), mont(b)
    assert _int(m_mul(ma, mb)) == a * b % P * R % P
    assert _int(m_mul(_words(a), _words(b))) == a * b * pow(R, -1, P) % P
    assert _int(m_add(ma, mb)) == (a + b) % P * R % P
    assert _int(m_sub(ma, mb)) == (a - b) % P * R % P
    assert val(m_mul12(ma)) == 12 * a % P


# the squaring's edges beside EDGES: top words at their extremes
SQR_EDGES = EDGES + [
    (1 << 352) - 1,  # top word 0, every other word all ones
    (P_W[-1] << 352) - 1,  # top word one below p's, the rest all ones
    P - (1 << 352),  # p's top word minus one, p's other words
    (P_W[-1] << 352) + 1,  # p's top word, all but the lowest bit of the rest 0
]


@settings(max_examples=150, deadline=None)
@given(field)
def test_model_sqr_is_the_product_by_itself(a):
    assert m_sqr(_words(a)) == m_mul(_words(a), _words(a))
    assert m_sqr(mont(a)) == mont(a * a % P)


@pytest.mark.parametrize("a", SQR_EDGES)
def test_model_sqr_edges(a):
    assert a < P
    assert m_sqr(_words(a)) == m_mul(_words(a), _words(a))
    assert _int(m_sqr(_words(a))) == a * a * pow(R, -1, P) % P


@pytest.mark.parametrize("a", EDGES)
@pytest.mark.parametrize("b", EDGES)
def test_model_edges(a, b):
    assert _int(m_mul(_words(a), _words(b))) == a * b * pow(R, -1, P) % P
    assert _int(m_add(_words(a), _words(b))) == (a + b) % P
    assert _int(m_sub(_words(a), _words(b))) == (a - b) % P


def _limbs_of(v: int):
    return [(v >> (11 * i)) & 0x7FF for i in range(LIMBS)]


def _entry_cases():
    rng = random.Random(11)
    top = (1 << 408) - 1
    cases = {
        "zero": [0] * LIMBS,
        "one": _limbs_of(1),
        "p-1": _limbs_of(P - 1),
        "p": _limbs_of(P),
        "near 2^408": _limbs_of(top - rng.randrange(P)),
        "2^408 - 1": _limbs_of(top),
        "all 2^12 - 1": [4095] * LIMBS,
        "all 2^12": [4096] * LIMBS,
        "all -2^12": [-4096] * LIMBS,
        "all -(2^12 - 1)": [-4095] * LIMBS,
        "alternating": [4095 if i % 2 else -4095 for i in range(LIMBS)],
    }
    for n in range(6):
        cases[f"random {n}"] = [rng.randrange(-4096, 4097) for _ in range(LIMBS)]
    return cases


@pytest.mark.parametrize("name,limbs", list(_entry_cases().items()))
def test_model_conversions_on_entry_domain(name, limbs):
    v = PL.limbs_to_int(np.array(limbs, dtype=np.int64))  # may be negative
    x = m_from_limbs(limbs)
    assert _int(x) == v % P * R % P, name
    out = m_to_limbs(x)
    assert PL.limbs_to_int(np.array(out)) == v % P
    assert all(0 <= l < 2048 for l in out) and out[-1] == 0


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(min_value=-4096, max_value=4096), min_size=LIMBS, max_size=LIMBS))
def test_model_entry_conversion_any_limbs(limbs):
    v = PL.limbs_to_int(np.array(limbs, dtype=np.int64))
    assert _int(m_from_limbs(limbs)) == v % P * R % P


@settings(max_examples=40, deadline=None)
@given(field, field)
def test_canonical_output_passes_through_modfield(a, b):
    """The exit conversion's limbs keep ModField's invariant: its add
    and mul take them unchanged in value."""
    f = PL.fq()
    la = torch.tensor(m_to_limbs(mont(a)), dtype=torch.int32)
    lb = torch.tensor(m_to_limbs(mont(b)), dtype=torch.int32)
    assert f.from_limbs(la.numpy()) == a and f.from_limbs(lb.numpy()) == b
    assert torch.equal(f.canon(la), la)
    assert f.from_limbs(f.add(la, lb).numpy()) == (a + b) % P
    assert f.from_limbs(f.mul(la, lb).numpy()) == a * b % P
    assert f.from_limbs(f.sub(la, lb).numpy()) == (a - b) % P


# ---------------------------------------------------------------------------
# 3. the header compiled for the host
# ---------------------------------------------------------------------------

_HARNESS = r"""
#include <cstdint>
#include <ucontext.h>
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__ static
// The two lanes of win_g2's pair run as coroutines that meet at every
// shuffle, as a warp's lanes do: a lane posts its word, switches to its
// partner, and on its return reads the partner's word of the same
// shuffle (two slots by parity, so a lane never overwrites a word its
// partner has yet to read).
struct Dim { unsigned x; };
static Dim threadIdx;
static ucontext_t lane_ctx[2], main_ctx;
static uint32_t slot[2][2];
static unsigned shuffles[2];
static uint32_t __shfl_xor_sync(unsigned, uint32_t v, int) {
  const unsigned me = threadIdx.x & 1, g = shuffles[me]++ & 1;
  slot[g][me] = v;
  swapcontext(&lane_ctx[me], &lane_ctx[me ^ 1]);
  threadIdx.x = me;
  return slot[g][me ^ 1];
}
#include "bls_mont.cuh"
static const int32_t* g2_src;
static const int32_t* g2_dig;
static int32_t* g2_dst;
static int g2_nwin;
static void g2_lane(int lane) {
  threadIdx.x = lane;
  const Pt<Fq2Lane> acc = windowed_ladder<Fq2Lane>(g2_src, g2_dig, g2_nwin);
  pt_store<Fq2Lane>(acc, g2_dst);
}
extern "C" {
static Fe in(const uint32_t* a) { Fe r; for (int i = 0; i < NW; ++i) r.w[i] = a[i]; return r; }
static void out(const Fe& r, uint32_t* o) { for (int i = 0; i < NW; ++i) o[i] = r.w[i]; }
void h_mul(const uint32_t* a, const uint32_t* b, uint32_t* o) { out(fe_mul(in(a), in(b)), o); }
void h_sqr(const uint32_t* a, uint32_t* o) { out(fe_sqr(in(a)), o); }
void h_add(const uint32_t* a, const uint32_t* b, uint32_t* o) { out(fe_add(in(a), in(b)), o); }
void h_sub(const uint32_t* a, const uint32_t* b, uint32_t* o) { out(fe_sub(in(a), in(b)), o); }
void h_from_limbs(const int32_t* l, uint32_t* o) { out(fe_from_limbs(l), o); }
void h_to_limbs(const uint32_t* a, int32_t* l) { fe_to_limbs(in(a), l); }
void h_ladder_g1(const int32_t* pts, const int32_t* dig, int32_t* o, int K, int nwin) {
  for (int k = 0; k < K; ++k)
    pt_store<FqM>(windowed_ladder<FqM>(pts + k * 3 * L, dig + k * nwin, nwin), o + k * 3 * L);
}
// one lane pair a point: lane 0 runs first; when it ends its context
// resumes lane 1's, and lane 1's end returns here
void h_ladder_g2(const int32_t* pts, const int32_t* dig, int32_t* o, int K, int nwin) {
  static char stacks[2][1 << 18];
  for (int k = 0; k < K; ++k) {
    g2_src = pts + k * 6 * L;
    g2_dig = dig + k * nwin;
    g2_dst = o + k * 6 * L;
    g2_nwin = nwin;
    shuffles[0] = shuffles[1] = 0;
    for (int h = 0; h < 2; ++h) {
      getcontext(&lane_ctx[h]);
      lane_ctx[h].uc_stack.ss_sp = stacks[h];
      lane_ctx[h].uc_stack.ss_size = sizeof stacks[h];
      lane_ctx[h].uc_link = h == 0 ? &lane_ctx[1] : &main_ctx;
      makecontext(&lane_ctx[h], (void (*)())g2_lane, 1, h);
    }
    swapcontext(&main_ctx, &lane_ctx[0]);
  }
}
int h_lane_shuffles() { return (int)(shuffles[0] == shuffles[1] ? shuffles[0] : -1); }
// points as 3 × 12 Montgomery words
static Pt<FqM> pt_in(const uint32_t* a) { return {in(a), in(a + NW), in(a + 2 * NW)}; }
static void pt_out(const Pt<FqM>& p, uint32_t* o) {
  out(p.x, o); out(p.y, o + NW); out(p.z, o + 2 * NW);
}
void h_point_add(const uint32_t* p, const uint32_t* q, uint32_t* o) {
  pt_out(point_add<FqM>(pt_in(p), pt_in(q)), o);
}
void h_point_dbl(const uint32_t* p, uint32_t* o) { pt_out(point_dbl<FqM>(pt_in(p)), o); }
// scan_g1's ladder, one row after another
void h_scan_g1(const int32_t* pts, const int32_t* bits, int32_t* o, int K, int nbits) {
  for (int k = 0; k < K; ++k)
    pt_store<FqM>(scan_ladder<FqM>(pt_load<FqM>(pts + k * 3 * L), bits + k * nbits, nbits),
                  o + k * 3 * L);
}
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the header with")
    d = tmp_path_factory.mktemp("bls_mont_host")
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
    for fn in ("h_mul", "h_add", "h_sub"):
        getattr(lib, fn).argtypes = [p, p, p]
    lib.h_sqr.argtypes = [p, p]
    lib.h_point_add.argtypes = [p, p, p]
    lib.h_point_dbl.argtypes = [p, p]
    lib.h_scan_g1.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int]
    lib.h_from_limbs.argtypes = [p, p]
    lib.h_to_limbs.argtypes = [p, p]
    for fn in ("h_ladder_g1", "h_ladder_g2"):
        getattr(lib, fn).argtypes = [p, p, p, ctypes.c_int, ctypes.c_int]
    lib.h_lane_shuffles.restype = ctypes.c_int
    return lib


def _call(fn, *args, out_dtype=np.uint32, n=NW):
    arrs = [np.ascontiguousarray(a) for a in args]
    out = np.zeros(n, dtype=out_dtype)
    fn(*[a.ctypes.data for a in arrs], out.ctypes.data)
    return out


@settings(max_examples=100, deadline=None)
@given(field, field, st.lists(st.integers(-4096, 4096), min_size=LIMBS, max_size=LIMBS))
def test_host_build_matches_model(host_lib, a, b, limbs):
    wa = np.array(_words(a), dtype=np.uint32)
    wb = np.array(_words(b), dtype=np.uint32)
    assert list(_call(host_lib.h_mul, wa, wb)) == m_mul(_words(a), _words(b))
    assert list(_call(host_lib.h_add, wa, wb)) == m_add(_words(a), _words(b))
    assert list(_call(host_lib.h_sub, wa, wb)) == m_sub(_words(a), _words(b))
    got = _call(host_lib.h_from_limbs, np.array(limbs, dtype=np.int32))
    assert list(got) == m_from_limbs(limbs)
    assert list(_call(host_lib.h_to_limbs, wa, out_dtype=np.int32, n=LIMBS)) == m_to_limbs(
        _words(a)
    )


def _run_ladder(fn, pts: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    pts, digits = pts.contiguous(), digits.contiguous()
    out = torch.empty_like(pts)
    fn(pts.data_ptr(), digits.data_ptr(), out.data_ptr(), pts.shape[0], digits.shape[1])
    return out


def _borrowed(limbs: torch.Tensor) -> torch.Tensor:
    """The same values with +2048 on limb i and −1 on limb i + 1 (limbs
    in [−1, 4094], the top limb −1)."""
    shift = torch.full((LIMBS,), 2047, dtype=torch.int32)
    shift[0], shift[-1] = 2048, -1
    return limbs + shift


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_host_ladder_matches_plain_at_canonical_values(host_lib, group):
    """The header's ladder (the kernels' code) against ``windowed_plain``
    / ``windowed_g2_plain``: canonical limbs out, equal to the plain
    version's canonical residues, on an identity row, a zero scalar,
    digits outside 0..15 and borrowed (negative-limb) inputs; in-range
    rows are k·P on the host curve."""
    rng = random.Random(0x3047)
    if group == "g1":
        gen, inf, to_limbs, from_limbs = PC.G1_GEN, PC.G1.infinity(), PE.g1_to_limbs, PE.g1_from_limbs
        fn, plain, bits = host_lib.h_ladder_g1, cuda_ec.windowed_plain, 255
    else:
        gen, inf, to_limbs, from_limbs = PC.G2_GEN, PC.G2.infinity(), PE.g2_to_limbs, PE.g2_from_limbs
        fn, plain, bits = host_lib.h_ladder_g2, cuda_ec.windowed_g2_plain, 64
    pts = [gen * rng.randrange(1, F.R) for _ in range(5)] + [inf]
    ks = [rng.randrange(0, 1 << bits) % F.R for _ in pts]
    ks[2] = 0
    limbs = torch.from_numpy(to_limbs(pts))
    limbs[1] = _borrowed(limbs[1])
    digits = torch.from_numpy(cuda_ec.bits_to_digits(PL.scalars_to_bits(ks, bits)).astype(np.int32))
    digits[3, 0], digits[4, -1] = 16, -7  # select the identity
    got = _run_ladder(fn, limbs, digits)
    f = PL.fq()
    assert torch.equal(f.canon(got), got)
    assert torch.equal(got, f.canon(plain(limbs, digits)))
    for i in (0, 1, 2, 5):
        assert from_limbs(got[i]) == pts[i] * ks[i], i


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_host_ladder_with_no_windows_is_the_identity(host_lib, group):
    if group == "g1":
        gen, to_limbs, from_limbs = PC.G1_GEN, PE.g1_to_limbs, PE.g1_from_limbs
        fn, plain = host_lib.h_ladder_g1, cuda_ec.windowed_plain
    else:
        gen, to_limbs, from_limbs = PC.G2_GEN, PE.g2_to_limbs, PE.g2_from_limbs
        fn, plain = host_lib.h_ladder_g2, cuda_ec.windowed_g2_plain
    pts = torch.from_numpy(to_limbs([gen * 5]))
    got = _run_ladder(fn, pts, torch.zeros((1, 0), dtype=torch.int32))
    assert from_limbs(got[0]).is_infinity()
    assert torch.equal(got, plain(pts, torch.zeros((1, 0), dtype=torch.int32)))
    if group == "g2":
        # the lanes met at every shuffle: 14 table adds of 12 products
        # (2 exchanges of 12 words each) and 2 mul_b3 (one exchange each)
        assert host_lib.h_lane_shuffles() == 14 * (12 * 2 + 2) * 12


@settings(max_examples=100, deadline=None)
@given(field)
def test_host_sqr_matches_mul_and_model(host_lib, a):
    wa = np.array(_words(a), dtype=np.uint32)
    got = list(_call(host_lib.h_sqr, wa))
    assert got == list(_call(host_lib.h_mul, wa, wa))
    assert got == m_sqr(_words(a))


@pytest.mark.parametrize("a", SQR_EDGES)
def test_host_sqr_edges(host_lib, a):
    wa = np.array(_words(a), dtype=np.uint32)
    assert list(_call(host_lib.h_sqr, wa)) == list(_call(host_lib.h_mul, wa, wa))


def _mont_point(x: int, y: int, z: int) -> np.ndarray:
    return np.array(mont(x) + mont(y) + mont(z), dtype=np.uint32)


def test_host_point_dbl_is_point_add_to_itself(host_lib):
    """point_dbl(p) equals point_add(p, p) word for word: on curve points,
    the identity, a point with Z = 0 and X ≠ 0, and arbitrary triples
    (the formulas run on any field elements)."""
    rng = random.Random(0xD81)
    cases = [_mont_point(0, 1, 0), _mont_point(5, 7, 0), _mont_point(0, 0, 0)]
    for pt in [PC.G1_GEN * rng.randrange(1, F.R) for _ in range(4)]:
        x, y = pt.affine()
        cases.append(_mont_point(int(x), int(y), 1))
    cases += [_mont_point(*(rng.randrange(P) for _ in range(3))) for _ in range(8)]
    cases.append(_mont_point(P - 1, P - 1, P - 1))
    for pt in cases:
        dbl = _call(host_lib.h_point_dbl, pt, n=3 * NW)
        assert np.array_equal(dbl, _call(host_lib.h_point_add, pt, pt, n=3 * NW))


@pytest.mark.parametrize("bits", [1, 2, 8, 16, 32, 48, 64, 96, 128])
def test_host_scan_ladder_matches_plain_at_canonical_values(host_lib, bits):
    """The header's bit-serial ladder (scan_g1's code) against
    ``scan_plain``: canonical limbs out, equal to the plain version's
    canonical residues, on identity rows, zero scalars, a scalar with
    only its top bit set and borrowed (negative-limb) inputs; the rows
    are k·P on the host curve."""
    rng = random.Random(bits * 7)
    pts = [PC.G1_GEN * rng.randrange(1, F.R) for _ in range(6)] + [PC.G1.infinity()] * 2
    ks = [rng.randrange(0, 1 << bits) for _ in pts]
    ks[2] = ks[6] = 0
    ks[3] = 1 << (bits - 1)
    limbs = torch.from_numpy(PE.g1_to_limbs(pts))
    limbs[1] = _borrowed(limbs[1])
    sbits = torch.from_numpy(PL.scalars_to_bits(ks, bits).astype(np.int32))
    out = torch.empty_like(limbs)
    host_lib.h_scan_g1(limbs.data_ptr(), sbits.data_ptr(), out.data_ptr(), len(pts), bits)
    f = PL.fq()
    assert torch.equal(f.canon(out), out)
    assert torch.equal(out, f.canon(cuda_ec.scan_plain(limbs, sbits)))
    for i, (pt, k) in enumerate(zip(pts, ks)):
        assert PE.g1_from_limbs(out[i]) == pt * k, i


def test_host_scan_ladder_with_no_set_bit_is_the_identity(host_lib):
    """Every bit 0, so the add of P is computed and dropped on each."""
    pts = torch.from_numpy(PE.g1_to_limbs([PC.G1_GEN * 5]))
    out = torch.empty_like(pts)
    zeros = torch.zeros((1, 16), dtype=torch.int32)
    host_lib.h_scan_g1(pts.data_ptr(), zeros.data_ptr(), out.data_ptr(), 1, 16)
    assert PE.g1_from_limbs(out[0]).is_infinity()
    plain = cuda_ec.scan_plain(pts, zeros)
    assert torch.equal(out, PL.fq().canon(plain))
