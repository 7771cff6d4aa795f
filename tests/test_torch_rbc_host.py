"""The broadcast plane's CUDA sources run on the host.

``csrc/sha256.cu``, ``csrc/merkle.cu`` (over ``csrc/sha256.cuh``) and
``csrc/gf_matmul.cu`` are compiled with the host C++ compiler, the CUDA
qualifiers defined away by a stand-in ``cuda_runtime.h``:

- ``sha256_kernel`` runs for every thread of its grid, through its words
  entry and its raw one (rows at every alignment, padded in registers);
- ``merkle_forest``'s body (``forest_tree``) runs a block's threads as
  ``std::thread``s meeting at a ``std::barrier`` where it calls
  ``__syncthreads``, tree after tree, into a host buffer standing for
  its shared (or global) rows;
- ``gf_matmul``'s scalar parts run around its product: each step's
  stage of the padded data as the copy lanes fill it (``x_span``), every
  consumer thread's symbols from it and its fragment of the data's
  bits (``stage_symbols``, ``fragment``), the product ``wgmma`` would
  compute as a scalar loop that reads each fragment byte where wgmma's
  register layout puts it and A_bin where its stage's core-matrix layout
  does (A_bin's tiles from ``ops/gf256.abin_tiles``), the accumulators in
  wgmma's register layout, and the epilogue (``pack_store``) by each
  warp's 32 lanes as ``std::thread``s whose ``__shfl_xor_sync`` meets at
  a barrier.

Their outputs must equal ``hashlib``, ``MerkleTree`` and the port's
``crypto/rs.py`` products exactly: a rehearsal of the kernels'
arithmetic, indexing and tiling where no card is.  The launch wrappers
(``<<<...>>>``), the bulk copies, the mbarriers and ``wgmma`` itself are
cut off; the card runs them in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import ctypes
import hashlib
import shutil
import subprocess

import numpy as np
import pytest

import torch

from hbbft_tpu_torch.crypto import rs as RS
from hbbft_tpu_torch.crypto.merkle import MerkleTree
from hbbft_tpu_torch.ops import gf256 as GF
from hbbft_tpu_torch.ops import kernels
from hbbft_tpu_torch.ops import sha256 as SH

_CUDA_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#define __align__(x)
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, int n) {
  n &= 31;
  return n ? (lo >> n) | (hi << (32 - n)) : lo;
}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
// a warp's lanes as threads: a shuffle meets its 31 peers at a barrier
struct HostWarp {
  std::barrier<> bar{32};
  uint32_t slot[32];
};
static thread_local HostWarp* g_warp;
static thread_local int g_lane;
inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int mask) {
  g_warp->slot[g_lane] = v;
  g_warp->bar.arrive_and_wait();
  const uint32_t r = g_warp->slot[g_lane ^ mask];
  g_warp->bar.arrive_and_wait();
  return r;
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local dim3 blockIdx, threadIdx;
static std::barrier<>* g_barrier;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
typedef int cudaError_t;
typedef void* cudaStream_t;
"""

_SHA_HARNESS = r"""
// every thread of the grid, through the words entry (padded) or the raw one
extern "C" void h_sha256(int padded, const void* src, uint32_t* out, int B, int64_t n) {
  for (int i = 0; i < B; ++i) {
    blockIdx = dim3(i / THREADS);
    threadIdx = dim3(i % THREADS);
    if (padded) sha256_kernel<true>(src, out, B, n); else sha256_kernel<false>(src, out, B, n);
  }
}
"""

_MERKLE_HARNESS = r"""
#include <thread>
#include <vector>
// T trees' rows into store [T, rows, 8], each tree by `threads` threads
extern "C" void h_merkle_forest(const uint8_t* values, uint32_t* store, int T, int n, int len,
                                int rows, int threads) {
  for (int t = 0; t < T; ++t) {
    std::barrier<> bar(threads);
    g_barrier = &bar;
    std::vector<std::thread> pool;
    for (int i = 0; i < threads; ++i)
      pool.emplace_back([=] {
        forest_tree(values + (size_t)t * n * len, n, len, store + (size_t)t * rows * 8, i, threads);
      });
    for (auto& th : pool) th.join();
  }
}
"""

_GF_HARNESS = r"""
#include <thread>
#include <vector>
// (row, k) of an A_bin stage as wgmma's descriptor smem_desc(p, 128, 256)
// reads it
static int desc_offset(int row, int k) {
  return (row / 8) * 256 + (k / 16) * 128 + (row % 8) * 16 + k % 16;
}
template <int W>
void tiles(const uint8_t* abin, const uint8_t* x, int xs, void* y, int m, int k, int n) {
  const int MT = (W * m + BM - 1) / BM, KS = (W * k + BK - 1) / BK, NT = (n + BN - 1) / BN;
  const int threads = 32 * CONSUMER_WARPS;
  std::vector<uint32_t> frag((size_t)KS * threads * 4);
  for (int mt = 0; mt < MT; ++mt)
    for (int nt = 0; nt < NT; ++nt) {
      // every consumer thread's fragment of every step
      for (int ks = 0; ks < KS; ++ks) {
        // the step's stage of data as the copy lanes fill it (x_span's
        // slices; what they do not copy holds stale bytes: 0xEE here)
        std::vector<uint8_t> xst(X_STAGE, 0xEE);
        for (int rr = 0; rr < BK / W; ++rr) {
          int off;
          const int len = x_span<W>((BK / W) * ks + rr, k, xs, nt, off);
          for (int q = 0; q < len; ++q)
            xst[rr * (BN * W / 8) + q] = x[(size_t)((BK / W) * ks + rr) * xs + off + q];
        }
        for (int th = 0; th < threads; ++th) {
          uint32_t v[4], a[4];
          stage_symbols<W>(v, xst.data(), k, xs, nt * BN, ks, th / 32, th % 32);
          fragment<W>(a, v, th % 32);
          for (int i = 0; i < 4; ++i) frag[((size_t)ks * threads + th) * 4 + i] = a[i];
        }
      }
      // element (row, kk) of a warpgroup's 64 × 32 A operand at step ks, read
      // from the thread and register wgmma's register layout puts it in:
      // lane 4·(row % 8) + (kk % 16) / 4 of warp row / 16, register
      // (row % 16) / 8 + 2·(kk / 16), byte kk % 4
      auto a_elem = [&](int ks, int wg, int row, int kk) -> uint32_t {
        const int th = 32 * (4 * wg + row / 16) + 4 * (row % 8) + (kk % 16) / 4;
        const uint32_t r = frag[((size_t)ks * threads + th) * 4 + (row % 16) / 8 + 2 * (kk / 16)];
        return (r >> (8 * (kk % 4))) & 0xFF;
      };
      const uint8_t* a = abin + (size_t)mt * KS * A_STAGE;
      for (int warp = 0; warp < CONSUMER_WARPS; ++warp) {
        HostWarp ctx;
        std::vector<std::thread> lanes;
        for (int lane = 0; lane < 32; ++lane)
          lanes.emplace_back([&, warp, lane] {
            g_warp = &ctx;
            g_lane = lane;
            const int g = lane >> 2, t = lane & 3, wg = warp / 4, ww = warp % 4;
            uint32_t d[ACC];
            for (int v = 0; v < ACC; ++v) {
              const int row = 16 * ww + g + 8 * ((v >> 1) & 1), col = 8 * (v >> 2) + 2 * t + (v & 1);
              uint32_t acc = 0;
              for (int ks = 0; ks < KS; ++ks)
                for (int kk = 0; kk < BK; ++kk)
                  acc += a_elem(ks, wg, row, kk) * a[(size_t)ks * A_STAGE + desc_offset(col, kk)];
              d[v] = acc;
            }
            pack_store<W>(d, lane, mt * BM, nt * BN + 16 * warp + g, y, m, n);
          });
        for (auto& th : lanes) th.join();
      }
    }
}
extern "C" void h_gf_matmul(int w, const uint8_t* abin, const uint8_t* x, int xs, void* y, int m,
                            int k, int n) {
  if (w == 8) tiles<8>(abin, x, xs, y, m, k, n); else tiles<16>(abin, x, xs, y, m, k, n);
}
"""


def _kernel_body(name: str, cut: str) -> str:
    src = (kernels.CSRC / f"{name}.cu").read_text()
    return src[: src.index(cut)] + "\n"


def _build(tmp_path_factory, name, body, harness, std):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp(f"{name}_host")
    (d / "cuda_runtime.h").write_text(_CUDA_RUNTIME)
    (d / "harness.cpp").write_text(body + harness)
    so = d / "harness.so"
    proc = subprocess.run(
        [cxx, "-O1", f"-std={std}", "-pthread", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         "-I", str(d), "-I", str(kernels.CSRC), "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def sha_lib(tmp_path_factory):
    body = _kernel_body("sha256", "// ---- the launch").replace("namespace {", "")
    return _build(tmp_path_factory, "sha256", body, _SHA_HARNESS, "c++20")


@pytest.fixture(scope="module")
def merkle_lib(tmp_path_factory):
    body = _kernel_body("merkle", "__global__ void __launch_bounds__(FOREST_THREADS)")
    return _build(tmp_path_factory, "merkle", body + "}  // namespace\n", _MERKLE_HARNESS,
                  "c++20")


@pytest.fixture(scope="module")
def gf_lib(tmp_path_factory):
    body = _kernel_body("gf_matmul", "// ---- the kernel")
    return _build(tmp_path_factory, "gf_matmul", body, _GF_HARNESS, "c++20")


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 119, 120, 1000])
def test_sha256_kernel_on_the_host(sha_lib, length):
    gen = np.random.default_rng(length)
    msgs = [gen.integers(0, 256, size=length, dtype=np.uint8).tobytes() for _ in range(5)]
    blocks = np.ascontiguousarray(SH.pad_messages(msgs))
    out = np.zeros((5, 8), np.uint32)
    sha_lib.h_sha256(1, _ptr(blocks), _ptr(out), 5, ctypes.c_int64(blocks.shape[1]))
    assert SH.digests_to_bytes(out) == [hashlib.sha256(m).digest() for m in msgs]


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("length", [1, 55, 56, 63, 64, 119, 120, 47_672])
def test_sha256_raw_entry_on_the_host(sha_lib, length, offset):
    """The raw entry: 7 rows back to back from ``offset`` bytes into an
    aligned buffer, so the rows start at every alignment (and 47,672 ≡ 8
    mod 16), the card's padding and the read-ahead of every inner block;
    the words entry on the same messages, both equal to ``hashlib``."""
    B = 7
    gen = np.random.default_rng(length * 4 + offset)
    buf = gen.integers(0, 256, size=B * length + 16, dtype=np.uint8)
    rows = buf[offset : offset + B * length]
    msgs = [rows[i * length : (i + 1) * length].tobytes() for i in range(B)]
    want = [hashlib.sha256(m).digest() for m in msgs]
    out = np.zeros((B, 8), np.uint32)
    sha_lib.h_sha256(0, _ptr(rows), _ptr(out), B, ctypes.c_int64(length))
    assert SH.digests_to_bytes(out) == want
    blocks = np.ascontiguousarray(SH.pad_messages(msgs))
    out[:] = 0
    sha_lib.h_sha256(1, _ptr(blocks), _ptr(out), B, ctypes.c_int64(blocks.shape[1]))
    assert SH.digests_to_bytes(out) == want


@pytest.mark.parametrize("T,n,length,threads,offset", [
    (2, 1, 2, 32, 0), (3, 5, 11, 32, 1), (2, 10, 55, 32, 3), (1, 64, 200, 64, 1),
    (2, 33, 56, 64, 2), (1, 300, 2, 256, 0), (1, 7, 1000, 32, 3), (1, 3, 0, 32, 0),
    (1, 3, 47_663, 32, 1)])
def test_merkle_forest_kernel_on_the_host(merkle_lib, T, n, length, threads, offset):
    """Every row of each tree equals ``MerkleTree.levels``: the leaf
    messages made in registers (a value at every alignment: ``offset``
    shifts the buffer, so the aligned word reads and byte permutes of a
    long leaf's inner blocks see each start), the odd levels' repeated
    hashes, the barriers between levels."""
    gen = np.random.default_rng(T * 1000 + n + length)
    buf = gen.integers(0, 256, size=T * n * length + 8, dtype=np.uint8)
    values = buf[offset : offset + T * n * length]
    rows = sum(SH.level_sizes(n))
    store = np.zeros((T, rows, 8), np.uint32)
    merkle_lib.h_merkle_forest(_ptr(values), _ptr(store), T, n, length, rows, threads)
    for t in range(T):
        vals = [values[(t * n + i) * length : (t * n + i + 1) * length].tobytes() for i in range(n)]
        got = SH.split_levels(b"".join(SH.digests_to_bytes(store[t])), n)
        assert got == MerkleTree(vals).levels


@pytest.mark.parametrize("W,m,k,n", [(8, 5, 40, 37), (8, 9, 33, 130), (16, 3, 35, 41),
                                     (16, 10, 7, 300), (8, 1, 1, 1)])
def test_gf_matmul_kernel_on_the_host(gf_lib, W, m, k, n):
    gen = np.random.default_rng(W * 1000 + n)
    dtype = np.uint8 if W == 8 else np.uint16
    mat = gen.integers(0, 1 << W, size=(m, k), dtype=dtype)
    mat[0, 0] = 0
    data = gen.integers(0, 1 << W, size=(k, n), dtype=dtype)
    table = torch.from_numpy(GF.const_table(mat) if W == 8 else GF.const_table(mat).view(np.int16))
    abin = np.ascontiguousarray(GF.abin_tiles(table, W).numpy())
    row_bytes = n * W // 8
    xs = -(-row_bytes // 16) * 16
    x = np.zeros((k, xs), np.uint8)  # rows padded to 16 bytes, as the wrapper does
    x[:, :row_bytes] = data.view(np.uint8).reshape(k, row_bytes)
    y = np.zeros((m, n), dtype)
    gf_lib.h_gf_matmul(W, _ptr(abin), _ptr(x), xs, _ptr(y), m, k, n)
    want = RS.gf_matmul(mat, data) if W == 8 else RS.gf16_matmul(mat, data)
    assert np.array_equal(y, want)


def test_abin_tiles_hold_the_binary_expansion():
    """``abin_tiles`` is ``_binary_matrix{,16}`` (the plain version's
    operand, held to the reference's in tests/test_torch_gf256.py) in the
    kernel's tile order, zero padded."""
    gen = np.random.default_rng(5)
    for W, m, k in ((8, 17, 9), (16, 9, 5)):
        dtype = np.uint8 if W == 8 else np.uint16
        mat = gen.integers(0, 1 << W, size=(m, k), dtype=dtype)
        table = GF.const_table(mat)
        tiles = GF.abin_tiles(torch.from_numpy(table if W == 8 else table.view(np.int16)), W)
        MT, KS, _ = tiles.shape
        flat = tiles.view(MT, KS, 32, 2, 8, 16).permute(0, 2, 4, 1, 3, 5).reshape(MT * 256, KS * 32)
        binary = (GF._binary_matrix if W == 8 else GF._binary_matrix16)(GF._key(mat))
        assert np.array_equal(flat[: W * m, : W * k].numpy(), binary.astype(np.uint8))
        assert not flat[W * m :].any() and not flat[:, W * k :].any()


def test_gf_sweep_patches_apply():
    """scripts/torch_gf_sweep.py's variants patch copies of
    csrc/gf_matmul.cu by text: every anchor must be in the source once, or
    the sweep would time the shipped kernel under another name."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_gf_sweep", kernels.PKG_DIR.parent / "scripts" / "torch_gf_sweep.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    src = (kernels.CSRC / "gf_matmul.cu").read_text()
    assert set(sweep.VARIANTS) == {"shipped", "no-mma", "no-data"}
    for label, patches in sweep.VARIANTS.items():
        for old, new in patches:
            assert src.count(old) == 1 and old != new, (label, old)
