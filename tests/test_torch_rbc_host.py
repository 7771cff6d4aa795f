"""The broadcast plane's CUDA sources run on the host.

``csrc/sha256.cu`` and ``csrc/gf_matmul.cu`` are compiled with the host
C++ compiler, the CUDA qualifiers defined away by a stand-in
``cuda_runtime.h``, and each kernel body is run for every thread of its
grid (``gf_matmul``'s threads of a block as ``std::thread``s meeting at a
``std::barrier`` where the kernel calls ``__syncthreads``).  Their
outputs must equal ``hashlib`` and the port's ``crypto/rs.py`` products
exactly: a rehearsal of the kernels' arithmetic, indexing and tiling
where no card is.  The launch wrappers (``<<<...>>>``) are cut off; the
card runs them in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import hashlib
import shutil
import subprocess

import numpy as np
import pytest

from hbbft_tpu_torch.crypto import rs as RS
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
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, int n) {
  n &= 31;
  return n ? (lo >> n) | (hi << (32 - n)) : lo;
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
extern "C" void h_sha256(const uint32_t* blocks, uint32_t* out, int B, int nblocks) {
  for (int i = 0; i < B; ++i) {
    blockIdx = dim3(i / THREADS);
    threadIdx = dim3(i % THREADS);
    sha256_kernel(blocks, out, B, nblocks);
  }
}
extern "C" void h_merkle_level(const uint32_t* level, uint32_t* out, int parents) {
  for (int i = 0; i < parents; ++i) {
    blockIdx = dim3(i / THREADS);
    threadIdx = dim3(i % THREADS);
    merkle_level_kernel(level, out, parents);
  }
}
"""

_GF_HARNESS = r"""
#include <thread>
#include <vector>
template <int W>
void grid(const void* c, const void* x, void* y, int m, int k, int words) {
  const int gx = (words + THREADS - 1) / THREADS, gy = (m + ROWS - 1) / ROWS;
  for (int by = 0; by < gy; ++by)
    for (int bx = 0; bx < gx; ++bx) {
      std::barrier<> bar(THREADS);
      g_barrier = &bar;
      std::vector<std::thread> threads;
      for (int t = 0; t < THREADS; ++t)
        threads.emplace_back([=] {
          blockIdx = dim3(bx, by);
          threadIdx = dim3(t);
          gf_matmul_kernel<W>(static_cast<const typename Lanes<W>::Sym*>(c),
                              static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), m, k,
                              words);
        });
      for (auto& th : threads) th.join();
    }
}
extern "C" void h_gf_matmul(int w, const void* c, const void* x, void* y, int m, int k, int words) {
  if (w == 8) grid<8>(c, x, y, m, k, words); else grid<16>(c, x, y, m, k, words);
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
         "-I", str(d), "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def sha_lib(tmp_path_factory):
    body = _kernel_body("sha256", 'extern "C" {').replace("}  // namespace", "")
    body = body.replace("namespace {", "")
    return _build(tmp_path_factory, "sha256", body, _SHA_HARNESS, "c++20")


@pytest.fixture(scope="module")
def gf_lib(tmp_path_factory):
    body = _kernel_body("gf_matmul", "template <int W>\nvoid launch(")
    body = body.replace("namespace {", "")
    return _build(tmp_path_factory, "gf_matmul", body, _GF_HARNESS, "c++20")


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 119, 120, 1000])
def test_sha256_kernel_on_the_host(sha_lib, length):
    gen = np.random.default_rng(length)
    msgs = [gen.integers(0, 256, size=length, dtype=np.uint8).tobytes() for _ in range(5)]
    blocks = np.ascontiguousarray(SH.pad_messages(msgs))
    out = np.zeros((5, 8), np.uint32)
    sha_lib.h_sha256(_ptr(blocks), _ptr(out), 5, blocks.shape[1])
    assert SH.digests_to_bytes(out) == [hashlib.sha256(m).digest() for m in msgs]


def test_merkle_level_kernel_on_the_host(sha_lib):
    level = np.random.default_rng(9).integers(0, 2**32, size=(10, 8), dtype=np.uint32)
    out = np.zeros((5, 8), np.uint32)
    sha_lib.h_merkle_level(_ptr(level), _ptr(out), 5)
    kids = SH.digests_to_bytes(level)
    want = [hashlib.sha256(b"\x01" + kids[i] + kids[i + 1]).digest() for i in range(0, 10, 2)]
    assert SH.digests_to_bytes(out) == want


@pytest.mark.parametrize("W,m,k,n", [(8, 5, 40, 37), (8, 9, 33, 130), (16, 3, 35, 41),
                                     (16, 10, 7, 300), (8, 1, 1, 1)])
def test_gf_matmul_kernel_on_the_host(gf_lib, W, m, k, n):
    gen = np.random.default_rng(W * 1000 + n)
    dtype = np.uint8 if W == 8 else np.uint16
    mat = gen.integers(0, 1 << W, size=(m, k), dtype=dtype)
    mat[0, 0] = 0
    data = gen.integers(0, 1 << W, size=(k, n), dtype=dtype)
    row_bytes = n * W // 8
    words = -(-row_bytes // 4)
    x = np.zeros((k, 4 * words), np.uint8)  # rows padded to a word, as the wrapper does
    x[:, :row_bytes] = data.view(np.uint8).reshape(k, row_bytes)
    y = np.zeros((m, words), np.uint32)
    table = np.ascontiguousarray(GF.const_table(mat))
    gf_lib.h_gf_matmul(W, _ptr(table), _ptr(x), _ptr(y), m, k, words)
    got = np.ascontiguousarray(y.view(np.uint8)[:, :row_bytes]).view(dtype)
    want = RS.gf_matmul(mat, data) if W == 8 else RS.gf16_matmul(mat, data)
    assert np.array_equal(got, want)
