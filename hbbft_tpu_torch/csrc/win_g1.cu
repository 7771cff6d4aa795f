// win_g1.cu — 4-bit fixed-window G1 scalar multiplication for Hopper.
//
// Replaces the TPU kernel hbbft_tpu/ops/pallas_ec.py:_make_windowed_kernel
// (g2=False), i.e. `_windowed_kernel` run through `_run_tiles`'
// pl.pallas_call (exec name win_g1).  Per point k·P over BLS12-381 G1:
// build the table j·P (j = 0..15) with complete adds, then for each 4-bit
// window, msb first, 4 doublings and one complete add of table[digit].
// The field and the complete addition are bls_fq.cuh's, limb for limb
// the reference's, so the output equals the plain PyTorch version bit for
// bit.
//
// Design (simple and right first): one thread per point, 128-thread
// blocks.  The Mosaic masked cascade (pallas_ec.py:263-268) becomes an
// indexed read of table[d]: the scalars are public Fiat–Shamir
// coefficients, so a data-dependent read leaks nothing.  The 16-entry
// table (7.3 KB a thread) lives in local memory.
//
// What bounds it on the card: int32 multiply-adds.  Each complete add is
// 12 field products of 38×38 = 1,444 multiply-adds plus the ~1,550 of
// their folds, and a point takes 14 + 5·nwin adds; the bytes moved (limbs
// in and out, digits in) are ~0.5 KB a point.  The layout at the wrapper
// is the reference's [K, 3, 38] int32 points and [K, nwin] int32 digits.

#include "bls_fq.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
win_g1_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ digits,
              int32_t* __restrict__ out, int K, int nwin) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  windowed_ladder<Fq>(pts + (size_t)k * 3 * L, digits + (size_t)k * nwin, nwin,
                      out + (size_t)k * 3 * L);
}

}  // namespace

extern "C" {

// pts [K, 3, 38] int32, digits [K, nwin] int32, out [K, 3, 38] int32, all
// contiguous on the current device; launches on `stream` and returns
// cudaGetLastError() (0 on success).
int win_g1_launch(const void* pts, const void* digits, void* out, int K, int nwin,
                  void* stream) {
  if (K > 0) {
    const int blocks = (K + THREADS - 1) / THREADS;
    win_g1_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(pts), static_cast<const int32_t*>(digits),
        static_cast<int32_t*>(out), K, nwin);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* win_g1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
