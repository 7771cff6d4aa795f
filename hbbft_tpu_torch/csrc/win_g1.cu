// win_g1.cu — 4-bit fixed-window G1 scalar multiplication for Hopper.
//
// Replaces the TPU kernel hbbft_tpu/ops/pallas_ec.py:_make_windowed_kernel
// (g2=False), i.e. `_windowed_kernel` run through `_run_tiles`'
// pl.pallas_call (exec name win_g1).  Per point k·P over BLS12-381 G1:
// build the table j·P (j = 0..15) with complete adds, then for each 4-bit
// window, msb first, 4 doublings and one complete add of table[digit]
// (bls_mont.cuh's windowed_ladder).  The output is the canonical residue
// of each coordinate, equal at canonical values to the plain PyTorch
// version (ops/cuda_ec.py windowed_plain); the limbs differ from its
// lazily reduced ones.
//
// What bounds it on the card: 32×32→64-bit multiplies.  A point takes
// 14 + 5·nwin complete adds of 12 Fq products, each 300 partial products
// (576 IMAD issue slots; chip_smoke.py's bound_ms counts them, and the
// squares of each doubling, as the function needs them); the bytes
// (limbs in and out, digits in) are ~1 KB a point, and the 2.3 KB table
// a thread adds ~5 KB of local traffic a point at 24 windows — well
// under a millisecond a launch.
//
// Design: one thread per point.  bls_mont.cuh keeps each coordinate in
// 12 Montgomery words and inlines every field routine but the product (a
// call on register values), so the accumulator and every temporary of
// the complete add live in registers (212, no spills); only the 16-entry
// table (16 × 144 B) is in local memory, read once a window.  It cannot
// move to shared memory: the 256 threads an SM resident at 212 registers
// would need 590 KB of it (227 KB is the most a block gets), and capping
// registers to fit 4 blocks an SM (one wave for 65,536 points) adds
// spills and loses.  The Mosaic masked
// cascade (pallas_ec.py:263-268) becomes an indexed read of table[d]: the
// scalars are public Fiat–Shamir coefficients, so a data-dependent read
// leaks nothing.  THREADS = 128 with no occupancy floor (the
// __launch_bounds__ minimum blocks, which caps the registers a thread)
// was the fastest launch shape of scripts/torch_win_sweep.py.
//
// The layout at the wrapper is the reference's [K, 3, 38] int32 points
// (limbs in [−2^12, 2^12]) and [K, nwin] int32 digits.

#include "bls_mont.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
win_g1_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ digits,
              int32_t* __restrict__ out, int K, int nwin) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  constexpr int P = 3 * FqM::LIMBS;
  pt_store<FqM>(windowed_ladder<FqM>(pts + (size_t)k * P, digits + (size_t)k * nwin, nwin),
                out + (size_t)k * P);
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
