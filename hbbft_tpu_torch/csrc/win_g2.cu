// win_g2.cu — 4-bit fixed-window G2 scalar multiplication for Hopper.
//
// Replaces the TPU kernel hbbft_tpu/ops/pallas_ec.py:_make_windowed_kernel
// (g2=True), i.e. `_windowed_kernel_g2` run through `_run_tiles`'
// pl.pallas_call (exec name win_g2).  Per point k·P on the twist
// E'(Fq2): y² = x³ + 4(1+u), the same ladder as win_g1 (bls_mont.cuh's
// windowed_ladder): the table j·P (j = 0..15) by complete adds, then per
// 4-bit window, msb first, 4 doublings and one complete add of
// table[digit] (a digit outside 0..15 selects the identity), with
// 3·b = 12(1+u).  The output is the canonical residue of each coordinate,
// equal at canonical values to the plain PyTorch version (ops/cuda_ec.py
// windowed_g2_plain).
//
// What bounds it on the card: 32×32→64-bit multiplies.  A complete add is
// 12 Fq2 products = 36 Fq products (Karatsuba) of 300 partial products
// (576 IMAD issue slots), and a point takes 14 + 5·nwin adds; the bytes
// (points in and out, digits in) are ~2 KB a point.
//
// Design: two threads a point (bls_mont.cuh's Fq2Lane).  One thread a
// point (Karatsuba, 3 Fq products an Fq2 product; a variant of
// scripts/torch_win_sweep.py) holds a 72-word point, and the accumulator
// and the complete add's temporaries overrun the 255 registers (ptxas
// spills ~1.3 KB).  Here lane h of a pair holds component c_h of every
// Fq2 value — 36 words a point, as in G1, 254 registers and no spills —
// and a product exchanges the operands' other halves with the partner
// lane by shuffles: 4 Fq products an Fq2 product where Karatsuba needs 3,
// for ~6 % less time (PERF.md).  The field values, and so the canonical
// output, are the same.  Every field routine but the Fq product (a call
// on register values) is inlined.  Each lane's 16-entry table (2.3 KB)
// lives in local memory, read once a window; an indexed read of
// table[d] takes the place of the Mosaic 15-way cascade (public
// Fiat–Shamir scalars: the data-dependent read leaks nothing).
// THREADS = 128 with no occupancy floor was the fastest launch shape of
// the sweep (capping registers to fit more blocks adds spills and loses).
//
// The layout at the wrapper is the reference's [K, 3, 2, 38] int32 points
// (limbs in [−2^12, 2^12]) and [K, nwin] int32 digits.

#include "bls_mont.cuh"

namespace {

constexpr int THREADS = 128;
// a lane pair never straddles a warp or a block, and every warp is whole
// for the full-mask shuffles
static_assert(THREADS % 32 == 0, "whole warps a block");
constexpr int LANES = 2;  // threads a point
constexpr int P = 3 * Fq2Lane::LIMBS;  // int32 a point at the wrapper

__global__ void __launch_bounds__(THREADS)
win_g2_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ digits,
              int32_t* __restrict__ out, int K, int nwin) {
  // every lane of a warp takes part in the shuffles: a pair past the end
  // recomputes the last point and stores nothing
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int k = min(t / LANES, K - 1);
  const Pt<Fq2Lane> acc =
      windowed_ladder<Fq2Lane>(pts + (size_t)k * P, digits + (size_t)k * nwin, nwin);
  if (t / LANES < K) pt_store<Fq2Lane>(acc, out + (size_t)k * P);
}

}  // namespace

extern "C" {

// pts [K, 3, 2, 38] int32, digits [K, nwin] int32, out [K, 3, 2, 38]
// int32, all contiguous on the current device; launches on `stream` and
// returns cudaGetLastError() (0 on success).
int win_g2_launch(const void* pts, const void* digits, void* out, int K, int nwin,
                  void* stream) {
  if (K > 0) {
    const int blocks = (LANES * K + THREADS - 1) / THREADS;
    win_g2_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(pts), static_cast<const int32_t*>(digits),
        static_cast<int32_t*>(out), K, nwin);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* win_g2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
