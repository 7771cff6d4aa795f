// win_g2.cu — 4-bit fixed-window G2 scalar multiplication for Hopper.
//
// Replaces the TPU kernel hbbft_tpu/ops/pallas_ec.py:_make_windowed_kernel
// (g2=True), i.e. `_windowed_kernel_g2` run through `_run_tiles`'
// pl.pallas_call (exec name win_g2).  Per point k·P on the twist
// E'(Fq2): y² = x³ + 4(1+u), the same ladder as win_g1 (bls_fq.cuh's
// windowed_ladder): the table j·P (j = 0..15) by complete adds, then per
// 4-bit window, msb first, 4 doublings and one complete add of
// table[digit] (a digit outside 0..15 selects the identity).
//
// Fq2 = Fq[u]/(u²+1) over bls_fq.cuh's Fq routines, in the operation
// order of pallas_ec._KernelField2 / ops/ec.py Fq2Ops: Karatsuba
// (a0b0 − a1b1, (a0+a1)(b0+b1) − a0b0 − a1b1) and 3·b = 12(1+u), i.e.
// mul_b3(a) = (12·(a0 − a1), 12·(a0 + a1)).  Limbs equal the plain
// PyTorch version's exactly.
//
// Design (simple and right first): one thread per point, 128-thread
// blocks, an indexed read of table[d] in place of the Mosaic 15-way
// cascade (public Fiat–Shamir scalars: the data-dependent read leaks
// nothing).  A point is 228 int32 (912 B), so the table is 14.6 KB a
// thread, in local memory.  The Fq2 routines are __noinline__, built on
// the shared __noinline__ Fq ones, which keeps the build short.
//
// What bounds it on the card: int32 multiply-adds.  A complete add is 12
// Fq2 products = 36 Fq products of 38×38 = 1,444 multiply-adds (plus the
// lazy schedule's folds, overhead of the representation), and a point
// takes 14 + 5·nwin adds; the bytes (points in and out, digits in) are
// ~2 KB a point.  The layout at the wrapper is the reference's
// [K, 3, 2, 38] int32 points and [K, nwin] int32 digits.

#include "bls_fq.cuh"

namespace {

constexpr int THREADS = 128;

// Fq2 ops on [2][L] elements (c0 then c1).  Each reads all of its inputs
// before it writes `out`, so `out` may alias an input.
__device__ __noinline__ void fq2_add(const int32_t* a, const int32_t* b, int32_t* out) {
  fe_add(a, b, out);
  fe_add(a + L, b + L, out + L);
}

__device__ __noinline__ void fq2_sub(const int32_t* a, const int32_t* b, int32_t* out) {
  fe_sub(a, b, out);
  fe_sub(a + L, b + L, out + L);
}

__device__ __noinline__ void fq2_mul(const int32_t* a, const int32_t* b, int32_t* out) {
  int32_t t0[L], t1[L], sa[L], sb[L], cross[L];
  fe_mul(a, b, t0);
  fe_mul(a + L, b + L, t1);
  fe_add(a, a + L, sa);
  fe_add(b, b + L, sb);
  fe_mul(sa, sb, cross);
  fe_sub(cross, t0, cross);
  fe_sub(cross, t1, cross);
  fe_sub(t0, t1, out);
#pragma unroll
  for (int i = 0; i < L; ++i) out[L + i] = cross[i];
}

__device__ __noinline__ void fq2_mul_b3(const int32_t* a, int32_t* out) {
  int32_t d[L], s[L];
  fe_sub(a, a + L, d);
  fe_add(a, a + L, s);
  fe_mul_small(d, 12, out);
  fe_mul_small(s, 12, out + L);
}

// The field of G2 for bls_fq.cuh's point_add / windowed_ladder.
struct Fq2 {
  static constexpr int N = 2 * L;
  __device__ static void add(const int32_t* a, const int32_t* b, int32_t* o) { fq2_add(a, b, o); }
  __device__ static void sub(const int32_t* a, const int32_t* b, int32_t* o) { fq2_sub(a, b, o); }
  __device__ static void mul(const int32_t* a, const int32_t* b, int32_t* o) { fq2_mul(a, b, o); }
  __device__ static void mul_b3(const int32_t* a, int32_t* o) { fq2_mul_b3(a, o); }
};

__global__ void __launch_bounds__(THREADS)
win_g2_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ digits,
              int32_t* __restrict__ out, int K, int nwin) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  constexpr int P = 3 * Fq2::N;
  windowed_ladder<Fq2>(pts + (size_t)k * P, digits + (size_t)k * nwin, nwin,
                       out + (size_t)k * P);
}

}  // namespace

extern "C" {

// pts [K, 3, 2, 38] int32, digits [K, nwin] int32, out [K, 3, 2, 38]
// int32, all contiguous on the current device; launches on `stream` and
// returns cudaGetLastError() (0 on success).
int win_g2_launch(const void* pts, const void* digits, void* out, int K, int nwin,
                  void* stream) {
  if (K > 0) {
    const int blocks = (K + THREADS - 1) / THREADS;
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
