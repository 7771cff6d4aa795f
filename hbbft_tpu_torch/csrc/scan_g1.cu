// scan_g1.cu — bit-serial G1 scalar multiplication for Hopper.
//
// Replaces the TPU kernel hbbft_tpu/ops/pallas_ec.py:_scalar_mul_kernel
// run through `_run_tiles`' pl.pallas_call (exec name scan_g1; entry
// scalar_mul_pallas).  Per point k·P over BLS12-381 G1, msb first, for
// every bit: acc = acc + acc, then acc = bit ? acc + P : acc, with both
// sums computed and a select, as the reference's per-lane _select does
// (pallas_ec.py:308-311).  Any nonzero bit selects acc + P.  The field
// and the complete addition are bls_fq.cuh's, so the limbs equal the
// plain PyTorch version's exactly.
//
// Design: one thread per point, 128-thread blocks; the point, the
// accumulator and acc + P (3 × 456 B) are the thread's whole state.
//
// What bounds it on the card: int32 multiply-adds.  The kernel computes
// 2·nbits complete adds a point, each 12 field products of 38×38 =
// 1,444 multiply-adds (plus the lazy schedule's folds), but k·P needs
// only bit_length − 1 doublings and popcount − 1 adds (~1.5·nbits for
// random scalars): the add on a zero bit is computed and dropped, as the
// TPU's lanes had to.  The bytes (points in and out, one int32 a bit)
// are ~1.9 KB a point at 255 bits.  The layout
// at the wrapper is the reference's [K, 3, 38] int32 points and
// [K, nbits] int32 bits.

#include "bls_fq.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
scan_g1_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ bits,
               int32_t* __restrict__ out, int K, int nbits) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  constexpr int P = 3 * L;
  int32_t base[P], acc[P], with_p[P];
  const int32_t* src = pts + (size_t)k * P;
  for (int i = 0; i < P; ++i) base[i] = src[i];
  set_identity<Fq>(acc);
  const int32_t* b = bits + (size_t)k * nbits;
  for (int i = 0; i < nbits; ++i) {
    point_add<Fq>(acc, acc, acc);
    point_add<Fq>(acc, base, with_p);
    if (b[i] != 0) {
      for (int j = 0; j < P; ++j) acc[j] = with_p[j];
    }
  }
  int32_t* dst = out + (size_t)k * P;
  for (int i = 0; i < P; ++i) dst[i] = acc[i];
}

}  // namespace

extern "C" {

// pts [K, 3, 38] int32, bits [K, nbits] int32, out [K, 3, 38] int32, all
// contiguous on the current device; launches on `stream` and returns
// cudaGetLastError() (0 on success).
int scan_g1_launch(const void* pts, const void* bits, void* out, int K, int nbits,
                   void* stream) {
  if (K > 0) {
    const int blocks = (K + THREADS - 1) / THREADS;
    scan_g1_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(pts), static_cast<const int32_t*>(bits),
        static_cast<int32_t*>(out), K, nbits);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* scan_g1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
