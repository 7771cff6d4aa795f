// scan_g1.cu — bit-serial G1 scalar multiplication for Hopper.
//
// Replaces the TPU kernel hbbft_tpu/ops/pallas_ec.py:_scalar_mul_kernel
// run through `_run_tiles`' pl.pallas_call (exec name scan_g1; entry
// scalar_mul_pallas).  Per point k·P over BLS12-381 G1, msb first, for
// every bit: acc = acc + acc, then acc = bit ? acc + P : acc (any nonzero
// bit selects), as the reference's per-lane _select does
// (pallas_ec.py:308-311) — bls_mont.cuh's scan_ladder.  The output is the
// canonical residue of each coordinate, equal at canonical values to the
// plain PyTorch version (ops/cuda_ec.py scan_plain); the limbs differ from
// its lazily reduced ones.
//
// Design: one thread per point over bls_mont.cuh's Montgomery field: the
// point, the accumulator and acc + P are 3 × 12 words each, in registers,
// with no table and no local-memory traffic.  The doubling is point_dbl
// (the complete addition with p == q, its six self-products squared by
// fe_sqr), equal to point_add(acc, acc) word for word; the add of P is
// computed on every bit and kept where the bit is set.  At 255 registers
// a thread (80 bytes spilled) an SM holds 256 threads, so 65,536 points
// take two waves whatever the block; THREADS = 256 with no occupancy
// floor, with fe_sqr a call, was the fastest build of
// scripts/torch_win_sweep.py (capping registers for one wave spills
// ~1 KB and loses; inlining fe_sqr loses).
//
// What bounds it on the card: 32×32→64-bit multiplies.  k·P needs
// bit_length − 1 doublings (6 squares of 444 IMAD slots and 6 products of
// 576) and popcount − 1 adds (12 products) a nonzero scalar
// (chip_smoke.py's scan_bound); the kernel also doubles the identity in
// leading zero bits and computes the add it drops on every zero bit.
// The bytes (limbs in and out, one int32 a bit) are ~1.9 KB a point at
// 255 bits.  The layout at the wrapper is the reference's [K, 3, 38]
// int32 points (limbs in [−2^12, 2^12]) and [K, nbits] int32 bits.

#include "bls_mont.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
scan_g1_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ bits,
               int32_t* __restrict__ out, int K, int nbits) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  constexpr int P = 3 * FqM::LIMBS;
  const Pt<FqM> base = pt_load<FqM>(pts + (size_t)k * P);
  pt_store<FqM>(scan_ladder<FqM>(base, bits + (size_t)k * nbits, nbits), out + (size_t)k * P);
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
