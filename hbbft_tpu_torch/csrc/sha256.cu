// sha256.cu — batched SHA-256 for Hopper.
//
// Replaces no Pallas kernel: the reference hashes its reliable-broadcast
// batches with an XLA program, hbbft_tpu/ops/sha256_jax.py (_compress /
// sha256_device, :57 and :90, a lax.scan over the 64 rounds and one over
// the blocks).
//
// - sha256_kernel: [B, nblocks, 16] big-endian words (padded on the host)
//   → [B, 8] digests.  One thread a message, block after block: SHA-256
//   is sequential within a message, so the parallelism is across
//   messages.  The compression (sha256.cuh, shared with merkle.cu's
//   Merkle forest) runs the 64 rounds unrolled in registers.
//
// What bounds it on the card: 32-bit integer operations.  A compression
// is about 1,400 of them (chip_smoke.py's SHA_OPS_PER_BLOCK counts
// rotates as one funnel shift, three-input xors and majorities as one
// LOP3, four-term sums as two IADD3) against 64 bytes read; a batch is
// bound by the int32 issue rate unless it is too short to fill the card,
// when one thread's chain of dependent rounds is the time.  The design
// does nothing more about that: a simple kernel that is right first.
//
// Words are passed as int32 bit patterns; every pointer is 16-byte
// aligned (the wrappers in ops/sha256.py see to it).

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
sha256_kernel(const uint32_t* __restrict__ blocks, uint32_t* __restrict__ out, int B,
              int nblocks) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B) return;
  const uint4* p = reinterpret_cast<const uint4*>(blocks + (size_t)i * nblocks * 16);
  uint32_t s[8];
  init_state(s);
  for (int blk = 0; blk < nblocks; ++blk, p += 4) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = p[q];
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
    }
    compress(s, w);
  }
  store_digest(s, out + (size_t)i * 8);
}

}  // namespace

extern "C" {

// blocks [B, nblocks, 16] and out [B, 8] int32 words, contiguous and
// 16-byte aligned on the current device; launches on `stream` and returns
// cudaGetLastError() (0 on success).
int sha256_launch(const void* blocks, void* out, int B, int nblocks, void* stream) {
  if (B > 0) {
    sha256_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(blocks), static_cast<uint32_t*>(out), B, nblocks);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sha256_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
