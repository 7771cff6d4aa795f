// sha256.cu — batched SHA-256 for Hopper.
//
// Replaces no Pallas kernel: the reference hashes its reliable-broadcast
// batches with an XLA program, hbbft_tpu/ops/sha256_jax.py (_compress /
// sha256_device, :57 and :90, a lax.scan over the 64 rounds and one over
// the blocks; sha256_many, :140, pads the messages on the host first).
//
// sha256_kernel<PADDED>, one thread a message, block after block (SHA-256
// is sequential within a message, so the parallelism is across messages),
// over sha256.cuh's compress_run:
// - PADDED: [B, nblocks, 16] big-endian words, padded already (the
//   reference's sha256_device form) → [B, 8] digests;
// - raw: [B, len] bytes, the rows back to back at any alignment (len need
//   not be a multiple of anything) → [B, 8] digests.  The card pads: each
//   block's big-endian words are built in registers from aligned 16-byte
//   loads, selects and byte permutes (hash_message<0>, the code merkle.cu's
//   leaves use), the padding's 0x80, zeros and bit length put in the
//   blocks that hold the message's end.
//
// What bounds it on the card: 32-bit integer operations.  A compression
// is about 1,400 of them (chip_smoke.py's SHA_OPS_PER_BLOCK counts rotates
// as one funnel shift, three-input xors and majorities as one LOP3,
// four-term sums as two IADD3) against 64 bytes read.  A batch of at
// least 528 warps (one a scheduler) is bound by the int32 issue rate; a
// smaller one by one warp's issue of its own chain, two clocks a 32-lane
// int32 instruction.  Each thread issues block b + 1's loads into
// registers before it compresses block b, so the chain does not wait on
// device memory between blocks.  __launch_bounds__(THREADS, 1) lets ptxas
// keep those registers live across the compression: under the bare
// bound it fitted the raw entry in 56 registers by issuing the loads after
// the compression (PERF.md).  A double buffer in shared memory
// through cp.async, tried beside it, was slower at 1,000 × 47,672 B.
//
// Words are int32 bit patterns; the words entry's pointer is 16-byte
// aligned, the raw entry's any (the wrappers in ops/sha256.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int THREADS = 128;

// n: blocks a row (PADDED) or bytes a row
template <bool PADDED>
__global__ void __launch_bounds__(THREADS, 1)
sha256_kernel(const void* __restrict__ src, uint32_t* __restrict__ out, int B, int64_t n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B) return;
  uint32_t s[8];
  if constexpr (PADDED) {
    PaddedBlocks blocks{static_cast<const uint4*>(src) + (size_t)i * n * 4};
    init_state(s);
    compress_run(s, blocks, 0, n, n, 0);
  } else {
    hash_message<0>(s, static_cast<const uint8_t*>(src) + (size_t)i * n, n, 0u);
  }
  store_digest(s, out + (size_t)i * 8);
}

// ---- the launch (tests/test_torch_rbc_host.py cuts the source here)

template <bool PADDED>
int launch(const void* src, void* out, int B, int64_t n, void* stream) {
  if (B > 0) {
    sha256_kernel<PADDED><<<(B + THREADS - 1) / THREADS, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        src, static_cast<uint32_t*>(out), B, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// blocks [B, nblocks, 16] and out [B, 8] int32 words, contiguous and
// 16-byte aligned on the current device; launches on `stream` and returns
// cudaGetLastError() (0 on success).
int sha256_launch(const void* blocks, void* out, int B, int nblocks, void* stream) {
  return launch<true>(blocks, out, B, nblocks, stream);
}

// msgs [B, len] bytes, contiguous (any alignment), and out [B, 8] int32
// words, 16-byte aligned, on the current device; launches on `stream` and
// returns cudaGetLastError() (0 on success).
int sha256_bytes_launch(const void* msgs, void* out, int B, long long len, void* stream) {
  return launch<false>(msgs, out, B, len, stream);
}

const char* sha256_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
