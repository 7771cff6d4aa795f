// ring_permute.cu — one step of the mesh ring: a shard's buffer stored into
// its right neighbour's buffer.
//
// Replaces the TPU kernel hbbft_tpu/ops/pallas_ec.py:_ring_permute_kernel
// (`ring_permute`, pl.pallas_call at :934), where every shard starts a
// `make_async_remote_copy` of its whole HBM buffer into the right
// neighbour's and waits on a send and a receive DMA semaphore.  Here the
// wrapper (hbbft_tpu_torch/ops/cuda_ec.py:ring_permute) calls this entry
// once per shard and round, on the SENDER's stream, with `dst` the buffer
// on the RECEIVER's device; the semaphores become CUDA events around the
// launch (the sender's stream waits until the receive buffer is free, the
// receiver's stream waits for the copy before its add).
//
// Body: a grid-stride copy in 16-byte words, plus the bytes past the last
// whole word; when either pointer is not 16-byte aligned every byte goes
// the byte loop.  On one card the store lands in the same HBM; across
// cards `dst` is a peer pointer and the stores cross NVLink, which the
// entry enables (cudaDeviceEnablePeerAccess) the first time a pair meets.
//
// What bounds it on the card: bytes — each byte read once and written once,
// over HBM's 3.35 TB/s on one card or NVLink's 450 GB/s each way across two.
// The mesh flush's message is [64, 3, 38] int32 = 29,184 bytes, ~17 ns of
// HBM time, so the launch latency (microseconds) is what a call costs.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 264;  // two waves of 132 SMs is plenty for a copy

__global__ void __launch_bounds__(THREADS)
ring_permute_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
                    size_t nbytes, int vectorized) {
  const size_t stride = (size_t)gridDim.x * THREADS;
  const size_t tid = (size_t)blockIdx.x * THREADS + threadIdx.x;
  size_t head = 0;
  if (vectorized) {
    const size_t nwords = nbytes / 16;
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (size_t i = tid; i < nwords; i += stride) d[i] = s[i];
    head = nwords * 16;
  }
  for (size_t i = head + tid; i < nbytes; i += stride) dst[i] = src[i];
}

// Let `src_dev` store into `dst_dev`'s memory; 0 or a cudaError_t.
int enable_peer(int src_dev, int dst_dev) {
  int can = 0;
  cudaError_t rc = cudaDeviceCanAccessPeer(&can, src_dev, dst_dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  rc = cudaDeviceEnablePeerAccess(dst_dev, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error the runtime recorded for that call
    return 0;
  }
  return static_cast<int>(rc);
}

}  // namespace

extern "C" {

// Copy `nbytes` from `src` (on device `src_dev`) into `dst` (on device
// `dst_dev`), launched on `stream`, a stream of `src_dev`.  No sync.
// Returns 0 on success, else a cudaError_t (peer access unsupported or
// refused, or the launch's cudaGetLastError()).
int ring_permute_launch(const void* src, void* dst, size_t nbytes, int src_dev, int dst_dev,
                        void* stream) {
  int prev = 0;
  cudaError_t rc = cudaGetDevice(&prev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaSetDevice(src_dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int out = 0;
  if (src_dev != dst_dev) out = enable_peer(src_dev, dst_dev);
  if (out == 0 && nbytes > 0) {
    const int vectorized = ((reinterpret_cast<uintptr_t>(src) |
                             reinterpret_cast<uintptr_t>(dst)) % 16) == 0;
    const size_t units = vectorized ? (nbytes + 15) / 16 : nbytes;
    size_t blocks = (units + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    ring_permute_kernel<<<static_cast<int>(blocks), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), nbytes,
        vectorized);
    out = static_cast<int>(cudaGetLastError());
  }
  cudaSetDevice(prev);
  return out;
}

const char* ring_permute_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
