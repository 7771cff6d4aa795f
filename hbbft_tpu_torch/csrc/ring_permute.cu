// ring_permute.cu — one step of the mesh ring: every shard's buffer stored
// into its right neighbour's buffer, one launch per sending card.
//
// Replaces the TPU kernel hbbft_tpu/ops/pallas_ec.py:_ring_permute_kernel
// (`ring_permute`, pl.pallas_call at :934), where, under shard_map, one
// pallas_call per ring step has every shard start a
// `make_async_remote_copy` of its whole HBM buffer into the right
// neighbour's and wait on a send and a receive DMA semaphore.  Here the
// wrapper (hbbft_tpu_torch/ops/cuda_ec.py:ring_permute) groups a round's
// copies by the sender's card and launches this kernel once a card, on
// one stream of that card, with up to MAX_JOBS (src, dst, nbytes) copies
// in a job table passed by value; `dst` may lie on another card (a peer
// pointer: the stores cross NVLink).  The semaphores become CUDA events
// around the launch.  Peer access is enabled once a card pair
// (ring_enable_peer), not on each launch.
//
// Body: blockIdx.y picks the job, blockIdx.x · THREADS + threadIdx.x is a
// 32-bit unit index within it, no grid-stride loop: the grid's x extent is
// the largest job's unit count.  A job whose two pointers are 16-byte
// aligned copies one int4 a unit for its whole words, and its last
// nbytes % 16 bytes one byte a unit; a misaligned job copies every byte,
// one a unit.  Units past a job's count return at once.
//
// What bounds it on the card: bytes — each byte read once and written once,
// over HBM's 3.35 TB/s on one card or NVLink's 450 GB/s each way across two.
// The mesh flush's message is [64, 3, 38] int32 = 29,184 bytes a shard,
// ~17 ns of HBM time a shard, so the launch (~2 µs on the card's
// timeline, more on the host) is what a round costs: one launch a card
// where the shards on it launched one each.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_JOBS = 8;  // 8 × 24 B of table: far inside the 4 KB parameter limit

struct Jobs {
  const unsigned char* src[MAX_JOBS];
  unsigned char* dst[MAX_JOBS];
  uint32_t words[MAX_JOBS];  // whole 16-byte words copied as int4 (0 when misaligned)
  uint32_t bytes[MAX_JOBS];  // bytes after them, copied one a unit
};

__global__ void __launch_bounds__(THREADS) ring_permute_kernel(const Jobs jobs) {
  const int j = blockIdx.y;
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t words = jobs.words[j];
  if (i < words) {
    reinterpret_cast<int4*>(jobs.dst[j])[i] = reinterpret_cast<const int4*>(jobs.src[j])[i];
  }
  if (i < jobs.bytes[j]) {
    const size_t at = (size_t)words * 16 + i;
    jobs.dst[j][at] = jobs.src[j][at];
  }
}

}  // namespace

extern "C" {

int ring_permute_max_jobs() { return MAX_JOBS; }

// Let device `src_dev` store into device `dst_dev`'s memory; 0 or a
// cudaError_t (cudaErrorPeerAccessUnsupported where the pair has no path).
// The caller makes it once a pair; it restores the current device.
int ring_enable_peer(int src_dev, int dst_dev) {
  int can = 0;
  cudaError_t rc = cudaDeviceCanAccessPeer(&can, src_dev, dst_dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int prev = 0;
  rc = cudaGetDevice(&prev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaSetDevice(src_dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceEnablePeerAccess(dst_dev, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error the runtime recorded for that call
    rc = cudaSuccess;
  }
  cudaSetDevice(prev);
  return static_cast<int>(rc);
}

// One launch of `njobs` (1..MAX_JOBS) copies, job j storing nbytes[j] bytes
// from src[j] into dst[j], on `stream`, a stream of device `dev` (every
// src[j] lies on `dev`; a dst[j] on another card needs ring_enable_peer
// first).  A job's unit count (its int4 words, or its bytes when a pointer
// is not 16-byte aligned) must be below 2^32.  No sync.  Returns 0, or a
// cudaError_t (a bad job count, the device switch, or the launch's
// cudaGetLastError()).
int ring_permute_launch(const uint64_t* src, const uint64_t* dst, const uint64_t* nbytes,
                        int njobs, int dev, void* stream) {
  if (njobs < 1 || njobs > MAX_JOBS) return static_cast<int>(cudaErrorInvalidValue);
  Jobs jobs = {};
  uint64_t units = 0;
  for (int j = 0; j < njobs; ++j) {
    const bool aligned = ((src[j] | dst[j]) % 16) == 0;
    const uint64_t words = aligned ? nbytes[j] / 16 : 0;
    const uint64_t bytes = nbytes[j] - words * 16;
    if (words >= (1ull << 32) || bytes >= (1ull << 32)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    jobs.src[j] = reinterpret_cast<const unsigned char*>(src[j]);
    jobs.dst[j] = reinterpret_cast<unsigned char*>(dst[j]);
    jobs.words[j] = static_cast<uint32_t>(words);
    jobs.bytes[j] = static_cast<uint32_t>(bytes);
    if (words > units) units = words;
    if (bytes > units) units = bytes;
  }
  if (units == 0) return 0;
  int prev = 0;
  cudaError_t rc = cudaGetDevice(&prev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (prev != dev && (rc = cudaSetDevice(dev)) != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>((units + THREADS - 1) / THREADS), njobs);
  ring_permute_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(jobs);
  const int out = static_cast<int>(cudaGetLastError());
  if (prev != dev) cudaSetDevice(prev);
  return out;
}

const char* ring_permute_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
