// cosim_step.cu — the packed co-simulation's per-epoch decision step: a
// zone histogram of the live receivers, then every agreement instance's
// closed-form decision, two launches on one stream.
//
// Replaces the XLA program hbbft_tpu/parallel/mesh.py:packed_cosim_step_fn
// (:473; its body `_body` :506-534), which the TPU runs as one fused
// launch an epoch (not a Pallas kernel).  For n validators in Z geo-zones:
//
//   a[z]  = Σ_j dst_on[j]·[zone_j = z]                        (cosim_hist)
//   c1[p] = ovr_mask[p] ? ovr_c1[p]
//                       : prop_on[p]·Σ_z reach[zone_p, z]·a[z] (cosim_step)
//   c0    = n_live − c1, and the agreement algebra below:
//   accepted = has1, nondef = has1 & has0,
//   dec_fail = accepted & (n_live − forged_cnt ≤ f), commit += accepted.
//
// All of it is int32 arithmetic, wrapping as XLA's does (products and sums
// taken in uint32); the histogram's atomics add integers, exact in any
// order, so the result is the reference's bit for bit.  On a mesh each
// shard histograms its own rows and the [Z] partials are summed by the
// ring_permute kernel and an int32 add (parallel/mesh.py); this source
// sees one shard.
//
// cosim_hist: a block reads THREADS · ROWS rows (neighbouring threads on
// neighbouring rows) and counts them in BINS shared-memory counters; a
// thread keeps a run of rows of one zone in a register and adds the run
// to shared memory when the zone changes (zones are contiguous id
// blocks, so a thread's runs are long), and the block adds each nonzero
// counter to a[] with one global atomic.  A Z above BINS is taken in
// windows of BINS zones, each a pass over the block's rows.  Rows whose
// zone lies outside [0, Z) add nothing (the reference's scatter drops
// them).  The wrapper's stream zeroes a[] first (cudaMemsetAsync).
//
// cosim_step: one thread an instance.  The block stages a[] in shared
// memory, a window of BINS zones at a time, and each thread dots its
// proposer's reach row (u8, read through L1/L2: Z² bytes in all) with it;
// a zone outside [0, Z) is clamped, as the reference's gather clamps.
// The decision is branch-free selects; commit is updated in place.
//
// What bounds it on the card: bytes.  An instance reads 1 + 1 + 4 + 1 + 4
// + 4 + 4 bytes (prop_on, dst_on, zone, ovr_mask, ovr_c1, forged_cnt,
// commit) and writes 4 + 3 (commit, the three masks), 26 bytes: 2.6 MB at
// n = 100,000, under a microsecond at 3.35 TB/s — so at the co-sim's
// sizes the two launches' fixed cost is what the step costs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;     // rows a thread reads in cosim_hist
constexpr int BINS = 256;   // zone counters a block keeps in shared memory

__global__ void __launch_bounds__(THREADS)
    cosim_hist_kernel(const int8_t* __restrict__ dst_on, const int32_t* __restrict__ zone, int n,
                      int Z, int32_t* __restrict__ a) {
  __shared__ int32_t counts[BINS];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS * ROWS + threadIdx.x;
  for (int z0 = 0; z0 < Z; z0 += BINS) {
    const int w = min(BINS, Z - z0);
    for (int k = threadIdx.x; k < w; k += THREADS) counts[k] = 0;
    __syncthreads();
    int run_zone = -1;
    uint32_t run = 0;
    for (int r = 0; r < ROWS; ++r) {
      const int64_t i = base + static_cast<int64_t>(r) * THREADS;
      if (i >= n) break;
      const int v = dst_on[i];
      const int z = zone[i] - z0;
      if (v == 0 || z < 0 || z >= w) continue;
      if (z != run_zone) {
        if (run_zone >= 0) atomicAdd(&counts[run_zone], static_cast<int32_t>(run));
        run_zone = z;
        run = 0;
      }
      run += static_cast<uint32_t>(v);
    }
    if (run_zone >= 0) atomicAdd(&counts[run_zone], static_cast<int32_t>(run));
    __syncthreads();
    for (int k = threadIdx.x; k < w; k += THREADS) {
      if (counts[k] != 0) atomicAdd(&a[z0 + k], counts[k]);
    }
    __syncthreads();  // the next window clears the counters
  }
}

__global__ void __launch_bounds__(THREADS)
    cosim_step_kernel(const int8_t* __restrict__ prop_on, const int32_t* __restrict__ zone,
                      const uint8_t* __restrict__ reach, const int8_t* __restrict__ ovr_mask,
                      const int32_t* __restrict__ ovr_c1, const int32_t* __restrict__ forged_cnt,
                      int32_t* __restrict__ commit, const int32_t* __restrict__ a, int n, int Z,
                      int n_live, int f, int8_t* __restrict__ accepted, int8_t* __restrict__ nondef,
                      int8_t* __restrict__ dec_fail) {
  __shared__ int32_t s_a[BINS];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const bool in = i < n;
  int p = 0;
  int zp = 0;
  if (in) {
    p = prop_on[i];
    zp = min(max(zone[i], 0), Z - 1);
  }
  uint32_t dot = 0;
  for (int z0 = 0; z0 < Z; z0 += BINS) {
    const int w = min(BINS, Z - z0);
    __syncthreads();  // the previous window has been read
    for (int k = threadIdx.x; k < w; k += THREADS) s_a[k] = a[z0 + k];
    __syncthreads();
    if (p != 0) {
      const uint8_t* row = reach + static_cast<int64_t>(zp) * Z + z0;
      for (int k = 0; k < w; ++k) dot += static_cast<uint32_t>(row[k]) * static_cast<uint32_t>(s_a[k]);
    }
  }
  if (!in) return;
  const int32_t c1_base = static_cast<int32_t>(static_cast<uint32_t>(p) * dot);
  const int32_t c1 = ovr_mask[i] != 0 ? ovr_c1[i] : c1_base;
  const int32_t c0 = static_cast<int32_t>(static_cast<uint32_t>(n_live) - static_cast<uint32_t>(c1));
  const int32_t lift1 = c1 >= f + 1 ? n_live : c1;
  const int32_t lift0 = c0 >= f + 1 ? n_live : c0;
  const bool bin1 = lift1 >= 2 * f + 1;
  const bool bin0 = lift0 >= 2 * f + 1;
  const bool pos = c1 > 0;
  const bool neg = c0 > 0;
  const bool has1 = (pos && bin1) || (pos && !bin1 && !bin0) || (neg && !bin0);
  const bool has0 = (neg && bin0) || (pos && !bin1 && bin0);
  const int32_t valid =
      static_cast<int32_t>(static_cast<uint32_t>(n_live) - static_cast<uint32_t>(forged_cnt[i]));
  accepted[i] = has1;
  nondef[i] = has1 && has0;
  dec_fail[i] = has1 && valid <= f;
  commit[i] = static_cast<int32_t>(static_cast<uint32_t>(commit[i]) + (has1 ? 1u : 0u));
}

}  // namespace

extern "C" {

// a[0..Z) = the zone histogram of dst_on over n rows, on `stream` (a[] is
// zeroed there first).  Z ≥ 1; n ≥ 0.  No sync.  Returns 0 or a
// cudaError_t (the memset's, or the launch's cudaGetLastError()).
int cosim_hist_launch(const void* dst_on, const void* zone, int n, int Z, void* a, void* stream) {
  if (Z < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(a, 0, sizeof(int32_t) * static_cast<size_t>(Z), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (n == 0) return 0;
  const int64_t per_block = static_cast<int64_t>(THREADS) * ROWS;
  const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  cosim_hist_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const int8_t*>(dst_on),
                                               static_cast<const int32_t*>(zone), n, Z,
                                               static_cast<int32_t*>(a));
  return static_cast<int>(cudaGetLastError());
}

// The decision for n instances given the histogram a[0..Z) and reach
// [Z, Z] u8 (row-major), on `stream`; commit[] is updated in place and
// the three masks written as 0/1 int8.  No sync.  Returns 0 or a
// cudaError_t.
int cosim_step_launch(const void* prop_on, const void* zone, const void* reach,
                      const void* ovr_mask, const void* ovr_c1, const void* forged_cnt,
                      void* commit, const void* a, int n, int Z, int n_live, int f,
                      void* accepted, void* nondef, void* dec_fail, void* stream) {
  if (Z < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(n) + THREADS - 1) / THREADS);
  cosim_step_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(prop_on), static_cast<const int32_t*>(zone),
      static_cast<const uint8_t*>(reach), static_cast<const int8_t*>(ovr_mask),
      static_cast<const int32_t*>(ovr_c1), static_cast<const int32_t*>(forged_cnt),
      static_cast<int32_t*>(commit), static_cast<const int32_t*>(a), n, Z, n_live, f,
      static_cast<int8_t*>(accepted), static_cast<int8_t*>(nondef),
      static_cast<int8_t*>(dec_fail));
  return static_cast<int>(cudaGetLastError());
}

const char* cosim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
