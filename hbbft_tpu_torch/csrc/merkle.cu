// merkle.cu — a forest of SHA-256 Merkle trees in one launch, for Hopper.
//
// Replaces no Pallas kernel: the reference builds each reliable-broadcast
// Merkle tree as an XLA program, hbbft_tpu/ops/sha256_jax.py
// merkle_levels_device (:147), one batched SHA-256 of the padded leaves
// (sha256_device, :90, over _compress, :57) and then one such batch a
// level, every level copied to the host and back.  Here one launch builds
// T trees of n uniform leaves of `len` bytes each:
//
//   leaf i = SHA-256(0x00 ‖ i as 8 big-endian bytes ‖ value_i)
//   node   = SHA-256(0x01 ‖ left ‖ right)
//
// and an odd level repeats its last hash (crypto/merkle.py's layout: the
// repeated hash is a row of that level), so a tree of n leaves has
// R = Σ level_sizes(n) rows (ops/sha256.py:level_sizes).
//
// Design.  One block a tree.  Its threads hash the leaves, building each
// leaf's message and padding in registers from the raw values ([T, n,
// len] bytes on the card) with sha256.cuh's hash_message<9>, the code
// sha256.cu's raw entry runs (aligned 32-bit loads and byte permutes, the
// next block's loads ahead of each compression), one thread a leaf, a
// multi-block leaf one thread's chain of compressions.  The tree's rows stay in shared memory (a 1,024-leaf
// tree's 2,047 rows take 64 KB; up to 7,264 rows, ~3,600 leaves, fit a
// block's 227 KB), and each level is built from the one below after a
// __syncthreads, one thread a parent.  At the end the block writes, with
// coalesced 16-byte stores, either every row (the levels, for trees whose
// proofs or levels are read) or only the root (roots_only).  A tree too
// large for shared memory keeps its rows in global memory instead (the
// output itself, or a scratch buffer for roots_only): the same code on a
// global pointer, correct and not tuned.
//
// What bounds it on the card: 32-bit integer operations, the leaves'
// compressions (one a leaf of up to 46 value bytes) and two a parent, at
// the int32 issue rate (chip_smoke.py's forest_bound), or the values read
// and rows written.  A level's parents halve, so the upper levels of a
// tree run few threads; a forest of hundreds of trees fills the card with
// trees instead.
//
// Words are int32 bit patterns of the digests' big-endian words; `out`
// and `scratch` are 16-byte aligned (ops/sha256.py sees to it).

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int FOREST_THREADS = 256;
// the most dynamic shared memory a block can use on an H100
constexpr int FOREST_SMEM_MAX = 232448;

// SHA-256(0x01 ‖ l ‖ r): the 65-byte message's first block is 0x01 and the
// children shifted by one byte, its second r's last byte, 0x80 and the
// bit length 520.
__device__ __forceinline__ void hash_node(uint32_t s[8], const uint32_t* l, const uint32_t* r) {
  uint32_t d[16];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 a = reinterpret_cast<const uint4*>(l)[q];
    const uint4 b = reinterpret_cast<const uint4*>(r)[q];
    d[4 * q] = a.x; d[4 * q + 1] = a.y; d[4 * q + 2] = a.z; d[4 * q + 3] = a.w;
    d[8 + 4 * q] = b.x; d[9 + 4 * q] = b.y; d[10 + 4 * q] = b.z; d[11 + 4 * q] = b.w;
  }
  uint32_t w[16];
  w[0] = 0x01000000u | (d[0] >> 8);
#pragma unroll
  for (int j = 1; j < 16; ++j) w[j] = (d[j - 1] << 24) | (d[j] >> 8);
  init_state(s);
  compress(s, w);
  w[0] = (d[15] << 24) | 0x00800000u;
#pragma unroll
  for (int j = 1; j < 15; ++j) w[j] = 0;
  w[15] = 65 * 8;
  compress(s, w);
}

// One tree, by the nthreads threads of a block (thread tid): the leaves of
// values v ([n, len] bytes), then level after level, into `store` (its R
// rows of 8 words, leaves first); the root is its last row.  Every thread
// of the block calls it: it meets at __syncthreads between levels and
// before it returns.
__device__ void forest_tree(const uint8_t* __restrict__ v, int n, int len, uint32_t* store,
                            int tid, int nthreads) {
  for (int i = tid; i < n; i += nthreads) {
    uint32_t s[8];
    hash_message<9>(s, v + (size_t)i * len, len, (uint32_t)i);
    store_digest(s, store + (size_t)i * 8);
  }
  int lo = 0, cnt = n;
  while (cnt > 1) {
    __syncthreads();  // the level below is whole
    const int rows = cnt + (cnt & 1), parents = rows / 2, next = lo + rows;
    // an odd level's repeated last hash (the last parent reads the
    // original, so nothing waits for this copy)
    if ((cnt & 1) && tid < 8)
      store[(size_t)(lo + cnt) * 8 + tid] = store[(size_t)(lo + cnt - 1) * 8 + tid];
    for (int p = tid; p < parents; p += nthreads) {
      const int right = 2 * p + 1 < cnt ? 2 * p + 1 : cnt - 1;
      uint32_t s[8];
      hash_node(s, store + (size_t)(lo + 2 * p) * 8, store + (size_t)(lo + right) * 8);
      store_digest(s, store + (size_t)(next + p) * 8);
    }
    lo = next;
    cnt = parents;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(FOREST_THREADS)
merkle_forest_kernel(const uint8_t* __restrict__ values, uint32_t* out, uint32_t* scratch, int n,
                     int len, int rows, int roots_only, int in_smem) {
  extern __shared__ __align__(16) uint32_t tree_smem[];
  const size_t t = blockIdx.x;
  uint32_t* store = in_smem ? tree_smem : (roots_only ? scratch : out) + t * rows * 8;
  forest_tree(values + t * n * (size_t)len, n, len, store, threadIdx.x, blockDim.x);
  if (roots_only) {
    if (threadIdx.x < 8) out[t * 8 + threadIdx.x] = store[(size_t)(rows - 1) * 8 + threadIdx.x];
  } else if (in_smem) {
    const uint4* src = reinterpret_cast<const uint4*>(store);
    uint4* dst = reinterpret_cast<uint4*>(out + t * rows * 8);
    for (int q = threadIdx.x; q < 2 * rows; q += blockDim.x) dst[q] = src[q];
  }
}

}  // namespace

extern "C" {

// values [T, n, len] bytes (len ≥ 0, n ≥ 1), contiguous on the current
// device; out [T, rows, 8] int32 words (every level, rows =
// Σ level_sizes(n)) or, with roots_only, [T, 8] (the roots); scratch
// [T, rows, 8] when roots_only and a tree's rows exceed shared memory
// (rows·32 > 232,448 bytes), else unused.  One block a tree, on `stream`;
// returns the first CUDA error (0 on success).
int merkle_forest_launch(const void* values, void* out, void* scratch, int T, int n, int len,
                         int rows, int roots_only, void* stream) {
  if (T <= 0) return 0;
  if (n < 1 || len < 0 || rows < n) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)rows * 32;
  const int in_smem = smem <= (size_t)FOREST_SMEM_MAX;
  if (!in_smem && roots_only && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (in_smem && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merkle_forest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = n >= FOREST_THREADS ? FOREST_THREADS : (n + 31) / 32 * 32;
  merkle_forest_kernel<<<T, threads, in_smem ? smem : 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(scratch), n, len, rows, roots_only, in_smem);
  return static_cast<int>(cudaGetLastError());
}

const char* merkle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
