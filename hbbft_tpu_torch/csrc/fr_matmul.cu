// fr_matmul.cu — Fr matrix product mod r on Hopper's int8 tensor cores: the
// DKG's dealing plane.
//
// Replaces no Pallas kernel: it replaces an XLA program of the reference,
// hbbft_tpu/ops/fr_jax.py:_matmul_limbs (with _add_limbs, and the fold of
// _sample_limbs), a jitted dot_general over 33 u8 limbs with int32
// accumulation followed by a carry scan and three folds.  It was added
// because at N = 1024 that program is the era change's entire compute:
// per dealer ROWS = POW[:681]·C ([681, 341]·[341, 341]) and
// VAL = ROWS[:341]·POWᵀ ([341, 341]·[341, 1023]), 1,023 dealers,
// 2.0·10¹¹ Fr multiply-adds in all.
//
//   out[m, p] = (acc[m, p] + Σ_k A[m, k]·B[k, p]) mod r
//
// A, B, acc: 32 little-endian bytes an element (any value < 2^256), out
// canonical 8 × 32-bit words.  The kernel takes A and B as byte planes,
// laid out by fr_planes_kernel below (ops/fr.py:fr_planes):
//
//   A'[(m, x), k] = byte x of A[m, k]    [32·M, K]
//   B'[(p, y), k] = byte y of B[k, p]    [32·P, K]
//
// so that C' = A'·B'ᵀ is an ordinary u8 × u8 → s32 matrix product of
// 1,024·M·K·P multiply-adds, and output (m, p) is the exact integer
// acc + Σ_q S_q·2^(8q) with S_q = Σ_{x+y=q} C'[(m, x), (p, y)], the
// diagonal sums of its 32 × 32 block.  fr_words.cuh has the arithmetic and
// the exactness argument (every S_q < 2^31 at k ≤ 971: no s32 accumulator
// or partial sum wraps), the conversion of the S_q into 17 words and the
// one reduction mod r.
//
// What bounds it on the card: the tensor cores, 1,024 u8 products an Fr
// multiply-add at 989·10¹² a second.  The planes are the words' bytes
// transposed (padded to whole tiles), and each tile reads its blocks from
// L2, which holds the dealing's operands; the reduction is a few hundred
// integer instructions an output against an output's 11 k-steps of 1,024
// products.  What holds it back (PERF.md): the loads from L2 and the
// tensor cores run about even in the main loop, and the diagonal sums,
// formed by the consumer warps between tiles, add about 40 % to it.
//
// Design.  A persistent block on every SM walks over output tiles of 4 Fr
// rows × 8 Fr columns (a 128 × 256 tile of C'), K padded to a multiple of
// 32 with zeros.  fr_planes_kernel writes each tile's planes in the order
// the tensor cores read them (wgmma's K-major layout without swizzle: 8
// rows × 16 bytes of k, 128 contiguous bytes, per core matrix), so one
// k-step of a tile is one contiguous 4 KB block of A' and one of 8 KB of B',
// and the padding of M, P and K is zeros there: the kernel reads no edge.
// The warps split the work:
//  - one producer thread (warp 8) copies each k-step's two blocks into a
//    ring of STAGES stages with the bulk copy engine (cp.async.bulk, one
//    mbarrier a stage counting the bytes), ahead of
//  - two consumer warpgroups (warps 0-7), each issuing one
//    wgmma.m64n256k32.s32.u8.u8 a k-step on its 64 plane rows (2 Fr rows)
//    against the stage's 256 plane columns, accumulating in 128 s32
//    registers a thread.  After a tile's last k-step each warp forms its
//    diagonal sums.  Thread (g, t) = lane 4g + t of warp (warpgroup wg,
//    ww = 2i + u) holds plane rows 16u + g + {0, 8} of Fr row 2wg + i and
//    plane columns 8c + 2t + {0, 1} of every Fr column; the planes put
//    bytes 4g + 2h + u of A and t + 8c + 4e of B there, so every register
//    holds byte position lane + u + δ, δ = 8c + 2h + 4e fixed by the
//    register.  Sixteen rotations (__shfl_sync from lane − δ mod 32) leave
//    each lane the sums at its positions lane + u and lane + 32 + u, which
//    it stores in a shared tile of sums; then
//  - two reducer warps (warps 9, 10), one lane an output, add the two
//    warps' sums of each position, convert the 63 S_q and acc into 17
//    words and reduce them once (fr_words.cuh), and store canonical words,
//    while the consumers run the next tile.  SBUF tiles of sums are in
//    flight between them, again through mbarriers.
// When M ≤ 2 (the λ row, the sampler's fold) the lower half of every A
// tile would be padding: the tile pairs up instead, both warpgroups on A's
// first 64 plane rows against two B tiles in alternate stages, 2 Fr rows
// × 16 Fr columns a tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr_words.cuh"
#include "wgmma_u8.cuh"

namespace {

constexpr int TILE_FR_M = 4;                      // Fr rows a tile
constexpr int TILE_FR_N = 8;                      // Fr columns a tile
constexpr int TILE_OUTS = TILE_FR_M * TILE_FR_N;  // outputs a tile
constexpr int BM = 32 * TILE_FR_M;                // plane rows a tile
constexpr int BN = 32 * TILE_FR_N;                // plane columns a tile
constexpr int BK = 32;                            // bytes of k a stage: one k-step
constexpr int A_STAGE = BM * BK;                  // 4,096 bytes
constexpr int B_STAGE = BN * BK;                  // 8,192 bytes
constexpr int STAGES = 12;
constexpr int SBUF = 2;                           // tiles of sums in flight
constexpr int SPAD = TILE_OUTS + 1;               // a sum row, padded off the banks
constexpr int S_HALF = 64 * SPAD;                 // one warp's 64 positions
constexpr int ACC_REGS = WGMMA_N256_REGS;        // s32 accumulators a consumer thread
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_WARP = CONSUMER_WARPS;
constexpr int REDUCER_WARPS = 2;
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1 + REDUCER_WARPS);

struct Smem {
  uint8_t a[STAGES][A_STAGE];
  uint8_t b[STAGES][B_STAGE];
  uint32_t s[SBUF][2 * S_HALF];  // [u][position][output]
  uint64_t full[STAGES], empty[STAGES], sfull[SBUF], sempty[SBUF];
};

__global__ void __launch_bounds__(THREADS, 1)
fr_matmul_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                 const uint4* __restrict__ ACC, uint4* __restrict__ OUT, int M, int P, int KS,
                 int NT, int tiles) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Paired tiles when M ≤ 2 (a warpgroup's 64 plane rows hold 2 Fr rows):
  // the warpgroups take the same A rows against two B tiles, each in its
  // own stage (warpgroup w the w-th of each pair of stages), so that a
  // block's tile holds 2 Fr rows × 16 Fr columns.  Otherwise a tile is 4 Fr
  // rows × 8 Fr columns, both warpgroups on every stage.
  const bool pair = M <= 2;
  const int NTP = pair ? (NT + 1) / 2 : NT;  // tiles along P
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], pair ? CONSUMER_WARPS / 2 : CONSUMER_WARPS);
    }
    for (int s = 0; s < SBUF; ++s) {
      mbar_init(&sm.sfull[s], 32 * CONSUMER_WARPS);
      mbar_init(&sm.sempty[s], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < CONSUMER_WARPS) {
    // warpgroup wg: plane rows 64·wg.. of the tile, Fr rows 2·wg, 2·wg + 1;
    // warp ww of it: Fr row i4, plane rows 16u..16u + 15 of that Fr row
    const int wg = warp / 4, ww = warp % 4;
    const int i4 = 2 * wg + (ww >> 1), u = ww & 1;
    const int mine = pair ? wg : 0, step = pair ? 2 : 1;
    uint32_t d[ACC_REGS];
#pragma unroll
    for (int i = 0; i < ACC_REGS; ++i) d[i] = 0u;
    int stage = 0;
    uint32_t phase = 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
      int prev = 0;
      for (int ks = 0; ks < KS; ++ks) {
        const int st = stage + mine;  // stage is even when paired
        mbar_wait(&sm.full[st], phase);
        // core matrices of a stage: [row / 8][k / 16], 128 bytes each
        const uint64_t da = smem_desc(sm.a[st] + (pair ? 0 : wg * 64 * BK), 128, 256);
        const uint64_t db = smem_desc(sm.b[st], 128, 256);
        fence_acc(d);
        wgmma_fence();
        wgmma_u8(d, da, db, ks > 0);
        wgmma_commit();
        if (ks > 0) {
          // the previous k-step is done with its stage
          wgmma_wait<1>();
          fence_acc(d);
          if (lane == 0) mbar_arrive(&sm.empty[prev]);
        }
        prev = st;
        if ((stage += step) == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(&sm.empty[prev]);

      // diagonal sums of this warp's 16 plane rows, Fr column by Fr column:
      // register 16j + v of lane l holds byte position l + u + δ_v, so lane
      // l gathers register v of lane l − δ_v (mod 32), its positions l + u
      // and, where l < δ_v, l + 32 + u (hi)
      const int sb = it % SBUF;
      mbar_wait(&sm.sempty[sb], ((it / SBUF) & 1) ^ 1);
      uint32_t* S = sm.s[sb] + u * S_HALF;
      const int mt = tile / NTP, nt = tile % NTP;
      const bool row_live = mt * TILE_FR_M + (pair ? i4 & 1 : i4) < M;
      const int p0 = (pair ? 2 * nt + wg : nt) * TILE_FR_N;
#pragma unroll
      for (int j = 0; j < TILE_FR_N; ++j) {
        if (row_live && p0 + j < P) {
          uint32_t all = 0, hi = 0;
#pragma unroll
          for (int v = 0; v < 16; ++v) {
            // register v = 4c + 2h + e: row g + 8h, column 8c + 2t + e of the
            // Fr column's 32, byte 4g + 2h + u of A's element times byte
            // t + 8c + 4e of B's (fr_planes): δ_v = 8c + 2h + 4e
            const int delta = 8 * (v >> 2) + 2 * ((v >> 1) & 1) + 4 * (v & 1);
            const int src = lane - delta;  // the shuffle takes it mod 32
            const uint32_t x = __shfl_sync(0xffffffffu, d[16 * j + v], src);
            all += x;
            hi += x & (uint32_t)(src >> 31);
          }
          const int out = i4 * TILE_FR_N + j;
          S[(lane + u) * SPAD + out] = all - hi;
          if (lane < 30) S[(lane + 32 + u) * SPAD + out] = hi;
        }
      }
      mbar_arrive(&sm.sfull[sb]);
    }
  } else if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mt = tile / NTP, nt = tile % NTP;
        const uint8_t* a = A + (size_t)mt * KS * A_STAGE;
        for (int ks = 0; ks < KS; ++ks) {
          for (int w = 0; w < (pair ? 2 : 1); ++w) {
            // a paired tile's second B tile may lie past P: its stage then
            // keeps old bytes, and the reducers store none of its outputs
            const int bt = pair ? 2 * nt + w : nt;
            const uint32_t bytes = bt < NT ? A_STAGE + B_STAGE : A_STAGE;
            mbar_wait(&sm.empty[stage], phase ^ 1);
            mbar_expect_tx(&sm.full[stage], bytes);
            bulk_load(sm.a[stage], a + (size_t)ks * A_STAGE, A_STAGE, &sm.full[stage]);
            if (bt < NT) {
              bulk_load(sm.b[stage], B + ((size_t)bt * KS + ks) * B_STAGE, B_STAGE,
                        &sm.full[stage]);
            }
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // reducer r takes the block's tiles r, r + REDUCER_WARPS, ...; lane =
    // output 16·wg + 8·i + j: warpgroup wg's Fr row i, Fr column j
    const int r = warp - PRODUCER_WARP - 1;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
      if (it % REDUCER_WARPS != r) continue;
      const int sb = it % SBUF;
      mbar_wait(&sm.sfull[sb], (it / SBUF) & 1);
      const uint32_t* S = sm.s[sb];
      // warp u = 0 wrote positions 0..61, u = 1 positions 1..62
      uint32_t pos[FR_POS];
#pragma unroll
      for (int q = 0; q < FR_POS; ++q) {
        pos[q] = (q <= 61 ? S[q * SPAD + lane] : 0u) +
                 (q >= 1 && q <= 62 ? S[S_HALF + q * SPAD + lane] : 0u);
      }
      mbar_arrive(&sm.sempty[sb]);
      const int mt = tile / NTP, nt = tile % NTP;
      const int wg = lane >> 4, i = (lane >> 3) & 1;
      const int m = mt * TILE_FR_M + (pair ? i : 2 * wg + i);
      const int p = (pair ? 2 * nt + wg : nt) * TILE_FR_N + (lane & 7);
      if (m < M && p < P) {
        const size_t o = ((size_t)m * P + p) * 2;
        FrSum s;
        if (ACC != nullptr) {
          const uint4 lo = ACC[o], hi = ACC[o + 1];
          const uint32_t acc[FR_W] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          fr_sum_positions(s, pos, acc);
        } else {
          fr_sum_positions(s, pos, nullptr);
        }
        uint32_t res[FR_W];
        fr_sum_reduce(s, res);
        OUT[o] = make_uint4(res[0], res[1], res[2], res[3]);
        OUT[o + 1] = make_uint4(res[4], res[5], res[6], res[7]);
      }
    }
  }
}

// Byte planes (ops/fr.py:fr_planes): one block a (tile, k-step) of FT Fr
// elements, A's side (FT = 4) or B's (FT = 8), in wgmma's K-major
// core-matrix order, one uint4 of output a thread.  The block
// stages its 32 k × FT elements × 32 bytes in shared memory (coalesced
// uint4 loads, zero past F and K) and gathers each output's 16 bytes of k.
template <int FT, bool A_SIDE>
__global__ void __launch_bounds__(FT * 64)
fr_planes_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, int F, int K, int KS) {
  __shared__ uint8_t st[BK][FT][32];  // [k][element][byte]
  const int tile = blockIdx.x / KS, ks = blockIdx.x % KS;
  const int tid = threadIdx.x, h = tid & 1;
  // A's k steps of one element are adjacent in memory, B's elements of one k
  const int f = A_SIDE ? (tid >> 1) / BK : (tid >> 1) % FT;
  const int kk = A_SIDE ? (tid >> 1) % BK : (tid >> 1) / FT;
  const int e = tile * FT + f, k = ks * BK + kk;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (e < F && k < K) v = src[(A_SIDE ? (size_t)e * K + k : (size_t)k * F + e) * 2 + h];
  *reinterpret_cast<uint4*>(&st[kk][f][16 * h]) = v;
  __syncthreads();
  // output uint4 tid: element ft, plane row n = 8·g8 + r8 of it, k // 16 = kc
  const int r8 = tid & 7, kc = (tid >> 3) & 1, g8 = (tid >> 4) & 3, ft = tid >> 6;
  const int n = 8 * g8 + r8;
  // A's plane row n = 16u + 8h + g holds byte 4g + 2h + u, B's n = 8c + 2t + e
  // byte t + 8c + 4e (the consumers' diagonal sums rely on both)
  const int y = A_SIDE ? 4 * (n & 7) + 2 * ((n >> 3) & 1) + (n >> 4)
                       : ((n >> 1) & 3) + 8 * (n >> 3) + 4 * (n & 1);
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k0 = 16 * kc + 4 * q;
    w[q] = (uint32_t)st[k0][ft][y] | (uint32_t)st[k0 + 1][ft][y] << 8 |
           (uint32_t)st[k0 + 2][ft][y] << 16 | (uint32_t)st[k0 + 3][ft][y] << 24;
  }
  dst[(size_t)blockIdx.x * (FT * 64) + tid] = make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace

extern "C" {

// a, b: A's and B's byte planes (fr_planes_launch) for an [M, K]·[K, P]
// product; acc [M, P, 8] int32 words (or null) and out [M, P, 8], contiguous
// on the current device.  Launches one block an SM (at most one a tile) on
// `stream` and returns the first CUDA error (0 on success).
int fr_matmul_launch(const void* a, const void* b, const void* acc, void* out, int M, int K,
                     int P, void* stream) {
  if (M <= 0 || P <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fr_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int KS = (K + BK - 1) / BK > 0 ? (K + BK - 1) / BK : 1;
  const int MT = (M + TILE_FR_M - 1) / TILE_FR_M, NT = (P + TILE_FR_N - 1) / TILE_FR_N;
  const long long tiles = (long long)MT * (M <= 2 ? (NT + 1) / 2 : NT);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);  // an int tile index
  const int grid = tiles < sms ? (int)tiles : sms;
  fr_matmul_kernel<<<grid, THREADS, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const uint4*>(acc), static_cast<uint4*>(out), M, P, KS, NT, (int)tiles);
  return static_cast<int>(cudaGetLastError());
}

// src [F, K, 8] (A side: a's words) or [K, F, 8] (B side: b's words) int32,
// contiguous on 16-byte boundaries; dst the planes, ⌈F/FT⌉ tiles × ⌈K/32⌉
// (at least 1) steps × FT·1,024 bytes (FT = 4 for A, 8 for B).  Launches on
// `stream`; returns cudaGetLastError() (0 on success).
int fr_planes_launch(const void* src, void* dst, int F, int K, int a_side, void* stream) {
  if (F <= 0) return 0;
  const int KS = (K + BK - 1) / BK > 0 ? (K + BK - 1) / BK : 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  const int ft = a_side ? TILE_FR_M : TILE_FR_N;
  const long long blocks = (long long)((F + ft - 1) / ft) * KS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (a_side) {
    fr_planes_kernel<TILE_FR_M, true><<<(unsigned)blocks, TILE_FR_M * 64, 0, st>>>(s, d, F, K, KS);
  } else {
    fr_planes_kernel<TILE_FR_N, false><<<(unsigned)blocks, TILE_FR_N * 64, 0, st>>>(s, d, F, K, KS);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fr_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
