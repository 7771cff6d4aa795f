// gf_matmul.cu — a constant GF(2^W) matrix times a symbol matrix, W = 8
// or 16, on Hopper's int8 tensor cores.
//
// Replaces no Pallas kernel: the reference runs its Reed–Solomon products
// as XLA programs, hbbft_tpu/ops/gf256_jax.py _bitsliced_matmul (:78, via
// gf_matmul_device :92) and _bitsliced_matmul16 (:219, via
// gf16_matmul_device :225).  Multiplication by a constant is GF(2)-linear
// in the input bits, so a constant [m, k] matrix M becomes a binary
// [W·m, W·k] matrix A_bin (row W·i + r, column W·j + b: bit r of
// M[i, j]·2^b; ops/gf256.py's _binary_matrix{,16} order), and
//
//     y_bits = (A_bin · x_bits) mod 2,   x_bits[W·j + b, c] = bit b of x[j, c],
//
// an integer product whose sums (at most W·k ≤ 5,472 at N = 1024) fit
// s32.  The reference runs it on the TPU's matrix unit; here it runs on
// wgmma.mma_async.m64n256k32.s32.u8.u8 (wgmma_u8.cuh, as fr_matmul.cu),
// both operands bytes of 0 or 1, as its transpose y_bitsᵀ = x_bitsᵀ·A_binᵀ.
//
// Design.  A persistent block on each SM walks over output tiles of 256
// bit rows (16 GF(2^16) or 32 GF(2^8) symbol rows) × 128 symbol columns,
// k in steps of 32 bits:
//  - A_bin is wgmma's B operand, from shared memory.  It is constant:
//    ops/gf256.py builds it once per matrix on the card and caches it in
//    the operand's order (tiles of 256 rows, steps of 32 bits, core
//    matrices of 8 rows × 16 bytes [row / 8][k / 16], zero padded), so one
//    thread of a warp of its own copies a step's 8 KB with the bulk copy
//    engine, up to STAGES steps ahead, through a ring of mbarriers;
//  - the same thread copies the step's data beside it: the 32 bits of k of
//    the tile's 128 columns are 2 rows of GF(2^16) symbols or 4 of GF(2^8),
//    512 bytes (the wrapper pads the data's rows to 16 bytes, so each row's
//    slice is one bulk copy), counted on the same mbarrier;
//  - x_bits is wgmma's A operand, from registers: each consumer warpgroup
//    takes 64 of the tile's columns, and each thread holds its fragment,
//    4 registers of 4 bytes of 0 or 1 (two columns × 8 bits of the step's
//    32; CUTLASS's ALayout_64x32), built from 4 symbols that it reads from
//    the stage.  No thread writes an operand to shared memory, so no proxy
//    fence stands between the data and the tensor cores, and each tile
//    makes the bits of its own steps only.  The symbols come through
//    shared memory because a register whose global load is outstanding
//    holds up the warp's next product (PERF.md);
//  - the two consumer warpgroups each issue one m64n256k32 a step and
//    free the step's stage once the next step's product is issued (the
//    fragments alternate between two register sets, each rewritten only
//    after the product that read it is done);
//  - the epilogue takes each accumulator's parity and packs a symbol's W
//    bits: thread (g, t) holds bits 8c + 2t + e of the tile's bit rows for
//    columns g and g + 8 of its warp's 16, so two xor-shuffles OR the
//    bits of a pair of blocks c together, and lane t stores the pairs of
//    index ≡ t (mod 4).  The s32 product never reaches global memory.
// Ragged edges: A_bin's padding rows and columns are zero, x_bits past k
// and n are zero, and the epilogue stores no symbol past m or n.
//
// What bounds it on the card: the tensor cores, (W·m)·(W·k)·n u8
// multiply-adds at 989·10¹² a second (chip_smoke.py's gf_bound takes the
// smaller of that and the XOR count of the bit-sliced form), or for a
// thin product the bytes.  A step reads 8 KB of A_bin (from L2 but for
// the first column tile of a row: the tiles of one row run side by side)
// and 512 bytes of data for 2^20 multiply-adds.  What holds it back
// (PERF.md; scripts/torch_gf_sweep.py): at the N = 1024 parity the
// copies and fragments alone take 0.106 ms and A_bin's copies with the
// products 0.083 ms of the 0.157 ms, overlapping only in part; a thin
// product (7 tiles) runs ~0.3 µs a step, two products in flight.
//
// The scalar parts (the fragments, the epilogue) come first and use no
// PTX: tests/test_torch_rbc_host.py compiles them for the host and runs
// them around a scalar product that reads the fragments where wgmma's
// register layout places them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 256;           // bit rows of A_bin a tile: wgmma's N
constexpr int BN = 128;           // symbol columns a tile: two warpgroups of 64
constexpr int BK = 32;            // bits of k a step
constexpr int A_STAGE = BM * BK;  // 8,192 bytes
constexpr int X_STAGE = BN * BK / 8;  // the data's 32 bits of k of BN columns: 512 bytes
constexpr int STAGES = 12;
constexpr int CONSUMER_WARPS = 8;
constexpr int COPY_WARP = CONSUMER_WARPS;  // A_bin's bulk copies
constexpr int THREADS = 32 * (COPY_WARP + 1);
constexpr int ACC = 128;          // s32 accumulators a consumer thread

// Data row r's slice for the column tile nt in a step's stage: its byte
// offset in the row (returned in off) and length, 0 past k rows or the
// padded row.  A step's rows are W·ks / 8 .. + 32 / W − 1, each BN·W/8
// bytes of the stage.
template <int W>
__device__ __forceinline__ int x_span(int r, int k, int xs, int nt, int& off) {
  off = nt * BN * (W / 8);
  if (r >= k || off >= xs) return 0;
  return xs - off < BN * (W / 8) ? xs - off : BN * (W / 8);
}

// The four symbols thread (warp, lane) = (4·wg + ww, 4g + t) needs for
// k-step ks of the column tile starting at col0, from the step's stage xst
// (rows 32/W·ks + rr, rr < 32/W, each BN·W/8 bytes): rows rr0 and rr1 at
// its two columns 64·wg + 16·ww + g and that + 8 of the tile (W = 16:
// rr0 = 0, rr1 = 1, the step's bits 0..15 and 16..31; W = 8: rr0 = t / 2,
// rr1 = rr0 + 2, the symbols that hold bits 4t .. 4t + 3 and 16 + 4t .. of
// the step).  v[0] = (rr0, low column), v[1] = (rr0, high), v[2] = (rr1,
// low), v[3] = (rr1, high); zero past k rows and the padded row (x_span's
// slices), which the stage does not hold.
template <int W>
__device__ __forceinline__ void stage_symbols(uint32_t (&v)[4], const uint8_t* xst, int k, int xs,
                                              int col0, int ks, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int c = 16 * warp + g;  // 64·wg + 16·ww = 16·warp
  const int rr0 = W == 16 ? 0 : t >> 1, rr1 = W == 16 ? 1 : rr0 + 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = i < 2 ? rr0 : rr1, cl = c + 8 * (i & 1);
    const uint8_t* row = xst + rr * (BN * W / 8);
    uint32_t s = 0u;
    if ((BK / W) * ks + rr < k && (col0 + cl) * (W / 8) < xs)
      s = W == 16 ? reinterpret_cast<const uint16_t*>(row)[cl] : row[cl];
    v[i] = s;
  }
}

// Four bits → four bytes of 0 or 1 (bit q in byte q): the product spreads
// the nibble's bits to 0, 7, 14 and 21 places up, no two of them on one
// bit, and the mask keeps bit q at 8q.
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t v) {
  return ((v & 0xFu) * 0x00204081u) & 0x01010101u;
}

// Thread (g, t)'s fragment of x_bitsᵀ for a step from its four symbols:
// a[i] holds k 4t + 16·(i / 2) .. + 3 of column g + 8·(i % 2), i.e.
// nibble t (W = 16) or t % 2 (W = 8) of v[i].
template <int W>
__device__ __forceinline__ void fragment(uint32_t (&a)[4], const uint32_t (&v)[4], int lane) {
  const int sh = 4 * (W == 16 ? (lane & 3) : (lane & 1));
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = nibble_bytes(v[i] >> sh);
}

// A consumer warp's epilogue: the parities of its accumulators
// (d[4c + 2h + e] = column 16·ww + g + 8h of its warpgroup's 64, bit row
// 8c + 2t + e of the tile), packed into symbols and stored.  row0: the
// tile's first bit row; col: the thread's column of h = 0.  Blocks c = 2P
// and 2P + 1 make a 32-bit word: for W = 16 symbol row P of columns h = 0
// (low half) and 1; for W = 8 symbol rows 2P (low half) and 2P + 1, each
// half the two columns' bytes.
template <int W>
__device__ __forceinline__ void pack_store(const uint32_t (&d)[ACC], int lane, int row0, int col,
                                           void* y, int m, int n) {
  const int t = lane & 3;
#pragma unroll
  for (int P = 0; P < BM / 16; ++P) {
    uint32_t w = 0;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at = (W == 16 ? 16 * h + 8 * p : 16 * p + 8 * h) + 2 * t + e;
          w |= (d[4 * (2 * P + p) + 2 * h + e] & 1u) << at;
        }
    w |= __shfl_xor_sync(0xffffffffu, w, 1);
    w |= __shfl_xor_sync(0xffffffffu, w, 2);
    if (t != (P & 3)) continue;
    if (W == 16) {
      const int i = row0 / 16 + P;
      if (i >= m) continue;
      uint16_t* y16 = static_cast<uint16_t*>(y) + (size_t)i * n;
      if (col < n) y16[col] = (uint16_t)(w & 0xFFFFu);
      if (col + 8 < n) y16[col + 8] = (uint16_t)(w >> 16);
    } else {
      uint8_t* y8 = static_cast<uint8_t*>(y);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int i = row0 / 8 + 2 * P + p;
        if (i >= m) continue;
        if (col < n) y8[(size_t)i * n + col] = (uint8_t)(w >> (16 * p));
        if (col + 8 < n) y8[(size_t)i * n + col + 8] = (uint8_t)(w >> (16 * p + 8));
      }
    }
  }
}

}  // namespace

// ---- the kernel: bulk copies, mbarriers and wgmma (the card only) ----

#include "wgmma_u8.cuh"

namespace {

struct Smem {
  uint8_t a[STAGES][A_STAGE];
  uint8_t x[STAGES][X_STAGE];
  uint64_t full[STAGES], empty[STAGES];
};

// keeps a fragment's registers live, and in place, until here
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// abin: A_bin's tiles, [MT][KS][A_STAGE] bytes; x [k, xs bytes] symbols
// (uint8 or uint16, rows zero padded to 16 bytes) and y [m, n]; NT column
// tiles; tiles = MT·NT.
template <int W>
__global__ void __launch_bounds__(THREADS, 1)
gf_matmul_kernel(const uint8_t* __restrict__ abin, const uint8_t* __restrict__ x, int xs,
                 void* __restrict__ y, int m, int k, int n, int KS, int NT, int tiles) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < CONSUMER_WARPS) {
    uint32_t d[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) d[i] = 0u;
    // fragments in two sets, the even and the odd steps of a tile
    uint32_t f0[4] = {0u, 0u, 0u, 0u}, f1[4] = {0u, 0u, 0u, 0u};
    int stage = 0;
    uint32_t phase = 0;
    int prev = 0;
    // one step: its fragment from its stage's symbols, the product, and the
    // previous step's stage freed
    auto step = [&](int tile, int ks, uint32_t (&f)[4]) {
      mbar_wait(&sm.full[stage], phase);
      uint32_t v[4];
      stage_symbols<W>(v, sm.x[stage], k, xs, (tile % NT) * BN, ks, warp, lane);
      fence_frag(f);  // the product that read it finished a step ago
      fragment<W>(f, v, lane);
      const uint64_t db = smem_desc(sm.a[stage], 128, 256);
      fence_acc(d);
      wgmma_fence();
      wgmma_u8_rs(d, f, db, ks > 0);
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();
        fence_acc(d);
        if (lane == 0) mbar_arrive(&sm.empty[prev]);
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int ks = 0; ks < KS; ks += 2) {
        step(tile, ks, f0);
        if (ks + 1 < KS) step(tile, ks + 1, f1);
      }
      wgmma_wait<0>();
      fence_acc(d);
      fence_frag(f0);
      fence_frag(f1);
      if (lane == 0) mbar_arrive(&sm.empty[prev]);
      pack_store<W>(d, lane, (tile / NT) * BM, (tile % NT) * BN + 16 * warp + (lane >> 2), y, m,
                    n);
    }
  } else if (lane == 0) {
    // each stage's A_bin and data, one arrival that counts their bytes
    constexpr int XR = BK / W;  // data rows a step
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const uint8_t* a = abin + (size_t)(tile / NT) * KS * A_STAGE;
      const int nt = tile % NT;
      for (int ks = 0; ks < KS; ++ks) {
        int off[XR], len[XR], bytes = A_STAGE;
#pragma unroll
        for (int rr = 0; rr < XR; ++rr)
          bytes += len[rr] = x_span<W>(XR * ks + rr, k, xs, nt, off[rr]);
        mbar_wait(&sm.empty[stage], phase ^ 1);
        mbar_expect_tx(&sm.full[stage], bytes);
        bulk_load(sm.a[stage], a + (size_t)ks * A_STAGE, A_STAGE, &sm.full[stage]);
#pragma unroll
        for (int rr = 0; rr < XR; ++rr)
          if (len[rr])
            bulk_load(sm.x[stage] + rr * (BN * W / 8), x + (size_t)(XR * ks + rr) * xs + off[rr],
                      len[rr], &sm.full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

template <int W>
cudaError_t launch(const void* abin, const void* x, int xs, void* y, int m, int k, int n,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gf_matmul_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  const long long MT = ((long long)W * m + BM - 1) / BM, KS = ((long long)W * k + BK - 1) / BK;
  const long long NT = ((long long)n + BN - 1) / BN, tiles = MT * NT;
  if (tiles > 0x7fffffff || KS > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = tiles < sms ? (int)tiles : sms;
  gf_matmul_kernel<W><<<grid, THREADS, sizeof(Smem), stream>>>(
      static_cast<const uint8_t*>(abin), static_cast<const uint8_t*>(x), xs, y, m, k, n, (int)KS,
      (int)NT, (int)tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// w = 8 or 16; abin: A_bin's tiles as ops/gf256.py lays them out
// (⌈w·m/256⌉ × ⌈w·k/32⌉ tiles of 8,192 bytes, 16-byte aligned); x [k, n]
// symbols (uint8 for w = 8, uint16 for w = 16) in rows of xs bytes (n·w/8
// rounded up to a multiple of 16, zero padded, 16-byte aligned) and y
// [m, n] symbols, contiguous on the current device, m, k, n ≥ 1.
// Launches one block an SM (at most one a tile) on `stream` and returns
// the first CUDA error (0 on success); an unknown w, or rows of the wrong
// length, return cudaErrorInvalidValue.
int gf_matmul_launch(int w, const void* abin, const void* x, int xs, void* y, int m, int k,
                     int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xs % 16 || xs < n * (w / 8)) return static_cast<int>(cudaErrorInvalidValue);
  if (w == 8) return static_cast<int>(launch<8>(abin, x, xs, y, m, k, n, s));
  if (w == 16) return static_cast<int>(launch<16>(abin, x, xs, y, m, k, n, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* gf_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
