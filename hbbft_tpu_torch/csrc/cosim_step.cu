// cosim_step.cu — the packed co-simulation's per-epoch step: the zone
// histogram of the live receivers and every agreement instance's
// closed-form decision.  On one card the whole step is ONE cooperative
// launch (cosim_step_kernel<true>); on a mesh each shard launches
// cosim_hist_kernel, the [Z] partials meet in the ring_permute ring and an
// int32 add (parallel/mesh.py), and each shard launches the decision alone
// (cosim_step_kernel<false>).  No launch is preceded by a memset.
//
// Replaces the XLA program hbbft_tpu/parallel/mesh.py:packed_cosim_step_fn
// (:473; its body `_body` :506-534), which the TPU runs as one fused
// launch an epoch (not a Pallas kernel).  For n validators in Z geo-zones:
//
//   a[z]  = Σ_j dst_on[j]·[zone_j = z]                        (histogram)
//   c1[p] = ovr_mask[p] ? ovr_c1[p]
//                       : prop_on[p]·Σ_z reach[zone_p, z]·a[z] (decision)
//   c0    = n_live − c1, and the agreement algebra below:
//   accepted = has1, nondef = has1 & has0,
//   dec_fail = accepted & (n_live − forged_cnt ≤ f), commit += accepted.
//
// All of it is int32 arithmetic, wrapping as XLA's does (products and sums
// taken in uint32); the histogram's atomics add integers, exact in any
// order, so the result is the reference's bit for bit.  A zone outside
// [0, Z) adds nothing to the histogram (the reference's scatter drops it)
// and is clamped for its reach row (the reference's gather clamps).
//
// Work split.  A thread takes chunks of ROWS = 4 consecutive rows: one
// 16-byte load of each int32 column and one 4-byte load of each int8
// column (scalar loads for the last, partial chunk and whenever a column is
// not 16-byte aligned; nothing past row n is read or written).  A block
// takes a contiguous run of chunks, at least a warp's worth, one block an
// SM while one chunk a thread covers the rows (at n = 100,000: 25,000
// chunks over 132 blocks), and the cooperative grid's most beyond that.
// Every column of a thread's first chunk is loaded before the first use of
// any, so they cost one round trip to memory; the chunks past the first
// (an n larger than one chunk a thread) are read again, from L2.  Four
// rows a thread, not sixteen: with a warp or two an SM, each thread's
// serial instructions, not the bytes, set the time, and 8 or 16 rows a
// thread (the int8 columns in 8- or 16-byte loads) are slower
// (scripts/torch_cosim_sweep.py builds and times them; PERF.md §6).
//
// Histogram (both forms).  The block keeps BINS = 256 zone counters in
// shared memory (a larger Z in windows of 256, each a pass over the rows
// in registers).  A thread folds its run of one zone in a register; a
// warp's runs of one zone are summed across its lanes (__match_any_sync,
// __reduce_add_sync) before one shared atomic; the block adds each nonzero
// counter to a [Z] accumulator in `scratch` with one global atomic.  The
// kernels leave the scratch as they found it, so no stream operation
// zeroes anything between epochs.
//
// One card, cosim_step_kernel<true>: after its histogram each block
// crosses a grid barrier (one atomic a block on a word in scratch whose top
// bit flips when the last block arrives, the algorithm of
// cooperative_groups' grid sync, written out so that it keeps its word
// where the kernel can read its parity, with a release add and acquire
// polls in place of full fences), then
// tabulates its zones' reach-row dots with the finished [Z] histogram,
// read from L2, and decides its rows, still in registers.  The accumulator
// alternates between two [Z] buffers by the barrier word's top bit at the
// launch's start: block 0 zeroes the one this launch does not use, which
// the previous launch used and the next one will.  The launch is
// cooperative (cudaLaunchCooperativeKernel), so every block is resident
// and the barrier cannot deadlock; a grid that cannot be resident is
// refused with its cudaError_t, which the wrapper raises.
//
// A mesh shard, cosim_hist_kernel: after its histogram each block takes a
// ticket (an acquire-release atomic); the last block copies the
// accumulator into a[], zeroes it and resets the ticket.  Then cosim_step_kernel<false> decides
// given the ring-summed a[].
//
// Decision.  The block first tabulates s_dot[z] = Σ_j reach[z, j]·a[j] for
// every zone (thread z takes zone z; a[] staged in shared memory; Z² u8 of
// reach through L1, the first PRE bytes of a row loaded before a[] so that
// the two round trips overlap), BINS zones at a time; a row's yes votes are
// then its proposer flag times one shared-memory read.  The algebra is
// branch-free selects; commit is written with one 16-byte store and each
// mask with one 4-byte store.
//
// A scratch serves one stream at a time: 4 + 3·Z int32 words, zeroed once
// when it is made (ops/cosim_step.py: CosimScratch).  The barrier word
// needs its low 31 bits 0 at every launch's start, which every completed
// launch leaves.
//
// What bounds it on the card.  Bytes, nominally: an instance reads 1 + 1 +
// 4 + 1 + 4 + 4 + 4 bytes (prop_on, dst_on, zone, ovr_mask, ovr_c1,
// forged_cnt, commit) and writes 4 + 3 (commit, the three masks), 26
// bytes: 2.6 MB at n = 100,000, 0.78 µs at 3.35 TB/s, which is below what
// one launch costs on the card's timeline.  So the step is a launch, a
// round trip to memory, a grid barrier and a round trip to L2, and
// chip_smoke.py times it beside an empty kernel's launch and the barrier
// alone (cosim_probe_launch).

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <mutex>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;         // rows of a chunk: one 16-byte load of an int32 column
constexpr int WORDS = ROWS / 4;
constexpr int PRE = 8;          // reach bytes of a zone's row loaded ahead of a[]
constexpr int BINS = 256;       // zone counters a block keeps in shared memory
constexpr int MIN_CHUNKS = 32;  // a block's least share: one chunk a lane of a warp
static_assert(ROWS == 4 || ROWS == 8 || ROWS == 16, "an int8 chunk is one 4-, 8- or 16-byte load");
constexpr int MAX_DEVICES = 64;

// The scratch's int32 words: the grid barrier's word, cosim_hist's
// ticket, then the one-launch step's two [Z] accumulators and
// cosim_hist's one.
constexpr int W_BAR = 0;
constexpr int W_TICKET = 1;
constexpr int W_HEAD = 4;
static_assert(THREADS == BINS, "a thread takes one zone of a window");

struct Cols {
  const int8_t* prop_on;
  const int8_t* dst_on;
  const int32_t* zone;
  const uint8_t* reach;
  const int8_t* ovr_mask;
  const int32_t* ovr_c1;
  const int32_t* forged_cnt;
  int32_t* commit;
  const int32_t* a;  // the summed histogram (a mesh shard's decision)
  int32_t* hist;     // cosim_hist's output
  int8_t* accepted;
  int8_t* nondef;
  int8_t* dec_fail;
  int32_t* scratch;
  int n, Z, n_live, f;
  int per_block;  // chunks a block takes
  bool vec;       // every column 16-byte aligned
};

// A chunk's rows of an int8 column, four to a 32-bit word.
struct Bytes {
  uint32_t w[WORDS];
};

// One chunk's columns in registers (arrays indexed by constants only,
// once unrolled).
struct Chunk {
  Bytes prop, dst, mask;
  int32_t zone[ROWS], c1[ROWS], forged[ROWS], commit[ROWS];
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ int byte_of(const Bytes& v, int k) {
  return static_cast<int8_t>(v.w[k >> 2] >> (8 * (k & 3)));
}

__device__ __forceinline__ Bytes load_bytes(const int8_t* col, int64_t row0, int rows, bool vec) {
  Bytes v;
  if (vec) {
    if constexpr (WORDS == 1) {
      v.w[0] = __ldg(reinterpret_cast<const unsigned*>(col + row0));
    } else if constexpr (WORDS == 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(col + row0));
      v.w[0] = q.x;
      v.w[1] = q.y;
    } else {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(col + row0));
      v.w[0] = q.x;
      v.w[1] = q.y;
      v.w[2] = q.z;
      v.w[3] = q.w;
    }
    return v;
  }
#pragma unroll
  for (int q = 0; q < WORDS; ++q) v.w[q] = 0u;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    if (k < rows) v.w[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(col[row0 + k])) << (8 * (k & 3));
  }
  return v;
}

// A chunk's int8 rows as one vector store (an aligned, whole chunk).
__device__ __forceinline__ void store_bytes(int8_t* col, int64_t row0, const Bytes& v) {
  if constexpr (WORDS == 1) {
    *reinterpret_cast<unsigned*>(col + row0) = v.w[0];
  } else if constexpr (WORDS == 2) {
    *reinterpret_cast<uint2*>(col + row0) = make_uint2(v.w[0], v.w[1]);
  } else {
    *reinterpret_cast<uint4*>(col + row0) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  }
}

// kNc: the column is not written by the kernel, so it may come through the
// read-only path (commit is read and written, so it may not).
template <bool kNc>
__device__ __forceinline__ void load_words(const int32_t* col, int64_t row0, int rows, bool vec,
                                           int32_t fill, int32_t (&out)[ROWS]) {
  if (vec) {
    const int4* p = reinterpret_cast<const int4*>(col + row0);
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q) {
      const int4 v = kNc ? __ldg(p + q) : p[q];
      out[4 * q] = v.x;
      out[4 * q + 1] = v.y;
      out[4 * q + 2] = v.z;
      out[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) out[k] = k < rows ? col[row0 + k] : fill;
  }
}

// Load chunk `chunk` of the block's [.., c_hi): the histogram's columns
// (kHist: dst_on and zone) and the decision's (kDecide: zone and the five
// others).  Returns its rows (0 past c_hi; its zones then read -1, in no
// window).
template <bool kHist, bool kDecide>
__device__ __forceinline__ int load_chunk(const Cols& c, int64_t chunk, int64_t c_hi, Chunk& x) {
  const int64_t row0 = chunk * ROWS;
  const int rows = chunk < c_hi ? static_cast<int>(lmin(ROWS, c.n - row0)) : 0;
  const bool vec = c.vec && rows == ROWS;
  if (kHist) x.dst = load_bytes(c.dst_on, row0, rows, vec);
  load_words<true>(c.zone, row0, rows, vec, -1, x.zone);
  if (kDecide) {
    x.prop = load_bytes(c.prop_on, row0, rows, vec);
    x.mask = load_bytes(c.ovr_mask, row0, rows, vec);
    load_words<true>(c.ovr_c1, row0, rows, vec, 0, x.c1);
    load_words<true>(c.forged_cnt, row0, rows, vec, 0, x.forged);
    load_words<false>(c.commit, row0, rows, vec, 0, x.commit);
  }
  return rows;
}

// Add a chunk's rows in zones [z0, z0 + w) to the block's counters.  With
// warp_fold every lane of the warp calls together, and the thread's last
// run is first summed over the warp's lanes in the same zone.
__device__ __forceinline__ void count_rows(const Bytes& dst, const int32_t (&zone)[ROWS], int z0, int w,
                                           int32_t* counts, bool warp_fold) {
  int run_zone = -1;
  uint32_t run = 0;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    // unsigned: a zone below z0 (or below 0) wraps past w
    const uint32_t z = static_cast<uint32_t>(zone[k]) - static_cast<uint32_t>(z0);
    if (z >= static_cast<uint32_t>(w)) continue;
    if (static_cast<int>(z) != run_zone) {
      if (run != 0) atomicAdd(&counts[run_zone], static_cast<int32_t>(run));
      run_zone = static_cast<int>(z);
      run = 0;
    }
    run += static_cast<uint32_t>(byte_of(dst, k));
  }
  if (warp_fold) {
    const unsigned peers = __match_any_sync(0xffffffffu, run_zone);
    run = __reduce_add_sync(peers, run);
    if ((threadIdx.x & 31) != __ffs(peers) - 1) run = 0;  // the lowest lane adds
  }
  if (run != 0) atomicAdd(&counts[run_zone], static_cast<int32_t>(run));
}

// The block's histogram of its chunks [c_lo, c_hi) into acc[0, Z), by one
// global atomic a nonzero counter; `first` is the thread's first chunk,
// in registers.  Every thread of the block calls it.
__device__ __forceinline__ void block_histogram(const Cols& c, const Chunk& first, int64_t c_lo, int64_t c_hi,
                                int32_t* acc, int32_t* counts) {
  const int laps = (c.per_block + THREADS - 1) / THREADS;
  for (int z0 = 0; z0 < c.Z; z0 += BINS) {
    const int w = min(BINS, c.Z - z0);
    for (int k = threadIdx.x; k < w; k += THREADS) counts[k] = 0;
    __syncthreads();
    count_rows(first.dst, first.zone, z0, w, counts, true);
    for (int lap = 1; lap < laps; ++lap) {
      Chunk x;
      if (load_chunk<true, false>(c, c_lo + threadIdx.x + static_cast<int64_t>(lap) * THREADS, c_hi, x))
        count_rows(x.dst, x.zone, z0, w, counts, false);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < w; k += THREADS) {
      if (counts[k] != 0) atomicAdd(&acc[z0 + k], counts[k]);
    }
    __syncthreads();  // the next window clears the counters
  }
}

// Release and acquire at the scope of the card, as CUTLASS's grid
// barriers take them: after a block barrier, thread 0's release makes the
// whole block's earlier writes and atomics visible to whoever acquires.
__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned atom_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The grid barrier, with one atomic a block on one word that nothing
// resets (cooperative_groups' grid sync, written out): every block's
// thread 0 adds 1 to it, block 0 adds 2^31 − (g − 1), so the word's top bit
// flips when the last of the g blocks has added and its low bits come back
// to 0.  A block waits for the flip.  `start` is the word as the block read
// it at the kernel's start (its top bit cannot flip before this block
// arrives).
__device__ __forceinline__ void grid_barrier(int32_t* scratch, unsigned start) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* word = reinterpret_cast<unsigned*>(scratch + W_BAR);
    red_release(word, blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u);
    while (((ld_acquire(word) ^ start) & 0x80000000u) == 0u) {
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int clamp_zone(int32_t z, int Z) { return min(max(z, 0), Z - 1); }

// The block's table of zone dots s_dot[i] = Σ_z reach[zw + i, z]·a[z] (u32)
// for the zones [zw, zw + BINS) ∩ [0, Z): thread i takes zone zw + i, a[]
// staged in s_a a window of BINS zones at a time.  The first PRE bytes of
// the thread's reach row in a window are loaded before a[] is staged, so
// that at small Z the two round trips to L2 overlap.  Every thread of the
// block calls it.
__device__ __forceinline__ void zone_dots(const Cols& c, const int32_t* a, int zw, int32_t* s_a,
                                          uint32_t* s_dot) {
  const int wz = min(BINS, c.Z - zw);
  const bool mine = static_cast<int>(threadIdx.x) < wz;
  const uint8_t* row = c.reach + static_cast<int64_t>(zw + (mine ? threadIdx.x : 0)) * c.Z;
  uint32_t s = 0u;
  for (int za = 0; za < c.Z; za += BINS) {
    const int wa = min(BINS, c.Z - za);
    uint32_t pre[PRE];
#pragma unroll
    for (int j = 0; j < PRE; ++j) pre[j] = mine && j < wa ? __ldg(row + za + j) : 0u;
    __syncthreads();  // the counters, or the previous window, are done with
    for (int k = threadIdx.x; k < wa; k += THREADS) s_a[k] = __ldcg(a + za + k);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PRE; ++j) s += pre[j] * static_cast<uint32_t>(s_a[j]);  // 0 past wa
    if (mine) {
      for (int j = PRE; j < wa; ++j) s += static_cast<uint32_t>(__ldg(row + za + j)) * static_cast<uint32_t>(s_a[j]);
    }
  }
  s_dot[threadIdx.x] = s;
  __syncthreads();
}

// Decide a chunk's rows and write them.  Each row's reach-row dot comes
// from the block's table of zone dots; with `tabulate` false the table
// already holds every zone (Z ≤ BINS).  Every thread of the block calls
// it, with rows 0 where it has no chunk.
__device__ __forceinline__ void decide_chunk(const Cols& c, Chunk& x, int rows, int64_t row0,
                                             const int32_t* a, int32_t* s_a, uint32_t* s_dot,
                                             bool tabulate) {
  uint32_t dot[ROWS];
  for (int zw = 0; zw < c.Z; zw += BINS) {
    if (tabulate) zone_dots(c, a, zw, s_a, s_dot);
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const uint32_t i = static_cast<uint32_t>(clamp_zone(x.zone[k], c.Z) - zw);
      if (zw == 0 || i < BINS) dot[k] = s_dot[i < BINS ? i : 0];
    }
  }
  Bytes acc, nd, fail;
#pragma unroll
  for (int q = 0; q < WORDS; ++q) acc.w[q] = nd.w[q] = fail.w[q] = 0u;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int32_t c1_base = static_cast<int32_t>(static_cast<uint32_t>(byte_of(x.prop, k)) * dot[k]);
    const int32_t c1 = byte_of(x.mask, k) != 0 ? x.c1[k] : c1_base;
    const int32_t c0 = static_cast<int32_t>(static_cast<uint32_t>(c.n_live) - static_cast<uint32_t>(c1));
    const int32_t lift1 = c1 >= c.f + 1 ? c.n_live : c1;
    const int32_t lift0 = c0 >= c.f + 1 ? c.n_live : c0;
    const bool bin1 = lift1 >= 2 * c.f + 1;
    const bool bin0 = lift0 >= 2 * c.f + 1;
    const bool pos = c1 > 0;
    const bool neg = c0 > 0;
    const bool has1 = (pos && bin1) || (pos && !bin1 && !bin0) || (neg && !bin0);
    const bool has0 = (neg && bin0) || (pos && !bin1 && bin0);
    const int32_t valid =
        static_cast<int32_t>(static_cast<uint32_t>(c.n_live) - static_cast<uint32_t>(x.forged[k]));
    const int shift = 8 * (k & 3);
    acc.w[k >> 2] |= static_cast<uint32_t>(has1) << shift;
    nd.w[k >> 2] |= static_cast<uint32_t>(has1 && has0) << shift;
    fail.w[k >> 2] |= static_cast<uint32_t>(has1 && valid <= c.f) << shift;
    x.commit[k] = static_cast<int32_t>(static_cast<uint32_t>(x.commit[k]) + (has1 ? 1u : 0u));
  }
  if (c.vec && rows == ROWS) {
    store_bytes(c.accepted, row0, acc);
    store_bytes(c.nondef, row0, nd);
    store_bytes(c.dec_fail, row0, fail);
    int4* out = reinterpret_cast<int4*>(c.commit + row0);
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q)
      out[q] = make_int4(x.commit[4 * q], x.commit[4 * q + 1], x.commit[4 * q + 2], x.commit[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      if (k < rows) {
        const int shift = 8 * (k & 3);
        c.accepted[row0 + k] = static_cast<int8_t>((acc.w[k >> 2] >> shift) & 1u);
        c.nondef[row0 + k] = static_cast<int8_t>((nd.w[k >> 2] >> shift) & 1u);
        c.dec_fail[row0 + k] = static_cast<int8_t>((fail.w[k >> 2] >> shift) & 1u);
        c.commit[row0 + k] = x.commit[k];
      }
    }
  }
}

// kFused: the whole step on one card (a cooperative launch: histogram,
// grid barrier, decision); else a mesh shard's decision given c.a.
template <bool kFused>
__global__ void __launch_bounds__(THREADS, 1) cosim_step_kernel(const Cols c) {
  __shared__ int32_t s_buf[BINS];  // the zone counters, then a window of a[]
  __shared__ uint32_t s_dot[BINS];
  __shared__ unsigned s_start;
  const int64_t chunks = (static_cast<int64_t>(c.n) + ROWS - 1) / ROWS;
  const int64_t c_lo = static_cast<int64_t>(blockIdx.x) * c.per_block;
  const int64_t c_hi = lmin(c_lo + c.per_block, chunks);
  const int64_t first = c_lo + threadIdx.x;
  Chunk x;
  const int rows = load_chunk<kFused, true>(c, first, c_hi, x);  // every load before any use
  const int32_t* a = c.a;
  if constexpr (kFused) {
    // the barrier word's top bit: this launch's parity
    if (threadIdx.x == 0) s_start = *reinterpret_cast<volatile unsigned*>(c.scratch + W_BAR);
    __syncthreads();
    const unsigned start = s_start;
    const int64_t parity = start >> 31;
    int32_t* acc = c.scratch + W_HEAD + parity * c.Z;
    if (blockIdx.x == 0) {
      int32_t* other = c.scratch + W_HEAD + (1 - parity) * c.Z;
      for (int k = threadIdx.x; k < c.Z; k += THREADS) other[k] = 0;
    }
    block_histogram(c, x, c_lo, c_hi, acc, s_buf);
    grid_barrier(c.scratch, start);
    a = acc;
  }
  decide_chunk(c, x, rows, first * ROWS, a, s_buf, s_dot, true);
  const int laps = (c.per_block + THREADS - 1) / THREADS;
  for (int lap = 1; lap < laps; ++lap) {
    const int64_t ch = first + static_cast<int64_t>(lap) * THREADS;
    Chunk y;
    const int r = load_chunk<false, true>(c, ch, c_hi, y);
    decide_chunk(c, y, r, ch * ROWS, a, s_buf, s_dot, c.Z > BINS);
  }
}

// A mesh shard's histogram: per-block counts into the scratch accumulator,
// then the last block to finish copies it into c.hist, zeroes it and
// resets the ticket.
__global__ void __launch_bounds__(THREADS) cosim_hist_kernel(const Cols c) {
  __shared__ int32_t counts[BINS];
  __shared__ bool s_last;
  const int64_t chunks = (static_cast<int64_t>(c.n) + ROWS - 1) / ROWS;
  const int64_t c_lo = static_cast<int64_t>(blockIdx.x) * c.per_block;
  const int64_t c_hi = lmin(c_lo + c.per_block, chunks);
  Chunk x;
  load_chunk<true, false>(c, c_lo + threadIdx.x, c_hi, x);
  int32_t* acc = c.scratch + W_HEAD + 2 * static_cast<int64_t>(c.Z);
  block_histogram(c, x, c_lo, c_hi, acc, counts);  // ends with a block barrier
  if (threadIdx.x == 0) {
    s_last = atom_acq_rel(reinterpret_cast<unsigned*>(c.scratch + W_TICKET), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  for (int k = threadIdx.x; k < c.Z; k += THREADS) {
    c.hist[k] = __ldcg(acc + k);
    acc[k] = 0;
  }
  if (threadIdx.x == 0) atomicExch(reinterpret_cast<unsigned*>(c.scratch + W_TICKET), 0u);
}

// Launch-cost probes for chip_smoke.py: an empty kernel, and a cooperative
// grid that crosses the grid barrier (kBarrier) or does nothing.
__global__ void empty_kernel() {}

template <bool kBarrier>
__global__ void __launch_bounds__(THREADS, 1) probe_kernel(int32_t* scratch) {
  if constexpr (kBarrier) {
    __shared__ unsigned s_start;
    if (threadIdx.x == 0) s_start = *reinterpret_cast<volatile unsigned*>(scratch + W_BAR);
    __syncthreads();
    grid_barrier(scratch, s_start);
  }
}

// What the launches size their grids by, one entry a device.
struct DevInfo {
  int sms;
  int fused_per_sm;
  int decide_per_sm;
  int hist_per_sm;
};

cudaError_t dev_info(DevInfo* out) {
  static DevInfo cache[MAX_DEVICES];
  static std::mutex lock;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  DevInfo& d = cache[dev];
  if (d.sms == 0) {
    DevInfo x{};
    if ((rc = cudaDeviceGetAttribute(&x.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&x.fused_per_sm, cosim_step_kernel<true>,
                                                             THREADS, 0)) != cudaSuccess ||
        (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&x.decide_per_sm, cosim_step_kernel<false>,
                                                             THREADS, 0)) != cudaSuccess ||
        (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&x.hist_per_sm, cosim_hist_kernel, THREADS,
                                                             0)) != cudaSuccess)
      return rc;
    d = x;
  }
  *out = d;
  return cudaSuccess;
}

// The grid for n rows on `sms` SMs when at most `cap` blocks may run: at
// least MIN_CHUNKS chunks a block, at most one block an SM while one chunk
// a thread covers the rows, at least one block (n = 0 included).
void grid_for(int n, int sms, int cap, int* blocks, int* per_block) {
  const int64_t chunks = (static_cast<int64_t>(n) + ROWS - 1) / ROWS;
  const int64_t one_lap = (chunks + THREADS - 1) / THREADS;
  int64_t g = (chunks + MIN_CHUNKS - 1) / MIN_CHUNKS;
  if (g > (one_lap > sms ? one_lap : sms)) g = one_lap > sms ? one_lap : sms;
  if (g > cap) g = cap;
  if (g < 1) g = 1;
  int64_t per = (chunks + g - 1) / g;
  if (per < 1) per = 1;
  g = (chunks + per - 1) / per;
  *blocks = static_cast<int>(g < 1 ? 1 : g);
  *per_block = static_cast<int>(per);
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

Cols make_cols(const void* prop_on, const void* dst_on, const void* zone, const void* reach,
               const void* ovr_mask, const void* ovr_c1, const void* forged_cnt, void* commit,
               const void* a, void* hist, void* accepted, void* nondef, void* dec_fail, void* scratch,
               int n, int Z, int n_live, int f) {
  Cols c{};
  c.prop_on = static_cast<const int8_t*>(prop_on);
  c.dst_on = static_cast<const int8_t*>(dst_on);
  c.zone = static_cast<const int32_t*>(zone);
  c.reach = static_cast<const uint8_t*>(reach);
  c.ovr_mask = static_cast<const int8_t*>(ovr_mask);
  c.ovr_c1 = static_cast<const int32_t*>(ovr_c1);
  c.forged_cnt = static_cast<const int32_t*>(forged_cnt);
  c.commit = static_cast<int32_t*>(commit);
  c.a = static_cast<const int32_t*>(a);
  c.hist = static_cast<int32_t*>(hist);
  c.accepted = static_cast<int8_t*>(accepted);
  c.nondef = static_cast<int8_t*>(nondef);
  c.dec_fail = static_cast<int8_t*>(dec_fail);
  c.scratch = static_cast<int32_t*>(scratch);
  c.n = n;
  c.Z = Z;
  c.n_live = n_live;
  c.f = f;
  // the row columns the launch reads or writes (null: not this launch's)
  c.vec = true;
  for (const void* p : {prop_on, dst_on, zone, ovr_mask, ovr_c1, forged_cnt,
                        static_cast<const void*>(commit), static_cast<const void*>(accepted),
                        static_cast<const void*>(nondef), static_cast<const void*>(dec_fail)}) {
    if (p != nullptr && !aligned(p)) c.vec = false;
  }
  return c;
}

int finish(cudaError_t rc) {
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear a launch error so it does not stick to later calls
    return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The whole step on one card, one cooperative launch on `stream`: the
// histogram into `scratch` (4 + 3·Z int32 words, zeroed when made, used
// by one stream at a time), the grid barrier, the decision for n rows
// given reach [Z, Z] u8 (row-major); commit[] is advanced in place and the
// three masks written as 0/1 int8.  Z ≥ 1; n ≥ 1 (the wrapper launches
// nothing at n = 0).  No sync.  Returns 0 or a cudaError_t (a grid that
// cannot be resident: cudaErrorCooperativeLaunchTooLarge).
int cosim_step_launch(const void* prop_on, const void* dst_on, const void* zone, const void* reach,
                      const void* ovr_mask, const void* ovr_c1, const void* forged_cnt, void* commit,
                      int n, int Z, int n_live, int f, void* accepted, void* nondef, void* dec_fail,
                      void* scratch, void* stream) {
  if (Z < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  DevInfo d;
  cudaError_t rc = dev_info(&d);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  Cols c = make_cols(prop_on, dst_on, zone, reach, ovr_mask, ovr_c1, forged_cnt, commit, nullptr,
                     nullptr, accepted, nondef, dec_fail, scratch, n, Z, n_live, f);
  int blocks = 0;
  grid_for(n, d.sms, d.sms * d.fused_per_sm, &blocks, &c.per_block);
  void* args[] = {&c};
  return finish(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&cosim_step_kernel<true>),
                                            dim3(blocks), dim3(THREADS), args, 0,
                                            static_cast<cudaStream_t>(stream)));
}

// a[0..Z) = the zone histogram of dst_on over n rows (a mesh shard's), on
// `stream`, through the accumulator and ticket in `scratch` (as above).
// Z ≥ 1; n ≥ 0 (n = 0 writes zeros).  No sync.  Returns 0 or a
// cudaError_t.
int cosim_hist_launch(const void* dst_on, const void* zone, int n, int Z, void* a, void* scratch,
                      void* stream) {
  if (Z < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  DevInfo d;
  cudaError_t rc = dev_info(&d);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  Cols c = make_cols(nullptr, dst_on, zone, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, a,
                     nullptr, nullptr, nullptr, scratch, n, Z, 0, 0);
  int blocks = 0;
  grid_for(n, d.sms, d.sms * d.hist_per_sm, &blocks, &c.per_block);
  cosim_hist_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(c);
  return finish(cudaSuccess);
}

// A mesh shard's decision for n rows given the summed histogram a[0..Z)
// and reach [Z, Z] u8, on `stream`; commit[] is advanced in place and the
// three masks written.  Z ≥ 1; n ≥ 1.  No sync.  Returns 0 or a
// cudaError_t.
int cosim_decide_launch(const void* prop_on, const void* zone, const void* reach,
                        const void* ovr_mask, const void* ovr_c1, const void* forged_cnt,
                        void* commit, const void* a, int n, int Z, int n_live, int f,
                        void* accepted, void* nondef, void* dec_fail, void* stream) {
  if (Z < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  DevInfo d;
  cudaError_t rc = dev_info(&d);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  Cols c = make_cols(prop_on, nullptr, zone, reach, ovr_mask, ovr_c1, forged_cnt, commit, a, nullptr,
                     accepted, nondef, dec_fail, nullptr, n, Z, n_live, f);
  int blocks = 0;
  grid_for(n, d.sms, d.sms * d.decide_per_sm, &blocks, &c.per_block);
  cosim_step_kernel<false><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(c);
  return finish(cudaSuccess);
}

// The one-launch step's grid at n rows (its blocks), or a negative
// cudaError_t.
int cosim_step_blocks(int n) {
  DevInfo d;
  const cudaError_t rc = dev_info(&d);
  if (rc != cudaSuccess) return -static_cast<int>(rc);
  int blocks = 0, per_block = 0;
  grid_for(n, d.sms, d.sms * d.fused_per_sm, &blocks, &per_block);
  return blocks;
}

// Launch-cost probes, on `stream`: kind 0 an empty <<<1, 32>>> kernel;
// kind 1 a cooperative grid of `blocks` × 256 threads that does nothing;
// kind 2 the same grid crossing the grid barrier once, on `scratch`'s
// barrier word (a scratch of its own: it flips the word's top bit, the
// step's accumulator parity).
int cosim_probe_launch(int kind, void* scratch, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    empty_kernel<<<1, 32, 0, s>>>();
    return finish(cudaSuccess);
  }
  if ((kind != 1 && kind != 2) || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  int32_t* words = static_cast<int32_t*>(scratch);
  void* args[] = {&words};
  const void* fn = kind == 1 ? reinterpret_cast<const void*>(&probe_kernel<false>)
                             : reinterpret_cast<const void*>(&probe_kernel<true>);
  return finish(cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(THREADS), args, 0, s));
}

const char* cosim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
