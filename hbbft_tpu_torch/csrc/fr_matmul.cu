// fr_matmul.cu — Fr matrix product mod r for Hopper: the DKG's dealing plane.
//
// Replaces no Pallas kernel: it replaces an XLA program of the reference,
// hbbft_tpu/ops/fr_jax.py:_matmul_limbs (with _add_limbs, and the fold of
// _sample_limbs), a jitted dot_general over 33 u8 limbs with int32
// accumulation followed by a carry scan and three folds.  It was added
// because at N = 1024 that program is the era change's entire compute:
// per dealer ROWS = POW[:681]·C ([681, 341]·[341, 341]) and
// VAL = ROWS[:341]·POWᵀ ([341, 341]·[341, 1023]), 1,023 dealers,
// 2.0·10¹¹ Fr multiply-adds in all.  Its plain form would materialise a
// [681·33, 341·33] int product per dealer.
//
//   out[m, p] = (acc[m, p] + Σ_k A[m, k]·B[k, p]) mod r
//
// A, B, acc: 8 little-endian 32-bit words an element (any value < 2^256),
// out canonical.  The arithmetic and its exactness argument are in
// fr_words.cuh: each thread keeps one output's exact sum (16 words + 8
// carry counters), 64 partial products of 32 × 32 → 64 bits a multiply-add,
// and reduces it once at the end.
//
// What bounds it on the card: the multiplies.  A multiply-add is 64 partial
// products, 128 IMAD issue slots (lo and hi halves), over 16.75·10¹² slots/s;
// the bytes (32 B an operand, read once) are negligible.  The tensor cores
// would do the limb form (33² u8 products a multiply-add at 989·10¹²/s)
// about seven times faster; that redesign (mma/wgmma on u8 limbs with a
// diagonal-sum epilogue) is later work, and chip_smoke.py reports the
// smaller of the two counts as the bound.
//
// Design: a block of 32 × tm threads (tm = 8, or m when m < 8) computes a
// tm × 32 output tile, one output a thread: warp y owns row m0 + y, lane x
// column p0 + x.  The block stages KC = 16 steps of k at a time in shared
// memory — A's tm rows as two uint4 halves (read by a whole warp at one
// address: a broadcast) and B's 32 columns as two planes of uint4 (lane x
// reads the x-th 16 bytes: conflict-free) — zero-filled past the edges,
// so ragged tiles need no masks in the inner loop.  Only the final store
// is masked.  Inputs are words, so rows → values → contribution stay on
// the card; the layout conversion from the reference's 33-byte limbs is
// torch on the card (ops/fr.py).

#include <cuda_runtime.h>

#include "fr_words.cuh"

namespace {

constexpr int TN = 32;      // output columns a block (one a lane)
constexpr int TM_MAX = 8;   // output rows a block (one a warp)
constexpr int KC = 16;      // k steps staged in shared memory at a time

__global__ void __launch_bounds__(TN* TM_MAX)
fr_matmul_kernel(const uint4* __restrict__ A, const uint4* __restrict__ B,
                 const uint4* __restrict__ ACC, uint4* __restrict__ OUT, int M, int K, int P) {
  __shared__ uint4 sa[KC][TM_MAX][2];
  __shared__ uint4 sb[KC][2][TN];
  const int tx = threadIdx.x, ty = threadIdx.y, tm = blockDim.y;
  const int tid = ty * TN + tx, nthreads = tm * TN;
  const int m0 = blockIdx.y * tm, p0 = blockIdx.x * TN;
  const int m = m0 + ty, p = p0 + tx;
  const bool live = m < M && p < P;
  const size_t o = ((size_t)m * P + p) * 2;

  FrSum s;
  if (ACC != nullptr && live) {
    const uint4 lo = ACC[o], hi = ACC[o + 1];
    const uint32_t acc[FR_W] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    fr_sum_init(s, acc);
  } else {
    fr_sum_init(s, nullptr);
  }

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < K; k0 += KC) {
    // A[m0 + r, k0 + kk] half h: consecutive threads along (kk, h)
    for (int e = tid; e < tm * KC * 2; e += nthreads) {
      const int h = e & 1, kk = (e >> 1) % KC, r = (e >> 1) / KC;
      const int mm = m0 + r, k = k0 + kk;
      sa[kk][r][h] = (mm < M && k < K) ? A[((size_t)mm * K + k) * 2 + h] : zero;
    }
    // B[k0 + kk, p0 + c] half h: consecutive threads along (c, h)
    for (int e = tid; e < KC * TN * 2; e += nthreads) {
      const int h = e & 1, c = (e >> 1) % TN, kk = (e >> 1) / TN;
      const int pp = p0 + c, k = k0 + kk;
      sb[kk][h][c] = (pp < P && k < K) ? B[((size_t)k * P + pp) * 2 + h] : zero;
    }
    __syncthreads();
    const int kn = K - k0 < KC ? K - k0 : KC;
#pragma unroll 1
    for (int kk = 0; kk < kn; ++kk) {
      const uint4 a0 = sa[kk][ty][0], a1 = sa[kk][ty][1];
      const uint4 b0 = sb[kk][0][tx], b1 = sb[kk][1][tx];
      const uint32_t a[FR_W] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const uint32_t b[FR_W] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      fr_sum_mac(s, a, b);
    }
    __syncthreads();
  }

  if (live) {
    uint32_t r[FR_W];
    fr_sum_reduce(s, r);
    OUT[o] = make_uint4(r[0], r[1], r[2], r[3]);
    OUT[o + 1] = make_uint4(r[4], r[5], r[6], r[7]);
  }
}

}  // namespace

extern "C" {

// a [M, K, 8], b [K, P, 8], acc [M, P, 8] (or null) and out [M, P, 8]
// int32 words, contiguous on the current device (M ≤ 8·65535); launches on
// `stream` and returns cudaGetLastError() (0 on success).
int fr_matmul_launch(const void* a, const void* b, const void* acc, void* out, int M, int K,
                     int P, void* stream) {
  if (M > 0 && P > 0) {
    const int tm = M < TM_MAX ? M : TM_MAX;
    const dim3 block(TN, tm);
    const dim3 grid((P + TN - 1) / TN, (M + tm - 1) / tm);
    fr_matmul_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(a), static_cast<const uint4*>(b),
        static_cast<const uint4*>(acc), static_cast<uint4*>(out), M, K, P);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fr_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
