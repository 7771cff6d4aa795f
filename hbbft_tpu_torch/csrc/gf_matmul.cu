// gf_matmul.cu — a constant GF(2^W) matrix times a symbol matrix, W = 8
// or 16, for Hopper.
//
// Replaces no Pallas kernel: the reference runs its Reed–Solomon products
// as XLA programs, hbbft_tpu/ops/gf256_jax.py _bitsliced_matmul (:78, via
// gf_matmul_device :92) and _bitsliced_matmul16 (:219, via
// gf16_matmul_device :225).  There a constant [m, k] matrix becomes a
// binary [W·m, W·k] matrix, the data's bits an int32 matmul, and the
// parity of each sum the output's bits: the TPU's matrix unit does the
// XOR as an integer sum.  Here the same binary expansion is XORed
// directly: multiplication by a constant M[i, j] is GF(2)-linear, so
//
//     y[i, c] = ⊕_j ⊕_b [bit b of x[j, c]] · (M[i, j] · 2^b),
//
// and the W constants M[i, j]·2^b (the columns of the reference's binary
// block for that entry) come from the host, [m, k, W] symbols.
//
// Design: SWAR on 32-bit lanes, four GF(2^8) bytes or two GF(2^16)
// symbols a lane.  A thread owns one 32-bit column word c and ROWS output
// rows.  For each contraction row j it reads x[j, c] once (coalesced
// across the block), makes the W masks ((x >> b) & 0x01010101)·0xFF
// (0x00010001·0xFFFF for W = 16), each lane all ones where its bit b is
// set, and XORs mask & splat(M[i, j]·2^b) into each of its rows: one
// three-input logical op a row, bit and word.  The constants of the
// block's ROWS rows go through shared memory in tiles of KC contraction
// rows, splatted to the lane width (every thread reads the same word:
// a broadcast); the N = 1024 epoch's parity product has 7.5 MB of them.
//
// What bounds it on the card: the XOR-AND ops, W·m·k a column word, at
// the int32 issue rate, or the same product as the binary expansion on the
// int8 tensor cores, whichever is less (chip_smoke.py's gf_bound), or for
// short products the bytes (the table and the data read once, the output
// written once).  A simple kernel that is right first: no tensor cores,
// no pipelining of the table tiles.
//
// Rows are ``words`` 32-bit words long: the wrapper pads each row of the
// data and the output to a multiple of 4 bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // column words a block
constexpr int ROWS = 8;       // output rows a block
constexpr int KC = 32;        // contraction rows a shared-memory tile

template <int W>
struct Lanes;
template <>
struct Lanes<8> {
  using Sym = uint8_t;
  static constexpr uint32_t LO = 0x01010101u, FILL = 0xFFu;
};
template <>
struct Lanes<16> {
  using Sym = uint16_t;
  static constexpr uint32_t LO = 0x00010001u, FILL = 0xFFFFu;
};

template <int W>
__global__ void __launch_bounds__(THREADS)
gf_matmul_kernel(const typename Lanes<W>::Sym* __restrict__ consts,  // [m, k, W]
                 const uint32_t* __restrict__ x,                       // [k, words]
                 uint32_t* __restrict__ y,                             // [m, words]
                 int m, int k, int words) {
  using L = Lanes<W>;
  __shared__ uint32_t tab[ROWS][KC][W];
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int i0 = blockIdx.y * ROWS;
  uint32_t acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0;
  for (int j0 = 0; j0 < k; j0 += KC) {
    __syncthreads();
    for (int e = threadIdx.x; e < ROWS * KC * W; e += THREADS) {
      const int r = e / (KC * W), jj = (e / W) % KC, b = e % W;
      const int i = i0 + r, j = j0 + jj;
      tab[r][jj][b] = (i < m && j < k) ? L::LO * consts[((size_t)i * k + j) * W + b] : 0u;
    }
    __syncthreads();
    if (c < words) {
      const int jn = min(KC, k - j0);
      const uint32_t* xp = x + (size_t)j0 * words + c;
      for (int jj = 0; jj < jn; ++jj, xp += words) {
        const uint32_t xv = *xp;
#pragma unroll
        for (int b = 0; b < W; ++b) {
          const uint32_t mask = ((xv >> b) & L::LO) * L::FILL;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r] ^= mask & tab[r][jj][b];
        }
      }
    }
  }
  if (c < words) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (i0 + r < m) y[(size_t)(i0 + r) * words + c] = acc[r];
  }
}

template <int W>
void launch(const void* consts, const void* x, void* y, int m, int k, int words,
            cudaStream_t stream) {
  const dim3 grid((words + THREADS - 1) / THREADS, (m + ROWS - 1) / ROWS);
  gf_matmul_kernel<W><<<grid, THREADS, 0, stream>>>(
      static_cast<const typename Lanes<W>::Sym*>(consts), static_cast<const uint32_t*>(x),
      static_cast<uint32_t*>(y), m, k, words);
}

}  // namespace

extern "C" {

// w = 8 or 16; consts [m, k, w] symbols (uint8 or uint16), x [k, words]
// and y [m, words] 32-bit words, all contiguous on the current device,
// m, k, words ≥ 1 and m ≤ 8·65,535.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); an unknown w returns
// cudaErrorInvalidValue.
int gf_matmul_launch(int w, const void* consts, const void* x, void* y, int m, int k, int words,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 8) {
    launch<8>(consts, x, y, m, k, words, s);
  } else if (w == 16) {
    launch<16>(consts, x, y, m, k, words, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gf_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
