// fr_words.cuh — exact sums of BLS12-381 Fr products, and their one
// reduction mod r: the arithmetic of fr_matmul.cu.
//
// An Fr operand is 8 little-endian words of 32 bits, any value < 2^256
// (canonical Fr, < r < 2^255, in the DKG; the sampler feeds 256-bit halves
// of random bytes): its own 32 little-endian bytes.  An output element
// holds the exact integer
//
//   T = acc + Σ_k a_k·b_k  <  2^256 + k·2^512
//
// and is reduced mod r once, at the end.  Nothing is reduced along the way,
// so the order of the k terms does not matter: the sum is exact.
//
// The products come from the tensor cores as byte planes (fr_matmul.cu):
// with a_k = Σ_x A_kx·2^(8x) and b_k = Σ_y B_ky·2^(8y), bytes A_kx, B_ky in
// [0, 255], the u8 × u8 → s32 matrix product gives every
//
//   C_xy = Σ_k A_kx·B_ky  ≤  255²·k,
//
// and T = acc + Σ_{p=0..62} S_p·2^(8p) with the diagonal sums
// S_p = Σ_{x+y=p} C_xy, at most 32 terms each:
//
//   S_p ≤ 32·255²·k = 2,080,800·k.
//
// The wrapper (ops/fr.py) takes k ≤ 971, the reference's bound, so
// S_p ≤ 2,020,456,800 < 2^31: no s32 accumulator, no partial diagonal sum
// and no S_p wraps (every term is ≥ 0, every partial sum ≤ S_p).  At
// k = 1,033 the bound would pass 2^31; tests/test_torch_fr.py holds it at
// k = 971 with every byte 0xFF.
//
// fr_sum_positions turns the S_p and acc into T's 17 words by 64-bit
// columns: word t collects acc_t, the carry from word t − 1 and
// S_{4t+d}·2^(8d) for d = 0..3, a column < 2^24 + 2^32 + 2^31·(2^24 + 2^16 +
// 2^8 + 1) < 2^56, so every carry is < 2^24 and nothing overflows 64 bits.
// Word 16 (< 2^10 at k ≤ 971) is the last carry.
//
// The sum (FrSum) is 16 words w[0..15] plus 8 carry counters c[0..7], c[j]
// weighing 2^(32(9+j)); fr_sum_positions fills w and c[7] (word 16) and
// zeroes c[0..6].  The reduction takes any counters, as their sum with the
// words fits 17 words.
//
// The reduction (fr_sum_reduce):
//  1. normalize: x[0..16] = T, the counters added in by one carry chain;
//  2. fold: V = x[0..7] + Σ_{j=0..8} x[8+j]·(2^(32(8+j)) mod r) (FR_FOLD),
//     V ≡ T mod r, and V < 2^256 + 9·2^32·r < 2^291 (10 words, the top
//     one < 8);
//  3. quotient: s = ⌊V / 2^250⌋ < 2^41 and q = ⌊s·μ / 2^64⌋ with
//     μ = ⌊2^314 / r⌋ < 2^60.  q ≤ s·2^250/r ≤ V/r, and
//     s·μ/2^64 > (V/2^250 − 1)(2^314/r − 1)/2^64 ≥ V/r − 2^250/r − V/2^314
//     > V/r − 0.035, so q ≥ ⌊V/r⌋ − 1;
//  4. V − q·r lies in [0, 2r) ⊂ [0, 2^256), so it is computed mod 2^256
//     from the low 8 words of V and of q·r;
//  5. one conditional subtraction of r leaves the canonical residue < r.
//
// Everything is plain C++ on uint32_t/uint64_t, so tests/test_torch_fr.py
// compiles this header for the host (the CUDA qualifiers defined away) and
// holds it against Python integers, the worst cases included.

#pragma once

#include <stdint.h>

namespace {

constexpr int FR_W = 8;
// byte positions of a product of two 32-byte operands (0..62), and one spare
constexpr int FR_POS = 64;

// r, little-endian words
__constant__ uint32_t FR_R[FR_W] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};

// FR_FOLD[j] = 2^(32(8+j)) mod r, j = 0..8
__constant__ uint32_t FR_FOLD[9][FR_W] = {
    {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
     0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u},
    {0xcaaf6b13u, 0x355094eau, 0x69a568efu, 0xf6b10cb3u,
     0x40cc3869u, 0xe2c926a6u, 0xed269aadu, 0x736a6d3bu},
    {0x0121c884u, 0xc98da28eu, 0xc7363c67u, 0xe6f4f4a0u,
     0xe92e7df1u, 0xb2d6ebc4u, 0x9d26242au, 0x19ae5794u},
    {0xc74a2349u, 0x39d7a53au, 0x605fbb45u, 0x5394c74du,
     0x088943e5u, 0x1563f13du, 0x3c5771fbu, 0x03913033u},
    {0xf81f712du, 0xcf2ab21bu, 0xac0a600du, 0x9277efb8u,
     0x7369510au, 0x7abbe568u, 0xd4843acbu, 0x2dbeaf1fu},
    {0x9afbc14cu, 0x5d23afe0u, 0x2b0e40d0u, 0x1deef9adu,
     0x203ba106u, 0xe07e784du, 0xa251b319u, 0x562ca75au},
    {0x41b4528fu, 0x59476ebcu, 0x43fcc152u, 0xc5a30cb2u,
     0x40ccbd72u, 0x2b34e639u, 0xca247088u, 0x1e179025u},
    {0xbd8c85feu, 0x8427cc90u, 0x0fe630beu, 0xc8ff7852u,
     0x27715045u, 0x2b4d2b66u, 0xe5a19691u, 0x05753400u},
    {0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
     0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u}};

// ⌊2^314 / r⌋
constexpr uint64_t FR_MU = 0x08d54253b7fb78ddull;

__device__ __forceinline__ uint64_t fr_umulhi(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

struct FrSum {
  uint32_t w[16];  // words 0..15 of the sum
  uint32_t c[8];   // c[j]: carries into word 9 + j
};

// T = acc + Σ_p S[p]·2^(8p) (acc: 8 words, nullptr for 0; every S[p] < 2^31,
// S[63] included, which the kernel leaves 0): w = words 0..15, c[7] = word 16
__device__ __forceinline__ void fr_sum_positions(FrSum& s, const uint32_t (&S)[FR_POS],
                                                 const uint32_t* acc) {
  uint64_t carry = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    uint64_t col = carry + ((acc != nullptr && t < FR_W) ? acc[t] : 0u);
#pragma unroll
    for (int d = 0; d < 4; ++d) col += (uint64_t)S[4 * t + d] << (8 * d);
    s.w[t] = (uint32_t)col;
    carry = col >> 32;
  }
#pragma unroll
  for (int j = 0; j < 7; ++j) s.c[j] = 0u;
  s.c[7] = (uint32_t)carry;
}

// out = T mod r, canonical
__device__ __forceinline__ void fr_sum_reduce(const FrSum& s, uint32_t (&out)[FR_W]) {
  // 1. the 17 words of T
  uint32_t x[17];
#pragma unroll
  for (int p = 0; p < 9; ++p) x[p] = s.w[p];
  uint64_t carry = 0;
#pragma unroll
  for (int p = 9; p < 16; ++p) {
    const uint64_t t = (uint64_t)s.w[p] + s.c[p - 9] + carry;
    x[p] = (uint32_t)t;
    carry = t >> 32;
  }
  x[16] = s.c[7] + (uint32_t)carry;

  // 2. V = x[0..7] + Σ x[8+j]·FR_FOLD[j]  (< 2^291)
  uint32_t v[10];
#pragma unroll
  for (int i = 0; i < FR_W; ++i) v[i] = x[i];
  v[8] = v[9] = 0u;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < FR_W; ++i) {
      const uint64_t t = (uint64_t)x[8 + j] * FR_FOLD[j][i] + v[i] + c;
      v[i] = (uint32_t)t;
      c = t >> 32;
    }
    const uint64_t t = (uint64_t)v[8] + c;
    v[8] = (uint32_t)t;
    v[9] += (uint32_t)(t >> 32);
  }

  // 3. q = ⌊V/r⌋ or one less
  const uint64_t top = (uint64_t)(v[7] >> 26) | ((uint64_t)v[8] << 6) | ((uint64_t)v[9] << 38);
  const uint64_t q = fr_umulhi(top, FR_MU);
  const uint32_t q0 = (uint32_t)q, q1 = (uint32_t)(q >> 32);

  // 4. y = V − q·r mod 2^256
  uint32_t qr[FR_W];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < FR_W; ++i) {
    const uint64_t t = (uint64_t)q0 * FR_R[i] + c;
    qr[i] = (uint32_t)t;
    c = t >> 32;
  }
  c = 0;
#pragma unroll
  for (int i = 0; i + 1 < FR_W; ++i) {
    const uint64_t t = (uint64_t)q1 * FR_R[i] + qr[i + 1] + c;
    qr[i + 1] = (uint32_t)t;
    c = t >> 32;
  }
  uint32_t y[FR_W];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < FR_W; ++i) {
    const uint64_t t = (uint64_t)v[i] - qr[i] - borrow;
    y[i] = (uint32_t)t;
    borrow = (t >> 32) & 1u;
  }

  // 5. y < 2r: subtract r once if y ≥ r
  uint32_t z[FR_W];
  borrow = 0;
#pragma unroll
  for (int i = 0; i < FR_W; ++i) {
    const uint64_t t = (uint64_t)y[i] - FR_R[i] - borrow;
    z[i] = (uint32_t)t;
    borrow = (t >> 32) & 1u;
  }
#pragma unroll
  for (int i = 0; i < FR_W; ++i) out[i] = borrow ? y[i] : z[i];
}

}  // namespace
