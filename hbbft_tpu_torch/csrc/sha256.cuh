// sha256.cuh — SHA-256 for sha256.cu (batched digests) and merkle.cu (the
// Merkle forest): the compression, and a message's blocks built in
// registers with the next block's loads issued ahead of each compression.
//
// - compress: one 16-word big-endian block into an 8-word state, the 64
//   rounds unrolled in registers with a 16-word rolling message schedule
//   and the round constants as immediates;
// - compress_run: a message's blocks from a source (PaddedBlocks: words
//   padded already; ByteBlocks: raw bytes at any alignment, each block's
//   big-endian words picked out of aligned 16-byte loads), block b + 1's
//   loads issued into registers before block b's compression, so a long
//   message's chain waits on the int32 pipe and not on device memory; the
//   blocks that hold the message's end get their padding (0x80, zeros,
//   the 64-bit bit length) in registers (pad_block);
// - hash_message<PLEN>: the digest of prefix ‖ value from the raw value
//   bytes, the prefix none (PLEN = 0, sha256.cu's raw entry) or
//   0x00 ‖ index₈ (PLEN = 9, merkle.cu's leaves; block 0 by leaf_block0).
//
// Plain C++ on uint32_t apart from the funnel shift and the byte permute,
// so tests/test_torch_rbc_host.py compiles it for the host with the CUDA
// qualifiers defined away.

#pragma once

#include <cstdint>

namespace {

// The round constant of round t: the 64 rounds are unrolled, so t is a
// compile-time index and each constant becomes an immediate.
__device__ __forceinline__ uint32_t round_k(int t) {
  constexpr uint32_t k[64] = {
      0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u, 0x923F82A4u,
      0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu,
      0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu,
      0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u,
      0xC6E00BF3u, 0xD5A79147u, 0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
      0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
      0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u,
      0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu, 0x682E6FF3u,
      0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u, 0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u,
      0xC67178F2u,
  };
  return k[t];
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__device__ __forceinline__ void init_state(uint32_t s[8]) {
  s[0] = 0x6A09E667u; s[1] = 0xBB67AE85u; s[2] = 0x3C6EF372u; s[3] = 0xA54FF53Au;
  s[4] = 0x510E527Fu; s[5] = 0x9B05688Cu; s[6] = 0x1F83D9ABu; s[7] = 0x5BE0CD19u;
}

// One compression of the block w (consumed as the rolling schedule) into s.
__device__ __forceinline__ void compress(uint32_t s[8], uint32_t w[16]) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + round_k(t) + wt;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + S0 + maj;
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d; s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

__device__ __forceinline__ void store_digest(const uint32_t s[8], uint32_t* out) {
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(s[0], s[1], s[2], s[3]);
  o[1] = make_uint4(s[4], s[5], s[6], s[7]);
}

// ---- messages ------------------------------------------------------------

// A message's blocks padded already: 16 big-endian words a block, read as
// four 16-byte vectors (p 16-byte aligned) into registers.
struct PaddedBlocks {
  static constexpr bool kTail = false;  // every block is whole
  const uint4* p;
  uint4 r[4];
  __device__ __forceinline__ void load(int64_t b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) r[q] = p[4 * b + q];
  }
  __device__ __forceinline__ void words(uint32_t w[16]) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[4 * q] = r[q].x; w[4 * q + 1] = r[q].y; w[4 * q + 2] = r[q].z; w[4 * q + 3] = r[q].w;
    }
  }
};

// The selector of __byte_perm that picks a big-endian word starting sh
// bytes into a pair of little-endian words.
__device__ __forceinline__ uint32_t be_selector(int sh) {
  return (uint32_t)((sh + 3) | ((sh + 2) << 4) | ((sh + 1) << 8) | (sh << 12));
}

// The blocks of the message prefix ‖ v[0, len) (prefix plen bytes) from
// the first that holds no prefix byte, through registers: block b's bytes
// from v + 64·b − plen are held by the five aligned 16-byte vectors from
// vec(b), of which only those that hold a byte of v are read (so none
// lies past v's allocation; a block past v's end reads none).  Their
// start's offset in the first vector, off, is the same for every block:
// k words and sh bytes.  The next block's vectors are loaded into r while
// this one is compressed.
struct ByteBlocks {
  static constexpr bool kTail = true;  // the last blocks hold the padding
  const uint8_t* v;
  int64_t len;
  int plen, off;
  uint4 r[5];
  __device__ __forceinline__ ByteBlocks(const uint8_t* v_, int64_t len_, int plen_)
      : v(v_), len(len_), plen(plen_), off((int)(((uintptr_t)v_ - (uintptr_t)plen_) & 15)) {}
  __device__ __forceinline__ const uint4* vec(int64_t b) const {
    return reinterpret_cast<const uint4*>(v + (64 * b - plen) - off);
  }
  // a block wholly inside v (its fifth vector holds a byte of v iff off)
  __device__ __forceinline__ void load(int64_t b) {
    const uint4* a = vec(b);
#pragma unroll
    for (int q = 0; q < 4; ++q) r[q] = a[q];
    r[4] = off ? a[4] : make_uint4(0u, 0u, 0u, 0u);
  }
  // a block that holds v's end, or lies past it: vector q is read only if
  // it holds a byte of v
  __device__ __forceinline__ void load_tail(int64_t b) {
    const uint4* a = vec(b);
#pragma unroll
    for (int q = 0; q < 5; ++q)
      r[q] = 16 * q < len - (64 * b - plen - off) ? a[q] : make_uint4(0u, 0u, 0u, 0u);
  }
  // the loaded block's 16 big-endian words: the 20 words shifted down by k
  // (two selects a word), each word picked out of two of them (one byte
  // permute)
  __device__ __forceinline__ void words(uint32_t w[16]) const {
    uint32_t x[20];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      x[4 * q] = r[q].x; x[4 * q + 1] = r[q].y; x[4 * q + 2] = r[q].z; x[4 * q + 3] = r[q].w;
    }
    const bool k2 = off & 8, k1 = off & 4;
#pragma unroll
    for (int q = 0; q < 18; ++q) x[q] = k2 ? x[q + 2] : x[q];
#pragma unroll
    for (int q = 0; q < 17; ++q) x[q] = k1 ? x[q + 1] : x[q];
    const uint32_t sel = be_selector(off & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = __byte_perm(x[j], x[j + 1], sel);
  }
};

// The padding of block b (of nblocks) of a message of mlen bytes: the
// block's bytes past the message masked off, 0x80 after its last byte,
// the 64-bit bit length in the last block's last 8 bytes.
__device__ __forceinline__ void pad_block(uint32_t w[16], int64_t mlen, int64_t b,
                                          int64_t nblocks) {
  const int64_t p0 = 64 * b;
  // the message's end relative to the block, in [0, 64]; where 0x80 goes
  // (64: not in this block)
  const int end = mlen - p0 < 0 ? 0 : (mlen - p0 > 64 ? 64 : (int)(mlen - p0));
  const int pad = mlen - p0 < 0 ? 64 : end;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int e = end - 4 * j, d = pad - 4 * j;  // the word's first e bytes are the message's
    const uint32_t keep = e >= 4 ? ~0u : (e <= 0 ? 0u : ~(~0u >> (8 * e)));
    w[j] = (w[j] & keep) | (d >= 0 && d < 4 ? 0x80u << (24 - 8 * d) : 0u);
  }
  if (b == nblocks - 1) {
    const uint64_t bits = 8ull * (uint64_t)mlen;
    w[14] = (uint32_t)(bits >> 32);
    w[15] = (uint32_t)bits;
  }
}

// Blocks [first, nblocks) of a message of mlen bytes from src into s:
// those before `last` are whole in src (src.load); with Blocks::kTail the
// others hold the value's end or lie past it (src.load_tail) and are
// padded.  Block b + 1's loads are issued before block b's compression,
// which does not read them.  One loop, so one copy of the compression's
// code runs whatever the length (a short message's call fetches it once).
template <class Blocks>
__device__ __forceinline__ void compress_run(uint32_t s[8], Blocks& src, int64_t first,
                                             int64_t nblocks, int64_t last, int64_t mlen) {
  if (first >= nblocks) return;
  if constexpr (Blocks::kTail) {
    if (first < last)
      src.load(first);
    else
      src.load_tail(first);
  } else {
    src.load(first);
  }
  for (int64_t b = first; b < nblocks; ++b) {
    uint32_t w[16];
    src.words(w);
    if constexpr (Blocks::kTail) {
      if (b >= last) pad_block(w, mlen, b, nblocks);
    }
    if (b + 1 < last) {
      src.load(b + 1);
    } else if constexpr (Blocks::kTail) {
      if (b + 1 < nblocks) src.load_tail(b + 1);
    }
    compress(s, w);
  }
}

// Block 0 of the padded Merkle leaf 0x00 ‖ index₈ ‖ v[0, len) (of nblocks):
// the value's bytes from the aligned 32-bit words that hold one of them,
// the prefix put in, then padded.
__device__ __forceinline__ void leaf_block0(uint32_t w[16], const uint8_t* v, int64_t len,
                                            uint32_t index, int64_t nblocks) {
  const int end = 9 + len > 64 ? 64 : (int)(9 + len);  // the value's bytes: [9, end)
  const uintptr_t start = (uintptr_t)v - 9;  // the block's first byte, before v
  const int sh = (int)(start & 3);
  const uint32_t* a0 = reinterpret_cast<const uint32_t*>(start - (uintptr_t)sh);
  const uint32_t sel = be_selector(sh);
  uint32_t r[17];
#pragma unroll
  for (int q = 0; q < 17; ++q)  // word q holds block bytes [4q − sh, 4q − sh + 4)
    r[q] = 4 * q - sh + 4 > 9 && 4 * q - sh < end ? a0[q] : 0u;
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = __byte_perm(r[j], r[j + 1], sel);
  // bytes 0..8: 0x00, then the index's 8 big-endian bytes
  w[0] = 0u;
  w[1] = index >> 8;
  w[2] = (w[2] & 0x00FFFFFFu) | index << 24;
  pad_block(w, 9 + len, 0, nblocks);
}

// The digest of prefix ‖ v[0, len): PLEN = 0, no prefix; PLEN = 9, the
// Merkle leaf prefix 0x00 ‖ index₈ (its block 0 by leaf_block0).  v may
// start at any byte.
template <int PLEN>
__device__ __forceinline__ void hash_message(uint32_t s[8], const uint8_t* v, int64_t len,
                                             uint32_t index) {
  const int64_t mlen = PLEN + len;
  const int64_t nblocks = (mlen + 72) / 64;  // the message, 0x80 and 8 length bytes
  init_state(s);
  if (PLEN) {
    uint32_t w[16];
    leaf_block0(w, v, len, index, nblocks);
    compress(s, w);
  }
  // from mlen / 64 on, blocks hold padding
  ByteBlocks src(v, len, PLEN);
  compress_run(s, src, PLEN ? 1 : 0, nblocks, mlen / 64, mlen);
}

}  // namespace
