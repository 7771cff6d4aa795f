// bls_mont.cuh — BLS12-381 base field in Montgomery form for Hopper, and the
// complete addition, the 4-bit windowed ladder and the bit-serial ladder
// over it, shared by win_g1.cu, win_g2.cu and scan_g1.cu.  Each kernel
// source includes it and is built on its own, so everything lives in an
// anonymous namespace; kernels.lib_path hashes every *.cuh into each
// kernel's build tag.
//
// Representation: an Fq element is 12 words of 32 bits, little-endian,
// holding a·R mod p with R = 2^384, always fully reduced to [0, p).
// Products are the CIOS Montgomery product with 64-bit partial products
// (2·12² + 12 = 300 of them) in its "no-carry" form: p's top word is
// 0x1a0111ea < (2^32 − 1)/2 − 1, so with a, b < p the running sum fits 12
// words and the per-row carry words vanish.  Every partial step is
// x = a·b + t + c in uint64, which cannot overflow ((2^32−1)² + 2(2^32−1)
// = 2^64 − 1).  A square (fe_sqr) is its own routine: the product's rows
// with the 12 squares a_i² and the 66 cross products a_i·a_j (i < j) taken
// once against the words of 2a — 78 products where a product takes 144
// (bounds at fe_sqr).  Add and sub are one carry chain plus a
// conditional correction by p.  3·b = 12 for G1 is four additions (2a, 4a, 8a,
// 8a + 4a): 12·(aR) = (12a)R.
//
// Fq2 = Fq[u]/(u² + 1) (Fq2Lane) is split over two threads, one
// component each, exchanging halves by shuffles; the twist's
// 3·b = 12(1 + u) gives mul_b3(a) = (12(a0 − a1), 12(a0 + a1)).  The
// complete addition is RCB 2015 Alg. 7 (a = 0) in the operation order of
// ops/ec.py PointKernel.add, and the ladder is the reference's: the table
// j·P by complete adds, then per 4-bit window, msb first, 4 doublings
// (complete adds) and one complete add of table[digit].  The bit-serial
// ladder (scan_g1) doubles with point_dbl, the complete addition with
// p == q in the same operation order, its six self-products squared.
// Fully reduced Montgomery results are unique residues, so fe_sqr(a)
// equals fe_mul(a, a) word for word and point_dbl(p) equals
// point_add(p, p).  Exact field
// arithmetic in the same order gives the same field elements as the
// plain PyTorch version, so kernel and plain version agree at canonical
// values (ModField.canon), coordinate by coordinate; their limbs differ.
//
// Entry conversion: a coordinate arrives as the reference's 38 limbs of
// 11 bits in int32.  The kernel accepts every limb in [−2^12, 2^12]
// (ModField.normalize's output has |limb| < 2^12 and value < 2^408; here
// the value may be anything those limbs give, negative included).  Each
// limb is biased by +2^12 into [0, 2^13], and
//   S = Σ (l_i + 2^12) · (2^(11i) · R² mod p)  ≤  38 · 2^13 · p  <  2^400
// is one 13-word sum (column sums < 2^51 in uint64).  One Montgomery
// reduction of S gives (v + C0)·R mod p with C0 = 2^12 · Σ 2^(11i), and a
// modular subtraction of C0·R mod p leaves v·R mod p.
//
// Exit conversion: one Montgomery reduction of (x, 0) gives x·R⁻¹ < p, the
// canonical residue, split into 38 limbs of 11 bits (limb 37 is 0).  Those
// limbs satisfy ModField's invariant, so the torch trees and the host
// converters take them unchanged.
//
// Every routine but the Fq product and square is __forceinline__ on values,
// and those two are calls on register values: coordinates and temporaries
// are register arrays indexed by constants, with no pointer into the stack.
// One copy of each one's unrolled code serves all its call sites,
// which keeps the ladder's code small (inlined, it ran 2× slower on the
// H100, likely from instruction-cache misses).  The constants are
// __constant__, so the unrolled products take p's words as constant-bank
// operands.  tests/test_torch_mont.py checks every table against Python
// integers, models the routines word by word, and compiles this header
// on the host to run the ladder itself (G2's lane pair emulated there).

#pragma once

#include <cstdint>

namespace {

constexpr int NW = 12;         // 32-bit words per Fq element
constexpr int L = 38;          // the reference's 11-bit limbs per element
constexpr int LIMB_BITS = 11;
constexpr uint32_t LIMB_MASK = (1u << LIMB_BITS) - 1;
constexpr int32_t ENTRY_BIAS = 1 << 12;
constexpr uint32_t PINV = 0xfffcfffdu;  // −p⁻¹ mod 2^32

// p, little-endian words
__constant__ uint32_t P_W[NW] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// R mod p: 1 in Montgomery form (the identity's Y)
__constant__ uint32_t ONE_W[NW] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
// R² mod p (TO_MONT[0]; kept by name for the tests' check)
__constant__ uint32_t R2_W[NW] = {
    0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u, 0x4c95b6d5u, 0x8de5476cu,
    0x939d83c0u, 0x67eb88a9u, 0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u};
// C0·R mod p, C0 = 2^12 · Σ_{i<38} 2^(11i): the entry bias in Montgomery form
__constant__ uint32_t BIAS_W[NW] = {
    0x679139dfu, 0x7647c4b5u, 0x242415b8u, 0xb3a43b36u, 0x7f1fe4d0u, 0xab8f755cu,
    0x648d501eu, 0x20183822u, 0xcf66076eu, 0x76552622u, 0xc6377ec9u, 0x02622b2eu};
// TO_MONT[i] = 2^(11i) · R² mod p
__constant__ uint32_t TO_MONT[L][NW] = {
    {0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u, 0x4c95b6d5u, 0x8de5476cu, 0x939d83c0u, 0x67eb88a9u, 0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u},
    {0xa287d8ddu, 0xb462a0e1u, 0x28b39121u, 0xc6a93761u, 0x0a52fee9u, 0xe317d98eu, 0x712b96e9u, 0xd2ddba53u, 0xb83f51f0u, 0x7155d496u, 0x4226bc13u, 0x14b54065u},
    {0x40e63b36u, 0xcf650d14u, 0x87b10f60u, 0xfe931198u, 0xdd381439u, 0xb5ef536fu, 0xd369f065u, 0x3e3fc302u, 0x7eb90325u, 0x748edb41u, 0x19825120u, 0x173318b7u},
    {0x343aad9fu, 0xc18ba207u, 0xfdff086eu, 0xb308cd91u, 0x2fb52c2du, 0x092c4c29u, 0x60ce61b2u, 0xfeb820c5u, 0x8306a4bfu, 0x707c2233u, 0xb6be447eu, 0x0322de33u},
    {0xd5bef7aeu, 0xa20639a1u, 0x918b764fu, 0xcd249131u, 0x9b54e6e2u, 0x3976e2d0u, 0x712d8c5cu, 0x36639944u, 0x8a6de8fbu, 0xb47e72f3u, 0xb13c5b3fu, 0x19ea66a2u},
    {0xfa65c2adu, 0x4fc60eadu, 0x94fe7f3eu, 0x9b3d96f8u, 0xde5cb070u, 0x02d73f8bu, 0xec7069ceu, 0x21b10c8fu, 0xe8f2d873u, 0x241b8034u, 0x76247983u, 0x00ad4125u},
    {0x2e271299u, 0xaeaa6fd3u, 0x3d95f28cu, 0x931bc4edu, 0xd2e08f5fu, 0x5ce0c39fu, 0x18c18e76u, 0xbbb1dcddu, 0xa818d075u, 0x4f47ee8bu, 0x3c515b2fu, 0x07d07633u},
    {0x3961c733u, 0x7fe59971u, 0xaec8661du, 0x2ef36d10u, 0x615babd3u, 0x1fd2fde6u, 0x07c3a916u, 0x34507c61u, 0x1bb7746bu, 0xd0047665u, 0x68967dcfu, 0x0b1f9032u},
    {0x0f5d96dcu, 0xb83789cbu, 0x77c0eceeu, 0xa6d889efu, 0xb7d455deu, 0x7cde743eu, 0xd1ec8a09u, 0xbbac9d4cu, 0x74afe896u, 0x2111452fu, 0xf2456687u, 0x00d845c7u},
    {0xecccdfeau, 0xc890587au, 0x4fbf75d3u, 0xdbf77c14u, 0x090f7fe6u, 0x590ba83fu, 0x9c01768eu, 0x7e28ee48u, 0x25c22655u, 0x2d083ea8u, 0x583ac541u, 0x0de7a12fu},
    {0x686c4e93u, 0xf10ad766u, 0x7d629f6fu, 0x8a2ca815u, 0x4d126260u, 0xfb6d09c9u, 0x6d814215u, 0x8d2e3f32u, 0x38825ea2u, 0xfeaae494u, 0xe416ab70u, 0x0275d9e5u},
    {0x62b4ed15u, 0x1d7c3343u, 0x64a77fbdu, 0x4594ace7u, 0x97a97316u, 0x9c7f7f0eu, 0x72bd8d8eu, 0xb409a430u, 0x56e7c606u, 0xb74b315bu, 0x5beeada2u, 0x1400ad8bu},
    {0xa975a5f3u, 0x91c11b15u, 0x4031ea9au, 0xf1334330u, 0x90de59f3u, 0x1e98986fu, 0xb4b61d50u, 0x332fe49fu, 0x379bd475u, 0x4266085fu, 0xb3895676u, 0x08d722d7u},
    {0xae179718u, 0x5b90ad4bu, 0x72f4d54cu, 0x3679858fu, 0x41b26d56u, 0x3806d6e8u, 0x9f1f8894u, 0x5acfac2fu, 0xe8e5c000u, 0xfd130235u, 0xf6f8be96u, 0x062e08cfu},
    {0xbd5abf5eu, 0x6b505d70u, 0x01326361u, 0x91a47e13u, 0x3f776921u, 0x50076479u, 0xada30a62u, 0xc2e81e92u, 0x6c55e1edu, 0x01914b43u, 0x9d24eefeu, 0x123e7d0eu},
    {0xd7d998ccu, 0x308785eau, 0xdfeb0ce3u, 0x17209f5eu, 0xf2a459f1u, 0x65464b13u, 0x19dde8d9u, 0xb3c8f7a7u, 0x3291e5dfu, 0x3b395901u, 0x9e06668fu, 0x15e7f70eu},
    {0xcf055dc1u, 0xf0ec56beu, 0x75631b5bu, 0x57feffceu, 0xdc64f756u, 0xde5d58f6u, 0x0797776fu, 0x4fe559f2u, 0x1a43563eu, 0xb16ef271u, 0xc05f9c2du, 0x0682bdaau},
    {0x2b98b200u, 0x64b5f678u, 0x70dae013u, 0x9ffe7648u, 0xc5ce6a82u, 0x892274f5u, 0xb1960024u, 0x3c388655u, 0x835843b6u, 0x40441c4bu, 0xfd1438f5u, 0x13c9818fu},
    {0xc797534eu, 0xb9c9c15cu, 0xa1c89ccfu, 0x48ea4b7bu, 0x1a5a152du, 0x1085ce91u, 0xa4210b6bu, 0x562d126au, 0x338fcb04u, 0x0693acddu, 0xb1623afdu, 0x0989786eu},
    {0xbb94c45bu, 0xaaf9e63cu, 0x0f7a7e9bu, 0x57c7e0e4u, 0x1f875651u, 0x763aa29fu, 0xa4f95904u, 0xae9cca1au, 0x135816d1u, 0x4745e9edu, 0x63a26992u, 0x029fe76cu},
    {0xa6678266u, 0x23ffe5dcu, 0x225cdd90u, 0x909f2189u, 0xb84c79adu, 0xcbcb7b75u, 0xd5b30dacu, 0x0e52102bu, 0x99d17822u, 0xbf0e73f0u, 0xce610211u, 0x125ef8a2u},
    {0x3df52e1eu, 0x68d4e533u, 0x467482abu, 0xb9845075u, 0xf83f1c7fu, 0x7e15f490u, 0x16c5813du, 0x16accdb6u, 0x6e4ec7d1u, 0x356a354eu, 0x3fa00274u, 0x15b9e572u},
    {0xabab431bu, 0x87d899efu, 0x73a95d1au, 0x22efb2f0u, 0x3026e263u, 0x0054c5f1u, 0x95a19eaeu, 0xed1bf31eu, 0xaf76551cu, 0x53d48846u, 0xb23d606fu, 0x0204d586u},
    {0x5a4dd7cbu, 0x3f6e7d5du, 0x27bcd46au, 0x70c3846du, 0xff2a38a8u, 0x8edcb787u, 0xcd4ecb21u, 0x79810d19u, 0xe6a88da1u, 0xfe150b47u, 0x349340c9u, 0x00021518u},
    {0x6ebe5800u, 0x73eaead2u, 0xe6a351fbu, 0x1c23693du, 0x51c54386u, 0xe5bc3ff9u, 0x76590c76u, 0x0868ce6au, 0x446d0bccu, 0xa85a3f35u, 0x9a064ff0u, 0x10a8c1a4u},
    {0xf47553a0u, 0x1c769375u, 0x4c0fdd06u, 0xe9c9f5e8u, 0xdf2eb7c3u, 0x07c8519du, 0xbe63a23du, 0x63104a52u, 0x84889060u, 0xe43e240au, 0x8301ae81u, 0x00915469u},
    {0xaaabaa9cu, 0xbcc7afa3u, 0x047830efu, 0x0a1f429au, 0x0f53d119u, 0x8628bb4fu, 0x4232af58u, 0x3dd19b19u, 0xb3814e13u, 0x085f80d0u, 0x2b786c9du, 0x127437d6u},
    {0x5f393371u, 0x912a1d55u, 0x47c37f73u, 0xe3d8d78fu, 0x7423bd4eu, 0x95befce2u, 0x6b2f5bd4u, 0x53c12877u, 0x15ec9769u, 0xb00fa020u, 0x68750e86u, 0x09ac02f3u},
    {0xca9931adu, 0x69e3aaf9u, 0xf9479d59u, 0x99707e20u, 0xc9dec5bfu, 0x37c4f323u, 0x9449e9b4u, 0x62a43d21u, 0x58c67e54u, 0x37cb73e1u, 0xbb3fb4d7u, 0x12e959feu},
    {0xcb7dbb65u, 0x4928ce54u, 0xd356cce6u, 0x1d850f64u, 0x1ae654b5u, 0xf4a00414u, 0xe64b9676u, 0xc80acc55u, 0xc8ca5245u, 0x7fc48fa8u, 0x8cba724fu, 0x0a96c281u},
    {0xeef0d195u, 0x0fb3a65bu, 0xb413332du, 0x5acf2adbu, 0x7cd4bd64u, 0x3a434314u, 0xf8b1b6d6u, 0x6e35f395u, 0x5954c562u, 0xbf808e35u, 0xba651fefu, 0x1898c140u},
    {0x89125025u, 0x4ac3df77u, 0xdd056a8fu, 0x65eae784u, 0x14f4bb8au, 0x51aeeffcu, 0xfbd3d796u, 0x84fa46ceu, 0x769449b2u, 0xb831b0b7u, 0x183fa889u, 0x03f17896u},
    {0x92e87ceeu, 0xe431bc48u, 0x6f9c7aaau, 0x32f4287du, 0xeb924372u, 0x8260d1bcu, 0xbb97fec6u, 0x29c104dfu, 0x24aa4754u, 0x9a08a4ffu, 0x5c630eeau, 0x0e78ff20u},
    {0x4563192fu, 0x04554497u, 0xeb195859u, 0x29fff14du, 0xfcc46ee3u, 0xe854c532u, 0x46e3ca7au, 0x0961fd55u, 0xe8889efau, 0x191cc937u, 0x44685454u, 0x15364dc5u},
    {0x1af6207eu, 0x54aaba2bu, 0x00cac9ebu, 0xe98277e0u, 0xdd1169afu, 0x7dab91dcu, 0x883b8aa7u, 0xadb404eau, 0x454e4b31u, 0xefe1b049u, 0x2a484e42u, 0x0f734c30u},
    {0xb29943c0u, 0xda9158d7u, 0x074f5bf1u, 0x62bf063cu, 0xc2bc53bau, 0x34a66a54u, 0x243c2ec3u, 0x69809cbdu, 0xcae48e50u, 0x4a25a86au, 0x22eaba9au, 0x154c68c1u},
    {0xcc4cfdd1u, 0x1f53bd94u, 0xd79b909fu, 0x0b75e8cau, 0xdd616879u, 0x387edda5u, 0xa2ba49ceu, 0xe36c3332u, 0x4db7444eu, 0x2919b160u, 0xaafb3193u, 0x0a43adbcu},
    {0x68fbdc48u, 0x9114a662u, 0x2b64f9d7u, 0xe0665addu, 0x6cbae65au, 0x44d462e0u, 0x364b45a6u, 0x49133975u, 0x5348ef46u, 0xbe41ab29u, 0x5ddcc24bu, 0x0a0d5a12u}};

struct Fe {
  uint32_t w[NW];
};

// s mod p for s < 2p: subtract p, keep s where that borrows.
__device__ __forceinline__ Fe fe_reduce_once(const Fe& s) {
  Fe d;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int64_t t = (int64_t)s.w[i] - (int64_t)P_W[i] + br;
    d.w[i] = (uint32_t)t;
    br = t >> 32;  // 0 or −1
  }
  const uint32_t keep = (uint32_t)br;  // all ones: s < p
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = (s.w[i] & keep) | (d.w[i] & ~keep);
  return r;
}

// a + b mod p, a, b < p (the sum < 2p < 2^382 fits 12 words).
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    s.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return fe_reduce_once(s);
}

// a − b mod p, a, b < p: subtract, and add p back where that borrows.
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int64_t t = (int64_t)a.w[i] - (int64_t)b.w[i] + br;
    d.w[i] = (uint32_t)t;
    br = t >> 32;
  }
  const uint32_t mask = (uint32_t)br;  // all ones: a < b
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)d.w[i] + (P_W[i] & mask);
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

// a·b·R⁻¹ mod p, a, b < p: CIOS, no-carry form (see the top of the file).
// The one routine that is not inlined: a call with its operands and
// result in registers (by value; ptxas gives it no stack).  Inlined at
// every call site it runs 2× slower (PERF.md).
__device__ __noinline__ Fe fe_mul(const Fe a, const Fe b) {
  Fe t;
#pragma unroll
  for (int j = 0; j < NW; ++j) t.w[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = b.w[i];
    uint64_t x = (uint64_t)a.w[0] * bi + t.w[0];
    uint64_t c = x >> 32;
    const uint32_t t0 = (uint32_t)x;
    const uint32_t m = t0 * PINV;
    uint64_t y = (uint64_t)m * P_W[0] + t0;
    uint64_t c2 = y >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      x = (uint64_t)a.w[j] * bi + t.w[j] + c;
      c = x >> 32;
      y = (uint64_t)m * P_W[j] + (uint32_t)x + c2;
      c2 = y >> 32;
      t.w[j - 1] = (uint32_t)y;
    }
    t.w[NW - 1] = (uint32_t)(c + c2);
  }
  return fe_reduce_once(t);
}

// a·a·R⁻¹ mod p, a < p: fe_mul's rows with the square's 78 products in
// place of 144.  Row i adds a_i·V_i, V_i = a_i·2^(32i) + 2·Σ_{j>i} a_j·2^(32j):
// a_i² first, then a_i times the words of 2a above word i (d, 2a < 2^382
// fits 12 words), the word just above i doubled without a_i's top bit —
// and then reduces one word, as fe_mul does.  Bounds: every step
// x = a_i·e + t + c < 2^64 as in fe_mul; V_i ≤ 2a < 2p, so a row adds
// < 2^33·p and, with t < 4p before it, leaves t < (4p + 2^33·p + 2^32·p)/2^32
// < 4p < 2^384: 12 words, the top word c + c2 without overflow (the
// products' cross terms are doubled, so this needs p < 2^382 where fe_mul's
// no-carry form needs p's top word below (2^32 − 1)/2 − 1).  The last t is
// (a² + M·p)/R < 2p, and one correction leaves the residue fe_mul(a, a)
// gives.  Not inlined, for the reason fe_mul is not.
__device__ __noinline__ Fe fe_sqr(const Fe a) {
  uint32_t d[NW];  // 2a
  d[0] = a.w[0] << 1;
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = (a.w[j] << 1) | (a.w[j - 1] >> 31);
  Fe t;
#pragma unroll
  for (int j = 0; j < NW; ++j) t.w[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t ai = a.w[i];
    uint64_t x = (uint64_t)ai * ai + t.w[i];
    t.w[i] = (uint32_t)x;
    uint64_t c = x >> 32;
#pragma unroll
    for (int j = i + 1; j < NW; ++j) {
      const uint32_t e = j == i + 1 ? a.w[j] << 1 : d[j];
      x = (uint64_t)ai * e + t.w[j] + c;
      t.w[j] = (uint32_t)x;
      c = x >> 32;
    }
    const uint32_t m = t.w[0] * PINV;
    uint64_t y = (uint64_t)m * P_W[0] + t.w[0];
    uint64_t c2 = y >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      y = (uint64_t)m * P_W[j] + t.w[j] + c2;
      t.w[j - 1] = (uint32_t)y;
      c2 = y >> 32;
    }
    t.w[NW - 1] = (uint32_t)(c + c2);
  }
  return fe_reduce_once(t);
}

// Montgomery reduction of a 13-word value s < 2^416 with s < p·R:
// s·R⁻¹ mod p.  After the first row the sum fits 12 words; the result
// before the last correction is < s/R + p < 2p.
__device__ __forceinline__ Fe fe_redc13(const uint32_t (&s)[NW + 1]) {
  uint32_t t[NW + 1];
#pragma unroll
  for (int j = 0; j <= NW; ++j) t[j] = s[j];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = t[0] * PINV;
    uint64_t y = (uint64_t)m * P_W[0] + t[0];
    uint64_t c = y >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      y = (uint64_t)m * P_W[j] + t[j] + c;
      t[j - 1] = (uint32_t)y;
      c = y >> 32;
    }
    y = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)y;
    t[NW] = (uint32_t)(y >> 32);
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = t[j];
  return fe_reduce_once(r);
}

__device__ __forceinline__ Fe fe_load(const uint32_t (&src)[NW]) {
  Fe r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = src[j];
  return r;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_one() { return fe_load(ONE_W); }

// 12·a by additions.
__device__ __forceinline__ Fe fe_mul12(const Fe& a) {
  const Fe a2 = fe_add(a, a);
  const Fe a4 = fe_add(a2, a2);
  const Fe a8 = fe_add(a4, a4);
  return fe_add(a8, a4);
}

// 38 reference limbs (each in [−2^12, 2^12]) → v·R mod p.
__device__ __forceinline__ Fe fe_from_limbs(const int32_t* limbs) {
  uint64_t col[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) col[j] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t l = (uint32_t)(limbs[i] + ENTRY_BIAS);  // [0, 2^13]
#pragma unroll
    for (int j = 0; j < NW; ++j) col[j] += (uint64_t)l * TO_MONT[i][j];
  }
  uint32_t s[NW + 1];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    c += col[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  s[NW] = (uint32_t)c;
  return fe_sub(fe_redc13(s), fe_load(BIAS_W));
}

// x·R⁻¹ (the canonical residue) → 38 limbs of 11 bits.
__device__ __forceinline__ void fe_to_limbs(const Fe& x, int32_t* limbs) {
  uint32_t s[NW + 1];
#pragma unroll
  for (int j = 0; j < NW; ++j) s[j] = x.w[j];
  s[NW] = 0;
  const Fe v = fe_redc13(s);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int bit = LIMB_BITS * i, w = bit / 32, sh = bit % 32;
    uint32_t lo = w < NW ? v.w[w] >> sh : 0u;
    if (sh + LIMB_BITS > 32 && w + 1 < NW) lo |= v.w[w + 1] << (32 - sh);
    limbs[i] = (int32_t)(lo & LIMB_MASK);
  }
}

// The field of G1.
struct FqM {
  using E = Fe;
  static constexpr int LIMBS = L;  // reference limbs an element
  __device__ static __forceinline__ E add(const E& a, const E& b) { return fe_add(a, b); }
  __device__ static __forceinline__ E sub(const E& a, const E& b) { return fe_sub(a, b); }
  __device__ static __forceinline__ E mul(const E& a, const E& b) { return fe_mul(a, b); }
  __device__ static __forceinline__ E sqr(const E& a) { return fe_sqr(a); }
  __device__ static __forceinline__ E mul_b3(const E& a) { return fe_mul12(a); }
  __device__ static __forceinline__ E zero() { return fe_zero(); }
  __device__ static __forceinline__ E one() { return fe_one(); }
  __device__ static __forceinline__ E load(const int32_t* src) { return fe_from_limbs(src); }
  __device__ static __forceinline__ void store(const E& a, int32_t* dst) { fe_to_limbs(a, dst); }
};

// The field of G2, Fq2 = Fq[u]/(u² + 1), split over a pair of threads:
// lane h (thread parity) holds component c_h of every Fq2 value, and the
// pair's elements are [2][38] limbs at the boundary.  Add, sub and the
// ladder's control are per lane.  A product swaps the operands' other
// halves with the partner lane (__shfl_xor_sync, so a block's threads
// must be whole warps) and computes c0 = a0b0 − a1b1 on lane 0 and
// c1 = a1b0 + a0b1 on lane 1 by lane masks, not branches: the pair never
// diverges.  That is 4 Fq products an Fq2 product where Karatsuba's 3 on
// one thread would do, for half the registers a thread (win_g2.cu).
// 3·b = 12(1 + u) gives mul_b3(a) = (12(a0 − a1), 12(a0 + a1)).
struct Fq2Lane {
  using E = Fe;
  static constexpr int LIMBS = 2 * L;  // coordinate stride at the boundary
  __device__ static __forceinline__ uint32_t lane_mask() {
    return 0u - (threadIdx.x & 1u);  // all ones on lane 1
  }
  __device__ static __forceinline__ E other(const E& a) {
    E r;
#pragma unroll
    for (int j = 0; j < NW; ++j) r.w[j] = __shfl_xor_sync(0xffffffffu, a.w[j], 1);
    return r;
  }
  // m ? b : a, word by word
  __device__ static __forceinline__ E pick(uint32_t m, const E& a, const E& b) {
    E r;
#pragma unroll
    for (int j = 0; j < NW; ++j) r.w[j] = (a.w[j] & ~m) | (b.w[j] & m);
    return r;
  }
  __device__ static __forceinline__ E add(const E& a, const E& b) { return fe_add(a, b); }
  __device__ static __forceinline__ E sub(const E& a, const E& b) { return fe_sub(a, b); }
  __device__ static __forceinline__ E mul(const E& a, const E& b) {
    const uint32_t m = lane_mask();
    const E a_o = other(a), b_o = other(b);
    const E p1 = fe_mul(a, pick(m, b, b_o));    // a0b0 | a1b0
    const E p2 = fe_mul(a_o, pick(m, b_o, b));  // a1b1 | a0b1
    return pick(m, fe_sub(p1, p2), fe_add(p1, p2));
  }
  // 12(a0 − a1) on lane 0, 12(a0 + a1) on lane 1
  __device__ static __forceinline__ E mul_b3(const E& a) {
    const E a_o = other(a);
    return fe_mul12(pick(lane_mask(), fe_sub(a, a_o), fe_add(a, a_o)));
  }
  __device__ static __forceinline__ E zero() { return fe_zero(); }
  __device__ static __forceinline__ E one() { return pick(lane_mask(), fe_one(), fe_zero()); }
  __device__ static __forceinline__ E load(const int32_t* src) {
    return fe_from_limbs(src + (threadIdx.x & 1) * L);
  }
  __device__ static __forceinline__ void store(const E& a, int32_t* dst) {
    fe_to_limbs(a, dst + (threadIdx.x & 1) * L);
  }
};

template <class F>
struct Pt {
  typename F::E x, y, z;
};

template <class F>
__device__ __forceinline__ Pt<F> pt_identity() {
  return {F::zero(), F::one(), F::zero()};
}

// The first six products of the complete addition: a·b, or a·a by F::sqr
// when the addition is a doubling (then b == a).
template <class F, bool DBL>
__device__ __forceinline__ typename F::E self_mul(const typename F::E& a,
                                                  const typename F::E& b) {
  if constexpr (DBL) {
    return F::sqr(a);
  } else {
    return F::mul(a, b);
  }
}

// Complete addition p + q (RCB 2015 Alg. 7, a = 0) in the operation order
// of ops/ec.py PointKernel.add; valid for p == q and for identities.  With
// DBL (and q == p) its six products of an element by itself are squares.
template <class F, bool DBL>
__device__ __forceinline__ Pt<F> complete_add(const Pt<F>& p, const Pt<F>& q) {
  using E = typename F::E;
  E t0 = self_mul<F, DBL>(p.x, q.x);
  E t1 = self_mul<F, DBL>(p.y, q.y);
  E t2 = self_mul<F, DBL>(p.z, q.z);
  E t3 = self_mul<F, DBL>(F::add(p.x, p.y), F::add(q.x, q.y));
  t3 = F::sub(t3, F::add(t0, t1));
  E t4 = self_mul<F, DBL>(F::add(p.y, p.z), F::add(q.y, q.z));
  t4 = F::sub(t4, F::add(t1, t2));
  E X3 = self_mul<F, DBL>(F::add(p.x, p.z), F::add(q.x, q.z));
  E Y3 = F::sub(X3, F::add(t0, t2));
  X3 = F::add(t0, t0);
  t0 = F::add(X3, t0);
  t2 = F::mul_b3(t2);
  E Z3 = F::add(t1, t2);
  t1 = F::sub(t1, t2);
  Y3 = F::mul_b3(Y3);
  X3 = F::sub(F::mul(t3, t1), F::mul(t4, Y3));
  Y3 = F::add(F::mul(t1, Z3), F::mul(Y3, t0));
  Z3 = F::add(F::mul(Z3, t4), F::mul(t0, t3));
  return {X3, Y3, Z3};
}

template <class F>
__device__ __forceinline__ Pt<F> point_add(const Pt<F>& p, const Pt<F>& q) {
  return complete_add<F, false>(p, q);
}

// point_add(p, p), word for word, with six squares for six products.
template <class F>
__device__ __forceinline__ Pt<F> point_dbl(const Pt<F>& p) {
  return complete_add<F, true>(p, p);
}

template <class F>
__device__ __forceinline__ Pt<F> pt_load(const int32_t* src) {
  return {F::load(src), F::load(src + F::LIMBS), F::load(src + 2 * F::LIMBS)};
}

template <class F>
__device__ __forceinline__ void pt_store(const Pt<F>& p, int32_t* dst) {
  F::store(p.x, dst);
  F::store(p.y, dst + F::LIMBS);
  F::store(p.z, dst + 2 * F::LIMBS);
}

// One thread's 4-bit fixed-window ladder (pallas_ec._make_windowed_kernel):
// the table j·P (j = 0..15) by complete adds, then per window, msb first,
// 4 doublings and one complete add of table[digit]; a digit outside 0..15
// selects the identity, as the reference's masked cascade does.  All
// 14 + 5·nwin complete adds go through one inlined point_add (one copy of
// its code).  The table (16 points) lives in local memory; `src` is
// [3 · F::LIMBS] reference limbs, and the caller stores the result with
// pt_store.
template <class F>
__device__ __forceinline__ Pt<F> windowed_ladder(const int32_t* src, const int32_t* dig,
                                                 int nwin) {
  Pt<F> table[16];
  table[0] = pt_identity<F>();
  table[1] = pt_load<F>(src);
  Pt<F> acc = table[1];
  const int steps = 14 + 5 * nwin;
  for (int s = 0; s < steps; ++s) {
    Pt<F> q;
    if (s < 14) {
      q = table[1];  // table[s + 2] = table[s + 1] + P
    } else {
      const int w = (s - 14) / 5, r = (s - 14) % 5;
      if (s == 14) acc = pt_identity<F>();
      if (r < 4) {
        q = acc;  // doubling, as a complete add
      } else {
        int d = dig[w];
        if (d < 0 || d > 15) d = 0;  // the cascade's default: identity
        q = table[d];
      }
    }
    acc = point_add<F>(acc, q);
    if (s < 14) table[s + 2] = acc;
  }
  if (steps == 14) acc = pt_identity<F>();  // nwin == 0: the empty sum
  return acc;
}

// One thread's bit-serial ladder (pallas_ec._scalar_mul_kernel): from the
// identity, msb first, acc = 2·acc (point_dbl), then acc = bit ? acc + P :
// acc, where any nonzero bit of the row's nbits int32 `bits` selects.
template <class F>
__device__ __forceinline__ Pt<F> scan_ladder(const Pt<F>& base, const int32_t* bits, int nbits) {
  Pt<F> acc = pt_identity<F>();
  for (int i = 0; i < nbits; ++i) {
    acc = point_dbl<F>(acc);
    const Pt<F> with_p = point_add<F>(acc, base);
    if (bits[i] != 0) acc = with_p;
  }
  return acc;
}

}  // namespace
