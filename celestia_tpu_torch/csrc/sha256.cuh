// SHA-256 compression shared by the port's hashing kernels (K1, K2, K3, K5,
// the NMT tree kernel and the DAH merkle kernel).
//
// One thread runs one message: the 16-word schedule window and the 8 state
// words stay in registers, the 64 rounds are fully unrolled so every
// schedule index is a compile-time constant, and the rotates are funnel
// shifts. The NMT leaf message (0x00 ‖ 29-byte namespace ‖ 512-byte cell,
// 542 bytes, 9 blocks) is assembled from a cell held as 128 little-endian
// words (in shared memory for K1 and K5, in registers for K2): cell byte b
// sits at message byte 30 + b, so every big-endian message word straddles
// two aligned cell words by two bytes and is put together with one byte
// permute.
#pragma once

#include <stdint.h>

namespace celestia {

static __constant__ uint32_t kSha256K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__device__ __forceinline__ void sha256_init(uint32_t st[8]) {
  st[0] = 0x6A09E667u; st[1] = 0xBB67AE85u; st[2] = 0x3C6EF372u; st[3] = 0xA54FF53Au;
  st[4] = 0x510E527Fu; st[5] = 0x9B05688Cu; st[6] = 0x1F83D9ABu; st[7] = 0x5BE0CD19u;
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One compression of the 16 big-endian words w into st; w is clobbered
// (it holds the rolling schedule window).
__device__ __forceinline__ void sha256_compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + kSha256K[t] + wt;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + S0 + maj;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// The message schedule of one block, for a thread that runs only the
// rounds: kw[t * stride] = K[t] + W[t] for t = 0..63 (the tree and merkle
// kernels' helper threads run it for the latency-bound upper levels).
__device__ __forceinline__ void expand_kw(uint32_t w[16], uint32_t* kw, int stride) {
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    kw[t * stride] = wt + kSha256K[t];
  }
}

// sha256_compress's 64 rounds over a precomputed K + W.
__device__ __forceinline__ void compress_kw(uint32_t st[8], const uint32_t* kw, int stride) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + kw[t * stride];
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + S0 + maj;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// Message words 0..6 and the top half of word 7 of a leaf message, from the
// namespace as 8 little-endian words (29 bytes, zero-padded to 32): message
// byte 4j+q is 0x00 for j = q = 0, else namespace byte 4j+q-1.
__device__ __forceinline__ void leaf_prefix_from_ns(const uint32_t nsw[8], uint32_t pre[8]) {
  uint32_t prev = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // bytes (hi..lo): prev.b3, cur.b0, cur.b1, cur.b2
    pre[j] = __byte_perm(prev, nsw[j], 0x3456);
    prev = nsw[j];
  }
  pre[7] &= 0xFFFF0000u;
}

// The prefix of a parity cell's leaf message: 0x00 ‖ 0xFF × 29.
__device__ __forceinline__ void leaf_prefix_parity(uint32_t pre[8]) {
  pre[0] = 0x00FFFFFFu;
#pragma unroll
  for (int j = 1; j < 7; ++j) pre[j] = 0xFFFFFFFFu;
  pre[7] = 0xFFFF0000u;
}

// Big-endian message word covering cell bytes 4m+2 .. 4m+5 (message word
// m + 8): the top two bytes of aligned cell word m, then the low two bytes
// of the next one (for m = 127, the 0x80 that starts the padding).
__device__ __forceinline__ uint32_t cell_word(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x2345);
}

// SHA-256 of the 542-byte NMT leaf message 0x00 ‖ ns ‖ cell. cw: the cell as
// 128 little-endian words (shared memory); pre: leaf_prefix_*; st: digest.
__device__ __forceinline__ void leaf_digest(const uint32_t* cw, const uint32_t pre[8],
                                            uint32_t st[8]) {
  uint32_t w[16];
  sha256_init(st);
  // block 0: message words 0..15
#pragma unroll
  for (int j = 0; j < 7; ++j) w[j] = pre[j];
  w[7] = pre[7] | __byte_perm(cw[0], 0u, 0x4401);  // ns[27] ns[28] cell[0] cell[1]
#pragma unroll
  for (int j = 0; j < 8; ++j) w[8 + j] = cell_word(cw[j], cw[j + 1]);
  sha256_compress(st, w);
  // blocks 1..7: message words 16..127, all inside the cell
#pragma unroll 1
  for (int blk = 1; blk < 8; ++blk) {
    const uint32_t* src = cw + 16 * blk - 8;
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = cell_word(src[j], src[j + 1]);
    sha256_compress(st, w);
  }
  // block 8: words 128..134 in the cell, 135 ends it with 0x80, then the
  // zero fill and the bit length 542 * 8
#pragma unroll
  for (int j = 0; j < 7; ++j) w[j] = cell_word(cw[120 + j], cw[121 + j]);
  w[7] = cell_word(cw[127], 0x80u);
#pragma unroll
  for (int j = 8; j < 15; ++j) w[j] = 0u;
  w[15] = 542u * 8u;
  sha256_compress(st, w);
}

// leaf_digest fed one quarter of the cell (128 bytes, 32 words) at a time,
// q = 0..3 (K5 receives a cell as four 128-lane chunks): quarter q completes
// blocks 2q and 2q + 1 (and 8 for q = 3). carry holds words 24..31 of the
// previous quarter, whose last two bytes start the next block. After q = 3,
// st is the digest.
__device__ __forceinline__ void leaf_digest_quarter(uint32_t st[8], uint32_t carry[8],
                                                    const uint32_t* cw, int q,
                                                    const uint32_t pre[8]) {
  if (q == 0) sha256_init(st);
  const int blocks = q == 3 ? 3 : 2;
#pragma unroll 1
  for (int blk = 0; blk < blocks; ++blk) {
    uint32_t w[16];
    if (blk == 1) {  // cell words 8..24 of the quarter
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = cell_word(cw[8 + j], cw[9 + j]);
    } else if (blk == 2) {  // block 8: the cell's last 30 bytes and the padding
#pragma unroll
      for (int j = 0; j < 7; ++j) w[j] = cell_word(cw[24 + j], cw[25 + j]);
      w[7] = cell_word(cw[31], 0x80u);
#pragma unroll
      for (int j = 8; j < 15; ++j) w[j] = 0u;
      w[15] = 542u * 8u;
    } else if (q == 0) {  // block 0: the prefix, then cell words 0..8
#pragma unroll
      for (int j = 0; j < 7; ++j) w[j] = pre[j];
      w[7] = pre[7] | __byte_perm(cw[0], 0u, 0x4401);
#pragma unroll
      for (int j = 0; j < 8; ++j) w[8 + j] = cell_word(cw[j], cw[j + 1]);
    } else {  // the carried words 24..31 of quarter q - 1, then words 0..8
#pragma unroll
      for (int j = 0; j < 7; ++j) w[j] = cell_word(carry[j], carry[j + 1]);
      w[7] = cell_word(carry[7], cw[0]);
#pragma unroll
      for (int j = 0; j < 8; ++j) w[8 + j] = cell_word(cw[j], cw[j + 1]);
    }
    sha256_compress(st, w);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) carry[j] = cw[24 + j];
}

}  // namespace celestia
