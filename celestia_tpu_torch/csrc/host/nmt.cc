// The port's native SHA-256, Namespaced Merkle Tree roots and DAH hash on
// the CPU (pkg/wrapper/nmt_wrapper.go semantics with nmt v0.20
// IgnoreMaxNamespace). Byte-identical to celestia_tpu_torch/ops/nmt_host.py.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNsSize = 29;
constexpr int kNodeSize = 2 * kNsSize + 32;  // 90

// ---------------- SHA-256 ----------------

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

void sha256(const uint8_t* msg, size_t len, uint8_t out[32]) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  size_t total = ((len + 8) / 64 + 1) * 64;
  std::vector<uint8_t> buf(total, 0);
  std::memcpy(buf.data(), msg, len);
  buf[len] = 0x80;
  uint64_t bits = (uint64_t)len * 8;
  for (int i = 0; i < 8; ++i) buf[total - 1 - i] = (bits >> (8 * i)) & 0xFF;

  for (size_t blk = 0; blk < total; blk += 64) {
    uint32_t w[64];
    for (int t = 0; t < 16; ++t)
      w[t] = (buf[blk + 4 * t] << 24) | (buf[blk + 4 * t + 1] << 16) |
             (buf[blk + 4 * t + 2] << 8) | buf[blk + 4 * t + 3];
    for (int t = 16; t < 64; ++t) {
      uint32_t s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3);
      uint32_t s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10);
      w[t] = w[t - 16] + s0 + w[t - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int t = 0; t < 64; ++t) {
      uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + s1 + ch + K[t] + w[t];
      uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      hh = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
  for (int i = 0; i < 8; ++i) {
    out[4 * i] = h[i] >> 24;
    out[4 * i + 1] = h[i] >> 16;
    out[4 * i + 2] = h[i] >> 8;
    out[4 * i + 3] = h[i];
  }
}

// ---------------- NMT ----------------

const uint8_t kParityNs[kNsSize] = {0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
                                    0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
                                    0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
                                    0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
                                    0xFF};

// node layout: minNs(29) ‖ maxNs(29) ‖ digest(32)
void nmt_hash_leaf(const uint8_t* ns, const uint8_t* data, size_t data_len,
                   uint8_t* node) {
  std::vector<uint8_t> msg(1 + kNsSize + data_len);
  msg[0] = 0x00;
  std::memcpy(msg.data() + 1, ns, kNsSize);
  std::memcpy(msg.data() + 1 + kNsSize, data, data_len);
  std::memcpy(node, ns, kNsSize);
  std::memcpy(node + kNsSize, ns, kNsSize);
  sha256(msg.data(), msg.size(), node + 2 * kNsSize);
}

void nmt_hash_node(const uint8_t* left, const uint8_t* right, uint8_t* node) {
  uint8_t msg[1 + 2 * kNodeSize];
  msg[0] = 0x01;
  std::memcpy(msg + 1, left, kNodeSize);
  std::memcpy(msg + 1 + kNodeSize, right, kNodeSize);
  // Two-branch specialization of nmt v0.20 HashNode (IgnoreMaxNamespace):
  //   min = left.min; max = (right.min == parity) ? left.max : right.max
  // Equal to the general three-branch rule for every tree with
  // non-decreasing leaf namespaces — guaranteed here because this path only
  // hashes honest EDS axes (Q0 sorted, parity in Q1/Q2/Q3). The general
  // hasher incl. order validation lives in ops/nmt_host.py; agreement is
  // pinned by tests/test_nmt_semantics.py.
  std::memcpy(node, left, kNsSize);
  bool right_parity = std::memcmp(right, kParityNs, kNsSize) == 0;
  std::memcpy(node + kNsSize, (right_parity ? left : right) + kNsSize, kNsSize);
  sha256(msg, sizeof(msg), node + 2 * kNsSize);
}

}  // namespace

extern "C" {

// NMT roots of every row and column of a 2k x 2k EDS.
// eds: row-major (2k, 2k, shard_size); Q0 cells use their own namespace
// (first 29 bytes of the share), parity cells the parity namespace
// (pkg/wrapper/nmt_wrapper.go:93-114). Output: row_roots then col_roots,
// each 2k x 90 bytes.
void eds_nmt_roots(int k, size_t shard_size, const uint8_t* eds,
                   uint8_t* row_roots, uint8_t* col_roots) {
  const int w = 2 * k;
  // Leaf nodes are shared between row and column trees.
  std::vector<uint8_t> leaves((size_t)w * w * kNodeSize);
  for (int i = 0; i < w; ++i) {
    for (int j = 0; j < w; ++j) {
      const uint8_t* share = eds + ((size_t)i * w + j) * shard_size;
      const uint8_t* ns = (i < k && j < k) ? share : kParityNs;
      nmt_hash_leaf(ns, share, shard_size,
                    leaves.data() + ((size_t)i * w + j) * kNodeSize);
    }
  }

  std::vector<uint8_t> level((size_t)w * kNodeSize);
  std::vector<uint8_t> next((size_t)w * kNodeSize);
  for (int axis = 0; axis < 2 * w; ++axis) {
    bool is_row = axis < w;
    int idx = is_row ? axis : axis - w;
    for (int p = 0; p < w; ++p) {
      size_t cell = is_row ? ((size_t)idx * w + p) : ((size_t)p * w + idx);
      std::memcpy(level.data() + (size_t)p * kNodeSize,
                  leaves.data() + cell * kNodeSize, kNodeSize);
    }
    for (int n = w; n > 1; n /= 2) {
      for (int p = 0; p < n / 2; ++p)
        nmt_hash_node(level.data() + (size_t)(2 * p) * kNodeSize,
                      level.data() + (size_t)(2 * p + 1) * kNodeSize,
                      next.data() + (size_t)p * kNodeSize);
      std::swap(level, next);
    }
    uint8_t* out = is_row ? row_roots + (size_t)idx * kNodeSize
                          : col_roots + (size_t)idx * kNodeSize;
    std::memcpy(out, level.data(), kNodeSize);
  }
}

// RFC-6962 merkle root over n items of item_size bytes (tendermint
// merkle.HashFromByteSlices; pkg/da/data_availability_header.go:92-108).
void merkle_root(const uint8_t* items, int n, size_t item_size, uint8_t out[32]) {
  if (n == 0) {
    sha256(nullptr, 0, out);
    return;
  }
  if (n == 1) {
    std::vector<uint8_t> msg(1 + item_size);
    msg[0] = 0x00;
    std::memcpy(msg.data() + 1, items, item_size);
    sha256(msg.data(), msg.size(), out);
    return;
  }
  int split = 1;
  while (split * 2 < n) split *= 2;
  uint8_t left[32], right[32];
  merkle_root(items, split, item_size, left);
  merkle_root(items + (size_t)split * item_size, n - split, item_size, right);
  uint8_t msg[65];
  msg[0] = 0x01;
  std::memcpy(msg + 1, left, 32);
  std::memcpy(msg + 33, right, 32);
  sha256(msg, sizeof(msg), out);
}

}  // extern "C"
