// The port's native host runtime: Leopard-compatible GF(2^8) Reed-Solomon
// and SHA-256 NMT roots for the DA hot path on the CPU.
//
// The App's `native` backend, and the target its device path degrades to
// (rsmt2d.NewLeoRSCodec's role for the reference,
// pkg/appconsts/global_consts.go:92). The code is the same code as
// celestia_tpu_torch/ops/gf256.py (LCH additive FFT over the Cantor basis,
// polynomial 0x11D) and byte-identical to it; the Python bindings are in
// celestia_tpu_torch/native.py (ctypes), which builds this file with g++
// into celestia_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBits = 8;
constexpr int kOrder = 256;
constexpr int kModulus = 255;
constexpr int kPolynomial = 0x11D;
constexpr uint8_t kCantorBasis[kBits] = {1, 214, 152, 146, 86, 200, 88, 230};

uint16_t g_log[kOrder];
uint8_t g_exp[kOrder];
uint8_t g_mul[kOrder][kOrder];
uint16_t g_skew[kOrder];
uint16_t g_log_walsh[kOrder];
bool g_initialized = false;

inline int add_mod(int a, int b) {
  int s = a + b;
  return (s + (s >> kBits)) & 0xFF;
}

int mul_log(int a, int log_b) {
  if (a == 0) return 0;
  return g_exp[add_mod(g_log[a], log_b)];
}

void init_tables() {
  if (g_initialized) return;
  // LFSR discrete log w.r.t. generator x.
  uint16_t expt[kOrder], logt[kOrder];
  int state = 1;
  for (int i = 0; i < kModulus; ++i) {
    expt[state] = i;
    state <<= 1;
    if (state >= kOrder) state ^= kPolynomial;
  }
  expt[0] = kModulus;

  // Cantor-basis change.
  logt[0] = 0;
  for (int i = 0; i < kBits; ++i) {
    int width = 1 << i;
    for (int j = 0; j < width; ++j) logt[j + width] = logt[j] ^ kCantorBasis[i];
  }
  for (int i = 0; i < kOrder; ++i) logt[i] = expt[logt[i]];
  for (int i = 0; i < kOrder; ++i) g_log[i] = logt[i];
  for (int i = 0; i < kOrder; ++i) g_exp[g_log[i]] = i;
  g_exp[kModulus] = g_exp[0];

  // Multiplication table.
  for (int a = 0; a < kOrder; ++a)
    for (int b = 0; b < kOrder; ++b)
      g_mul[a][b] = (a == 0 || b == 0) ? 0 : g_exp[add_mod(g_log[a], g_log[b])];

  // FFT skew schedule (LCH subspace polynomial recursion).
  uint8_t skew_elem[kOrder] = {0};
  int temp[kBits - 1];
  for (int i = 1; i < kBits; ++i) temp[i - 1] = 1 << i;
  for (int m = 0; m < kBits - 1; ++m) {
    int step = 1 << (m + 1);
    skew_elem[(1 << m) - 1] = 0;
    for (int i = m; i < kBits - 1; ++i) {
      int s = 1 << (i + 1);
      for (int j = (1 << m) - 1; j < s; j += step)
        skew_elem[j + s] = skew_elem[j] ^ temp[i];
    }
    int temp_m = kModulus - g_log[g_mul[temp[m]][temp[m] ^ 1]];
    for (int i = m + 1; i < kBits - 1; ++i) {
      int s = add_mod(g_log[temp[i] ^ 1], temp_m);
      temp[i] = mul_log(temp[i], s);
    }
    temp[m] = temp_m;
  }
  for (int i = 0; i < kOrder; ++i) g_skew[i] = g_log[skew_elem[i]];

  // FWHT of the log table — the decoder's error-locator helper
  // (Leopard's ErrorBitfield path).
  for (int i = 0; i < kOrder; ++i) g_log_walsh[i] = (i == 0) ? 0 : g_log[i];
  for (int dist = 1; dist < kOrder; dist <<= 1) {
    for (int r = 0; r < kOrder; r += dist * 2) {
      for (int i = r; i < r + dist; ++i) {
        int a = g_log_walsh[i], b = g_log_walsh[i + dist];
        g_log_walsh[i] = (a + b) % kModulus;
        g_log_walsh[i + dist] = ((a - b) % kModulus + kModulus) % kModulus;
      }
    }
  }
  g_initialized = true;
}

// In-place FWHT over Z/255 on a full-order int buffer.
void fwht_mod255(int* data) {
  for (int dist = 1; dist < kOrder; dist <<= 1) {
    for (int r = 0; r < kOrder; r += dist * 2) {
      for (int i = r; i < r + dist; ++i) {
        int a = data[i], b = data[i + dist];
        data[i] = (a + b) % kModulus;
        data[i + dist] = ((a - b) % kModulus + kModulus) % kModulus;
      }
    }
  }
}

// dst = exp(log_m) * src over `size` bytes (overwrite, not accumulate).
inline void mul_block(uint8_t* dst, const uint8_t* src, int log_m, size_t size) {
  if (log_m == kModulus) {
    std::memset(dst, 0, size);
    return;
  }
  const uint8_t* row = g_mul[g_exp[log_m]];
  for (size_t i = 0; i < size; ++i) dst[i] = row[src[i]];
}

// y_block ^= exp(log_m) * x_block over `size` bytes; then x ^= ... pattern
// handled by callers. Uses the mul row for the constant.
inline void muladd(uint8_t* dst, const uint8_t* src, int log_m, size_t size) {
  const uint8_t* row = g_mul[g_exp[log_m]];
  for (size_t i = 0; i < size; ++i) dst[i] ^= row[src[i]];
}

inline void xor_block(uint8_t* dst, const uint8_t* src, size_t size) {
  for (size_t i = 0; i < size; ++i) dst[i] ^= src[i];
}

}  // namespace

extern "C" {

// Leopard RS encode: k data shards of shard_size bytes -> k parity shards.
// Matches reedsolomon.New(k, k, WithLeopardGF(true)).Encode: work =
// IFFT_skew(data) at offset m, parity = FFT_skew(work) at offset 0.
void leo_encode(int k, size_t shard_size, const uint8_t* data, uint8_t* parity) {
  init_tables();
  if (k <= 0 || (k & (k - 1))) return;  // power-of-two only (callers validate)
  if (k == 1) {  // both transforms degenerate to identity
    std::memcpy(parity, data, shard_size);
    return;
  }
  std::memcpy(parity, data, (size_t)k * shard_size);
  uint8_t* work = parity;

  // IFFT (decimation in time), skew offset m-1.
  for (int dist = 1; dist < k; dist <<= 1) {
    for (int r = 0; r < k; r += dist * 2) {
      int log_m = g_skew[k - 1 + r + dist];
      for (int i = 0; i < dist; ++i) {
        uint8_t* x = work + (size_t)(r + i) * shard_size;
        uint8_t* y = work + (size_t)(r + dist + i) * shard_size;
        xor_block(y, x, shard_size);
        if (log_m != kModulus) muladd(x, y, log_m, shard_size);
      }
    }
  }
  // FFT, skew offset 0.
  for (int dist = k >> 1; dist >= 1; dist >>= 1) {
    for (int r = 0; r < k; r += dist * 2) {
      int log_m = g_skew[r + dist - 1];
      for (int i = 0; i < dist; ++i) {
        uint8_t* x = work + (size_t)(r + i) * shard_size;
        uint8_t* y = work + (size_t)(r + dist + i) * shard_size;
        if (log_m != kModulus) muladd(x, y, log_m, shard_size);
        xor_block(y, x, shard_size);
      }
    }
  }
}

// Leopard O(n log n) erasure decode of ONE axis (the reference's
// klauspost/reedsolomon Leopard decode role). cells: 2k shards of
// shard_size bytes, positions [0,k) original data, [k,2k) parity as
// produced by leo_encode. present: 2k bytes, 0 = erased. Erased cells are
// recovered in place. Requires >= k present shards (caller checks).
//
// Published LCH erasure-decode recipe, matching ops/gf256.leopard_decode:
// scale received symbols by the FWHT-evaluated error locator, full-length
// IFFT, formal derivative, FFT, unscale at the erased positions.
void leo_decode(int k, size_t shard_size, uint8_t* cells, const uint8_t* present) {
  init_tables();
  const int m = k, n = 2 * k;
  if (k == 1) {
    if (!present[0]) std::memcpy(cells, cells + shard_size, shard_size);
    if (!present[1]) std::memcpy(cells + shard_size, cells, shard_size);
    return;
  }

  // Erasure indicator in codeword order [parity | data] and its locator.
  int erased[kOrder] = {0};
  for (int i = 0; i < m; ++i) erased[i] = present[k + i] ? 0 : 1;
  for (int i = 0; i < m; ++i) erased[m + i] = present[i] ? 0 : 1;
  int loc[kOrder];
  for (int i = 0; i < kOrder; ++i) loc[i] = erased[i];
  fwht_mod255(loc);
  for (int i = 0; i < kOrder; ++i) loc[i] = (loc[i] * g_log_walsh[i]) % kModulus;
  fwht_mod255(loc);

  // Scale into the work buffer (codeword order).
  std::vector<uint8_t> work((size_t)n * shard_size);
  for (int i = 0; i < n; ++i) {
    const uint8_t* src =
        cells + (size_t)((i < m) ? (k + i) : (i - m)) * shard_size;
    uint8_t* dst = work.data() + (size_t)i * shard_size;
    if (erased[i]) {
      std::memset(dst, 0, shard_size);
    } else {
      mul_block(dst, src, loc[i] % kModulus, shard_size);
    }
  }

  // IFFT (skew offset 0), formal derivative, FFT.
  for (int dist = 1; dist < n; dist <<= 1) {
    for (int r = 0; r < n; r += dist * 2) {
      int log_m = g_skew[r + dist - 1];
      for (int i = 0; i < dist; ++i) {
        uint8_t* x = work.data() + (size_t)(r + i) * shard_size;
        uint8_t* y = work.data() + (size_t)(r + dist + i) * shard_size;
        xor_block(y, x, shard_size);
        if (log_m != kModulus) muladd(x, y, log_m, shard_size);
      }
    }
  }
  for (int i = 1; i < n; ++i) {
    int width = ((i ^ (i - 1)) + 1) >> 1;
    for (int j = i - width; j < i; ++j)
      xor_block(work.data() + (size_t)j * shard_size,
                work.data() + (size_t)(j + width) * shard_size, shard_size);
  }
  for (int dist = n >> 1; dist >= 1; dist >>= 1) {
    for (int r = 0; r < n; r += dist * 2) {
      int log_m = g_skew[r + dist - 1];
      for (int i = 0; i < dist; ++i) {
        uint8_t* x = work.data() + (size_t)(r + i) * shard_size;
        uint8_t* y = work.data() + (size_t)(r + dist + i) * shard_size;
        if (log_m != kModulus) muladd(x, y, log_m, shard_size);
        xor_block(y, x, shard_size);
      }
    }
  }

  // Unscale erased positions and write them back to the cell layout.
  for (int i = 0; i < n; ++i) {
    if (!erased[i]) continue;
    uint8_t* dst =
        cells + (size_t)((i < m) ? (k + i) : (i - m)) * shard_size;
    int unlog = (kModulus - (loc[i] % kModulus)) % kModulus;
    mul_block(dst, work.data() + (size_t)i * shard_size, unlog, shard_size);
  }
}

// Repair a 2k x 2k EDS (row-major cells of shard_size bytes) given a 0/1
// presence mask. Rows and columns are decoded iteratively to a fixed
// point, the rsmt2d.Repair strategy. Returns 0 on success, 1 when the
// pattern is unrepairable. present is updated to all-ones on success.
int eds_repair(int k, size_t shard_size, uint8_t* eds, uint8_t* present) {
  init_tables();
  const int w = 2 * k;
  std::vector<uint8_t> axis((size_t)w * shard_size);
  std::vector<uint8_t> axis_present(w);
  for (;;) {
    bool all = true, progress = false;
    for (int pass = 0; pass < 2; ++pass) {  // 0 = rows, 1 = columns
      for (int a = 0; a < w; ++a) {
        int have = 0;
        for (int i = 0; i < w; ++i) {
          axis_present[i] = pass == 0 ? present[a * w + i] : present[i * w + a];
          have += axis_present[i];
        }
        if (have == w) continue;
        all = false;
        if (have < k) continue;
        if (pass == 0) {
          leo_decode(k, shard_size, eds + (size_t)a * w * shard_size,
                     axis_present.data());
          for (int i = 0; i < w; ++i) present[a * w + i] = 1;
        } else {
          for (int i = 0; i < w; ++i)
            std::memcpy(axis.data() + (size_t)i * shard_size,
                        eds + ((size_t)i * w + a) * shard_size, shard_size);
          leo_decode(k, shard_size, axis.data(), axis_present.data());
          for (int i = 0; i < w; ++i) {
            if (!axis_present[i])
              std::memcpy(eds + ((size_t)i * w + a) * shard_size,
                          axis.data() + (size_t)i * shard_size, shard_size);
            present[i * w + a] = 1;
          }
        }
        progress = true;
      }
    }
    if (all) return 0;
    // one more scan to see if anything is still missing
    bool missing = false;
    for (int i = 0; i < w * w; ++i)
      if (!present[i]) { missing = true; break; }
    if (!missing) return 0;
    if (!progress) return 1;
  }
}

// Extend a k x k share square (row-major, shard_size bytes per cell) into a
// 2k x 2k EDS (Q1 = row-extend Q0, Q2 = col-extend Q0, Q3 = row-extend Q2).
void eds_extend(int k, size_t shard_size, const uint8_t* q0, uint8_t* eds) {
  init_tables();
  const int w = 2 * k;
  std::vector<uint8_t> shards((size_t)k * shard_size);
  std::vector<uint8_t> parity((size_t)k * shard_size);

  // Q0
  for (int i = 0; i < k; ++i)
    std::memcpy(eds + ((size_t)i * w) * shard_size, q0 + (size_t)i * k * shard_size,
                (size_t)k * shard_size);
  // Q1: extend rows.
  for (int i = 0; i < k; ++i) {
    leo_encode(k, shard_size, eds + ((size_t)i * w) * shard_size, parity.data());
    std::memcpy(eds + ((size_t)i * w + k) * shard_size, parity.data(),
                (size_t)k * shard_size);
  }
  // Q2: extend columns.
  for (int j = 0; j < k; ++j) {
    for (int i = 0; i < k; ++i)
      std::memcpy(shards.data() + (size_t)i * shard_size,
                  eds + ((size_t)i * w + j) * shard_size, shard_size);
    leo_encode(k, shard_size, shards.data(), parity.data());
    for (int i = 0; i < k; ++i)
      std::memcpy(eds + ((size_t)(k + i) * w + j) * shard_size,
                  parity.data() + (size_t)i * shard_size, shard_size);
  }
  // Q3: extend the Q2 rows.
  for (int i = k; i < w; ++i) {
    leo_encode(k, shard_size, eds + ((size_t)i * w) * shard_size, parity.data());
    std::memcpy(eds + ((size_t)i * w + k) * shard_size, parity.data(),
                (size_t)k * shard_size);
  }
}

}  // extern "C"
