// The decode sweep of EDS repair for sm_90a: one planned sweep of the
// Leopard erasure decode over every axis of one orientation, in place in
// the (2k, 2k, 512) EDS.
//
// It replaces the XLA graph repair_tpu._sweep_device
// (celestia_tpu/ops/repair_tpu.py:124), which runs the decode as a GF(2)
// bit-matrix contraction: unpack bits, an 8 x 8 scale block per position,
// one (8n x 8n) product with the decode core's bit matrix, unscale, pack,
// and a masked write (no Pallas kernel: the JAX package leaves it to XLA).
// This kernel runs the decode core's own spelling instead,
// gf256._decode_core: an inverse additive FFT over the n = 2k positions of
// an axis, the formal derivative, and a forward FFT, between the
// per-position scale and unscale multiplies of the plan.
//
// Layout. The EDS is read and written in place: axis a, cell c at
// eds + a * axis + c * cell (bytes; multiples of 512). A row sweep passes
// (2k * 512, 512), a column sweep (512, 2k * 512), so no transposed copy is
// made. The codeword order of the code is [parity | data]: position p is
// cell (p + k) mod 2k, address arithmetic only. consts is the sweep's plan,
// (3, axes, n) uint8: the scale bytes and the unscale bytes per (axis,
// position) in codeword order, then the write mask per (axis, cell) in cell
// order. The core's operands (ops/rs.py decode_program, built once per n
// and device): rows (n_const, 256) uint8, row i the products mul(c_i,
// 0..255) of the i-th distinct nonzero twiddle (127 at n = 256), and group
// (2(n - 1),) int16, each butterfly group's row or -1 for a zero twiddle;
// logs (256,) int16 and exps (1024,) uint8 (rs.mul_log_exp), with
// a * b = exps[logs[a] + logs[b]] and the log of 0 large enough that any
// sum holding it reads a zero.
//
// Design. Two blocks own one axis, 256 byte lanes each: each thread owns
// one byte lane of every cell. A state word holds 4 positions of that
// lane, byte b of word j being position 4j + b, so the n = 256 positions of
// k = 128 fit in 64 registers and two blocks fit an SM (the launch bounds
// cap a thread at 128 registers). Two lanes a word, as K4 holds its
// shards, would take 128 state registers at n = 256 and leave one block of
// 8 warps per SM to wait on its own lookups.
// Butterflies with dist >= 4 pair whole words and share one twiddle, so a
// multiply is 4 byte lookups in the twiddle's product row in shared memory
// (addresses made by byte permutes, as in K4, csrc/rs_hash.cu). The dist 2
// butterflies pair the two half-words of a word (y ^= x is w ^= w << 16;
// x ^= c * y multiplies bytes 2, 3 into bytes 0, 1), and the dist 1
// butterflies pair bytes 0, 1 and bytes 2, 3, two groups with their own
// twiddles. The formal derivative, i ascending, work[i - b .. i) ^=
// work[i .. i + b) with b the lowest set bit of i, is a word XOR for
// b >= 4 and a shifted, masked XOR inside a word below; it reads only
// bytes no earlier step wrote. The scale multiply runs before the IFFT
// through the log/exp tables (an erased position's constant is 0, so its
// bytes, garbage or not, drop out); the unscale multiply and the store run
// only for the cells the plan's write mask marks, which folds JAX's
// jnp.where(write, recovered, eds) into the store. An axis the sweep writes
// nothing of (fully present, or not yet decodable) returns before it loads
// a byte. Every level unrolls at compile time (n is a template parameter);
// the twiddles stay in shared memory and are read as broadcasts, so the
// branch over a zero twiddle is uniform.
//
// What bounds it (k = 128: 256 axes x 512 lanes = 131,072 lanes,
// n = 256): operations. Per lane the core has 2,048 butterflies, 1,538 of
// them with a multiply, and 512 scale/unscale multiplies at most; the
// 32 MiB EDS read once and the written cells stored once are 0.010 ms at
// 3.35 TB/s. chip_smoke.py counts the bound from decode_program(256) the
// way it counts K4's FFT bound.
//
// Every entry checks its launch with cudaGetLastError() and returns it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace celestia {
namespace decode {

constexpr int kCell = 512;             // bytes per share
constexpr int kThreads = 256;          // one byte lane a thread: 2 blocks per axis
constexpr int kMinBlocks = 2;          // blocks per SM: at most 128 registers a thread
constexpr int kRow = 256;              // bytes per product row in shared memory
constexpr int kBranchDist = 8;         // groups this wide branch over a zero twiddle
constexpr int kLogZero = 511;          // rs.LOG_ZERO: the log of the byte 0
constexpr int kExps = 1024;            // rs.mul_log_exp's exps
constexpr int kMaxN = 256;
static_assert(2 * kLogZero < kExps, "a sum of two logs must index the exps table");

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }
__host__ __device__ constexpr int groups_of(int n) { return 2 * (n - 1); }
// the group table comes first; the product rows start on a row boundary
__host__ __device__ constexpr int rows_offset(int n) {
  return (groups_of(n) * 4 + kRow - 1) / kRow * kRow;
}

// Shared memory after the product rows and the zero row.
struct Tables {
  int16_t* logs;    // 256
  uint8_t* exps;    // kExps
  int16_t* scale;   // n: log of each position's scale constant
  int16_t* unscale; // n: log of each position's unscale constant
  uint8_t* write;   // n: the write mask, cell order
};

__host__ __device__ constexpr size_t tables_bytes(int n) {
  return 256 * 2 + kExps + 2 * n * 2 + n;
}

// c * y in GF(256) for the 4 bytes of y; base is the byte offset of c's
// product row in `rows`, a multiple of 256, so a byte permute that puts a
// byte of y into base's low byte makes the lookup address.
__device__ __forceinline__ uint32_t gf_mul4(uint32_t y, uint32_t base, const uint8_t* rows) {
  const uint32_t p0 = rows[__byte_perm(y, base, 0x7650)];
  const uint32_t p1 = rows[__byte_perm(y, base, 0x7651)];
  const uint32_t p2 = rows[__byte_perm(y, base, 0x7652)];
  const uint32_t p3 = rows[__byte_perm(y, base, 0x7653)];
  return __byte_perm(p0, p1, 0x1140) | __byte_perm(p2, p3, 0x4011);
}

// c * (bytes 2, 3 of y), in bytes 0, 1 (bytes 2, 3 zero): the dist 2 multiply.
__device__ __forceinline__ uint32_t gf_mul_hi(uint32_t y, uint32_t base, const uint8_t* rows) {
  const uint32_t p2 = rows[__byte_perm(y, base, 0x7652)];
  const uint32_t p3 = rows[__byte_perm(y, base, 0x7653)];
  return __byte_perm(p2, p3, 0x1140);
}

// a * byte 1 of y in byte 0 and b * byte 3 in byte 2 (bytes 1, 3 zero): the
// dist 1 multiply, two groups with their own twiddles a and b.
__device__ __forceinline__ uint32_t gf_mul_odd(uint32_t y, uint32_t base_a, uint32_t base_b,
                                               const uint8_t* rows) {
  const uint32_t p1 = rows[__byte_perm(y, base_a, 0x7651)];
  const uint32_t p3 = rows[__byte_perm(y, base_b, 0x7653)];
  return __byte_perm(p1, p3, 0x5410);
}

// The byte v (0..255) times the constant whose log is lc, through the
// log/exp tables; a zero byte or constant gives 0.
__device__ __forceinline__ uint32_t mul_const(uint32_t v, int lc, const Tables& tb) {
  return tb.exps[tb.logs[v] + lc];
}

// The butterflies and the formal derivative of gf256._decode_core over N
// positions on state words in registers (every index is a compile-time
// constant once unrolled): byte b of word j is position 4j + b (N = 2 uses
// bytes 0 and 1 of one word). Group g's product row is at grp[g], in the
// order ops/rs.py decode_program emits; `zero` is the zero row's offset,
// which a zero twiddle's group points at.
template <int N>
struct DecodeCore {
  static constexpr int kWords = N < 4 ? 1 : N / 4;
  static constexpr int kLog = log2_of(N);

  // the dist 1 groups of word j: 2j (bytes 0, 1) and 2j + 1 (bytes 2, 3)
  static __device__ __forceinline__ uint32_t odd_base(const uint32_t* grp, int g, uint32_t zero) {
    return N < 4 ? zero : grp[g];
  }

  // IFFT level LV: dist = 2^LV; y ^= x, then x ^= c * y
  template <int LV>
  static __device__ __forceinline__ void ifft(uint32_t (&w)[kWords], const uint32_t* grp,
                                              const uint8_t* rows, uint32_t zero) {
    if constexpr (LV < kLog) {
      constexpr int dist = 1 << LV;
      constexpr int g0 = N - (N >> LV);
      if constexpr (dist == 1) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          w[j] ^= (w[j] << 8) & 0xFF00FF00u;
          w[j] ^= gf_mul_odd(w[j], grp[g0 + 2 * j], odd_base(grp, g0 + 2 * j + 1, zero), rows);
        }
      } else if constexpr (dist == 2) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          w[j] ^= w[j] << 16;
          w[j] ^= gf_mul_hi(w[j], grp[g0 + j], rows);
        }
      } else {
        constexpr int half = dist / 4;  // words per half of a group
#pragma unroll
        for (int j = 0; j < N / (2 * dist); ++j) {
          const int r = 2 * half * j;  // the group's first word
          const uint32_t base = grp[g0 + j];
#pragma unroll
          for (int i = 0; i < half; ++i) w[r + half + i] ^= w[r + i];
          if (dist < kBranchDist || base != zero) {
#pragma unroll
            for (int i = 0; i < half; ++i) w[r + i] ^= gf_mul4(w[r + half + i], base, rows);
          }
        }
      }
      ifft<LV + 1>(w, grp, rows, zero);
    }
  }

  // FFT level LV: dist = N / 2^(LV + 1); x ^= c * y, then y ^= x
  template <int LV>
  static __device__ __forceinline__ void fft(uint32_t (&w)[kWords], const uint32_t* grp,
                                             const uint8_t* rows, uint32_t zero) {
    if constexpr (LV < kLog) {
      constexpr int dist = N >> (LV + 1);
      constexpr int g0 = (N - 1) + (1 << LV) - 1;
      if constexpr (dist == 1) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          w[j] ^= gf_mul_odd(w[j], grp[g0 + 2 * j], odd_base(grp, g0 + 2 * j + 1, zero), rows);
          w[j] ^= (w[j] << 8) & 0xFF00FF00u;
        }
      } else if constexpr (dist == 2) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          w[j] ^= gf_mul_hi(w[j], grp[g0 + j], rows);
          w[j] ^= w[j] << 16;
        }
      } else {
        constexpr int half = dist / 4;
#pragma unroll
        for (int j = 0; j < (1 << LV); ++j) {
          const int r = 2 * half * j;
          const uint32_t base = grp[g0 + j];
          if (dist < kBranchDist || base != zero) {
#pragma unroll
            for (int i = 0; i < half; ++i) w[r + i] ^= gf_mul4(w[r + half + i], base, rows);
          }
#pragma unroll
          for (int i = 0; i < half; ++i) w[r + half + i] ^= w[r + i];
        }
      }
      fft<LV + 1>(w, grp, rows, zero);
    }
  }

  // the formal derivative on positions [LO, LO + M) (LO a multiple of M):
  // its steps i = LO + 1 .. LO + M - 1 in ascending order, each
  // work[i - b .. i) ^= work[i .. i + b) with b the lowest set bit of i.
  // The first half's steps, then step LO + M/2 (b = M/2), then the second
  // half's: recursion depth log2(N), every index a constant.
  template <int LO, int M>
  static __device__ __forceinline__ void derivative(uint32_t (&w)[kWords]) {
    if constexpr (M >= 2) {
      derivative<LO, M / 2>(w);
      if constexpr (M == 2) {  // byte LO % 4 ^= byte LO % 4 + 1
        w[LO / 4] ^= (w[LO / 4] >> 8) & (LO % 4 ? 0x00FF0000u : 0x000000FFu);
      } else if constexpr (M == 4) {  // bytes 0, 1 ^= bytes 2, 3
        w[LO / 4] ^= w[LO / 4] >> 16;
      } else {
#pragma unroll
        for (int m = 0; m < M / 8; ++m) w[LO / 4 + m] ^= w[(LO + M / 2) / 4 + m];
      }
      derivative<LO + M / 2, M / 2>(w);
    }
  }
};

template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_sweep_kernel(uint8_t* __restrict__ eds, size_t axis_stride, size_t cell_stride,
                    const uint8_t* __restrict__ consts, int axes,
                    const uint8_t* __restrict__ fft_rows, const int16_t* __restrict__ fft_group,
                    int n_const, const int16_t* __restrict__ logs,
                    const uint8_t* __restrict__ exps) {
  constexpr int kGroups = groups_of(N);
  constexpr int kWords = DecodeCore<N>::kWords;
  constexpr int kHalf = N / 2;  // = k: position p is cell (p + k) mod N
  extern __shared__ uint4 smem_vec[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_vec);
  uint32_t* grp = reinterpret_cast<uint32_t*>(smem);  // kGroups row offsets
  uint8_t* rows = smem + rows_offset(N);               // n_const rows, then a zero row
  uint8_t* tail = rows + static_cast<size_t>(n_const + 1) * kRow;
  Tables tb;
  tb.logs = reinterpret_cast<int16_t*>(tail);
  tb.scale = tb.logs + 256;
  tb.unscale = tb.scale + N;
  tb.exps = reinterpret_cast<uint8_t*>(tb.unscale + N);
  tb.write = tb.exps + kExps;
  const uint32_t zero = static_cast<uint32_t>(n_const) * kRow;

  const int axis = blockIdx.x;
  const int t = threadIdx.x;
  const size_t plane = static_cast<size_t>(axes) * N;  // bytes of one (axes, n) plane
  const uint8_t* scale_b = consts + static_cast<size_t>(axis) * N;
  const uint8_t* unscale_b = scale_b + plane;
  const uint8_t* write_b = unscale_b + plane;

  // an axis this sweep writes nothing of loads nothing
  int wr = 0;
  for (int c = t; c < N; c += kThreads) {
    tb.write[c] = write_b[c];
    wr |= write_b[c];
  }
  if (!__syncthreads_or(wr)) return;

  // this thread's lane of every cell of the axis
  uint8_t* lane = eds + static_cast<size_t>(axis) * axis_stride + blockIdx.y * kThreads + t;
  uint32_t w[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 4 && 4 * j + i < N; ++i) {
      b[i] = lane[((4 * j + i + kHalf) % N) * cell_stride];
    }
    w[j] = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
  }

  const int nvec = n_const * (kRow / 16);
  for (int i = t; i < nvec + kRow / 16; i += kThreads) {
    reinterpret_cast<uint4*>(rows)[i] =
        i < nvec ? reinterpret_cast<const uint4*>(fft_rows)[i] : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int g = t; g < kGroups; g += kThreads) {
    const int r = fft_group[g];
    grp[g] = r < 0 ? zero : static_cast<uint32_t>(r) * kRow;
  }
  for (int i = t; i < 256; i += kThreads) tb.logs[i] = logs[i];
  for (int i = t; i < kExps; i += kThreads) tb.exps[i] = exps[i];
  __syncthreads();
  for (int p = t; p < N; p += kThreads) {
    tb.scale[p] = tb.logs[scale_b[p]];
    tb.unscale[p] = tb.logs[unscale_b[p]];
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 4 && 4 * j + i < N; ++i) {
      b[i] = mul_const(__byte_perm(w[j], 0u, 0x4440 + i), tb.scale[4 * j + i], tb);
    }
    w[j] = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
  }

  DecodeCore<N>::template ifft<0>(w, grp, rows, zero);
  DecodeCore<N>::template derivative<0, N>(w);
  DecodeCore<N>::template fft<0>(w, grp, rows, zero);

#pragma unroll
  for (int j = 0; j < kWords; ++j) {
#pragma unroll
    for (int i = 0; i < 4 && 4 * j + i < N; ++i) {
      const int c = (4 * j + i + kHalf) % N;
      if (tb.write[c]) {
        lane[c * cell_stride] = static_cast<uint8_t>(
            mul_const(__byte_perm(w[j], 0u, 0x4440 + i), tb.unscale[4 * j + i], tb));
      }
    }
  }
}

template <int N>
static cudaError_t launch_sweep(uint8_t* eds, size_t axis_stride, size_t cell_stride,
                                const uint8_t* consts, int axes, const uint8_t* rows,
                                const int16_t* group, int n_const, const int16_t* logs,
                                const uint8_t* exps, cudaStream_t stream) {
  const size_t smem = rows_offset(N) + static_cast<size_t>(n_const + 1) * kRow + tables_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(decode_sweep_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_sweep_kernel<N><<<dim3(axes, kCell / kThreads), kThreads, smem, stream>>>(
      eds, axis_stride, cell_stride, consts, axes, rows, group, n_const, logs, exps);
  return cudaGetLastError();
}

}  // namespace decode
}  // namespace celestia

extern "C" int celestia_decode_sweep(void* eds, long long axis_stride, long long cell_stride,
                                     const void* consts, int axes, const void* fft_rows,
                                     const void* fft_group, int n_const, const void* logs,
                                     const void* exps, int n, int device, void* stream) {
  using namespace celestia::decode;
  if (axis_stride <= 0 || cell_stride <= 0 || axis_stride % kCell || cell_stride % kCell ||
      n < 2 || n > kMaxN || (n & (n - 1)) || axes <= 0 || n_const < 0 ||
      n_const > groups_of(n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto e = static_cast<uint8_t*>(eds);
  auto as = static_cast<size_t>(axis_stride);
  auto cs = static_cast<size_t>(cell_stride);
  auto c = static_cast<const uint8_t*>(consts);
  auto r = static_cast<const uint8_t*>(fft_rows);
  auto g = static_cast<const int16_t*>(fft_group);
  auto l = static_cast<const int16_t*>(logs);
  auto x = static_cast<const uint8_t*>(exps);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: err = launch_sweep<2>(e, as, cs, c, axes, r, g, n_const, l, x, s); break;
    case 4: err = launch_sweep<4>(e, as, cs, c, axes, r, g, n_const, l, x, s); break;
    case 8: err = launch_sweep<8>(e, as, cs, c, axes, r, g, n_const, l, x, s); break;
    case 16: err = launch_sweep<16>(e, as, cs, c, axes, r, g, n_const, l, x, s); break;
    case 32: err = launch_sweep<32>(e, as, cs, c, axes, r, g, n_const, l, x, s); break;
    case 64: err = launch_sweep<64>(e, as, cs, c, axes, r, g, n_const, l, x, s); break;
    case 128: err = launch_sweep<128>(e, as, cs, c, axes, r, g, n_const, l, x, s); break;
    default: err = launch_sweep<256>(e, as, cs, c, axes, r, g, n_const, l, x, s); break;
  }
  return static_cast<int>(err);
}
