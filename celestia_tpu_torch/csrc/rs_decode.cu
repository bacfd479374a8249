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
// order. The core's operands (ops/rs.py decode_operands, built once per
// device and n): table, 256 half rows H[c][y] = c * y for y < 128 (32 KiB,
// row c at c * 128), then the 256 high-bit products c * 0x80, in device
// memory; and twiddles, on the host, each butterfly group's multiply entry
// (a Twiddle, below) for its twiddle constant in rs.decode_program's order
// (0: a zero twiddle), passed as a kernel parameter.
//
// Multiplies. GF(256) multiplication distributes over XOR, so
// c * y = H[c][y & 0x7F] ^ (bit 7 of y ? c * 0x80 : 0). A half row is 128
// bytes, 32 words, one in every bank, so the 32 byte lookups of a warp
// into one row take one shared-memory wavefront whatever the bytes are
// (a 256-byte row is two words a bank, and random bytes mostly cost two).
// Every multiply of the kernel has one constant across a warp: a twiddle
// is one per butterfly group, and a scale or unscale constant is one per
// (axis, position) while a block works on one axis. The constant c enters
// as (c >> 1) << 8, the row pair's offset, and c & 1 in bit 7 of the masked
// bytes, so one byte permute still makes each lookup address; the high-bit
// term is one sign-replicating byte permute (a mask of bit 7 of every byte)
// and one AND with c * 0x80 in every byte. One table serves the butterflies
// and the locator scale and unscale: no log/exp lookups.
//
// Design. A persistent grid of as many blocks as fit (2 an SM at 128
// registers) loads the table into shared memory once, then walks over work
// items, each one axis and one half of its 512 byte lanes, 256 threads a
// block, each thread one lane of every cell. Per
// item a block stages only that axis's plan: each position's scale and
// unscale row offset, each state word's bit-7 and high-bit products, and
// the write flags in position order. A state word holds 4 positions of the
// thread's lane, byte b of word j being position 4j + b, so the n = 256
// positions of k = 128 fit in 64 registers. Butterflies with dist >= 4 pair
// whole words and share one twiddle. The dist 2 butterflies pair the two
// half-words of a word (y ^= x is w ^= w << 16; x ^= c * y multiplies
// bytes 2, 3 into bytes 0, 1), and the dist 1 butterflies pair bytes 0, 1
// and bytes 2, 3, two groups with their own twiddles. The formal
// derivative, i ascending, work[i - b .. i) ^= work[i .. i + b) with b the
// lowest set bit of i, is a word XOR for b >= 4 and a shifted, masked XOR
// inside a word below; it reads only bytes no earlier step wrote. The scale
// multiply runs on the loaded words (an erased position's constant is 0,
// so its bytes, garbage or not, drop out); the unscale multiply and the
// store run only for the words that hold a cell the plan's write mask
// marks, and only the marked bytes are stored, which folds JAX's
// jnp.where(write, recovered, eds) into the store. An axis the sweep
// writes nothing of loads no cell. Every level unrolls at compile time (n
// is a template parameter), so every twiddle entry is read at a constant
// offset of the kernel's parameters: a constant-bank operand of the permute
// or LOP3 that uses it, with no shared-memory load and no register held.
// The branch over a zero twiddle is uniform.
//
// What bounds it (k = 128: 256 axes x 512 lanes = 131,072 lanes,
// n = 256): operations. Per lane the core has 2,048 butterflies, 1,538 of
// them with a multiply, and 512 scale/unscale multiplies at most; the
// 32 MiB EDS read once and the written cells stored once are 0.010 ms at
// 3.35 TB/s. chip_smoke.py counts the bound from decode_program(256) the
// way it counts K4's FFT bound (9 ALU operations and 4 lookups a multiply
// word). This spelling spends 10 ALU operations and 4 conflict-free
// lookups a multiply word.
//
// Every entry checks its launch with cudaGetLastError() and returns it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace celestia {
namespace decode {

constexpr int kCell = 512;             // bytes per share
constexpr int kThreads = 256;          // one byte lane a thread: 2 items per axis
constexpr int kMinBlocks = 2;          // blocks per SM: at most 128 registers a thread
constexpr int kHalfRow = 128;          // bytes of H[c]: c * y for y < 128
constexpr int kTable = 256 * kHalfRow; // H, row c at c * kHalfRow
constexpr int kTableBytes = kTable + 256;  // H, then c * 0x80 for every c
constexpr int kBranchDist = 8;         // groups this wide branch over a zero twiddle
constexpr int kMaxN = 256;
constexpr int kMaxDevices = 16;

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }
__host__ __device__ constexpr int groups_of(int n) { return 2 * (n - 1); }
__host__ __device__ constexpr int words_of(int n) { return n < 4 ? 1 : n / 4; }

// A multiply by the constant c: `base` = (c >> 1) << 8, the byte offset of
// the 256-byte row pair that holds H[c]; `cbits` = bit 0 of c in bit 7 of
// every byte (which half of the pair); `hi` = c * 0x80 in every byte.
struct Twiddle {
  uint32_t base, cbits, hi;
};

// Every group's entry, by value in the kernel's parameters (6 KiB at
// n = 256, within the 32 KiB a launch may pass).
template <int N>
struct TwiddleTable {
  Twiddle e[groups_of(N)];
};

// Shared memory per block: H and the high-bit products, then one work
// item's plan.
template <int N>
struct Layout {
  static constexpr int kWords = words_of(N);
  static constexpr int kPos = 4 * kWords;  // positions, padded to whole words
  static constexpr int sbase = kTableBytes;                  // kPos uint32: scale bases
  static constexpr int ubase = sbase + 4 * kPos;             // kPos uint32: unscale bases
  static constexpr int sword = ubase + 4 * kPos;             // kWords uint2: scale cbits, hi
  static constexpr int uword = sword + 8 * kWords;           // kWords uint2: unscale cbits, hi
  static constexpr int wflag = uword + 8 * kWords;           // kWords uint32: write flags
  static constexpr int bytes = wflag + 4 * kWords;
};

// PTX prmt: a selector nibble with bit 3 set replicates the sign (bit 7)
// of the byte its low 3 bits pick.
template <uint32_t kSel>
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "n"(kSel));
  return d;
}

__device__ __forceinline__ uint32_t low7(uint32_t y, uint32_t cbits) {
  return (y & 0x7F7F7F7Fu) | cbits;
}

// x ^ c * y in GF(256) for the 4 bytes of y (one constant): the two half
// products and x in one three-input XOR, the high-bit term in a second.
__device__ __forceinline__ uint32_t gf_mac4(uint32_t x, uint32_t y, const Twiddle& tw,
                                            const uint8_t* H) {
  const uint32_t m = low7(y, tw.cbits);
  const uint32_t p0 = H[prmt<0x7650>(m, tw.base)];
  const uint32_t p1 = H[prmt<0x7651>(m, tw.base)];
  const uint32_t p2 = H[prmt<0x7652>(m, tw.base)];
  const uint32_t p3 = H[prmt<0x7653>(m, tw.base)];
  const uint32_t acc = x ^ prmt<0x1140>(p0, p1) ^ prmt<0x4011>(p2, p3);
  return acc ^ (prmt<0xBA98>(y, 0u) & tw.hi);
}

// x ^ c * (bytes 2, 3 of y), the product in bytes 0, 1: the dist 2 multiply.
__device__ __forceinline__ uint32_t gf_mac_hi(uint32_t x, uint32_t y, const Twiddle& tw,
                                              const uint8_t* H) {
  const uint32_t m = low7(y, tw.cbits);
  const uint32_t p2 = H[prmt<0x7652>(m, tw.base)];
  const uint32_t p3 = H[prmt<0x7653>(m, tw.base)];
  const uint32_t acc = x ^ prmt<0x1140>(p2, p3);
  return acc ^ (prmt<0x44BA>(y, 0u) & tw.hi);
}

// x ^ (a * byte 1 of y in byte 0, b * byte 3 in byte 2): the dist 1
// multiply, two groups with their own twiddles a and b.
__device__ __forceinline__ uint32_t gf_mac_odd(uint32_t x, uint32_t y, const Twiddle& a,
                                               const Twiddle& b, const uint8_t* H) {
  const uint32_t p1 = H[prmt<0x7651>(low7(y, a.cbits), a.base)];
  const uint32_t p3 = H[prmt<0x7653>(low7(y, b.cbits), b.base)];
  const uint32_t hi = (a.hi & 0x0000FFFFu) | (b.hi & 0xFFFF0000u);
  const uint32_t acc = x ^ prmt<0x5410>(p1, p3);
  return acc ^ (prmt<0x4B49>(y, 0u) & hi);
}

// Byte b of y times the constant of position 4j + b, for the positions
// this word holds: base4 the positions' row offsets, cw their bit-7 bits
// and high-bit products, a byte each.
template <int N>
__device__ __forceinline__ uint32_t gf_mul_pos(uint32_t y, int j, const uint4& base4,
                                               const uint2& cw, const uint8_t* H) {
  const uint32_t m = low7(y, cw.x);
  const uint32_t p0 = H[prmt<0x7650>(m, base4.x)];
  const uint32_t p1 = H[prmt<0x7651>(m, base4.y)];
  const uint32_t p2 = 4 * j + 2 < N ? H[prmt<0x7652>(m, base4.z)] : 0u;
  const uint32_t p3 = 4 * j + 3 < N ? H[prmt<0x7653>(m, base4.w)] : 0u;
  return prmt<0x1140>(p0, p1) ^ prmt<0x4011>(p2, p3) ^ (prmt<0xBA98>(y, 0u) & cw.y);
}

// The butterflies and the formal derivative of gf256._decode_core over N
// positions on state words in registers (every index is a compile-time
// constant once unrolled): byte b of word j is position 4j + b (N = 2 uses
// bytes 0 and 1 of one word). Group g's twiddle is grp[g], in the order
// ops/rs.py decode_program emits.
template <int N>
struct DecodeCore {
  static constexpr int kWords = words_of(N);
  static constexpr int kLog = log2_of(N);

  // the dist 1 groups of word j: 2j (bytes 0, 1) and 2j + 1 (bytes 2, 3);
  // N = 2 has one, and bytes 2, 3 are zero
  static __device__ __forceinline__ Twiddle odd_twiddle(const Twiddle* grp, int g) {
    return N < 4 ? Twiddle{0u, 0u, 0u} : grp[g];
  }

  // IFFT level LV: dist = 2^LV; y ^= x, then x ^= c * y
  template <int LV>
  static __device__ __forceinline__ void ifft(uint32_t (&w)[kWords], const Twiddle* grp,
                                              const uint8_t* H) {
    if constexpr (LV < kLog) {
      constexpr int dist = 1 << LV;
      constexpr int g0 = N - (N >> LV);
      if constexpr (dist == 1) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          w[j] ^= (w[j] << 8) & 0xFF00FF00u;
          w[j] = gf_mac_odd(w[j], w[j], grp[g0 + 2 * j],
                            odd_twiddle(grp, g0 + 2 * j + 1), H);
        }
      } else if constexpr (dist == 2) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          w[j] ^= w[j] << 16;
          w[j] = gf_mac_hi(w[j], w[j], grp[g0 + j], H);
        }
      } else {
        constexpr int half = dist / 4;  // words per half of a group
#pragma unroll
        for (int j = 0; j < N / (2 * dist); ++j) {
          const int r = 2 * half * j;  // the group's first word
          const Twiddle tw = grp[g0 + j];
#pragma unroll
          for (int i = 0; i < half; ++i) w[r + half + i] ^= w[r + i];
          if (dist < kBranchDist || tw.hi != 0u) {
#pragma unroll
            for (int i = 0; i < half; ++i) w[r + i] = gf_mac4(w[r + i], w[r + half + i], tw, H);
          }
        }
      }
      ifft<LV + 1>(w, grp, H);
    }
  }

  // FFT level LV: dist = N / 2^(LV + 1); x ^= c * y, then y ^= x
  template <int LV>
  static __device__ __forceinline__ void fft(uint32_t (&w)[kWords], const Twiddle* grp,
                                             const uint8_t* H) {
    if constexpr (LV < kLog) {
      constexpr int dist = N >> (LV + 1);
      constexpr int g0 = (N - 1) + (1 << LV) - 1;
      if constexpr (dist == 1) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          w[j] = gf_mac_odd(w[j], w[j], grp[g0 + 2 * j],
                            odd_twiddle(grp, g0 + 2 * j + 1), H);
          w[j] ^= (w[j] << 8) & 0xFF00FF00u;
        }
      } else if constexpr (dist == 2) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          w[j] = gf_mac_hi(w[j], w[j], grp[g0 + j], H);
          w[j] ^= w[j] << 16;
        }
      } else {
        constexpr int half = dist / 4;
#pragma unroll
        for (int j = 0; j < (1 << LV); ++j) {
          const int r = 2 * half * j;
          const Twiddle tw = grp[g0 + j];
          if (dist < kBranchDist || tw.hi != 0u) {
#pragma unroll
            for (int i = 0; i < half; ++i) w[r + i] = gf_mac4(w[r + i], w[r + half + i], tw, H);
          }
#pragma unroll
          for (int i = 0; i < half; ++i) w[r + half + i] ^= w[r + i];
        }
      }
      fft<LV + 1>(w, grp, H);
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
                    const uint8_t* __restrict__ table, const __grid_constant__ TwiddleTable<N> tw) {
  using L = Layout<N>;
  constexpr int kWords = L::kWords;
  constexpr int kHalf = N / 2;  // = k: position p is cell (p + k) mod N
  extern __shared__ uint4 smem_vec[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_vec);
  const uint8_t* H = smem;
  const uint8_t* hi = smem + kTable;
  const Twiddle* grp = tw.e;
  uint32_t* sbase = reinterpret_cast<uint32_t*>(smem + L::sbase);
  uint32_t* ubase = reinterpret_cast<uint32_t*>(smem + L::ubase);
  uint2* sword = reinterpret_cast<uint2*>(smem + L::sword);
  uint2* uword = reinterpret_cast<uint2*>(smem + L::uword);
  uint32_t* wflag = reinterpret_cast<uint32_t*>(smem + L::wflag);
  const int t = threadIdx.x;

  // once per block: the table
  for (int i = t; i < kTableBytes / 16; i += kThreads) {
    smem_vec[i] = reinterpret_cast<const uint4*>(table)[i];
  }
  __syncthreads();

  const size_t plane = static_cast<size_t>(axes) * N;  // bytes of one (axes, n) plane
  for (int item = blockIdx.x; item < 2 * axes; item += gridDim.x) {
    const int axis = item >> 1;
    const uint8_t* scale_b = consts + static_cast<size_t>(axis) * N;
    const uint8_t* unscale_b = scale_b + plane;
    const uint8_t* write_b = unscale_b + plane;

    // this item's plan; an axis this sweep writes nothing of loads nothing
    int wr = 0;
    for (int p = t; p < L::kPos; p += kThreads) {
      sbase[p] = p < N ? (static_cast<uint32_t>(scale_b[p]) >> 1) << 8 : 0u;
      ubase[p] = p < N ? (static_cast<uint32_t>(unscale_b[p]) >> 1) << 8 : 0u;
      if (p < N) wr |= write_b[p];
    }
    for (int j = t; j < kWords; j += kThreads) {
      uint32_t scb = 0u, shi = 0u, ucb = 0u, uhi = 0u, wf = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = 4 * j + i;
        if (p < N) {
          const uint32_t cs = scale_b[p], cu = unscale_b[p];
          scb |= (cs & 1u) << (8 * i + 7);
          shi |= static_cast<uint32_t>(hi[cs]) << (8 * i);
          ucb |= (cu & 1u) << (8 * i + 7);
          uhi |= static_cast<uint32_t>(hi[cu]) << (8 * i);
          wf |= static_cast<uint32_t>(write_b[(p + kHalf) % N] != 0) << (8 * i);
        }
      }
      sword[j] = make_uint2(scb, shi);
      uword[j] = make_uint2(ucb, uhi);
      wflag[j] = wf;
    }
    if (!__syncthreads_or(wr)) continue;

    // this thread's lane of every cell of the axis, scaled
    uint8_t* lane = eds + static_cast<size_t>(axis) * axis_stride + (item & 1) * kThreads + t;
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
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      w[j] = gf_mul_pos<N>(w[j], j, reinterpret_cast<const uint4*>(sbase)[j], sword[j], H);
    }

    DecodeCore<N>::template ifft<0>(w, grp, H);
    DecodeCore<N>::template derivative<0, N>(w);
    DecodeCore<N>::template fft<0>(w, grp, H);

    // unscale and store the marked cells, with a copy of the cell stride
    // the compiler cannot see is the loads': else it keeps every cell's
    // 64-bit address from the loads live across the decode (two registers
    // a cell) and spills them
    size_t out_stride;
    asm volatile("mov.b64 %0, %1;" : "=l"(out_stride) : "l"(cell_stride));
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint32_t wf = wflag[j];
      if (wf) {
        const uint32_t u =
            gf_mul_pos<N>(w[j], j, reinterpret_cast<const uint4*>(ubase)[j], uword[j], H);
#pragma unroll
        for (int i = 0; i < 4 && 4 * j + i < N; ++i) {
          if (wf & (0xFFu << (8 * i))) {
            lane[((4 * j + i + kHalf) % N) * out_stride] = static_cast<uint8_t>(u >> (8 * i));
          }
        }
      }
    }
    __syncthreads();  // the next item rewrites the plan tables
  }
}

template <int N>
static cudaError_t launch_sweep(uint8_t* eds, size_t axis_stride, size_t cell_stride,
                                const uint8_t* consts, int axes, const uint8_t* table,
                                const uint32_t* twiddles, int device, cudaStream_t stream) {
  // blocks a grid holds: as many as stay resident, per device, found once
  static int resident[kMaxDevices] = {};
  constexpr int smem = Layout<N>::bytes;
  cudaError_t err = cudaFuncSetAttribute(decode_sweep_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = device < kMaxDevices ? resident[device] : 0;
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_sweep_kernel<N>,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = per_sm * sms;
    if (device < kMaxDevices) resident[device] = blocks;
  }
  TwiddleTable<N> tw;
  for (int g = 0; g < groups_of(N); ++g) {
    tw.e[g] = {twiddles[3 * g], twiddles[3 * g + 1], twiddles[3 * g + 2]};
  }
  const int items = 2 * axes;
  const int grid = items < blocks ? items : blocks;
  decode_sweep_kernel<N><<<grid, kThreads, smem, stream>>>(eds, axis_stride, cell_stride,
                                                           consts, axes, table, tw);
  return cudaGetLastError();
}

}  // namespace decode
}  // namespace celestia

// twiddles: host memory, (2(n - 1), 3) uint32, each group's Twiddle
// (ops/rs.py decode_twiddles).
extern "C" int celestia_decode_sweep(void* eds, long long axis_stride, long long cell_stride,
                                     const void* consts, int axes, const void* table,
                                     const void* twiddles, int n, int device, void* stream) {
  using namespace celestia::decode;
  if (axis_stride <= 0 || cell_stride <= 0 || axis_stride % kCell || cell_stride % kCell ||
      n < 2 || n > kMaxN || (n & (n - 1)) || axes <= 0 || device < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto e = static_cast<uint8_t*>(eds);
  auto as = static_cast<size_t>(axis_stride);
  auto cs = static_cast<size_t>(cell_stride);
  auto c = static_cast<const uint8_t*>(consts);
  auto tb = static_cast<const uint8_t*>(table);
  auto tw = static_cast<const uint32_t*>(twiddles);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: err = launch_sweep<2>(e, as, cs, c, axes, tb, tw, device, s); break;
    case 4: err = launch_sweep<4>(e, as, cs, c, axes, tb, tw, device, s); break;
    case 8: err = launch_sweep<8>(e, as, cs, c, axes, tb, tw, device, s); break;
    case 16: err = launch_sweep<16>(e, as, cs, c, axes, tb, tw, device, s); break;
    case 32: err = launch_sweep<32>(e, as, cs, c, axes, tb, tw, device, s); break;
    case 64: err = launch_sweep<64>(e, as, cs, c, axes, tb, tw, device, s); break;
    case 128: err = launch_sweep<128>(e, as, cs, c, axes, tb, tw, device, s); break;
    default: err = launch_sweep<256>(e, as, cs, c, axes, tb, tw, device, s); break;
  }
  return static_cast<int>(err);
}
