// K1 encode2d_hash, K4 encode2d and K2 leaf_digests2d for sm_90a.
//
// K1 replaces the Pallas kernel rs_pallas.encode2d_hash
// (celestia_tpu/ops/rs_pallas.py:276, body _fused_kernel :167, pallas_call
// :217): the Leopard RS encode of k data shards, fused with the SHA-256 NMT
// leaf digest of every parity cell it produces.
// K4 replaces rs_pallas.encode2d (rs_pallas.py:270, body _encode_kernel :163,
// pallas_call :197): K1 with the hash stage compiled out (kHash = false), so
// the encode has one copy.
// K2 replaces rs_pallas.leaf_digests2d (rs_pallas.py:295, body
// _leaf_kernel :178): the leaf digests of existing cells, each with its own
// namespace.
//
// Layouts. K1/K4 read k data shards of `cells` 512-byte cells and write k
// parity shards of as many cells, each operand at a shard stride and a cell
// stride in bytes (multiples of 512, so every 2-byte lane access stays
// aligned): shard i, cell c of x at x + i * xs.shard + c * xs.cell. A
// contiguous (k, n) operand has strides (n, 512); the quadrants of a
// (2k, 2k, 512) EDS are read and written in place, a column extend at
// (2k * 512, 512) and a row extend, whose shards are the EDS columns, at
// (512, 2k * 512). K1's digests are (k, cells, 8) uint32, [shard, cell]. K2
// reads x (rows, n) uint8, n a multiple of 512, and each cell's namespace
// as the first 29 of 32 bytes at ns + cell * ns_stride (ns_stride a
// multiple of 16: 32 for rs_cuda.pad_namespaces' (rows, n/512, 32) array,
// 512 for a Q0 whose cells carry their own namespace, read from x itself),
// and writes (rows, n/512, 8) uint32. The encode's operands (ops/rs.py fft_program,
// built once per k and device): fft_rows (n_const, 256) uint8, row i the
// products mul(c_i, 0..255) of the i-th distinct nonzero twiddle
// (n_const = k - 1), and fft_group (2(k - 1),) int16, each butterfly group's
// row or -1 for a zero twiddle.
//
// K1/K4 design. The encode is gf256.leopard_encode's own spelling, an
// inverse then a forward additive FFT over the k shards (896 butterflies at
// k = 128, 769 of them with a multiply by one of 127 constants), not the
// TPU kernel's GF(2) bit-matrix product on the MXU carried over. One block
// owns one 512-lane cell column; each of its 256 threads owns 2 adjacent
// lanes, held as one 16-bit half-word per shard in a register (k registers).
// The butterflies are unrolled at compile time (k is a template parameter)
// and run in registers; a multiply x ^= c * y looks up each byte of y in
// c's product row in shared memory, with the address made by one byte
// permute (the row sits on a 256-byte boundary), and puts the two products
// back together with one more. Every lane runs the same program, so the
// twiddle is a broadcast and the branch over a zero twiddle is uniform
// (groups narrower than kBranchDist multiply by a zero row instead, to keep
// the small groups free of branches). K1 also writes its parity into a
// shared-memory tile with a 516-byte row stride; after a barrier thread i
// hashes cell i of the column from the tile with sha256.cuh's leaf digest,
// the one K5 uses.
// What bounds it (k = 128, N = 65,536, see ops/rs_cuda.py): operations. The
// cheapest spelling of the FFT counts 9 int32 operations per multiply
// butterfly on a 4-lane word (4 address permutes, 3 assembling permutes,
// 2 XORs) and 1 per plain butterfly, 6.9 us on the ALUs, beside 769 byte
// lookups per lane, 6.0 us on the shared-memory pipe without bank
// conflicts; K1 adds the leaf SHA on the same ALUs. This kernel holds 2
// lanes per word (per 2-lane multiply: 2 address permutes, 1 assembling
// permute, 2 XORs, 2 lookups): at 4 lanes a thread, k = 128 has one warp per
// SM sub-partition and the dependent lookups stall it; 2 lanes give two
// warps and measured faster (PERF.md). A product row is 64 words over 32
// banks, so a warp's 32 lookups cost up to two wavefronts. Compiled for
// sm_90a (nvcc 12.8), K4's k = 128 instance is 7,360 SASS instructions per
// thread for its 776 multiply butterflies (7 of them by the zero row) and
// 120 plain ones: 2,693 PRMT, 1,634 LOP3, 514 IADD3 and 1,858 LDS (the
// 1,552 lookups and the group table), in 254 registers with no spill
// (chip_smoke.py's sass_mix and ptxas lines).
//
// K2 design. x, the namespaces and the digests are all cell-major (cell = row * n/512
// + column), so the kernel is one flat grid over cells, any row count and no
// tiles. One thread hashes one leaf, with no shared memory and no barrier: it
// streams its own 512-byte cell through registers in 16-byte read-only loads,
// the loads of message block b + 1 written before block b's compression.
// ptxas issues them about four fifths of the way through it (SASS), which
// still leaves ~300 instructions to cover their latency; an explicit L1
// prefetch at the top was moved down beside them and gained nothing
// (PERF.md). A warp's loads touch 32 cells, but each 32-byte sector is read
// by two loads of one thread and the second hits L1, so DRAM sees each byte
// once. With no shared memory the registers alone set the residency: the
// launch bounds hold a thread to 128 registers, so 8 blocks of 64 fit an SM
// and the k = 128 EDS (65,536 leaves) runs in one wave. Bound by the SHA work
// on the integer pipes (9 compressions a leaf); the 9 MB it moves at k = 128
// are 2.7 us at 3.35 TB/s. Compiled for sm_90a (nvcc 12.8) it takes 80
// registers with no spill, and its 4,256 SASS instructions hold three copies
// of the compression (block 0, the loop, block 8): 1,980 SHF, 1,048 LOP3, 708
// IADD3, 354 IMAD and 41 PRMT. ptxas already issues the two-input adds as
// IMAD on the FMA pipe; moving the three-input adds there too was 4% faster
// on the k = 128 EDS but 7% slower on Q0, where one warp per sub-partition
// waits on the longer chains (PERF.md), so it is not done.
//
// Every entry checks its launch with cudaGetLastError() and returns it.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sha256.cuh"

namespace celestia {

constexpr int kCell = 512;            // bytes per share
constexpr int kCellVecs = kCell / 16;  // 16-byte loads per cell
constexpr int kTileStride = 129;      // words per shared-memory cell row (516 B)
constexpr int kLeafThreads = 64;      // K2 threads (leaves) per block
constexpr int kLeafMinBlocks = 8;     // K2 blocks per SM: at most 128 registers a thread
constexpr int kRow = 256;             // bytes per product row in shared memory
constexpr int kBranchDist = 8;        // groups this wide branch over a zero twiddle
constexpr int kLanes = 2;             // lanes (bytes) per state word
constexpr int kEncodeThreads = kCell / kLanes;  // one block per cell column

// Where a shard and a cell of an encode operand lie, in bytes from its base:
// shard i, cell c at base + i * shard + c * cell, both multiples of kCell.
struct Strides {
  size_t shard;
  size_t cell;
};

__host__ __device__ constexpr int ilog2(int k) { return k <= 1 ? 0 : 1 + ilog2(k / 2); }
__host__ __device__ constexpr int groups_of(int k) { return 2 * (k - 1); }
// the group table comes first; the product rows start on a row boundary
__host__ __device__ constexpr int rows_offset(int k) {
  return (groups_of(k) * 4 + kRow - 1) / kRow * kRow;
}

// c * y in GF(256) for the 2 bytes of y; base is the byte offset of c's
// product row in `rows`, a multiple of 256, so a byte permute that puts a
// byte of y into base's low byte makes the lookup address.
__device__ __forceinline__ uint32_t gf_mul(uint32_t y, uint32_t base, const uint8_t* rows) {
  const uint32_t p0 = rows[__byte_perm(y, base, 0x7650)];
  const uint32_t p1 = rows[__byte_perm(y, base, 0x7651)];
  return __byte_perm(p0, p1, 0x1140);
}

// The butterflies of gf256.leopard_encode for K shards on state words in
// registers (every index is a compile-time constant once unrolled). Group
// g's product row is at grp[g], in the order ops/rs.py fft_program emits;
// `zero` is the zero row's offset, which a zero twiddle's group points at.
template <int K>
struct LeopardFft {
  static constexpr int kLog = ilog2(K);

  // IFFT level LV: dist = 2^LV; y ^= x, then x ^= c * y
  template <int LV>
  static __device__ __forceinline__ void ifft(uint32_t (&w)[K], const uint32_t* grp,
                                              const uint8_t* rows, uint32_t zero) {
    if constexpr (LV < kLog) {
      constexpr int dist = 1 << LV;
      constexpr int g0 = K - (K >> LV);
#pragma unroll
      for (int j = 0; j < K / (2 * dist); ++j) {
        const int r = 2 * dist * j;
        const uint32_t base = grp[g0 + j];
#pragma unroll
        for (int i = 0; i < dist; ++i) w[r + dist + i] ^= w[r + i];
        if (dist < kBranchDist || base != zero) {
#pragma unroll
          for (int i = 0; i < dist; ++i) w[r + i] ^= gf_mul(w[r + dist + i], base, rows);
        }
      }
      ifft<LV + 1>(w, grp, rows, zero);
    }
  }

  // FFT level LV: dist = K / 2^(LV + 1); x ^= c * y, then y ^= x
  template <int LV>
  static __device__ __forceinline__ void fft(uint32_t (&w)[K], const uint32_t* grp,
                                             const uint8_t* rows, uint32_t zero) {
    if constexpr (LV < kLog) {
      constexpr int dist = K >> (LV + 1);
      constexpr int g0 = (K - 1) + (1 << LV) - 1;
#pragma unroll
      for (int j = 0; j < (1 << LV); ++j) {
        const int r = 2 * dist * j;
        const uint32_t base = grp[g0 + j];
        if (dist < kBranchDist || base != zero) {
#pragma unroll
          for (int i = 0; i < dist; ++i) w[r + i] ^= gf_mul(w[r + dist + i], base, rows);
        }
#pragma unroll
        for (int i = 0; i < dist; ++i) w[r + dist + i] ^= w[r + i];
      }
      fft<LV + 1>(w, grp, rows, zero);
    }
  }
};

template <int K, bool kHash>
__global__ void __launch_bounds__(kEncodeThreads)
encode2d_fft_kernel(const uint8_t* __restrict__ x, Strides xs,
                    const uint8_t* __restrict__ fft_rows,
                    const int16_t* __restrict__ fft_group, int n_const,
                    uint8_t* __restrict__ parity, Strides ps, uint32_t* __restrict__ digests) {
  constexpr int kGroups = groups_of(K);
  extern __shared__ uint4 smem_vec[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_vec);
  uint32_t* grp = reinterpret_cast<uint32_t*>(smem);     // kGroups row offsets
  uint8_t* rows = smem + rows_offset(K);                  // n_const rows, then a zero row
  uint32_t* tile = reinterpret_cast<uint32_t*>(rows + (n_const + 1) * kRow);  // kHash
  uint8_t* tile_bytes = reinterpret_cast<uint8_t*>(tile);
  const uint32_t zero = static_cast<uint32_t>(n_const) * kRow;

  const int col = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* xc = x + static_cast<size_t>(col) * xs.cell + kLanes * t;
  uint8_t* pc = parity + static_cast<size_t>(col) * ps.cell + kLanes * t;

  uint32_t w[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    w[i] = *reinterpret_cast<const uint16_t*>(xc + static_cast<size_t>(i) * xs.shard);
  }

  const int nvec = n_const * (kRow / 16);
  for (int i = t; i < nvec + kRow / 16; i += kEncodeThreads) {
    reinterpret_cast<uint4*>(rows)[i] =
        i < nvec ? reinterpret_cast<const uint4*>(fft_rows)[i] : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int g = t; g < kGroups; g += kEncodeThreads) {
    const int r = fft_group[g];
    grp[g] = r < 0 ? zero : static_cast<uint32_t>(r) * kRow;
  }
  __syncthreads();

  LeopardFft<K>::template ifft<0>(w, grp, rows, zero);
  LeopardFft<K>::template fft<0>(w, grp, rows, zero);

#pragma unroll
  for (int i = 0; i < K; ++i) {
    const uint16_t v = static_cast<uint16_t>(w[i]);
    *reinterpret_cast<uint16_t*>(pc + static_cast<size_t>(i) * ps.shard) = v;
    if (kHash) {
      *reinterpret_cast<uint16_t*>(tile_bytes + i * kTileStride * 4 + kLanes * t) = v;
    }
  }
  if (!kHash) return;
  __syncthreads();

  if (t < K) {
    uint32_t pre[8], st[8];
    leaf_prefix_parity(pre);
    leaf_digest(tile + t * kTileStride, pre, st);
    uint32_t* out = digests + (static_cast<size_t>(t) * gridDim.x + col) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = st[i];
  }
}

__global__ void __launch_bounds__(kLeafThreads, kLeafMinBlocks)
leaf_digests2d_kernel(const uint4* __restrict__ x, const uint4* __restrict__ ns,
                      int ns_vecs, uint4* __restrict__ digests, int cells) {
  const int cell = blockIdx.x * kLeafThreads + threadIdx.x;
  if (cell >= cells) return;
  const uint4* src = x + static_cast<size_t>(cell) * kCellVecs;

  // block 0 reads v[0..2]; v[3..6] are the new words of block 1
  uint4 v0 = __ldg(src), v1 = __ldg(src + 1), carry = __ldg(src + 2);
  uint4 next[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) next[i] = __ldg(src + 3 + i);
  const uint4* nsc = ns + static_cast<size_t>(ns_vecs) * cell;
  const uint4 lo = __ldg(nsc);
  const uint4 hi = __ldg(nsc + 1);
  const uint32_t nsw[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};

  uint32_t w[16], st[8];
  sha256_init(st);
  // block 0: 0x00 ‖ namespace, then cell bytes 0..33 (cell words 0..8)
  leaf_prefix_from_ns(nsw, w);
  w[7] |= __byte_perm(v0.x, 0u, 0x4401);
  {
    const uint32_t c[9] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w, carry.x};
#pragma unroll
    for (int j = 0; j < 8; ++j) w[8 + j] = cell_word(c[j], c[j + 1]);
  }
  sha256_compress(st, w);

  // blocks 1..7: block b reads v[4b-2 .. 4b+2]; the loads of v[4b+3 ..
  // 4b+6] for block b + 1 come first (clamped to v[31]: block 8 reads only
  // v[30] and v[31])
#pragma unroll 1
  for (int b = 1; b < 8; ++b) {
    const uint4 win[5] = {carry, next[0], next[1], next[2], next[3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) next[i] = __ldg(src + min(4 * b + 3 + i, kCellVecs - 1));
    carry = win[4];
    // cell words 16b-8 .. 16b+11; the block reads the first 17
    uint32_t c[20];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      c[4 * i] = win[i].x; c[4 * i + 1] = win[i].y;
      c[4 * i + 2] = win[i].z; c[4 * i + 3] = win[i].w;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = cell_word(c[j], c[j + 1]);
    sha256_compress(st, w);
  }

  // block 8: cell words 120..127 (v[30] = carry, v[31] = next[0]), the 0x80
  // that ends the message, the zero fill and the bit length 542 * 8
  {
    const uint32_t c[9] = {carry.x, carry.y, carry.z, carry.w,
                           next[0].x, next[0].y, next[0].z, next[0].w, 0x80u};
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = cell_word(c[j], c[j + 1]);
  }
#pragma unroll
  for (int j = 8; j < 15; ++j) w[j] = 0u;
  w[15] = 542u * 8u;
  sha256_compress(st, w);

  uint4* out = digests + 2 * static_cast<size_t>(cell);
  out[0] = make_uint4(st[0], st[1], st[2], st[3]);
  out[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

template <int K, bool kHash>
static cudaError_t launch_encode(const uint8_t* x, Strides xs, const uint8_t* rows,
                                 const int16_t* group, int n_const, uint8_t* parity, Strides ps,
                                 uint32_t* digests, int cells, cudaStream_t stream) {
  const size_t smem = rows_offset(K) + static_cast<size_t>(n_const + 1) * kRow +
                      (kHash ? static_cast<size_t>(K) * kTileStride * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(encode2d_fft_kernel<K, kHash>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  encode2d_fft_kernel<K, kHash><<<cells, kEncodeThreads, smem, stream>>>(
      x, xs, rows, group, n_const, parity, ps, digests);
  return cudaGetLastError();
}

// The butterfly program's shape depends on k alone, so k is a template
// parameter and every level unrolls; the twiddles stay in memory.
template <bool kHash>
static int encode_entry(const void* x, long long x_shard, long long x_cell, const void* rows,
                        const void* group, int n_const, void* parity, long long p_shard,
                        long long p_cell, void* digests, int k, int cells, int device,
                        void* stream) {
  const long long strides[4] = {x_shard, x_cell, p_shard, p_cell};
  for (long long v : strides) {
    if (v <= 0 || v % kCell) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k < 1 || k > 128 || (k & (k - 1)) || cells <= 0 || n_const < 0 ||
      n_const > groups_of(k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto xs = static_cast<const uint8_t*>(x);
  auto rs = static_cast<const uint8_t*>(rows);
  auto gs = static_cast<const int16_t*>(group);
  auto ps = static_cast<uint8_t*>(parity);
  auto ds = static_cast<uint32_t*>(digests);
  auto s = static_cast<cudaStream_t>(stream);
  const Strides in{static_cast<size_t>(x_shard), static_cast<size_t>(x_cell)};
  const Strides out{static_cast<size_t>(p_shard), static_cast<size_t>(p_cell)};
  switch (k) {
    case 1: err = launch_encode<1, kHash>(xs, in, rs, gs, n_const, ps, out, ds, cells, s); break;
    case 2: err = launch_encode<2, kHash>(xs, in, rs, gs, n_const, ps, out, ds, cells, s); break;
    case 4: err = launch_encode<4, kHash>(xs, in, rs, gs, n_const, ps, out, ds, cells, s); break;
    case 8: err = launch_encode<8, kHash>(xs, in, rs, gs, n_const, ps, out, ds, cells, s); break;
    case 16: err = launch_encode<16, kHash>(xs, in, rs, gs, n_const, ps, out, ds, cells, s); break;
    case 32: err = launch_encode<32, kHash>(xs, in, rs, gs, n_const, ps, out, ds, cells, s); break;
    case 64: err = launch_encode<64, kHash>(xs, in, rs, gs, n_const, ps, out, ds, cells, s); break;
    default: err = launch_encode<128, kHash>(xs, in, rs, gs, n_const, ps, out, ds, cells, s); break;
  }
  return static_cast<int>(err);
}

}  // namespace celestia

extern "C" int celestia_encode2d_hash(const void* x, long long x_shard, long long x_cell,
                                      const void* fft_rows, const void* fft_group, int n_const,
                                      void* parity, long long p_shard, long long p_cell,
                                      void* digests, int k, int cells, int device, void* stream) {
  return celestia::encode_entry<true>(x, x_shard, x_cell, fft_rows, fft_group, n_const, parity,
                                      p_shard, p_cell, digests, k, cells, device, stream);
}

extern "C" int celestia_encode2d(const void* x, long long x_shard, long long x_cell,
                                 const void* fft_rows, const void* fft_group, int n_const,
                                 void* parity, long long p_shard, long long p_cell, int k,
                                 int cells, int device, void* stream) {
  return celestia::encode_entry<false>(x, x_shard, x_cell, fft_rows, fft_group, n_const, parity,
                                       p_shard, p_cell, nullptr, k, cells, device, stream);
}

extern "C" int celestia_leaf_digests2d(const void* x, const void* ns, int ns_stride,
                                       void* digests, int rows, int n, int device,
                                       void* stream) {
  using namespace celestia;
  if (rows <= 0 || n <= 0 || n % kCell || rows > INT_MAX / (n / kCell) || ns_stride < 32 ||
      ns_stride % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cells = rows * (n / kCell);
  leaf_digests2d_kernel<<<(cells + kLeafThreads - 1) / kLeafThreads, kLeafThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(ns), ns_stride / 16,
      static_cast<uint4*>(digests), cells);
  return static_cast<int>(cudaGetLastError());
}
