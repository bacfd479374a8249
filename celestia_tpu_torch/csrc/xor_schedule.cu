// K5 encode2d_xor_hash and K6 encode2d_xor for sm_90a.
//
// K5 replaces the Pallas kernel xor_schedule.encode2d_xor_hash
// (celestia_tpu/ops/xor_schedule.py:537, body _xor_fused_kernel :485): K1's
// output contract (parity bytes and the NMT leaf digest of every parity
// cell), with the parity computed by the compiled XOR schedule instead of
// the dense GF(2) product. K6 replaces xor_schedule.encode2d_xor
// (xor_schedule.py:476, body _xor_encode_kernel :447): the same encode
// without the hash (kHash = false).
//
// Operands (ops/xor_cuda.py's XorLayout, built once per k):
//   x      (k, n) uint8, the shard axis leading, n a multiple of 512
//   prog   (groups, words) uint32: group g's program (its shared part: the
//          header, the node entries, the row pairs past kRegPairs; then the
//          first kRegPairs row pairs and the thread words, read once into
//          registers; see XorLayout)
//   parity (k, n) uint8; digests (k, n/512, 8) uint32 (K5 only)
// A plane is bit-sliced: one 32-bit word carries one bit of 32 lanes, a
// 128-lane chunk of a plane is one 16-byte slot. Slots: input plane 8s + b
// at 8s + ((b + s) mod 8), the zero plane at 8k + r (one per residue r),
// then the nodes a group holds, in the layout's order.
//
// Design. The k shards' output rows are split into `groups` groups; block b
// runs group b % groups and walks the lane chunks b / groups, + the number
// of walkers, ... (K5: whole 512-lane cell columns). One block an SM. The
// schedule stays on chip for the whole launch: a group's nodes (those its
// rows need, level by level) in shared memory, and each thread's row
// program (one row segment's operand slots, two to a 32-bit word) in
// registers, the part past kRegPairs in shared memory; no index is read
// from L2 after the prologue. For each 128-lane chunk:
//   1. bit-slice: thread (s, w) takes 32 bytes of shard s (staged by
//      cp.async a chunk ahead) and turns them into word w of the shard's 8
//      planes with three rounds of bit swaps in registers (bit 8m + j of
//      word w of plane b is bit b of lane 32w + 4j + m); the 8 shards of a
//      warp store 8 residues, so the stores are conflict-free;
//   2. the nodes, level by level, one node a thread: a | b operands, the
//      result slot; a barrier per level;
//   3. the rows: a thread XORs its segment's operands, two per three-input
//      XOR, into a uint4 (128 lanes), and stores it in the row buffer;
//   4. pack: thread (s, w) XORs the segments of its shard's 8 rows, runs
//      the bit swaps again (they are their own inverse) and writes 32
//      parity bytes (K5: also to a ring slot for the hash warp).
// Every 16-byte shared-memory access is served eight threads at a time; the
// layout makes those eight hit eight different bank groups at every step
// (node operands and results, row operands, bit-slice stores, pack loads),
// padding with zero-plane reads where the operands do not allow it.
// K5 adds a 17th warp: lane s keeps the SHA-256 state of its shard's cell in
// the current column and takes each 128-byte chunk from the ring as the
// encode warps finish it (sha256.cuh's leaf_digest_quarter: two
// compressions a chunk, three for the last), so only the last chunk's three
// compressions trail the encode. Its registers bound the block's at 96, so
// both kernels keep 32 step pairs in registers. Named barriers: 1 the
// encode warps, 2..5 a ring slot is full, 6..9 it is free.
// What bounds it: the spelling reads every operand from shared memory,
// 247,616 16-byte reads per 128 lanes at k = 128, 61 µs at one 128-byte
// wavefront a clock and SM; this layout reads 282,976 (each of 4 groups
// reads the nodes its rows need, and 4% are zero-plane padding), 69 µs.
// The ALU work (one LOP3 per two operands) is a quarter of that.
//
// Every entry checks its launch with cudaGetLastError() and returns it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

namespace celestia {

constexpr int kCell = 512;         // bytes per share
constexpr int kChunk = 128;        // lanes per chunk: one 16-byte slot per plane
constexpr int kEncThreads = 512;   // the encode warps
constexpr int kHashThreads = 32;   // K5's hash warp, one lane a shard
constexpr int kRing = 4;           // K5's chunk slots between encode and hash warps
constexpr int kRingStride = 33;    // words per shard row of a ring slot
constexpr int kBarEncode = 1;      // named barriers: the encode warps,
constexpr int kBarFull = 2;        // a ring slot is full (2..5),
constexpr int kBarFree = kBarFull + kRing;  // a ring slot is free (6..9)
constexpr int kRegPairs = 32;      // registers of a thread's row program
constexpr int kHeader = 5;         // fixed header words of a group's program
constexpr int kStageStride = 144;  // bytes per shard row of the staged chunk
constexpr int kMaxSmem = 232448;   // per block, after the opt-in

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void xor4(uint4& acc, const uint4 v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// acc ^= slot a ^ slot b, ab = a | b << 16: one three-input XOR a word
__device__ __forceinline__ void xor_pair(uint4& acc, const uint4* planes, uint32_t ab) {
  const uint4 a = planes[ab & 0xFFFFu];
  const uint4 b = planes[ab >> 16];
  acc.x ^= a.x ^ b.x;
  acc.y ^= a.y ^ b.y;
  acc.z ^= a.z ^ b.z;
  acc.w ^= a.w ^ b.w;
}

// Exchange bit j of the word index with bit D's place of the bit position,
// for the word pair (a: j = 0, b: j = 1); M marks the positions whose D bit
// is 0.
template <int D, uint32_t M>
__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b) {
  const uint32_t t = ((a >> D) ^ b) & M;
  b ^= t;
  a ^= t << D;
}

// 32 bytes as 8 little-endian words (byte 4j + m of word j at bits
// 8m .. 8m + 7) <-> 8 bit planes (bit b of byte 4j + m at bit 8m + j of
// word b). The three swaps exchange disjoint pairs of address bits, so they
// commute and the network is its own inverse.
__device__ __forceinline__ void bit_slice(uint32_t w[8]) {
  swap_bits<1, 0x55555555u>(w[0], w[1]);
  swap_bits<1, 0x55555555u>(w[2], w[3]);
  swap_bits<1, 0x55555555u>(w[4], w[5]);
  swap_bits<1, 0x55555555u>(w[6], w[7]);
  swap_bits<2, 0x33333333u>(w[0], w[2]);
  swap_bits<2, 0x33333333u>(w[1], w[3]);
  swap_bits<2, 0x33333333u>(w[4], w[6]);
  swap_bits<2, 0x33333333u>(w[5], w[7]);
  swap_bits<4, 0x0F0F0F0Fu>(w[0], w[4]);
  swap_bits<4, 0x0F0F0F0Fu>(w[1], w[5]);
  swap_bits<4, 0x0F0F0F0Fu>(w[2], w[6]);
  swap_bits<4, 0x0F0F0F0Fu>(w[3], w[7]);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

// Stage 32 bytes (lanes base + 32w ..) of shard s for the bit-slice.
__device__ __forceinline__ void stage_chunk(uint8_t* stage, const uint8_t* x, int s, int w,
                                            int n, size_t base) {
  const uint8_t* src = x + static_cast<size_t>(s) * n + base + 32 * w;
  uint8_t* dst = stage + s * kStageStride + 32 * w;
  cp_async16(dst, src);
  cp_async16(dst + 16, src + 16);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <bool kHash>
__global__ void __launch_bounds__(kEncThreads + (kHash ? kHashThreads : 0), 1)
encode2d_xor_kernel(const uint8_t* __restrict__ x, const uint32_t* __restrict__ prog,
                    int words, int smem_words, int n_levels, int max_pairs, int n_slots,
                    int groups, int segs, uint8_t* __restrict__ parity,
                    uint32_t* __restrict__ digests, int k, int n) {
  extern __shared__ uint4 smem[];
  const int spc = k / groups;
  uint4* planes = smem;
  uint4* rowbuf = planes + n_slots;
  uint32_t* prg = reinterpret_cast<uint32_t*>(rowbuf + segs * 8 * spc + 8);
  uint8_t* stage = reinterpret_cast<uint8_t*>(prg + smem_words);
  uint32_t* ring = reinterpret_cast<uint32_t*>(stage + k * kStageStride);  // K5

  const int t = threadIdx.x;
  const int g = blockIdx.x % groups;
  const int walker = blockIdx.x / groups;
  const int walkers = gridDim.x / groups;
  constexpr int kPerUnit = kHash ? kCell / kChunk : 1;  // chunks of a walker's unit
  const int units = n / (kChunk * kPerUnit);
  const int chunks = walker < units ? (units - 1 - walker) / walkers * kPerUnit + kPerUnit : 0;
  auto chunk_lane = [&](int i) -> size_t {  // first lane of the walker's chunk i
    const size_t unit = walker + static_cast<size_t>(i / kPerUnit) * walkers;
    return (unit * kPerUnit + i % kPerUnit) * kChunk;
  };
  const uint32_t* gprog = prog + static_cast<size_t>(g) * words;

  // the program's shared part; the first chunk's input on its way
  const bool slicer = t < 4 * k;  // bit-slice unit (shard t / 4, word t % 4)
  const int s_in = t >> 2;
  const int w_in = t & 3;
  if (slicer && chunks > 0) stage_chunk(stage, x, s_in, w_in, n, chunk_lane(0));
  for (int i = t; i < smem_words / 4; i += blockDim.x) {
    reinterpret_cast<uint4*>(prg)[i] = __ldg(reinterpret_cast<const uint4*>(gprog) + i);
  }
  if (t < 8) planes[8 * k + t] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  if (kHash && t >= kEncThreads) {
    // the hash warp: lane s keeps the SHA-256 state of shard g * spc + s's
    // cell of the current column and takes each chunk of it from the ring
    const int lane = t - kEncThreads;
    uint32_t pre[8], st[8], carry[8];
    leaf_prefix_parity(pre);
    for (int i = 0; i < chunks; ++i) {
      bar_sync(kBarFull + i % kRing, kEncThreads + kHashThreads);
      if (lane < spc) {
        const uint32_t* cw = ring + ((i % kRing) * spc + lane) * kRingStride;
        leaf_digest_quarter(st, carry, cw, i % kPerUnit, pre);
        if (i % kPerUnit == kPerUnit - 1) {
          const size_t col = walker + static_cast<size_t>(i / kPerUnit) * walkers;
          uint32_t* out = digests + ((static_cast<size_t>(g) * spc + lane) * (n / kCell) + col) * 8;
#pragma unroll
          for (int j = 0; j < 8; ++j) out[j] = st[j];
        }
      }
      __syncwarp();
      if (i + kRing < chunks) bar_arrive(kBarFree + i % kRing, kEncThreads + kHashThreads);
    }
    return;
  }

  // this thread's row program: the first kRegPairs step pairs in registers,
  // the rest in shared memory, four pairs a 16-byte vector
  uint32_t idx[kRegPairs];
  const int reg_pairs = max_pairs < kRegPairs ? max_pairs : kRegPairs;
#pragma unroll
  for (int j = 0; j < kRegPairs; ++j) {
    idx[j] = j < reg_pairs ? __ldg(gprog + smem_words + j * kEncThreads + t) : 0u;
  }
  const uint32_t meta = __ldg(gprog + smem_words + reg_pairs * kEncThreads + t);
  const uint4* row_vec = reinterpret_cast<const uint4*>(prg + prg[4]) + t;
  const int n_pairs = meta >> 16;  // one count for the warp, a multiple of 4
  const uint32_t* rowbuf32 = reinterpret_cast<const uint32_t*>(rowbuf);

  uint32_t* planes32 = reinterpret_cast<uint32_t*>(planes);

  for (int i = 0; i < chunks; ++i) {
    const size_t base = chunk_lane(i);
    // 1. bit-slice the staged chunk into the input planes; stage the next
    if (slicer) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      const uint4* src = reinterpret_cast<const uint4*>(stage + s_in * kStageStride + 32 * w_in);
      const uint4 v0 = src[0];
      const uint4 v1 = src[1];
      uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      bit_slice(w);
#pragma unroll
      for (int b = 0; b < 8; ++b) planes32[(8 * s_in + ((b + s_in) & 7)) * 4 + w_in] = w[b];
      if (i + 1 < chunks) stage_chunk(stage, x, s_in, w_in, n, chunk_lane(i + 1));
    }
    bar_sync(kBarEncode, kEncThreads);

    // 2. the group's nodes, level by level; a level reads only earlier
    // slots, so its loads may run ahead of its stores
    for (int l = 0; l < n_levels; ++l) {
      const int count = prg[kHeader + l];
      const uint2* entry = reinterpret_cast<const uint2*>(prg + prg[kHeader + n_levels + l]);
      const uint4* __restrict__ src = planes;
      uint4* __restrict__ dst = planes;
#pragma unroll 2
      for (int j = t; j < count; j += kEncThreads) {
        const uint2 e = entry[j];
        uint4 v = src[e.x & 0xFFFFu];
        xor4(v, src[e.x >> 16]);
        dst[e.y] = v;
      }
      bar_sync(kBarEncode, kEncThreads);
    }

    // 3. the row segments, one a thread, its operand slots in registers
    {
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < kRegPairs; j += 2) {
        if (j >= n_pairs) break;
        xor_pair(acc, planes, idx[j]);
        xor_pair(acc, planes, idx[j + 1]);
      }
      for (int j = kRegPairs; j < n_pairs; j += 4) {
        const uint4 v = row_vec[(j - kRegPairs) / 4 * kEncThreads];
        xor_pair(acc, planes, v.x);
        xor_pair(acc, planes, v.y);
        xor_pair(acc, planes, v.z);
        xor_pair(acc, planes, v.w);
      }
      rowbuf[meta & 0xFFFFu] = acc;
    }
    bar_sync(kBarEncode, kEncThreads);

    // 4. pack: shard s's 8 rows, word w -> 32 parity bytes (K5: also into
    // a ring slot, once the hash warp has freed it)
    if (kHash && i >= kRing) bar_sync(kBarFree + i % kRing, kEncThreads + kHashThreads);
    if (t < 4 * spc) {
      const int s = t >> 2;
      const int w = t & 3;
      uint32_t r[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) {  // segs is 1 or 2
        const int slot = 8 * s + ((b + s) & 7);
        r[b] = rowbuf32[slot * 4 + w];
        if (segs > 1) r[b] ^= rowbuf32[(8 * spc + slot) * 4 + w];
      }
      bit_slice(r);
      uint4* out = reinterpret_cast<uint4*>(
          parity + (static_cast<size_t>(g) * spc + s) * n + base + 32 * w);
      out[0] = make_uint4(r[0], r[1], r[2], r[3]);
      out[1] = make_uint4(r[4], r[5], r[6], r[7]);
      if (kHash) {
        uint32_t* row = ring + ((i % kRing) * spc + s) * kRingStride + 8 * w;
#pragma unroll
        for (int j = 0; j < 8; ++j) row[j] = r[j];
      }
    }
    if (kHash) {
      __threadfence_block();
      bar_arrive(kBarFull + i % kRing, kEncThreads + kHashThreads);
    }
  }
}

template <bool kHash>
static int xor_entry(const void* x, const void* prog, int words, int smem_words, int n_levels,
                     int max_pairs, int n_slots, int groups, int segs, void* parity,
                     void* digests, int k, int n, int device, void* stream) {
  if (k < 1 || k > 128 || (k & (k - 1)) || n <= 0 || n % kCell || groups < 1 ||
      k % groups || k / groups > kHashThreads || segs < 1 || segs > 2 || n_levels < 0 ||
      max_pairs < 0 || max_pairs % 4 || smem_words % 4 || smem_words < kHeader + 2 * n_levels ||
      words < smem_words + ((max_pairs < kRegPairs ? max_pairs : kRegPairs) + 1) * kEncThreads ||
      n_slots < 8 * k + 8 || n_slots > 65536 || segs * 8 * (k / groups) + 8 > 65536) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int spc = k / groups;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = n / (kHash ? kCell : kChunk);
  const int walkers = units < sms / groups ? units : (sms / groups > 0 ? sms / groups : 1);
  const size_t smem = 16 * static_cast<size_t>(n_slots + segs * 8 * spc + 8) +
                      4 * static_cast<size_t>(smem_words) + static_cast<size_t>(k) * kStageStride +
                      (kHash ? 4 * static_cast<size_t>(kRing) * spc * kRingStride : 0);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(encode2d_xor_kernel<kHash>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  encode2d_xor_kernel<kHash><<<groups * walkers, kEncThreads + (kHash ? kHashThreads : 0), smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint32_t*>(prog), words, smem_words,
      n_levels, max_pairs, n_slots, groups, segs,
      static_cast<uint8_t*>(parity),
      static_cast<uint32_t*>(digests), k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace celestia

extern "C" int celestia_encode2d_xor_hash(const void* x, const void* prog, int words,
                                          int smem_words, int n_levels, int max_pairs,
                                          int n_slots, int groups, int segs, void* parity,
                                          void* digests, int k, int n, int device, void* stream) {
  return celestia::xor_entry<true>(x, prog, words, smem_words, n_levels, max_pairs, n_slots,
                                   groups, segs, parity, digests, k, n, device, stream);
}

extern "C" int celestia_encode2d_xor(const void* x, const void* prog, int words, int smem_words,
                                     int n_levels, int max_pairs, int n_slots, int groups,
                                     int segs, void* parity, int k, int n, int device,
                                     void* stream) {
  return celestia::xor_entry<false>(x, prog, words, smem_words, n_levels, max_pairs, n_slots,
                                    groups, segs, parity, nullptr, k, n, device, stream);
}
