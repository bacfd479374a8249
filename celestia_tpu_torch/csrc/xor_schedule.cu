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
// Operands (ops/xor_cuda.py builds them once per k and device):
//   x        (k, n) uint8, the shard axis leading, n a multiple of 512
//   node_ab  (n_nodes,) uint32, node i = planes[a] ^ planes[b] with
//            a = low 16 bits, b = high 16 bits
//   level_off (n_levels + 1,) int32, level l is nodes [off[l], off[l+1])
//   row_blk  (width8, 8k, 8) uint16: row r's plane indices in groups of 8,
//            padded with the zero plane
//   parity   (k, n) uint8; digests (k, n/512, 8) uint32 (K5 only)
// Plane space: input plane q = 8*shard + bit (LSB first) in [0, 8k), the
// zero plane at 8k, node i at 8k + 1 + i.
//
// Design. The TPU kernel works on int32 0/1 elements. Here a plane is
// bit-sliced: one 32-bit word carries one bit of 32 lanes, so one XOR
// serves 32 lanes. A block evaluates the schedule on chunks of 128 lanes,
// one uint4 per plane, with the whole plane store in shared memory
// ((8k + 1 + n_nodes) * 16 B, 82 KB at k = 128):
//   1. bit-slice: a warp reads 128 bytes of one shard (4 lanes per thread)
//      and turns them into that shard's 8 planes with 32 __ballot_sync;
//      word b of a plane holds lanes 4t + b, t = 0..31, so the loads
//      coalesce and the pack stage reads each word as a broadcast;
//   2. nodes, level by level, one node per thread, a barrier per level;
//   3. rows: each thread XORs its output rows' planes (row_blk read as one
//      16-byte vector per 8 indices, coalesced across the warp);
//   4. pack: the 8k row words go back over the input planes and every
//      thread assembles one output byte from 8 of them.
// K5's block owns one 512-lane cell column (4 chunks) and writes each
// chunk's parity into a shared-memory tile as well; after the last chunk,
// thread i hashes cell i of the column with K1's own leaf digest
// (sha256.cuh) from a tile with K1's row stride. K6's block owns one chunk.
// What bounds it: at k = 128 the schedule is 242,496 XORs per 32 lanes;
// this first version is limited by its shared-memory reads (one 16-byte
// plane read per XOR per 128 lanes) and by reading row_blk (0.5 MB at
// k = 128) once per chunk from L2.
//
// Every entry checks its launch with cudaGetLastError() and returns it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

namespace celestia {

constexpr int kCell = 512;                // bytes per share
constexpr int kTileStride = 129;          // words per tile row, as in K1 (516 B)
constexpr int kChunk = 128;               // lanes per chunk: one uint4 per plane
constexpr int kXorThreads = 512;
constexpr int kMaxRowsPerThread = 2;      // 8k <= 1024 output rows
constexpr int kMaxSmem = 232448;          // per block, after the opt-in

__device__ __forceinline__ void xor4(uint4& acc, const uint4 v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

template <bool kHash>
__global__ void __launch_bounds__(kXorThreads)
encode2d_xor_kernel(const uint8_t* __restrict__ x, const uint32_t* __restrict__ node_ab,
                    const int* __restrict__ level_off, int n_levels, int n_nodes,
                    const uint4* __restrict__ row_blk, int width8,
                    uint8_t* __restrict__ parity, uint32_t* __restrict__ digests,
                    int k, int n) {
  extern __shared__ uint4 planes[];  // (8k + 1 + n_nodes) planes, then the tile
  uint32_t* planes32 = reinterpret_cast<uint32_t*>(planes);
  const int n_in = 8 * k;
  uint32_t* tile = planes32 + 4 * (n_in + 1 + n_nodes);
  uint8_t* tile_bytes = reinterpret_cast<uint8_t*>(tile);

  constexpr int kWarps = kXorThreads / 32;
  constexpr int kChunks = kHash ? kCell / kChunk : 1;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  if (t == 0) planes[n_in] = make_uint4(0u, 0u, 0u, 0u);

  for (int c = 0; c < kChunks; ++c) {
    const size_t base = (static_cast<size_t>(blockIdx.x) * kChunks + c) * kChunk;

    // 1. bit-slice: bit q = 8b + bit of v is bit `bit` of lane 4*lane + b;
    // its ballot is word b of plane 8s + bit, stored by thread 4*bit + b
    for (int s = warp; s < k; s += kWarps) {
      const uint32_t v =
          *reinterpret_cast<const uint32_t*>(x + static_cast<size_t>(s) * n + base + 4 * lane);
      uint32_t mine = 0u;
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const uint32_t m = __ballot_sync(0xFFFFFFFFu, (v >> q) & 1u);
        if (lane == 4 * (q & 7) + (q >> 3)) mine = m;
      }
      planes32[32 * s + lane] = mine;
    }
    __syncthreads();

    // 2. the shared nodes, level by level
    for (int l = 0; l < n_levels; ++l) {
      const int hi = level_off[l + 1];
      for (int i = level_off[l] + t; i < hi; i += kXorThreads) {
        const uint32_t ab = __ldg(node_ab + i);
        uint4 v = planes[ab & 0xFFFFu];
        xor4(v, planes[ab >> 16]);
        planes[n_in + 1 + i] = v;
      }
      __syncthreads();
    }

    // 3. output rows
    uint4 acc[kMaxRowsPerThread];
#pragma unroll
    for (int i = 0; i < kMaxRowsPerThread; ++i) {
      acc[i] = make_uint4(0u, 0u, 0u, 0u);
      const int r = t + i * kXorThreads;
      if (r >= n_in) continue;
      const uint4* idx = row_blk + r;
      for (int g = 0; g < width8; ++g) {
        const uint4 iv = __ldg(idx + static_cast<size_t>(g) * n_in);
        const uint32_t w[4] = {iv.x, iv.y, iv.z, iv.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          xor4(acc[i], planes[w[h] & 0xFFFFu]);
          xor4(acc[i], planes[w[h] >> 16]);
        }
      }
    }
    __syncthreads();  // every read of the input planes is done

    // 4. pack: output byte of lane L = 4p + b, shard s, is bit p of word b
    // of rows 8s .. 8s + 7
#pragma unroll
    for (int i = 0; i < kMaxRowsPerThread; ++i) {
      const int r = t + i * kXorThreads;
      if (r < n_in) planes[r] = acc[i];
    }
    __syncthreads();
    for (int i = t; i < k * kChunk; i += kXorThreads) {
      const int s = i / kChunk;
      const int l = i % kChunk;
      const uint32_t* rows = planes32 + 4 * 8 * s + (l & 3);
      const int p = l >> 2;
      uint32_t byte = 0u;
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) byte |= ((rows[4 * bit] >> p) & 1u) << bit;
      parity[static_cast<size_t>(s) * n + base + l] = static_cast<uint8_t>(byte);
      if (kHash) tile_bytes[s * kTileStride * 4 + c * kChunk + l] = static_cast<uint8_t>(byte);
    }
    __syncthreads();  // the next chunk overwrites the planes
  }

  if (kHash && t < k) {
    uint32_t pre[8], st[8];
    leaf_prefix_parity(pre);
    leaf_digest(tile + t * kTileStride, pre, st);
    uint32_t* out = digests + (static_cast<size_t>(t) * (n / kCell) + blockIdx.x) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = st[i];
  }
}

template <bool kHash>
static int xor_entry(const void* x, const void* node_ab, const void* level_off, int n_levels,
                     int n_nodes, const void* row_blk, int width8, void* parity, void* digests,
                     int k, int n, int device, void* stream) {
  if (k < 1 || k > 128 || (k & (k - 1)) || n <= 0 || n % kCell || n_levels < 0 ||
      n_nodes < 0 || 8 * k + 1 + n_nodes > 65536 || width8 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(8 * k + 1 + n_nodes) * sizeof(uint4) +
                      (kHash ? static_cast<size_t>(k) * kTileStride * sizeof(uint32_t) : 0);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(encode2d_xor_kernel<kHash>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n / (kHash ? kCell : kChunk);
  encode2d_xor_kernel<kHash><<<grid, kXorThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint32_t*>(node_ab),
      static_cast<const int*>(level_off), n_levels, n_nodes, static_cast<const uint4*>(row_blk),
      width8, static_cast<uint8_t*>(parity), static_cast<uint32_t*>(digests), k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace celestia

extern "C" int celestia_encode2d_xor_hash(const void* x, const void* node_ab,
                                          const void* level_off, int n_levels, int n_nodes,
                                          const void* row_blk, int width8, void* parity,
                                          void* digests, int k, int n, int device,
                                          void* stream) {
  return celestia::xor_entry<true>(x, node_ab, level_off, n_levels, n_nodes, row_blk, width8,
                                   parity, digests, k, n, device, stream);
}

extern "C" int celestia_encode2d_xor(const void* x, const void* node_ab, const void* level_off,
                                     int n_levels, int n_nodes, const void* row_blk, int width8,
                                     void* parity, int k, int n, int device, void* stream) {
  return celestia::xor_entry<false>(x, node_ab, level_off, n_levels, n_nodes, row_blk, width8,
                                    parity, nullptr, k, n, device, stream);
}
