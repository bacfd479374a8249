// dah_merkle for sm_90a: the DataAvailabilityHeader's merkle root over its
// 4k axis roots, in one launch for a batch of DAHs.
//
// Replaces the merkle form of the Pallas kernel sha256_pallas.sha256_words
// (celestia_tpu/ops/sha256_pallas.py:129), which the JAX package runs once
// per level from extend_tpu.merkle_root_pow2 (celestia_tpu/ops/extend_tpu.py:181)
// over message tensors built, padded and transposed outside the kernel.
// The function is tendermint's merkle.HashFromByteSlices on a power-of-two
// count (RFC 6962; pkg/da/data_availability_header.go:92-108): leaf i is
// SHA-256(0x00 ‖ root i), 91 bytes; a node is SHA-256(0x01 ‖ left ‖ right),
// 65 bytes; both are two SHA-256 blocks.
//
// Inputs. roots: (B, n, 90) uint8, n = 4k a power of two from 4 to 512,
// each DAH's row roots then its column roots; out: (B, 32) uint8.
//
// Design. A DAH is one thread-block cluster of C blocks (the C entry picks C:
// 1 up to 64 leaves, then n / 64, at most 8), each block
// owning n / C consecutive leaves, one thread a leaf. A block copies its
// leaves' roots into shared memory as they lie (8-byte copies: every run of
// 4 roots is 360 bytes), one pad word before and after. Leaf i's message
// byte m (m >= 1) is root byte m - 1, so every big-endian message word is
// one byte permute of two neighbouring shared words, the shift 3 or 1 bytes
// by the parity of i; word 0's top byte becomes the 0x00 prefix and word
// 22's low byte the 0x80 that starts the padding, then the zero fill and
// the bit length 728. The digests go to shared memory as word planes, a
// barrier, and half the threads hash each level's nodes, their messages
// funnel shifts of the children's digest words, up to the block's subtree
// root. The latency-bound upper levels (at most kHelpNodes nodes) split
// each node's work: helper threads expand both blocks' message schedules
// into K + W in shared memory, and the hashing thread runs only the rounds.
// Then the cluster synchronises, block 0 gathers the C subtree roots from
// the other blocks' shared memory (distributed shared memory) and hashes
// the last log2(C) levels, and a second cluster barrier keeps every
// block's shared memory alive until it has. Nothing is built on the host:
// no message tensor, no constant copied in.
//
// What bounds it (k = 128: 512 leaves and 511 nodes, 2 blocks each): one
// tree's chain of 10 levels of 2 blocks' rounds, about 0.0155 ms at one
// warp's issue rate (chip_smoke.py counts it, the rounds from the tree
// kernel's SASS); all 2,046 blocks at the card's ALU rate are far less.
// In one block a DAH, the leaf level and the next two (16, 8 and 4 warps
// at k = 128) would be bound by one SM's ALU pipe; the cluster spreads
// them over C SMs, leaving the chain of levels.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

namespace celestia {
namespace merkle {

namespace cg = cooperative_groups;

constexpr int kRootBytes = 90;
constexpr int kMinLeaves = 4;
constexpr int kMaxLeaves = 512;  // 4k at k = 128
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kClusterLeaves = 64;  // leaves a block of a cluster, at least
constexpr int kHelpNodes = 32;   // levels this narrow hash their rounds alone
constexpr uint32_t kLeafBits = 91u * 8u;
constexpr uint32_t kNodeBits = 65u * 8u;

// Blocks a DAH of n leaves spreads over: one up to 64 leaves, then one a
// 64 leaves, at most 8.
constexpr int cluster_size(int n) {
  return n / kClusterLeaves < 1 ? 1 : (n / kClusterLeaves > kMaxCluster ? kMaxCluster
                                                                         : n / kClusterLeaves);
}

__host__ __device__ constexpr int area_words(int leaves) { return leaves * kRootBytes / 4 + 2; }

// shared words of a block of `leaves` leaves: the roots area, the leaf
// digests (pitch leaves), the next level's (pitch leaves / 2), the gathered
// subtree roots (pitch C), K + W of the helped levels (2 blocks x 64 rounds)
__host__ __device__ constexpr int smem_words(int leaves) {
  return area_words(leaves) + 8 * leaves + 8 * (leaves / 2) + 8 * kMaxCluster +
         2 * 64 * kHelpNodes;
}

// Block b (0 or 1) of the leaf message of the root whose message byte 0
// would be the area byte at word a, shifted by the permute selector sel.
__device__ __forceinline__ void leaf_block(const uint32_t* a, uint32_t sel, int b,
                                           uint32_t w[16]) {
  if (b == 0) {
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = __byte_perm(a[j], a[j + 1], sel);
    w[0] &= 0x00FFFFFFu;  // the 0x00 leaf prefix
  } else {
#pragma unroll
    for (int j = 0; j < 7; ++j) w[j] = __byte_perm(a[16 + j], a[17 + j], sel);
    w[6] = (w[6] & 0xFFFFFF00u) | 0x80u;  // root bytes 87..89, then the padding
#pragma unroll
    for (int j = 7; j < 15; ++j) w[j] = 0u;
    w[15] = kLeafBits;
  }
}

// Block b of the node message 0x01 ‖ l ‖ r from the children's digest
// words (word j at [j * sp]).
__device__ __forceinline__ void node_block(const uint32_t* l, const uint32_t* r, int sp, int b,
                                           uint32_t w[16]) {
  if (b == 0) {
    w[0] = 0x01000000u | (l[0] >> 8);
#pragma unroll
    for (int j = 1; j < 8; ++j) w[j] = __funnelshift_r(l[j * sp], l[(j - 1) * sp], 8);
    w[8] = __funnelshift_r(r[0], l[7 * sp], 8);
#pragma unroll
    for (int j = 9; j < 16; ++j) w[j] = __funnelshift_r(r[(j - 8) * sp], r[(j - 9) * sp], 8);
  } else {
    w[0] = (r[7 * sp] << 24) | 0x00800000u;
#pragma unroll
    for (int j = 1; j < 15; ++j) w[j] = 0u;
    w[15] = kNodeBits;
  }
}

__device__ __forceinline__ void put_digest(const uint32_t st[8], uint32_t* dst, int dp) {
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j * dp] = st[j];
}

// The levels above 2 x count nodes at src (pitch 2 x count) up to one, by
// the whole block, each level into buf0 and buf1 in turn (pitch count);
// returns the root's digest words (pitch 1).
__device__ __forceinline__ const uint32_t* reduce(const uint32_t* src, int count,
                                                  uint32_t* buf0, uint32_t* buf1,
                                                  uint32_t* kw) {
  const int t = threadIdx.x;
  uint32_t* dst = buf0;
  for (; count >= 1; count /= 2) {
    const int sp = 2 * count;
    if (count <= kHelpNodes) {
      // 2 x count helpers expand the schedules, then count threads hash
      if (t < 2 * count) {
        const int b = t / count, m = t - b * count;
        uint32_t w[16];
        node_block(src + 2 * m, src + 2 * m + 1, sp, b, w);
        expand_kw(w, kw + b * 64 * kHelpNodes + m, kHelpNodes);
      }
      __syncthreads();
      if (t < count) {
        uint32_t st[8];
        sha256_init(st);
#pragma unroll 1
        for (int b = 0; b < 2; ++b) compress_kw(st, kw + b * 64 * kHelpNodes + t, kHelpNodes);
        put_digest(st, dst + t, count);
      }
    } else if (t < count) {
      uint32_t st[8], w[16];
      sha256_init(st);
#pragma unroll 1
      for (int b = 0; b < 2; ++b) {
        node_block(src + 2 * t, src + 2 * t + 1, sp, b, w);
        sha256_compress(st, w);
      }
      put_digest(st, dst + t, count);
    }
    __syncthreads();
    src = dst;
    dst = dst == buf0 ? buf1 : buf0;
  }
  return src;
}

__global__ void __launch_bounds__(kMaxLeaves)
dah_merkle_kernel(const uint8_t* __restrict__ roots, uint8_t* __restrict__ out, int n,
                  int cluster) {
  extern __shared__ uint32_t smem[];
  const int leaves = n / cluster;  // this block's
  uint32_t* area = smem;           // the roots' bytes from word 1
  uint32_t* da = smem + area_words(leaves);
  uint32_t* db = da + 8 * leaves;
  uint32_t* gat = db + 8 * (leaves / 2);
  uint32_t* kw = gat + 8 * kMaxCluster;
  const int t = threadIdx.x;
  const int dah = blockIdx.x / cluster;
  const int rank = blockIdx.x - dah * cluster;

  const uint2* src = reinterpret_cast<const uint2*>(
      roots + (static_cast<size_t>(dah) * n + static_cast<size_t>(rank) * leaves) * kRootBytes);
  for (int i = t; i < leaves * kRootBytes / 8; i += blockDim.x) {
    const uint2 v = src[i];
    area[1 + 2 * i] = v.x;
    area[2 + 2 * i] = v.y;
  }
  if (t == 0) {
    area[0] = 0u;
    area[area_words(leaves) - 1] = 0u;
  }
  __syncthreads();

  // the leaves: message byte 0 sits at area byte 90 t + 3
  if (t < leaves) {
    const int o = kRootBytes * t + 3;
    const uint32_t* a = area + (o >> 2);
    const uint32_t sel = (o & 3) == 3 ? 0x3456u : 0x1234u;
    uint32_t st[8], w[16];
    sha256_init(st);
#pragma unroll 1
    for (int b = 0; b < 2; ++b) {
      leaf_block(a, sel, b, w);
      sha256_compress(st, w);
    }
    put_digest(st, da + t, leaves);
  }
  __syncthreads();
  const uint32_t* root = reduce(da, leaves / 2, db, da, kw);

  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every block's subtree root is in its shared memory
    if (rank == 0) {
      for (int i = t; i < 8 * cluster; i += blockDim.x) {  // word j of block r's root, pitch C
        const int r = i >> 3, j = i & 7;
        gat[j * cluster + r] = cl.map_shared_rank(root, r)[j];
      }
      __syncthreads();
      root = reduce(gat, cluster / 2, db, da, kw);
    }
    cl.sync();  // block 0 has read every other block's shared memory
  }
  if (rank == 0 && t < 8) {  // the root's digest words, big-endian
    reinterpret_cast<uint32_t*>(out + static_cast<size_t>(dah) * 32)[t] =
        __byte_perm(root[t], 0u, 0x0123);
  }
}

}  // namespace merkle
}  // namespace celestia

extern "C" int celestia_dah_merkle(const void* roots, void* out, int batch, int n, int device,
                                   void* stream) {
  using namespace celestia::merkle;
  if (batch <= 0 || n < kMinLeaves || n > kMaxLeaves || (n & (n - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cluster = cluster_size(n);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dah_merkle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             4 * smem_words(kMaxLeaves));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int leaves = n / cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(leaves < 32 ? 32 : leaves);
  cfg.dynamicSmemBytes = 4 * smem_words(leaves);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, dah_merkle_kernel, static_cast<const uint8_t*>(roots),
                           static_cast<uint8_t*>(out), n, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
