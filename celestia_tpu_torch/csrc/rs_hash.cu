// K1 encode2d_hash and K2 leaf_digests2d for sm_90a.
//
// K1 replaces the Pallas kernel rs_pallas.encode2d_hash
// (celestia_tpu/ops/rs_pallas.py:276, body _fused_kernel :167): the Leopard
// RS encode of k data shards as a GF(2) bit-matrix product, fused with the
// SHA-256 NMT leaf digest of every parity cell it produces.
// K2 replaces rs_pallas.leaf_digests2d (rs_pallas.py:295, body
// _leaf_kernel :178): the leaf digests of existing cells, each with its own
// namespace.
//
// Layouts: x (rows, n) uint8 with the shard axis leading, n a multiple of
// 512; parity (k, n) uint8; digests (rows, n/512, 8) uint32; ns_pad
// (rows, n/512, 32) uint8; m2p (8k, W) uint32, row p of the (8k, 8k) GF(2)
// encode matrix packed LSB-first (bit j of word w is M2[p, 32w + j]),
// W = max(4, k/4).
//
// K1 design. The k bytes of one lane x[:, n], read as little-endian 32-bit
// words, are the 8k-bit data vector in M2's column order (q = 8*shard + bit),
// so parity bit p = popcount(AND of M2 row p with the data words) mod 2, and
// the XOR of the ANDs needs one popcount per bit. One block owns one
// 512-lane cell column: one thread per lane, M2 in shared memory (every
// thread of a warp reads the same 16-byte vector, a broadcast), the data
// words in registers. The (k, 512) parity tile goes to global memory and to
// shared memory; after a barrier, thread i hashes cell i of the column from
// shared memory. What bounds it: operations (see ops/rs_cuda.py); this
// first version runs the contraction on the integer ALUs, not the int8
// tensor cores, and hashes with k of the 512 threads.
//
// K2 design. One block owns up to kLeafRows rows of one cell column: it
// copies the cells into shared memory with coalesced word loads, then each
// thread hashes one cell. Bound by the SHA work.
//
// Every entry checks its launch with cudaGetLastError() and returns it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

namespace celestia {

constexpr int kCell = 512;            // bytes per share
constexpr int kTileStride = 129;      // words per shared-memory cell row (516 B)
constexpr int kLeafRows = 64;         // K2 rows per block

template <int W>
__global__ void __launch_bounds__(kCell)
encode2d_hash_kernel(const uint8_t* __restrict__ x, const uint32_t* __restrict__ m2p,
                     uint8_t* __restrict__ parity, uint32_t* __restrict__ digests,
                     int k, int n) {
  extern __shared__ uint4 smem_vec[];
  uint32_t* sm2 = reinterpret_cast<uint32_t*>(smem_vec);  // 8k * W words
  uint32_t* tile = sm2 + 8 * k * W;                        // k * kTileStride words
  uint8_t* tile_bytes = reinterpret_cast<uint8_t*>(tile);

  const int col = blockIdx.x;
  const int t = threadIdx.x;
  const size_t lane = static_cast<size_t>(col) * kCell + t;

  for (int i = t; i < 8 * k * W / 4; i += kCell) {
    smem_vec[i] = reinterpret_cast<const uint4*>(m2p)[i];
  }

  uint32_t d[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t v = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = 4 * w + b;
      if (i < k) v |= static_cast<uint32_t>(x[static_cast<size_t>(i) * n + lane]) << (8 * b);
    }
    d[w] = v;
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    uint32_t byte = 0u;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint4* row = reinterpret_cast<const uint4*>(sm2 + (8 * j + r) * W);
      uint32_t acc = 0u;
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const uint4 m = row[q];
        acc ^= (m.x & d[4 * q]) ^ (m.y & d[4 * q + 1]) ^
               (m.z & d[4 * q + 2]) ^ (m.w & d[4 * q + 3]);
      }
      byte |= (__popc(acc) & 1u) << r;
    }
    parity[static_cast<size_t>(j) * n + lane] = static_cast<uint8_t>(byte);
    tile_bytes[j * kTileStride * 4 + t] = static_cast<uint8_t>(byte);
  }
  __syncthreads();

  if (t < k) {
    uint32_t pre[8], st[8];
    leaf_prefix_parity(pre);
    leaf_digest(tile + t * kTileStride, pre, st);
    uint32_t* out = digests + (static_cast<size_t>(t) * (n / kCell) + col) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = st[i];
  }
}

__global__ void __launch_bounds__(kLeafRows)
leaf_digests2d_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ ns_pad,
                      uint32_t* __restrict__ digests, int rows, int n) {
  __shared__ uint32_t tile[kLeafRows * kTileStride];
  const int col = blockIdx.x;
  const int row0 = blockIdx.y * kLeafRows;
  const int nrows = min(kLeafRows, rows - row0);
  const int ncells = n / kCell;

  for (int idx = threadIdx.x; idx < nrows * (kCell / 4); idx += blockDim.x) {
    const int r = idx / (kCell / 4), wd = idx % (kCell / 4);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        x + static_cast<size_t>(row0 + r) * n + static_cast<size_t>(col) * kCell);
    tile[r * kTileStride + wd] = src[wd];
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r < nrows) {
    const size_t cell = static_cast<size_t>(row0 + r) * ncells + col;
    const uint4* nsv = reinterpret_cast<const uint4*>(ns_pad + cell * 32);
    const uint4 lo = nsv[0], hi = nsv[1];
    const uint32_t nsw[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t pre[8], st[8];
    leaf_prefix_from_ns(nsw, pre);
    leaf_digest(tile + r * kTileStride, pre, st);
    uint32_t* out = digests + cell * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = st[i];
  }
}

template <int W>
static cudaError_t launch_encode(const uint8_t* x, const uint32_t* m2p, uint8_t* parity,
                                 uint32_t* digests, int k, int n, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(8) * k * W + static_cast<size_t>(k) * kTileStride) *
                      sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(encode2d_hash_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  encode2d_hash_kernel<W><<<n / kCell, kCell, smem, stream>>>(x, m2p, parity, digests, k, n);
  return cudaGetLastError();
}

}  // namespace celestia

extern "C" int celestia_encode2d_hash(const void* x, const void* m2p, void* parity,
                                      void* digests, int k, int n, int device, void* stream) {
  using namespace celestia;
  if (k < 1 || k > 128 || (k & (k - 1)) || n <= 0 || n % kCell) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto xs = static_cast<const uint8_t*>(x);
  auto ms = static_cast<const uint32_t*>(m2p);
  auto ps = static_cast<uint8_t*>(parity);
  auto ds = static_cast<uint32_t*>(digests);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 16) {
    err = launch_encode<4>(xs, ms, ps, ds, k, n, s);
  } else if (k == 32) {
    err = launch_encode<8>(xs, ms, ps, ds, k, n, s);
  } else if (k == 64) {
    err = launch_encode<16>(xs, ms, ps, ds, k, n, s);
  } else {
    err = launch_encode<32>(xs, ms, ps, ds, k, n, s);
  }
  return static_cast<int>(err);
}

extern "C" int celestia_leaf_digests2d(const void* x, const void* ns_pad, void* digests,
                                       int rows, int n, int device, void* stream) {
  using namespace celestia;
  if (rows <= 0 || n <= 0 || n % kCell) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / kCell, (rows + kLeafRows - 1) / kLeafRows);
  leaf_digests2d_kernel<<<grid, kLeafRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(ns_pad),
      static_cast<uint32_t*>(digests), rows, n);
  return static_cast<int>(cudaGetLastError());
}
