// assemble_square for sm_90a: a proposal's (k, k, 512) share square, built
// on the card from the resident blob arena and a small host-share table.
//
// Replaces the XLA graph extend_tpu._assemble_square with _derive_cells
// (celestia_tpu/ops/extend_tpu.py:766, :726), no Pallas kernel: the JAX
// package expands per-blob metadata into per-cell vectors (a searchsorted,
// gathers, wheres) and gathers a (S, 512) index grid from the arena. Here
// each cell finds its blob and its host row itself and writes its 512
// bytes once; nothing per cell is built or read from device memory.
//
// Inputs (ops/assemble_cuda.py stages them; ops/extend.assembled_roots
// validates them on the host first):
//   arena   (n_arena,) uint8: the blob arena (ops/blob_pool.py);
//   host    (n_host, 512) uint8: the deduplicated host shares;
//   meta    (4, n_blobs) int32: start cell, shares, arena offset, blob
//           length; starts strictly ascending;
//   ns      (n_blobs, 29) uint8: each blob's namespace;
//   sparse  (2, n_sparse) int32: host cell positions (strictly ascending)
//           and their rows of `host`.
// Output: out (cells, 512) uint8, cells = k * k.
//
// Each cell, as the JAX graph writes it:
//   - b = the last blob whose start is <= the cell (0 if none);
//   - a host cell (its position is in `sparse`) is its host row, and wins
//     over a blob cell; a row outside [0, n_host) is clamped into it;
//   - a blob cell (0 <= cell - start_b < shares_b) is namespace_b ‖ info
//     (1 on the blob's first share, else 0) ‖ [4-byte big-endian length on
//     the first share] ‖ min(cap, len_b - doff) arena bytes from
//     off_b + doff ‖ zeros, where cap is 478 (first) or 482 and doff is 0
//     on the first share, 478 + (j - 1) * 482 on share j > 0; an arena
//     index is clamped into [0, n_arena);
//   - any other cell is blob 0's namespace ‖ 0x00 ‖ zeros (all zeros with
//     no blob).
//
// Design. A block of 8 warps owns a tile of 32 consecutive cells, 4 a
// warp. Because starts and host positions are strictly ascending, the
// blobs that can own a tile's cells are one window of at most 32 starts
// (the last start <= the tile's first cell, then those inside the tile),
// and its host cells one window of at most 32 positions: thread 0 finds
// both windows by binary search in device memory, the block copies them to
// shared memory, and every cell binary-searches there. A warp writes a
// cell as 32 lanes x 16 bytes, one aligned 16-byte store a lane (a host
// cell is a 16-byte load a lane too). The data segment starts at byte 30
// or 34 of the cell at an arbitrary arena offset, so a lane gathers its 16
// data bytes with byte loads (neighbouring lanes on neighbouring bytes,
// served by L1); funnel-shifted word loads are later work.
//
// What bounds it: bytes. Each cell written once (k^2 * 512), each blob byte
// and each used host row read once: (k^2 * 512 + blob bytes + host rows *
// 512) / 3.35 TB/s, 0.0047 ms at k = 128 with 60 blobs of 120,000 bytes.
//
// The entry checks its launch with cudaGetLastError() and returns it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace celestia {
namespace assemble {

constexpr int kWarps = 8;
constexpr int kCellsPerWarp = 4;
constexpr int kTile = kWarps * kCellsPerWarp;  // cells a block
constexpr int kNs = 29;                        // namespace bytes
constexpr int kFirst = 478;                    // data bytes of a blob's first share
constexpr int kCont = 482;                     // data bytes of a continuation share

struct Params {
  const uint8_t* arena;
  long long n_arena;
  const uint4* host;  // 32 vectors a row
  int n_host;
  const int* meta;  // (4, n_blobs)
  const uint8_t* ns;
  int n_blobs;
  const int* sparse;  // (2, n_sparse)
  int n_sparse;
  uint4* out;
  int cells;
};

// the number of a[0 .. n) that are <= v (a ascending)
__device__ __forceinline__ int count_le(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the number of a[0 .. n) that are < v (a ascending)
__device__ __forceinline__ int count_lt(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kWarps * 32)
assemble_square_kernel(const __grid_constant__ Params p) {
  __shared__ int s_start[kTile];
  __shared__ int s_hpos[kTile];
  __shared__ int s_hrow[kTile];
  __shared__ int s_win[4];  // blob window base and size, host window base and size

  const int c0 = blockIdx.x * kTile;
  const int c1 = min(c0 + kTile, p.cells);
  if (threadIdx.x == 0) {
    int b_lo = 0, b_n = 0;
    if (p.n_blobs > 0) {
      b_lo = max(count_le(p.meta, p.n_blobs, c0) - 1, 0);
      const int b_hi = max(count_le(p.meta, p.n_blobs, c1 - 1) - 1, 0);
      b_n = min(b_hi - b_lo + 1, kTile);  // at most kTile when starts ascend
    }
    const int* pos = p.sparse;
    const int h_lo = count_lt(pos, p.n_sparse, c0);
    s_win[0] = b_lo;
    s_win[1] = b_n;
    s_win[2] = h_lo;
    s_win[3] = min(count_lt(pos, p.n_sparse, c1) - h_lo, kTile);
  }
  __syncthreads();
  const int b_lo = s_win[0], b_n = s_win[1], h_lo = s_win[2], h_n = s_win[3];
  if (threadIdx.x < b_n) s_start[threadIdx.x] = p.meta[b_lo + threadIdx.x];
  if (threadIdx.x < h_n) {
    s_hpos[threadIdx.x] = p.sparse[h_lo + threadIdx.x];
    s_hrow[threadIdx.x] = p.sparse[p.n_sparse + h_lo + threadIdx.x];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nb = p.n_blobs;
  for (int t = 0; t < kCellsPerWarp; ++t) {
    const int c = c0 + warp * kCellsPerWarp + t;
    if (c >= c1) break;
    uint4* dst = p.out + static_cast<size_t>(c) * 32 + lane;

    const int h = count_lt(s_hpos, h_n, c);
    if (h < h_n && s_hpos[h] == c) {  // a host cell wins over a blob cell
      const int row = min(max(s_hrow[h], 0), p.n_host - 1);
      *dst = __ldg(p.host + static_cast<size_t>(row) * 32 + lane);
      continue;
    }

    bool in_blob = false, first = false;
    long long data_start = 0, data_len = 0;
    int cb = 0;
    unsigned int blen = 0;
    if (nb > 0) {
      const int b = b_lo + max(count_le(s_start, b_n, c) - 1, 0);
      const int j = c - p.meta[b];
      in_blob = j >= 0 && j < p.meta[nb + b];
      if (in_blob) {
        first = j == 0;
        const long long doff = first ? 0 : kFirst + static_cast<long long>(j - 1) * kCont;
        const long long cap = first ? kFirst : kCont;
        data_start = static_cast<long long>(p.meta[2 * nb + b]) + doff;
        data_len = min(cap, static_cast<long long>(p.meta[3 * nb + b]) - doff);
        cb = b;
        blen = static_cast<unsigned int>(p.meta[3 * nb + b]);
      }
    }
    const int prefix_len = first ? kNs + 5 : kNs + 1;
    const uint8_t* ns = nb > 0 ? p.ns + static_cast<size_t>(cb) * kNs : nullptr;
    uint32_t w[4];
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pos = lane * 16 + q4 * 4 + q;
        uint32_t v = 0;
        if (pos < kNs) {
          v = ns != nullptr ? __ldg(ns + pos) : 0u;
        } else if (pos == kNs) {
          v = first ? 1u : 0u;
        } else if (pos < prefix_len) {  // the first share's big-endian length
          v = (blen >> (8 * (kNs + 4 - pos))) & 0xFFu;
        } else {
          const long long d = pos - prefix_len;
          if (d < data_len) {
            const long long idx = min(max(data_start + d, 0LL), p.n_arena - 1);
            v = __ldg(p.arena + idx);
          }
        }
        word |= v << (8 * q);
      }
      w[q4] = word;
    }
    *dst = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

}  // namespace assemble
}  // namespace celestia

// arena: device, n_arena >= 1 bytes; host: device, n_host rows of 512
// bytes, 16-byte aligned (any pointer when n_host == 0, which needs
// n_sparse == 0); meta: device int32 (4, n_blobs); ns: device (n_blobs, 29);
// sparse: device int32 (2, n_sparse); out: device, 16-byte aligned, k * k
// cells of 512 bytes.
extern "C" int celestia_assemble_square(const void* arena, long long n_arena, const void* host,
                                        int n_host, const void* meta, const void* ns,
                                        int n_blobs, const void* sparse, int n_sparse, void* out,
                                        int k, int device, void* stream) {
  using namespace celestia::assemble;
  if (arena == nullptr || n_arena <= 0 || n_host < 0 || n_blobs < 0 || n_sparse < 0 ||
      (n_sparse > 0 && (n_host == 0 || sparse == nullptr)) ||
      (n_blobs > 0 && (meta == nullptr || ns == nullptr)) ||
      (n_host > 0 && (host == nullptr || reinterpret_cast<uintptr_t>(host) % 16)) ||
      out == nullptr || reinterpret_cast<uintptr_t>(out) % 16 || k <= 0 || k > 128 ||
      device < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.arena = static_cast<const uint8_t*>(arena);
  p.n_arena = n_arena;
  p.host = static_cast<const uint4*>(host);
  p.n_host = n_host;
  p.meta = static_cast<const int*>(meta);
  p.ns = static_cast<const uint8_t*>(ns);
  p.n_blobs = n_blobs;
  p.sparse = static_cast<const int*>(sparse);
  p.n_sparse = n_sparse;
  p.out = static_cast<uint4*>(out);
  p.cells = k * k;
  const int blocks = (p.cells + kTile - 1) / kTile;
  assemble_square_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
