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
//   arena   (n_arena,) uint8, 16-byte aligned: the blob arena
//           (ops/blob_pool.py);
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
// What bounds it: bytes. Each cell written once (k^2 * 512), each blob byte
// and each used host row read once: (k^2 * 512 + blob bytes + host rows *
// 512) / 3.35 TB/s, 0.0047 ms at k = 128 with 60 blobs of 120,000 bytes.
//
// Design, and what changed from the first version. The first version ran
// at 4.8x this bound, for three reasons, each undone here:
//   - A serial search before any byte moved: thread 0 of every block ran
//     four binary searches in device memory (~34 dependent loads). Now a
//     block's tile is 8 cells, and two warps search at once, warp 0 the
//     blob starts, warp 1 the host positions. Each step, every lane tests
//     one of 32 evenly spaced candidates and __ballot_sync + __popc narrow
//     the range 32-fold, until at most kNarrowTo candidates are left (one
//     step over 60 blobs or 1,444 host cells); then one load of 64 entries
//     from one before the range (4 meta fields a blob, position and row a
//     host cell) leaves a window in shared memory that holds every blob and
//     host cell the tile's cells can name (starts and positions ascend
//     strictly, so at most 8 more than at the tile's first cell). A cell
//     resolves itself there with two ballots a search. At config 8b's
//     square a cell's first store waits on 3 dependent global loads: the
//     narrowing step, the window, its data.
//   - Byte loads of the data segment: 16 LDG.U8 a lane and a branch a
//     byte. The data starts at cell byte 30 or 34 at any arena offset, so
//     source and destination differ in their alignment mod 16 (14 on a
//     first share and 2 (j - 1) mod 16 on share j of a 4 KiB-aligned arena
//     slot; TMA and cp.async.bulk need both 16-byte aligned). Now, with
//     r = (arena index of cell byte 0) mod 16, uniform over the warp,
//     lane l loads the aligned vector V_l that holds the arena bytes of
//     cell bytes [16 l - r, 16 l - r + 16) with one 16-byte __ldg, takes
//     V_(l+1) from lane l + 1 with __shfl_sync, and funnel-shifts the pair
//     by r bytes (a warp-uniform switch on r / 4, so no register array is
//     indexed at run time). Lane 0's bytes are all prefix, so lane 0 loads
//     V_32 for lane 31 instead of V_0. A vector no data byte of the cell
//     lies in is not loaded. The bytes outside [prefix, prefix + data) are
//     masked to zero; lanes 0-2 merge the prefix (namespace, info byte,
//     length), which the warp lays out in shared memory: lane t < 29 loads
//     namespace byte t.
//   - Little in flight: a warp did 4 cells in series. Now a warp owns 2
//     cells and issues both cells' loads before its first store; blocks of
//     4 warps, 16 resident an SM (64 warps, 32 registers a thread), 2,048
//     blocks at k = 128. The masks outside the data are one 16-bit mask a
//     lane, spread to byte masks by a multiply.
// A cell whose data would need a vector not wholly inside [0, n_arena)
// (an arena whose end is not 16-byte aligned, a blob past the arena's end,
// a negative offset) takes the byte path with its clamping instead; the
// fast path never reads a byte outside the arena tensor. Host cells are
// one 16-byte load and one store a lane. Stores are plain (cacheable): K2
// and K1 read the square right after, and its 8 MiB fit in L2.
//
// The entry checks its launch with cudaGetLastError() and returns it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace celestia {
namespace assemble {

constexpr int kWarps = 4;
constexpr int kCells = 2;                      // cells a warp
constexpr int kTile = kWarps * kCells;         // cells a block
constexpr int kMinBlocks = 16;                 // resident blocks an SM: 64 warps
constexpr int kWin = 64;                       // window entries a search leaves
constexpr int kWinLoads = kWin / 32;           // window entries a lane
constexpr int kNarrowTo = kWin - kTile - 1;    // a range this narrow fits the window
constexpr int kNs = 29;                        // namespace bytes
constexpr int kFirst = 478;                    // data bytes of a blob's first share
constexpr int kCont = 482;                     // data bytes of a continuation share
constexpr int kBelowAll = -2147483647 - 1;     // window padding before index 0
constexpr int kAboveAll = 2147483647;          // window padding past the end
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kWin % 32 == 0 && kNarrowTo >= 32, "a narrowing step must leave the window range");

struct Params {
  const uint8_t* arena;    // 16-byte aligned
  const uint4* arena_vec;  // the same, as vectors
  long long n_arena;
  const uint4* host;       // 32 vectors a row
  int n_host;
  const int* meta;  // (4, n_blobs)
  const uint8_t* ns;
  int n_blobs;
  const int* sparse;  // (2, n_sparse)
  int n_sparse;
  uint4* out;
  int cells;
};

// The warp's narrowing of a count over a[0 .. n) (ascending): the number
// of entries < v (kStrict) or <= v. Each step every lane tests the last
// entry of one of 32 equal segments; the ballot's popcount is the number
// of whole segments below v, and the count lies in the next segment.
// Returns lo with the count in [lo, lo + kNarrowTo].
template <bool kStrict>
__device__ __forceinline__ int narrow(const int* __restrict__ a, int n, int v, int lane) {
  int lo = 0, hi = n;
  while (hi - lo > kNarrowTo) {
    const int w = (hi - lo + 31) >> 5;
    const int q = lo + (lane + 1) * w - 1;
    bool below = false;
    if (q < hi) {
      const int x = __ldg(a + q);
      below = kStrict ? x < v : x <= v;
    }
    const int c = __popc(__ballot_sync(kFull, below));
    hi = min(lo + (c + 1) * w - 1, hi);
    lo += c * w;
  }
  return lo;
}

// a lane's bytes [lo, hi) of its 16, both clamped into [0, 16], as the
// byte masks of its four words
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t n) {  // bit i -> byte i
  return ((n * 0x00204081u) & 0x01010101u) * 0xFFu;
}
__device__ __forceinline__ uint4 lane_mask(int lo, int hi) {
  lo = min(max(lo, 0), 16);
  hi = min(max(hi, 0), 16);
  const uint32_t m = ((1u << hi) - 1u) & ~((1u << lo) - 1u);
  return make_uint4(nibble_bytes(m & 15u), nibble_bytes((m >> 4) & 15u),
                    nibble_bytes((m >> 8) & 15u), nibble_bytes(m >> 12));
}

// bytes r .. r + 15 of the 32 bytes x0..x3 ‖ y0..y3 (little-endian words)
__device__ __forceinline__ uint4 realign(uint4 x, uint4 y, int r) {
  const unsigned s = 8u * (r & 3);
  switch (r >> 2) {
    case 0:
      return make_uint4(__funnelshift_r(x.x, x.y, s), __funnelshift_r(x.y, x.z, s),
                        __funnelshift_r(x.z, x.w, s), __funnelshift_r(x.w, y.x, s));
    case 1:
      return make_uint4(__funnelshift_r(x.y, x.z, s), __funnelshift_r(x.z, x.w, s),
                        __funnelshift_r(x.w, y.x, s), __funnelshift_r(y.x, y.y, s));
    case 2:
      return make_uint4(__funnelshift_r(x.z, x.w, s), __funnelshift_r(x.w, y.x, s),
                        __funnelshift_r(y.x, y.y, s), __funnelshift_r(y.y, y.z, s));
    default:
      return make_uint4(__funnelshift_r(x.w, y.x, s), __funnelshift_r(y.x, y.y, s),
                        __funnelshift_r(y.y, y.z, s), __funnelshift_r(y.z, y.w, s));
  }
}

enum Kind { kNone = 0, kHost = 1, kFast = 2, kBytes = 3 };

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
assemble_square_kernel(const __grid_constant__ Params p) {
  __shared__ int s_start[kWin], s_nsh[kWin], s_off[kWin], s_len[kWin];
  __shared__ int s_hpos[kWin], s_hrow[kWin];
  __shared__ int s_bwb;                        // the blob window's first index
  __shared__ uint4 s_pre[kWarps][kCells][3];   // each cell's bytes 0..47 of prefix

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kTile;
  const int nb = p.n_blobs;

  // the tile's windows: warp 0 the blobs, warp 1 the host cells, at once
  if (warp == 0 && nb > 0) {
    const int wb = narrow<false>(p.meta, nb, c0, lane) - 1;
#pragma unroll
    for (int h = 0; h < kWinLoads; ++h) {
      const int slot = h * 32 + lane;
      const int i = wb + slot;
      int st = i < 0 ? kBelowAll : kAboveAll, nsh = 0, off = 0, len = 0;
      if (i >= 0 && i < nb) {
        st = __ldg(p.meta + i);
        nsh = __ldg(p.meta + nb + i);
        off = __ldg(p.meta + 2 * nb + i);
        len = __ldg(p.meta + 3 * nb + i);
      }
      s_start[slot] = st;
      s_nsh[slot] = nsh;
      s_off[slot] = off;
      s_len[slot] = len;
    }
    if (lane == 0) s_bwb = wb;
  } else if (warp == 1 && p.n_sparse > 0) {
    const int wb = narrow<true>(p.sparse, p.n_sparse, c0, lane) - 1;
#pragma unroll
    for (int h = 0; h < kWinLoads; ++h) {
      const int slot = h * 32 + lane;
      const int i = wb + slot;
      int pos = -1, row = 0;
      if (i >= 0 && i < p.n_sparse) {
        pos = __ldg(p.sparse + i);
        row = __ldg(p.sparse + p.n_sparse + i);
      }
      s_hpos[slot] = pos;
      s_hrow[slot] = row;
    }
  }
  __syncthreads();

  // phase 1: resolve both cells and issue all their loads
  uint4 v[kCells];
  int kind[kCells], r[kCells], pre[kCells], end[kCells];
  bool first[kCells];
  int cb[kCells];
  unsigned blen[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int c = c0 + warp * kCells + i;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    kind[i] = kNone;
    r[i] = 0;
    pre[i] = kNs + 1;
    end[i] = kNs + 1;
    first[i] = false;
    cb[i] = 0;
    blen[i] = 0;
    if (c >= p.cells) continue;
    int row = -1;
    if (p.n_sparse > 0) {  // a host cell wins over a blob cell
      int h = -1;
#pragma unroll
      for (int g = kWinLoads - 1; g >= 0; --g) {  // positions ascend: one match at most
        const unsigned m = __ballot_sync(kFull, s_hpos[g * 32 + lane] == c);
        if (m) h = g * 32 + __ffs(m) - 1;
      }
      if (h >= 0) row = min(max(s_hrow[h], 0), p.n_host - 1);
    }
    if (row >= 0) {
      kind[i] = kHost;
      v[i] = __ldg(p.host + static_cast<size_t>(row) * 32 + lane);
      continue;
    }
    long long data_start = 0;
    int data_len = 0;
    if (nb > 0) {
      const int wb = s_bwb;
      int cnt = 0;
#pragma unroll
      for (int g = 0; g < kWinLoads; ++g) {
        cnt += __popc(__ballot_sync(kFull, s_start[g * 32 + lane] <= c));
      }
      const int slot = min(max(max(wb + cnt - 1, 0) - wb, 0), kWin - 1);
      const int j = c - s_start[slot];
      if (j >= 0 && j < s_nsh[slot]) {
        first[i] = j == 0;
        const long long doff = first[i] ? 0 : kFirst + static_cast<long long>(j - 1) * kCont;
        data_start = static_cast<long long>(s_off[slot]) + doff;
        data_len = static_cast<int>(
            min(static_cast<long long>(first[i] ? kFirst : kCont), s_len[slot] - doff));
        cb[i] = wb + slot;
        blen[i] = static_cast<unsigned>(s_len[slot]);
      }
    }
    pre[i] = first[i] ? kNs + 5 : kNs + 1;
    end[i] = pre[i] + max(data_len, 0);
    kind[i] = kFast;
    if (data_len <= 0) continue;
    const long long v_lo = data_start >> 4, v_hi = (data_start + data_len + 15) >> 4;
    if (v_lo >= 0 && v_hi * 16 <= p.n_arena) {  // all inside the arena: 32-bit from here
      const int a_cell = static_cast<int>(data_start) - pre[i];  // arena index of cell byte 0
      r[i] = a_cell & 15;
      const int vm = (a_cell >> 4) + (lane == 0 ? 32 : lane);
      if (vm >= static_cast<int>(v_lo) && vm < static_cast<int>(v_hi)) {
        v[i] = __ldg(p.arena_vec + vm);
      }
    } else {  // the byte path, clamped as the JAX graph clips
      kind[i] = kBytes;
      uint32_t w[4];
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        uint32_t word = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d = lane * 16 + q4 * 4 + q - pre[i];
          if (d >= 0 && d < data_len) {
            const long long idx = min(max(data_start + d, 0LL), p.n_arena - 1);
            word |= static_cast<uint32_t>(__ldg(p.arena + idx)) << (8 * q);
          }
        }
        w[q4] = word;
      }
      v[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  // the prefixes, laid out in shared memory: lane t < 29 namespace byte t
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    if (kind[i] < kFast) continue;
    uint8_t* sp = reinterpret_cast<uint8_t*>(s_pre[warp][i]);
    unsigned b;
    if (lane < kNs) {
      b = nb > 0 ? __ldg(p.ns + static_cast<size_t>(cb[i]) * kNs + lane) : 0u;
    } else if (lane == kNs) {
      b = first[i] ? 1u : 0u;
    } else {  // bytes 30, 31: the length's top two bytes on a first share
      b = first[i] ? blen[i] >> (8 * (kNs + 4 - lane)) : 0u;
    }
    sp[lane] = static_cast<uint8_t>(b);
    if (lane < 16) {  // bytes 32, 33: its low two; then zeros
      sp[32 + lane] = static_cast<uint8_t>(first[i] && lane < 2 ? blen[i] >> (8 - 8 * lane) : 0u);
    }
  }
  __syncwarp();

  // phase 2: realign, mask, merge the prefix, store
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    if (kind[i] == kNone) continue;
    uint4* dst = p.out + static_cast<size_t>(c0 + warp * kCells + i) * 32 + lane;
    if (kind[i] == kHost) {
      *dst = v[i];
      continue;
    }
    uint4 d = v[i];
    if (kind[i] == kFast) {
      const int src = (lane + 1) & 31;
      const uint4 y = make_uint4(__shfl_sync(kFull, d.x, src), __shfl_sync(kFull, d.y, src),
                                 __shfl_sync(kFull, d.z, src), __shfl_sync(kFull, d.w, src));
      d = realign(d, y, r[i]);
    }
    const uint4 m = lane_mask(pre[i] - lane * 16, end[i] - lane * 16);
    d = make_uint4(d.x & m.x, d.y & m.y, d.z & m.z, d.w & m.w);
    if (lane < 3) {
      const uint4 pw = s_pre[warp][i][lane];
      d = make_uint4(d.x | pw.x, d.y | pw.y, d.z | pw.z, d.w | pw.w);
    }
    *dst = d;
  }
}

}  // namespace assemble
}  // namespace celestia

// arena: device, 16-byte aligned, n_arena >= 1 bytes; host: device, n_host rows of 512
// bytes, 16-byte aligned (any pointer when n_host == 0, which needs
// n_sparse == 0); meta: device int32 (4, n_blobs); ns: device (n_blobs, 29);
// sparse: device int32 (2, n_sparse); out: device, 16-byte aligned, k * k
// cells of 512 bytes.
extern "C" int celestia_assemble_square(const void* arena, long long n_arena, const void* host,
                                        int n_host, const void* meta, const void* ns,
                                        int n_blobs, const void* sparse, int n_sparse, void* out,
                                        int k, int device, void* stream) {
  using namespace celestia::assemble;
  if (arena == nullptr || reinterpret_cast<uintptr_t>(arena) % 16 || n_arena <= 0 ||
      n_host < 0 || n_blobs < 0 || n_sparse < 0 ||
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
  p.arena_vec = static_cast<const uint4*>(arena);
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
