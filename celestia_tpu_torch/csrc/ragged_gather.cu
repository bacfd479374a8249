// ragged_gather for sm_90a: one bucket of a ragged cross-height row group,
// gathered from the paged EDS cache's pages into one contiguous buffer.
//
// Replaces the XLA graph ragged._jitted_gather (celestia_tpu/ops/ragged.py:51),
// which stacks every unique page of the bucket into one new device array
// (jnp.stack) and then takes a vmapped dynamic_slice per descriptor (no
// Pallas kernel: the JAX package leaves it to XLA). Here the pages are
// never stacked: each row is read in place through a page table, the
// block-table shape of paged attention that the JAX module borrows.
//
// Inputs. A table of the bucket's unique page base pointers (every page a
// contiguous (rows, w, 512) uint8 buffer of one shape) and, per descriptor,
// its page slot and its row within the page, packed as slot << 16 | row;
// row_bytes = w * 512, uniform within the bucket. Output: out, the
// (n, w, 512) rows in descriptor order. The table goes by value in the
// kernel's parameters, a __grid_constant__ struct (Hopper with CUDA >= 12.1
// takes up to 32,764 bytes of them), so a gather copies no descriptor to
// the device: the wrapper (ops/ragged_cuda.py) splits a larger group into
// launches of at most kMaxDescs descriptors over at most kMaxPages pages
// (28 KiB of parameters).
//
// Design. The grid is (row chunks, descriptors): block (x, y) copies bytes
// [x * 16 KiB, (x + 1) * 16 KiB) of descriptor y's row, 256 threads, each
// four 16-byte vectors, neighbouring threads on neighbouring addresses, all
// four loads issued before the stores. A 128 KiB row at k = 128 spreads
// over 8 blocks; a 1 KiB row at k = 1 is one block with 64 threads busy.
// The descriptor and its page pointer are read from the parameter bank,
// one uniform load each a block. Pages are read-only while pinned, so the
// loads take the non-coherent path.
//
// What bounds it: bytes, each row read once and written once,
// 2 * n * row_bytes / 3.35 TB/s (n = 64 rows at k = 128: 16 MiB, 0.005 ms).
//
// Every entry checks its launch with cudaGetLastError() and returns it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace celestia {
namespace ragged {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // 16-byte vectors a thread copies
constexpr int kChunkVecs = kThreads * kVecs;  // 16 KiB of a row a block
constexpr int kMaxPages = 512;
constexpr int kMaxDescs = 6144;

struct Table {
  const uint4* page[kMaxPages];  // each unique page's base
  uint32_t desc[kMaxDescs];      // slot << 16 | row within the page
  long long row_vecs;            // 16-byte vectors a row
};

static_assert(sizeof(Table) <= 32764, "parameters over 32,764 bytes");

__global__ void __launch_bounds__(kThreads)
ragged_gather_kernel(uint4* __restrict__ out, const __grid_constant__ Table t) {
  const uint32_t d = t.desc[blockIdx.y];
  const size_t row_vecs = static_cast<size_t>(t.row_vecs);
  const uint4* __restrict__ src = t.page[d >> 16] + static_cast<size_t>(d & 0xFFFFu) * row_vecs;
  uint4* __restrict__ dst = out + static_cast<size_t>(blockIdx.y) * row_vecs;
  const size_t lo = static_cast<size_t>(blockIdx.x) * kChunkVecs + threadIdx.x;
  uint4 v[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const size_t i = lo + static_cast<size_t>(u) * kThreads;
    if (i < row_vecs) v[u] = __ldg(src + i);
  }
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const size_t i = lo + static_cast<size_t>(u) * kThreads;
    if (i < row_vecs) dst[i] = v[u];
  }
}

}  // namespace ragged
}  // namespace celestia

// pages: host memory, n_pages device pointers (uint64, 16-byte aligned);
// descs: host memory, n packed descriptors (slot << 16 | row), every slot
// below n_pages; row_bytes: a multiple of 16.
extern "C" int celestia_ragged_gather(const void* pages, int n_pages, const void* descs, int n,
                                      long long row_bytes, void* out, int device, void* stream) {
  using namespace celestia::ragged;
  if (n <= 0 || n > kMaxDescs || n_pages <= 0 || n_pages > kMaxPages || row_bytes <= 0 ||
      row_bytes % 16 || device < 0 || reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto p = static_cast<const uint64_t*>(pages);
  auto d = static_cast<const uint32_t*>(descs);
  for (int i = 0; i < n_pages; ++i) {
    if (p[i] == 0 || p[i] % 16) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < n; ++i) {
    if (static_cast<int>(d[i] >> 16) >= n_pages) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Table t;
  for (int i = 0; i < n_pages; ++i) t.page[i] = reinterpret_cast<const uint4*>(p[i]);
  for (int i = 0; i < n; ++i) t.desc[i] = d[i];
  t.row_vecs = row_bytes / 16;
  const long long chunks = (t.row_vecs + kChunkVecs - 1) / kChunkVecs;
  ragged_gather_kernel<<<dim3(static_cast<unsigned>(chunks), n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(static_cast<uint4*>(out), t);
  return static_cast<int>(cudaGetLastError());
}
