// nmt_tree for sm_90a: NMT leaf digests -> row and column roots (and, on
// request, every row-tree level) in one launch.
//
// Replaces the tree form of the Pallas kernel sha256_pallas.sha256_words
// (celestia_tpu/ops/sha256_pallas.py:129), which the JAX package calls once
// per tree level from extend_tpu._nmt_reduce_once (extend_tpu.py:136-153)
// over message tensors built outside the kernel. Here one block owns whole
// trees: it builds each leaf node from its digest and namespace, then every
// inner node's 181-byte message 0x01 ‖ left(90) ‖ right(90) from the
// children in shared memory, and chains the levels with one barrier each.
//
// Inputs. The (2k, 2k) grid of leaf digests (uint32 big-endian word values,
// 8 per cell) as four (k, k) quadrant tiles, each given by its pointer and
// its row and column strides in words, so the four outputs of K1/K2 are read
// in place whatever their orientation (the fused route's d1t and d3t are
// [col, row]). The Q0 namespaces as a strided (k, k) grid of byte runs (a
// view of the shares), read as two 16-byte loads from a 16-byte-aligned
// start: bytes 29..31 of each run are read and ignored. Cell (r, c) has namespace
// q0_ns[r, c] when r < k and c < k, else the parity namespace (29 bytes of
// 0xFF); its leaf node is ns ‖ ns ‖ digest, as extend._leaf_namespaces
// builds it.
//
// The row-block mode (celestia_nmt_tree_rows) reduces the row trees alone of
// a block of grid rows, as one shard of a row-sharded mesh holds them: its
// top rows (the rows below k, read from the Q0 and Q1 tiles, Q0's cells under
// their own namespaces) and then its bottom rows (from the Q2 and Q3 tiles,
// every cell under the parity namespace), each pair of tiles holding only
// those rows. The same kernel runs both modes: the (2k, 2k) grid is the row
// block of k top and k bottom rows, followed by the 2k column trees.
//
// The inner node rule (nmt v0.20 with IgnoreMaxNamespace, in the two-branch
// form of extend_tpu._nmt_reduce_once): min = left.min; max = left.max if
// right.min is the parity namespace, else right.max.
//
// Layout in shared memory. A node is 23 words (90 bytes, zero-padded): bytes
// 0..28 min, 29..57 max, 58..89 the digest, little-endian within a word, so
// the word is the byte string as memory holds it. A level is stored word
// plane by word plane (word j of node n at j * pitch + (n & 1) * half +
// (n >> 1)): thread t reads children 2t and 2t + 1 at consecutive addresses
// of the even and odd halves, and the odd half starts 16 banks after the
// even one, so neither the reads nor the writes of a level conflict. Two
// such buffers alternate between levels (all leaves, and half of them).
//
// Message words. The left child starts at message byte 1 and the right at
// byte 91, so no child is word-aligned: big-endian message word i is one
// byte permute of two neighbouring node words (offset 1: selector 0x3456,
// offset 91: 0x1234), word 22 joins the last left byte pair with the first
// right byte, word 45 holds the last right byte and the 0x80 that starts the
// padding, and word 47 the bit length 1,448. The digest goes back into the
// parent node at byte 58, again as byte permutes of the state words.
//
// Blocks. A block of 128 x groups threads owns 256 x groups leaves: at
// k = 128 one tree a group, at smaller k 128 / k trees a group side by side
// (so at every level thread t pairs nodes 2t and 2t + 1 of the block and
// never straddles two trees). The host takes as many groups (1, 2 or 4) as
// leave at least 128 blocks, so at the main path's shapes one block runs on
// an SM (4 groups for an extend at k = 128, 2 for its row levels, 1 at
// k = 64) and the few busy warps of the upper levels share the SM with no
// other block's. The upper levels (at most 16 nodes a group) are latency
// bound, one warp or less on the SM: there helper threads first expand
// every (node, block) message schedule into K + W in shared memory, and
// the hashing thread then runs only the rounds. The trees are the 2k row
// trees, then (unless the row levels are kept, which is a call for the rows
// alone) the 2k column trees; the roots are written as (trees, 90) bytes, the
// row levels level-major as (2k, 2k >> L, 90) for L = 0 .. log2(2k), both
// through a cooperative copy of each level's nodes in 16-bit stores (every
// node starts on an even byte).
//
// What bounds the function at k = 128 (rows and columns, 130,560 inner
// nodes of 3 SHA-256 blocks of 1,265 ALU-pipe operations each, as nvcc 12.8
// compiles sha256_compress): all the nodes at the card's ALU rate. The
// trees are independent, so the other term, one tree's chain of 8 levels x
// 3 blocks of 64 rounds at one warp's issue rate, is the shorter one
// (chip_smoke.py nmt_tree_floor counts both, the rounds from this kernel's
// SASS). This design runs every tree's level at once, so each of its six
// upper levels takes at least such a chain of whole blocks: the sum over its
// levels, about 0.045 ms, is the design's floor, not the function's. The
// digests read and the roots written are ~2 MB, far below the memory line.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

namespace celestia {

constexpr int kTreeThreads = 128;
constexpr int kTreeLeaves = 2 * kTreeThreads;
constexpr int kNodeWords = 23;
constexpr int kNodeHalves = 45;  // 90 bytes as 16-bit stores
constexpr int kNodeBytes = 90;
// plane geometry for one group (128 threads): the odd half 16 banks after
// the even half, pitch odd; a block of g groups has half 128g + 16 and
// pitch 256g + 17 (buffer A), half 64g + 16 and pitch 128g + 17 (buffer B)
constexpr int kHalfA = 144, kPitchA = 273;  // 256 nodes (leaves, even levels)
constexpr int kHalfB = 80, kPitchB = 145;   // 128 nodes (odd levels)
constexpr uint32_t kParityWord = 0xFFFFFFFFu;

struct Planes {
  uint32_t* base;
  int half;
  int pitch;
  // word 0 of node n; word j is at [j * pitch]
  __device__ __forceinline__ uint32_t* node(int n) const {
    return base + (n & 1) * half + (n >> 1);
  }
};

struct TreeArgs {
  const uint32_t* quad[4];  // Q0, Q1, Q2, Q3 digest tiles
  int quad_rs[4];           // row stride of each tile, in words
  int quad_cs[4];           // column stride, in words
  const uint8_t* ns;        // Q0 namespaces
  int ns_rs, ns_cs;         // their strides, in bytes
  uint8_t* roots;           // (n_trees, 90)
  uint8_t* levels;          // row levels, or null
  int k, log_w;             // w = 2k leaves a tree
  int top_rows;             // grid rows read from Q0 and Q1 (k; a row block's own count)
  int row_trees;            // row trees: top_rows plus the rows of Q2 and Q3
  int n_trees;              // the row trees, then 2k column trees on an extend's call
};

// Words 14..22 of a node: the last two max-namespace bytes (bytes 0, 1 of
// x14) and the digest st at byte 58.
__device__ __forceinline__ void put_digest(uint32_t* dst, int pitch, uint32_t x14,
                                           const uint32_t st[8]) {
  dst[14 * pitch] = __byte_perm(x14, st[0], 0x6710);
#pragma unroll
  for (int j = 1; j < 8; ++j) dst[(14 + j) * pitch] = __byte_perm(st[j - 1], st[j], 0x6701);
  dst[22 * pitch] = __byte_perm(st[7], 0u, 0x4401);
}

// The leaf node ns ‖ ns ‖ digest of cell (r, c) of the grid: rows below
// top_rows are read from Q0 and Q1, the rest from Q2 and Q3.
__device__ __forceinline__ void load_leaf(const TreeArgs& a, int r, int c, uint32_t* dst,
                                          int pitch) {
  const int k = a.k;
  const bool bottom = r >= a.top_rows;
  const int q = (bottom ? 2 : 0) + (c >= k ? 1 : 0);
  const int tr = bottom ? r - a.top_rows : r;  // the row within its tile
  const uint32_t* base = q == 0 ? a.quad[0] : q == 1 ? a.quad[1] : q == 2 ? a.quad[2] : a.quad[3];
  const int rs = q == 0 ? a.quad_rs[0] : q == 1 ? a.quad_rs[1] : q == 2 ? a.quad_rs[2] : a.quad_rs[3];
  const int cs = q == 0 ? a.quad_cs[0] : q == 1 ? a.quad_cs[1] : q == 2 ? a.quad_cs[2] : a.quad_cs[3];
  const uint4* d = reinterpret_cast<const uint4*>(
      base + static_cast<size_t>(tr) * rs + static_cast<size_t>(c & (k - 1)) * cs);
  const uint4 d0 = __ldg(d), d1 = __ldg(d + 1);
  const uint32_t st[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
  uint32_t nw[8];
  if (q == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(
        a.ns + static_cast<size_t>(r) * a.ns_rs + static_cast<size_t>(c) * a.ns_cs);
    const uint4 n0 = __ldg(src), n1 = __ldg(src + 1);
    nw[0] = n0.x; nw[1] = n0.y; nw[2] = n0.z; nw[3] = n0.w;
    nw[4] = n1.x; nw[5] = n1.y; nw[6] = n1.z; nw[7] = n1.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) nw[j] = kParityWord;
  }
  // bytes 0..28 the namespace, 29..57 again (shifted one byte), then the digest
#pragma unroll
  for (int j = 0; j < 7; ++j) dst[j * pitch] = nw[j];
  dst[7 * pitch] = __byte_perm(nw[7], nw[0], 0x6540);
#pragma unroll
  for (int m = 1; m < 7; ++m) dst[(7 + m) * pitch] = __byte_perm(nw[m - 1], nw[m], 0x6543);
  put_digest(dst, pitch, __byte_perm(nw[6], nw[7], 0x0043), st);
}

// Big-endian message words 16b .. 16b + 15 of the node message
// 0x01 ‖ l ‖ r (181 bytes, 3 blocks), from the children's word planes.
__device__ __forceinline__ void message_block(const uint32_t* l, const uint32_t* r, int sp,
                                              int b, uint32_t w[16]) {
  if (b == 0) {  // words 0..15: 0x01 ‖ left bytes 0..62
    w[0] = __byte_perm(0x01000000u, l[0], 0x3456);
#pragma unroll
    for (int j = 1; j < 16; ++j) w[j] = __byte_perm(l[(j - 1) * sp], l[j * sp], 0x3456);
  } else if (b == 1) {  // words 16..31; word 22 = left bytes 87..89 ‖ right byte 0
#pragma unroll
    for (int j = 16; j < 22; ++j) w[j - 16] = __byte_perm(l[(j - 1) * sp], l[j * sp], 0x3456);
    w[6] = __byte_perm(__byte_perm(l[21 * sp], l[22 * sp], 0x3456), r[0], 0x3214);
#pragma unroll
    for (int j = 23; j < 32; ++j) {
      w[j - 16] = __byte_perm(r[(j - 23) * sp], r[(j - 22) * sp], 0x1234);
    }
  } else {  // words 32..44, 45 = right byte 89 ‖ 0x80, the zero fill, the bit length
#pragma unroll
    for (int j = 32; j < 45; ++j) {
      w[j - 32] = __byte_perm(r[(j - 23) * sp], r[(j - 22) * sp], 0x1234);
    }
    w[13] = __byte_perm(r[22 * sp], 0x80u, 0x1455);
    w[14] = 0u;
    w[15] = 181u * 8u;
  }
}

// The parent node of l and r (word planes of the source level) with
// digest st, into dst.
__device__ __forceinline__ void put_node(const uint32_t* l, const uint32_t* r, int sp,
                                         const uint32_t st[8], uint32_t* dst, int dp) {
  // max = left.max if right.min is the parity namespace, else right.max
  bool right_parity = (r[7 * sp] & 0xFFu) == 0xFFu;
#pragma unroll
  for (int j = 0; j < 7; ++j) right_parity &= r[j * sp] == kParityWord;
  const uint32_t* x = right_parity ? l : r;
#pragma unroll
  for (int j = 0; j < 7; ++j) dst[j * dp] = l[j * sp];
  dst[7 * dp] = __byte_perm(l[7 * sp], x[7 * sp], 0x7650);
#pragma unroll
  for (int j = 8; j < 14; ++j) dst[j * dp] = x[j * sp];
  put_digest(dst, dp, x[14 * sp], st);
}

// The parent of l and r, hashed by one thread. The three blocks run through
// one copy of the compression: three unrolled copies, run once each a node,
// took twice as long (PERF.md).
__device__ __forceinline__ void inner_node(const uint32_t* l, const uint32_t* r, int sp,
                                           uint32_t* dst, int dp) {
  uint32_t st[8], w[16];
  sha256_init(st);
#pragma unroll 1
  for (int b = 0; b < 3; ++b) {
    message_block(l, r, sp, b, w);
    sha256_compress(st, w);
  }
  put_node(l, r, sp, st, dst, dp);
}

// The upper levels, where most of the block's threads would idle: helper
// threads expand the message schedule of each (node, block) pair into
// kw[t * stride] = K[t] + W[t] (sha256.cuh expand_kw), and the hashing
// thread runs only the rounds (compress_kw).
__device__ __forceinline__ void schedule_block(const uint32_t* l, const uint32_t* r, int sp,
                                               int b, uint32_t* kw, int stride) {
  uint32_t w[16];
  message_block(l, r, sp, b, w);
  expand_kw(w, kw, stride);
}

// Nodes [0, count) of a level to out (90 bytes each, even-aligned), by the
// whole block, in 16-bit stores.
__device__ __forceinline__ void copy_nodes(const Planes& p, int count, uint8_t* out) {
  uint16_t* o = reinterpret_cast<uint16_t*>(out);
  for (int h = threadIdx.x; h < count * kNodeHalves; h += blockDim.x) {
    const int n = h / kNodeHalves;
    const int i = h - n * kNodeHalves;
    const uint32_t word = p.node(n)[(i >> 1) * p.pitch];
    o[h] = static_cast<uint16_t>(word >> (16 * (i & 1)));
  }
}

constexpr int kMaxGroups = 4;
constexpr int kHelpNodes = 16;  // helped levels: at most 16 nodes a group

__global__ void __launch_bounds__(kTreeThreads * kMaxGroups) nmt_tree_kernel(const TreeArgs a) {
  extern __shared__ uint32_t smem[];
  const int groups = blockDim.x / kTreeThreads;
  const Planes buf_a{smem, kHalfA * groups - 16 * (groups - 1), kPitchA * groups - 17 * (groups - 1)};
  const Planes buf_b{smem + kNodeWords * buf_a.pitch, kHalfB * groups - 16 * (groups - 1),
                     kPitchB * groups - 17 * (groups - 1)};
  // K + W of the helped levels: (3 blocks x 64 rounds, help_max nodes)
  const int help_max = kHelpNodes * groups;
  uint32_t* kw = buf_b.base + kNodeWords * buf_b.pitch;
  const int t = threadIdx.x;
  const int leaves = 2 * blockDim.x;
  const int w = 2 * a.k;
  const int trees = leaves >> a.log_w;  // trees in this block
  const int tree0 = blockIdx.x * trees;
  // the row trees come first; only they have levels
  const int row_trees = min(max(a.row_trees - tree0, 0), trees);
  const bool keep = a.levels != nullptr;

  // level 0: leaves 2t and 2t + 1 of the block
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int c = 2 * t + s;
    const int tree = tree0 + (c >> a.log_w);
    uint32_t* dst = buf_a.node(c);
    if (tree < a.n_trees) {
      const bool col = tree >= a.row_trees;
      const int i = col ? tree - a.row_trees : tree, n = c & (w - 1);
      load_leaf(a, col ? n : i, col ? i : n, dst, buf_a.pitch);
    } else {
#pragma unroll
      for (int j = 0; j < kNodeWords; ++j) dst[j * buf_a.pitch] = 0u;
    }
  }
  __syncthreads();
  size_t level_off = 0;  // row-level nodes before level L
  if (keep) {
    copy_nodes(buf_a, row_trees * w,
               a.levels + static_cast<size_t>(tree0) * w * kNodeBytes);
    level_off += static_cast<size_t>(a.row_trees) * w;
  }

  for (int lv = 1; lv <= a.log_w; ++lv) {
    const Planes& src = (lv & 1) ? buf_a : buf_b;
    const Planes& dst = (lv & 1) ? buf_b : buf_a;
    const int count = leaves >> lv;
    if (count <= help_max) {
      // 3 x count helpers expand the schedules, then count threads hash
      if (t < 3 * count) {
        const int b = t / count, m = t - b * count;
        schedule_block(src.node(2 * m), src.node(2 * m + 1), src.pitch, b,
                       kw + b * 64 * help_max + m, help_max);
      }
      __syncthreads();
      if (t < count) {
        uint32_t st[8];
        sha256_init(st);
#pragma unroll 1
        for (int b = 0; b < 3; ++b) compress_kw(st, kw + b * 64 * help_max + t, help_max);
        put_node(src.node(2 * t), src.node(2 * t + 1), src.pitch, st, dst.node(t), dst.pitch);
      }
    } else if (t < count) {
      inner_node(src.node(2 * t), src.node(2 * t + 1), src.pitch, dst.node(t), dst.pitch);
    }
    __syncthreads();
    const int per_tree = w >> lv;
    if (keep) {
      copy_nodes(dst, row_trees * per_tree,
                 a.levels + (level_off + static_cast<size_t>(tree0) * per_tree) * kNodeBytes);
      level_off += static_cast<size_t>(a.row_trees) * per_tree;
    }
    if (lv == a.log_w) {
      copy_nodes(dst, min(trees, a.n_trees - tree0),
                 a.roots + static_cast<size_t>(tree0) * kNodeBytes);
    }
  }
}

// Blocks of 128 x groups threads, each owning 256 x groups leaves: as many
// groups (1, 2 or 4) as keep at least 128 blocks, so that one block runs on
// an SM and the few busy warps of the upper levels share it with no other
// block's.
static int groups_for(int total_leaves) {
  int groups = 1;
  while (groups < kMaxGroups && total_leaves / (kTreeLeaves * 2 * groups) >= 128) groups *= 2;
  return groups;
}

static size_t smem_bytes(int groups) {
  return static_cast<size_t>(4) *
         (kNodeWords * ((kPitchA * groups - 17 * (groups - 1)) +
                        (kPitchB * groups - 17 * (groups - 1))) +
          3 * 64 * kHelpNodes * groups);
}

}  // namespace celestia

namespace celestia {

// One launch over the grid: top_rows + bottom_rows row trees, then (with
// columns) the 2k column trees; the row levels when levels is not null.
static int launch_tree(const void* const q[4], const int rs[4], const int cs[4], const void* ns,
                       int ns_rs, int ns_cs, void* roots, void* levels, int k, int top_rows,
                       int bottom_rows, bool columns, int device, void* stream) {
  if (k < 1 || k > kTreeThreads || (k & (k - 1)) || top_rows < 0 || bottom_rows < 0 ||
      top_rows + bottom_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  TreeArgs a;
  for (int i = 0; i < 4; ++i) {
    a.quad[i] = static_cast<const uint32_t*>(q[i]);
    a.quad_rs[i] = rs[i];
    a.quad_cs[i] = cs[i];
  }
  a.ns = static_cast<const uint8_t*>(ns);
  a.ns_rs = ns_rs;
  a.ns_cs = ns_cs;
  a.roots = static_cast<uint8_t*>(roots);
  a.levels = static_cast<uint8_t*>(levels);
  a.k = k;
  a.log_w = 0;
  while ((1 << a.log_w) < 2 * k) ++a.log_w;
  a.top_rows = top_rows;
  a.row_trees = top_rows + bottom_rows;
  a.n_trees = a.row_trees + (columns ? 2 * k : 0);
  const int groups = groups_for(a.n_trees * 2 * k);
  const int per_block = kTreeLeaves * groups / (2 * k);
  const int grid = (a.n_trees + per_block - 1) / per_block;
  const size_t smem = smem_bytes(groups);
  err = cudaFuncSetAttribute(nmt_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(kMaxGroups)));
  if (err != cudaSuccess) return static_cast<int>(err);
  nmt_tree_kernel<<<grid, kTreeThreads * groups, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace celestia

// The (2k, 2k) grid: the 2k row trees, and the 2k column trees unless the
// row levels are kept.
extern "C" int celestia_nmt_tree(const void* q0, const void* q1, const void* q2, const void* q3,
                                 int q0_rs, int q0_cs, int q1_rs, int q1_cs, int q2_rs,
                                 int q2_cs, int q3_rs, int q3_cs, const void* ns, int ns_rs,
                                 int ns_cs, void* roots, void* levels, int k, int device,
                                 void* stream) {
  const void* q[4] = {q0, q1, q2, q3};
  const int rs[4] = {q0_rs, q1_rs, q2_rs, q3_rs};
  const int cs[4] = {q0_cs, q1_cs, q2_cs, q3_cs};
  return celestia::launch_tree(q, rs, cs, ns, ns_rs, ns_cs, roots, levels, k, k, k,
                               levels == nullptr, device, stream);
}

// The row-block mode: the row trees alone of a block of grid rows, top_rows
// of them read from the Q0 and Q1 tiles (Q0's cells under their own
// namespaces) and bottom_rows from the Q2 and Q3 tiles (every cell under the
// parity namespace), with their levels when levels is not null.
extern "C" int celestia_nmt_tree_rows(const void* q0, const void* q1, const void* q2,
                                      const void* q3, int q0_rs, int q0_cs, int q1_rs,
                                      int q1_cs, int q2_rs, int q2_cs, int q3_rs, int q3_cs,
                                      const void* ns, int ns_rs, int ns_cs, void* roots,
                                      void* levels, int k, int top_rows, int bottom_rows,
                                      int device, void* stream) {
  const void* q[4] = {q0, q1, q2, q3};
  const int rs[4] = {q0_rs, q1_rs, q2_rs, q3_rs};
  const int cs[4] = {q0_cs, q1_cs, q2_cs, q3_cs};
  return celestia::launch_tree(q, rs, cs, ns, ns_rs, ns_cs, roots, levels, k, top_rows,
                               bottom_rows, false, device, stream);
}

// Blocks of nmt_tree_kernel resident on one SM at the block size of the
// k = 128 extend (rows and columns), for chip_smoke.py's report.
extern "C" int celestia_nmt_tree_blocks_per_sm(int device) {
  using namespace celestia;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  const int groups = groups_for(2 * 256 * 256);
  if (cudaFuncSetAttribute(nmt_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes(kMaxGroups))) != cudaSuccess) {
    return -1;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, nmt_tree_kernel,
                                                    kTreeThreads * groups,
                                                    smem_bytes(groups)) != cudaSuccess) {
    return -1;
  }
  return blocks;
}
