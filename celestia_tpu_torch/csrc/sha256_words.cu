// K3 sha256_words for sm_90a: batched SHA-256 over padded message words.
//
// Replaces the Pallas kernel sha256_pallas.sha256_words
// (celestia_tpu/ops/sha256_pallas.py:129, body _sha_kernel :91, math
// _sha_core :56). Layout (the Pallas one): words (16*nb, batch) uint32,
// big-endian message words with the batch on the lanes; out (8, batch)
// uint32 digest words.
//
// One thread hashes one message. Word row w of message b is read at
// words[w * batch + b], so the 32 loads of a warp are one coalesced
// 128-byte line. What bounds it: the ~2.2k int32 operations of each 64-byte
// block against the ~16.7 T int32 op/s of the SM array (an estimate from the
// SM layout); the 64 bytes read per block are far below the memory line.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

namespace celestia {

constexpr int kShaThreads = 128;

__global__ void __launch_bounds__(kShaThreads)
sha256_words_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
                    int n_blocks, int batch) {
  const int lane = blockIdx.x * kShaThreads + threadIdx.x;
  if (lane >= batch) return;
  uint32_t st[8], w[16];
  sha256_init(st);
#pragma unroll 1
  for (int blk = 0; blk < n_blocks; ++blk) {
    const uint32_t* src = words + static_cast<size_t>(16 * blk) * batch + lane;
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = src[static_cast<size_t>(j) * batch];
    sha256_compress(st, w);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[static_cast<size_t>(i) * batch + lane] = st[i];
}

}  // namespace celestia

extern "C" int celestia_sha256_words(const void* words, void* out, int n_blocks, int batch,
                                     int device, void* stream) {
  using namespace celestia;
  if (n_blocks <= 0 || batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (batch + kShaThreads - 1) / kShaThreads;
  sha256_words_kernel<<<grid, kShaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), n_blocks, batch);
  return static_cast<int>(cudaGetLastError());
}
