// sketch_probe: batched BBHash MPHF lookup of u32 token fingerprints.
//
// Replaces src/repro/kernels/sketch_probe/kernel.py sketch_probe_pallas
// (_probe_kernel), together with the fallback resolution that the JAX
// wrapper (ops.py mphf_probe_arrs) ran as jnp around it.
//
// What bounds it on an H100: not bandwidth and not arithmetic.  A probe
// reads one fingerprint, a few 4-byte words of the level bit-vectors and at
// most one 32-byte rank block, and writes 5 bytes; the sketch of a segment
// (tens to hundreds of KB) stays in L2 after the first wave.  At the waves
// the query engine sends (Q*T = 1e3..1e5 fingerprints) the kernel lasts a
// few microseconds, so the launch and the dependent gathers (level word ->
// rank block) bound it.  The design: one thread per fingerprint, so the
// gathers of many fingerprints overlap; read-only loads through __ldg;
// __popc for the rank; the level table is data (two small device arrays),
// so one compiled kernel serves every segment layout (the TPU kernel was
// recompiled per layout); the sorted fallback array is binary-searched in
// the same thread, so one launch returns the final (idx, absent).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kLevelSeed = 0x5EED1E5u;
constexpr int kRankBlockWords = 8;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void sketch_probe_kernel(
    const uint32_t* __restrict__ fps, int q,
    const uint32_t* __restrict__ words,
    const uint32_t* __restrict__ block_rank,
    const int* __restrict__ level_bits,
    const int* __restrict__ level_word_offset, int n_levels,
    const uint32_t* __restrict__ fb_fps, const int* __restrict__ fb_idx,
    int fb_count, int* __restrict__ out_idx, bool* __restrict__ out_absent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const uint32_t fp = __ldg(fps + i);
  for (int l = 0; l < n_levels; ++l) {
    const uint32_t m = static_cast<uint32_t>(__ldg(level_bits + l));
    if (m == 0) continue;
    const uint32_t pos = fmix32(fp ^ (kLevelSeed * static_cast<uint32_t>(l + 1))) % m;
    // global bit = level_word_offset * 32 + pos: its word and in-word bit
    const int64_t word = static_cast<int64_t>(__ldg(level_word_offset + l)) + (pos >> 5);
    const uint32_t bit = pos & 31u;
    const uint32_t wv = __ldg(words + word);
    if ((wv >> bit) & 1u) {
      // rank = sampled block rank + popcount of the earlier words of the
      // block + the masked popcount of this word (bit < 32: no UB shift)
      const int64_t block = word / kRankBlockWords;
      int r = static_cast<int>(__ldg(block_rank + block));
      for (int64_t j = block * kRankBlockWords; j < word; ++j) r += __popc(__ldg(words + j));
      r += __popc(wv & ((1u << bit) - 1u));
      out_idx[i] = r;
      out_absent[i] = false;
      return;
    }
  }
  // collided through every level: lower_bound over the real fallback keys
  int lo = 0, hi = fb_count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(fb_fps + mid) < fp) lo = mid + 1; else hi = mid;
  }
  const bool hit = lo < fb_count && __ldg(fb_fps + lo) == fp;
  out_idx[i] = hit ? __ldg(fb_idx + lo) : 0;
  out_absent[i] = !hit;
}

}  // namespace

extern "C" int sketch_probe_launch(
    const void* fps, int q, const void* words, const void* block_rank,
    const void* level_bits, const void* level_word_offset, int n_levels,
    const void* fb_fps, const void* fb_idx, int fb_count, void* out_idx,
    void* out_absent, void* stream) {
  const int threads = 256;
  const int blocks = (q + threads - 1) / threads;
  sketch_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(fps), q, static_cast<const uint32_t*>(words),
      static_cast<const uint32_t*>(block_rank), static_cast<const int*>(level_bits),
      static_cast<const int*>(level_word_offset), n_levels,
      static_cast<const uint32_t*>(fb_fps), static_cast<const int*>(fb_idx), fb_count,
      static_cast<int*>(out_idx), static_cast<bool*>(out_absent));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
