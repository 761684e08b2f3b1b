// bitmap_extract: (Q, W) u32 hit bitmaps -> the ascending set-bit positions
// of each row, (Q, max_hits) i32, -1 past the row's hits, hits past
// max_hits dropped; counts (Q,) i32 = each row's full popcount.
//
// Replaces src/repro/kernels/bitmap_extract/kernel.py bitmap_extract_pallas
// (_extract_kernel) and the -1 masking of its wrapper (ops.py
// bitmap_extract).  The TPU kernel wrote max_hits + 32 columns so its
// 32-wide vector stores stayed in bounds; here every store is a scalar
// store guarded by max_hits, so the output is exactly (Q, max_hits).
//
// What bounds it on an H100: bytes (each bitmap word read once, each id
// slot written once) and, at the engine's waves, the launch.  The design:
// one warp per row walking W in chunks of 32 words; each lane takes one
// word's __popc, an inclusive warp scan (__shfl_up_sync) gives the word
// its first output slot, and the lane writes its word's set bits (__ffs
// order, so ascending) while the slot is below max_hits.  The same warp
// then fills the row's tail with -1, so no second pass is needed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void bitmap_extract_kernel(const uint32_t* __restrict__ bitmaps, int q, int w,
                                      int max_hits, int* __restrict__ ids,
                                      int* __restrict__ counts) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= q) return;  // uniform per warp
  const uint32_t* src = bitmaps + static_cast<size_t>(row) * w;
  int* dst = ids + static_cast<size_t>(row) * max_hits;
  int total = 0;  // set bits of the chunks before this one (warp-uniform)
  for (int base = 0; base < w; base += 32) {
    const int k = base + lane;
    uint32_t v = k < w ? __ldg(src + k) : 0u;
    const int pc = __popc(v);
    int scan = pc;
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(kFull, scan, off);
      if (lane >= off) scan += n;
    }
    int slot = total + scan - pc;
    while (v != 0u && slot < max_hits) {
      dst[slot++] = (k << 5) + (__ffs(v) - 1);
      v &= v - 1u;
    }
    total += __shfl_sync(kFull, scan, 31);
  }
  for (int s = min(total, max_hits) + lane; s < max_hits; s += 32) dst[s] = -1;
  if (lane == 0) counts[row] = total;
}

}  // namespace

extern "C" int bitmap_extract_launch(const void* bitmaps, int q, int w, int max_hits,
                                     void* ids, void* counts, void* stream) {
  const int threads = 256;  // 8 rows per block
  const int blocks = (q + 7) / 8;
  bitmap_extract_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bitmaps), q, w, max_hits, static_cast<int*>(ids),
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
