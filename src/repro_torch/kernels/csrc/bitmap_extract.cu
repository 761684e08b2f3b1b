// bitmap_extract: (Q, W) u32 hit bitmaps -> the ascending set-bit positions
// of each row.  Two entries, one kernel body:
//   * the padded entry writes (Q, max_hits) i32, -1 past the row's hits,
//     hits past max_hits dropped, and counts (Q,) i32 = each row's full
//     popcount (the function of the TPU kernel);
//   * the ragged entry writes exactly ``total`` i32 ids: row q's go to
//     ids[offsets[q] : offsets[q + 1]] (the last row's end is total), so a
//     wave's answer is one compacted array with no padding and no tail.
//     The caller gives the exclusive prefix sums of the rows' popcounts;
//     whatever it gives, a row writes only inside [offsets[q], its end)
//     clamped to [0, total).
//
// Replaces src/repro/kernels/bitmap_extract/kernel.py bitmap_extract_pallas
// (_extract_kernel) and the -1 masking of its wrapper (ops.py
// bitmap_extract).  The TPU kernel wrote max_hits + 32 columns so its
// 32-wide vector stores stayed in bounds; here every store is guarded by
// the row's end, so the output is exactly (Q, max_hits) or (total,).
//
// What bounds it on an H100: bytes (each bitmap word read once, each id
// written once) and, at the engine's waves, the launch and each warp's
// chain of dependent steps.  The design: one warp per row walking W in
// chunks of 32 words, a word a lane.  A ballot finds the chunk's non-zero
// words; for each in order, the word is broadcast, lane b holds bit b, and
// the lanes whose bit is set store their ids to consecutive slots: one
// coalesced store a non-zero word, no divergence.  Zero words cost their
// load and nothing else.  On the main path's own term and contains waves
// (kernels/bitmap_extract/bench.py --waves) each lane writing its own
// word's bits (one step per bit of the chunk's densest word) took 1.6-2.5x
// as long, and choosing between the two per chunk gained nothing (PERF.md).
// The padded entry's warp then fills its row's -1 tail.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 8;  // rows (warps) per block

template <bool kPadded>
__global__ void __launch_bounds__(kRows * 32)
bitmap_extract_kernel(const uint32_t* __restrict__ bitmaps, int q, int w,
                      const int* __restrict__ offsets, int total, int max_hits,
                      int* __restrict__ ids, int* __restrict__ counts) {
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= q) return;  // uniform per warp: the ballots below see 32 lanes
  const uint32_t* src = bitmaps + static_cast<size_t>(row) * w;
  int* dst;
  int cap;  // slots this row may write
  if (kPadded) {
    dst = ids + static_cast<size_t>(row) * max_hits;
    cap = max_hits;
  } else {
    const int start = max(__ldg(offsets + row), 0);
    const int end = min(row + 1 < q ? __ldg(offsets + row + 1) : total, total);
    dst = ids + start;
    cap = end - start;
  }
  const uint32_t below = (1u << lane) - 1u;  // the lanes under this one
  int n = 0;  // set bits of the words before (warp-uniform)
  for (int base = 0; base < w; base += 32) {
    const int k = base + lane;
    const uint32_t v = k < w ? __ldg(src + k) : 0u;
    for (unsigned live = __ballot_sync(kFull, v != 0u); live != 0u; live &= live - 1u) {
      const int j = __ffs(live) - 1;
      const uint32_t word = __shfl_sync(kFull, v, j);
      const int slot = n + __popc(word & below);
      if (((word >> lane) & 1u) && slot < cap) dst[slot] = ((base + j) << 5) + lane;
      n += __popc(word);
    }
  }
  if (kPadded) {
    for (int s = min(n, max_hits) + lane; s < max_hits; s += 32) dst[s] = -1;
    if (lane == 0) counts[row] = n;
  }
}

}  // namespace

extern "C" int bitmap_extract_launch(const void* bitmaps, int q, int w, int max_hits,
                                     void* ids, void* counts, void* stream) {
  bitmap_extract_kernel<true><<<(q + kRows - 1) / kRows, kRows * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bitmaps), q, w, nullptr, 0, max_hits,
      static_cast<int*>(ids), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// offsets: (q,) i32 row starts; ids: (total,) i32.
extern "C" int bitmap_extract_ragged_launch(const void* bitmaps, int q, int w,
                                            const void* offsets, int total, void* ids,
                                            void* stream) {
  bitmap_extract_kernel<false><<<(q + kRows - 1) / kRows, kRows * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bitmaps), q, w, static_cast<const int*>(offsets), total, 0,
      static_cast<int*>(ids), nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
