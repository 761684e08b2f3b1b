// bitset_reduce_batch: AND/OR fold of (Q, T, W) u32 posting planes over the
// token axis T, plus each row's popcount -> (Q, W) u32 and (Q,) i32.  The
// single-query form (T, W) -> (W,) is the Q = 1 call of the same kernel.
//
// Replaces src/repro/kernels/bitset_ops/kernel.py bitset_reduce_batch_pallas
// (_bitset_batch_kernel) and bitset_reduce_pallas (_bitset_kernel).
//
// What bounds it on an H100: bytes.  Every plane word is read once and
// every combined word written once, with a handful of integer operations
// per word, far below the card's operation rate; at the query engine's
// waves (Q*T*W*4 = 1..8 MB) the launch is a visible share too.  The design:
// one warp per row, lanes striding over W so neighbouring lanes read
// neighbouring words of each token plane; 16-byte (uint4) loads and stores
// when W is a multiple of 4; the popcount is a warp shuffle reduce written
// once by lane 0, so no atomics and no zeroed counter are needed.  The
// ragged W edge is the loop bound, so no neutral-word padding (and no
// pad * 32 count correction, as the TPU wrapper needed) exists.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kAnd>
__device__ __forceinline__ uint32_t fold(uint32_t a, uint32_t b) {
  return kAnd ? (a & b) : (a | b);
}

template <bool kAnd, bool kVec>
__global__ void bitset_reduce_batch_kernel(const uint32_t* __restrict__ planes,
                                           int q, int t, int w,
                                           uint32_t* __restrict__ out,
                                           int* __restrict__ counts) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= q) return;  // uniform per warp: the shuffles below see 32 lanes
  const uint32_t* src = planes + static_cast<size_t>(row) * t * w;
  uint32_t* dst = out + static_cast<size_t>(row) * w;
  int pc = 0;
  if (kVec) {
    const int w4 = w >> 2;
    for (int k = lane; k < w4; k += 32) {
      uint4 acc = __ldg(reinterpret_cast<const uint4*>(src) + k);
      for (int s = 1; s < t; ++s) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(s) * w) + k);
        acc.x = fold<kAnd>(acc.x, v.x);
        acc.y = fold<kAnd>(acc.y, v.y);
        acc.z = fold<kAnd>(acc.z, v.z);
        acc.w = fold<kAnd>(acc.w, v.w);
      }
      reinterpret_cast<uint4*>(dst)[k] = acc;
      pc += __popc(acc.x) + __popc(acc.y) + __popc(acc.z) + __popc(acc.w);
    }
  } else {
    for (int k = lane; k < w; k += 32) {
      uint32_t acc = __ldg(src + k);
      for (int s = 1; s < t; ++s) acc = fold<kAnd>(acc, __ldg(src + static_cast<size_t>(s) * w + k));
      dst[k] = acc;
      pc += __popc(acc);
    }
  }
  for (int off = 16; off > 0; off >>= 1) pc += __shfl_xor_sync(0xffffffffu, pc, off);
  if (lane == 0) counts[row] = pc;
}

template <bool kAnd, bool kVec>
void launch(const uint32_t* planes, int q, int t, int w, uint32_t* out, int* counts,
            cudaStream_t stream) {
  const int threads = 256;  // 8 rows per block
  const int blocks = (q + 7) / 8;
  bitset_reduce_batch_kernel<kAnd, kVec><<<blocks, threads, 0, stream>>>(planes, q, t, w, out, counts);
}

}  // namespace

// op_and: 1 for AND, 0 for OR.  vec: 1 when W % 4 == 0 and the planes and
// out pointers are 16-byte aligned (the wrapper checks).
extern "C" int bitset_reduce_batch_launch(const void* planes, int q, int t, int w,
                                          int op_and, int vec, void* out, void* counts,
                                          void* stream) {
  const auto* p = static_cast<const uint32_t*>(planes);
  auto* o = static_cast<uint32_t*>(out);
  auto* c = static_cast<int*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  if (op_and) {
    if (vec) launch<true, true>(p, q, t, w, o, c, s); else launch<true, false>(p, q, t, w, o, c, s);
  } else {
    if (vec) launch<false, true>(p, q, t, w, o, c, s); else launch<false, false>(p, q, t, w, o, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
