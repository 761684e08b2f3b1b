// bitset_reduce_batch: AND/OR fold of u32 posting planes over the token
// axis, plus each result row's popcount.  Two entries, one kernel body:
//   * the (Q, T, W) entry folds every row over all T planes -> (Q, W) u32
//     and (Q,) i32; the single-query form (T, W) -> (W,) is its Q = 1 call;
//   * the ragged entry takes the query engine's (Qb, Tb, W) accumulator as
//     the fused probes left it and a (Q,) i32 ``lens`` (Q <= Qb): row q
//     folds its first lens[q] planes only (clamped to [0, Tb]; a row with
//     none gives the fold's neutral word), and only rows q < Q are read or
//     written.  That is the reference engine's jnp.where of the pad slots
//     to the neutral word followed by the fold, without the rewrite pass.
//
// Replaces src/repro/kernels/bitset_ops/kernel.py bitset_reduce_batch_pallas
// (_bitset_batch_kernel) and bitset_reduce_pallas (_bitset_kernel).
//
// What bounds it on an H100: bytes (each plane word a row folds is read
// once and each combined word written once, with one integer operation per
// word), and at the engine's waves (~1 MB) the launch.  The design: one warp
// per row, lanes striding over W in the widest vector the row allows (16
// bytes when W % 4 == 0, 8 when W % 2 == 0, as at the 1M-line store's
// W = 62, else 4), so neighbouring lanes read neighbouring words of each
// plane.  The token loop is unrolled at the engine's power-of-two T buckets
// (1..16): every plane load of a vector is issued before the first fold, a
// slot past the row's length predicated off; buckets past 16 loop over
// chunks of 16.  The popcount is a warp shuffle reduce written once by lane
// 0, so no atomics and no zeroed counter are needed.  The ragged W edge is
// the loop bound, so no neutral-word padding (and no pad * 32 count
// correction, as the TPU wrapper needed) exists.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;  // rows (warps) per block
constexpr int kMaxUnroll = 16;

template <bool kAnd>
__device__ __forceinline__ uint32_t fold(uint32_t a, uint32_t b) {
  return kAnd ? (a & b) : (a | b);
}

template <int kN>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&v)[kN]) {
  if constexpr (kN == 4) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (kN == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int kN>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&v)[kN]) {
  if constexpr (kN == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kN == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// kN words a load, kU token planes in flight together.
template <bool kAnd, int kN, int kU>
__global__ void __launch_bounds__(kRows * 32)
bitset_reduce_kernel(const uint32_t* __restrict__ planes, const int* __restrict__ lens, int q,
                     int t, int w, uint32_t* __restrict__ out, int* __restrict__ counts) {
  constexpr uint32_t kNeutral = kAnd ? 0xffffffffu : 0u;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= q) return;  // uniform per warp: the shuffles below see 32 lanes
  const int len = lens ? min(max(__ldg(lens + row), 0), t) : t;
  const uint32_t* src = planes + static_cast<size_t>(row) * t * w;
  uint32_t* dst = out + static_cast<size_t>(row) * w;
  int pc = 0;
  for (int k = lane * kN; k < w; k += 32 * kN) {
    uint32_t acc[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] = kNeutral;
    for (int base = 0; base < len; base += kU) {
      uint32_t v[kU][kN];
#pragma unroll
      for (int s = 0; s < kU; ++s) {
        if (base + s < len) {
          load_words<kN>(src + static_cast<size_t>(base + s) * w + k, v[s]);
        } else {
#pragma unroll
          for (int i = 0; i < kN; ++i) v[s][i] = kNeutral;
        }
      }
#pragma unroll
      for (int s = 0; s < kU; ++s) {
#pragma unroll
        for (int i = 0; i < kN; ++i) acc[i] = fold<kAnd>(acc[i], v[s][i]);
      }
    }
    store_words<kN>(dst + k, acc);
#pragma unroll
    for (int i = 0; i < kN; ++i) pc += __popc(acc[i]);
  }
  for (int off = 16; off > 0; off >>= 1) pc += __shfl_xor_sync(0xffffffffu, pc, off);
  if (lane == 0) counts[row] = pc;
}

struct Args {
  const uint32_t* planes;
  const int* lens;
  int q, t, w;
  uint32_t* out;
  int* counts;
  cudaStream_t stream;
};

template <bool kAnd, int kN, int kU>
void launch(const Args& a) {
  bitset_reduce_kernel<kAnd, kN, kU><<<(a.q + kRows - 1) / kRows, kRows * 32, 0, a.stream>>>(
      a.planes, a.lens, a.q, a.t, a.w, a.out, a.counts);
}

template <bool kAnd, int kN>
void launch_unroll(const Args& a) {
  // the smallest power of two >= T, up to kMaxUnroll
  if (a.t <= 1) launch<kAnd, kN, 1>(a);
  else if (a.t <= 2) launch<kAnd, kN, 2>(a);
  else if (a.t <= 4) launch<kAnd, kN, 4>(a);
  else if (a.t <= 8) launch<kAnd, kN, 8>(a);
  else launch<kAnd, kN, kMaxUnroll>(a);
}

template <bool kAnd>
void launch_vec(const Args& a, int vec) {
  if (vec == 4) launch_unroll<kAnd, 4>(a);
  else if (vec == 2) launch_unroll<kAnd, 2>(a);
  else launch_unroll<kAnd, 1>(a);
}

}  // namespace

// planes: (>= q, t, w) u32; lens: (q,) i32, or null for every row's t
// planes.  op_and: 1 for AND, 0 for OR.  vec: words a load, 4, 2 or 1; the
// wrapper passes 4 (2) only when W % 4 (2) == 0 and the planes and out
// pointers are 16- (8-) byte aligned.
extern "C" int bitset_reduce_batch_launch(const void* planes, const void* lens, int q, int t,
                                          int w, int op_and, int vec, void* out, void* counts,
                                          void* stream) {
  const Args a{static_cast<const uint32_t*>(planes), static_cast<const int*>(lens), q, t, w,
               static_cast<uint32_t*>(out), static_cast<int*>(counts),
               static_cast<cudaStream_t>(stream)};
  if (op_and) launch_vec<true>(a, vec); else launch_vec<false>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
