// embedding_bag: (V, D) f32 table + (B, BAG) i32 indices -> (B, D) f32 bag
// sums, out[b, d] = sum over j = 0..BAG-1 of table[idx[b, j], d], summed in
// f32 (in the order below, not bag order).  On the model path it is
// xDeepFM's wide term: D = 1, BAG = 39 fields, over the 39M-row wide table.
//
// Replaces src/repro/kernels/embedding_bag/kernel.py embedding_bag_pallas
// (_ebag_kernel).  The TPU kernel walked a (B, BAG) grid whose index map
// steered one (1, D) row DMA per step from scalar-prefetched indices, and
// accumulated into a revisited output block.  Here a group of lanes loads
// its bag's indices itself and then the rows they name.
//
// What bounds it on an H100: latency.  A call moves its indices, the
// B * BAG rows they name and the output (0.16 MB at the path's shape, a
// ten-thousandth of its time at 3.35 TB/s); what it cannot avoid is two
// dependent memory round trips, index then row, plus a launch.  The first
// design gave a bag L = pow2(D) lanes (one lane per bag at D = 1: 512 bags
// in 2 blocks on 2 SMs) and walked the bag one entry at a time, an index
// load and the row load behind it, so a bag of 39 cost ~10 such pairs in
// series.  The design here: a bag gets a group of G lanes, G = pow2(C *
// BAG) in [C, 32], where C = pow2(D / VEC) capped at 32 lanes run over a
// row's columns (VEC = 4 floats a lane where D % 4 == 0 and the table is
// 16-byte aligned, else 1) and the group's E = G / C entry lanes run over
// the bag's entries (at D = 1 a warp per bag, its lanes over the entries).
// A pass covers E * kSlots entries: each lane first issues all kSlots of
// its index loads (neighbouring lanes, neighbouring indices), then all
// kSlots row loads, and only then adds them up, in slot order.  After the
// last pass the E entry lanes of a column fold by a __shfl_xor_sync tree.
// A bag of up to E * kSlots entries (256 at D = 1) costs one index and one
// row round trip.  Small blocks spread the groups over the SMs.  The sum
// is in f32 but not in bag order: folding in bag order (a shuffle from the
// entry's lane for each entry) cost 5% at the path's shape and 15% at D 8
// and 64, so the tree stays and the order is what the tolerance covers.
// Contract, as the TPU kernel's: 0 <= idx < V (the wrapper checks it only
// on the CPU, where it costs no device sync).  The table's gradient is
// embedding_bag_backward_launch, below.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // 2 warps a block: the path's 512 bags -> 256 blocks
constexpr int kSlots = 8;     // entries a lane holds in flight in one pass

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }
__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void add(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}
__device__ __forceinline__ void add_xor(float& acc, int lane) {
  acc += __shfl_xor_sync(0xFFFFFFFFu, acc, lane);
}
__device__ __forceinline__ void add_xor(float4& acc, int lane) {
  acc.x += __shfl_xor_sync(0xFFFFFFFFu, acc.x, lane);
  acc.y += __shfl_xor_sync(0xFFFFFFFFu, acc.y, lane);
  acc.z += __shfl_xor_sync(0xFFFFFFFFu, acc.z, lane);
  acc.w += __shfl_xor_sync(0xFFFFFFFFu, acc.w, lane);
}

// T is float or float4; dv = D / (sizeof(T) / 4) elements of T a row.
// Every lane of a warp runs the same loops (B, BAG and D are the warp's
// own), so the shuffles see all 32 lanes; lanes past B load nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx, int b,
                     int bag, int dv, int g_log, int c_log, T* __restrict__ out) {
  const int group = 1 << g_log, entry_lanes = group >> c_log;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = t >> g_log;
  const bool live = row < b;
  const int g = static_cast<int>(t & (group - 1));
  const int c = g & ((1 << c_log) - 1), e = g >> c_log;
  const int* ids = idx + (live ? row : 0) * static_cast<long long>(bag);
  const int step = entry_lanes * kSlots;
  for (int c0 = 0; c0 < dv; c0 += 1 << c_log) {
    const int col = c0 + c;
    const bool on = live && col < dv;
    T acc;
    zero(acc);
    for (int base = 0; base < bag; base += step) {
      int id[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = base + s * entry_lanes + e;
        id[s] = on && j < bag ? __ldg(ids + j) : -1;
      }
      T v[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        zero(v[s]);
        if (id[s] >= 0) v[s] = load(table + static_cast<long long>(id[s]) * dv + col);
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) add(acc, v[s]);
    }
    for (int lane = 1 << c_log; lane < group; lane <<= 1) add_xor(acc, lane);
    if (on && e == 0) out[row * dv + col] = acc;
  }
}

int ceil_log2(long long n) {
  int l = 0;
  while ((1LL << l) < n) ++l;
  return l;
}

}  // namespace

extern "C" int embedding_bag_launch(const void* table, const void* idx, int b, int bag,
                                    int d, void* out, void* stream) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int dv = vec ? d / 4 : d;
  const int c_log = ceil_log2(dv < 32 ? dv : 32);
  int g_log = ceil_log2((1LL << c_log) * (bag > 1 ? bag : 1));
  if (g_log > 5) g_log = 5;
  const long long lanes = static_cast<long long>(b) << g_log;
  const int blocks = static_cast<int>((lanes + kThreads - 1) / kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    embedding_bag_kernel<float4><<<blocks, kThreads, 0, s>>>(
        static_cast<const float4*>(table), static_cast<const int*>(idx), b, bag, dv, g_log,
        c_log, static_cast<float4*>(out));
  else
    embedding_bag_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(table), static_cast<const int*>(idx), b, bag, dv, g_log,
        c_log, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- backward
// embedding_bag_backward: the gradient of the bag sums with respect to the
// table.  grad_table[idx[b, j], d] += grad_out[b, d] for every b < B, j <
// BAG, d < D, into a (V, D) f32 table that the launch zeroes first; ids
// that repeat, within a bag or across bags, add up.  On the training path
// it is xDeepFM's wide term: V 39M, D 1, B 65,536, BAG 39.
//
// Replaces no TPU kernel: the JAX package differentiates its wide term's
// jnp.take with jax.value_and_grad and has no Pallas backward.  It exists
// because the port computes that term through the forward kernel above,
// a ctypes call that autograd cannot see through.
//
// What bounds it on an H100: memory.  The table must be zeroed (V D 4
// bytes, 156 MB at the path's shape), and each (b, j, d) reads its id and
// its gradient and does one read-modify-write of a table word, at random
// rows of a table three times the L2.  The design is the simple one: a
// thread per (b, j, d), d fastest, so that the lanes of a wide row update
// neighbouring words, and an atomicAdd, since nothing orders the writers
// of one row.  The order of the additions into a word is the atomics' own,
// so a sum of duplicates rounds differently from run to run.
constexpr int kBackThreads = 256;
constexpr long long kBackMaxBlocks = 1 << 20;   // past it the blocks stride

__global__ void __launch_bounds__(kBackThreads)
embedding_bag_backward_kernel(const float* __restrict__ grad_out, const int* __restrict__ idx,
                              long long n, int bag, int d, float* __restrict__ grad_table) {
  const long long stride = static_cast<long long>(gridDim.x) * kBackThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kBackThreads + threadIdx.x; t < n;
       t += stride) {
    const long long entry = t / d;  // b * BAG + j
    const int col = static_cast<int>(t - entry * d);
    const long long b = entry / bag;
    const int id = __ldg(idx + entry);
    atomicAdd(grad_table + static_cast<long long>(id) * d + col, __ldg(grad_out + b * d + col));
  }
}

extern "C" int embedding_bag_backward_launch(const void* grad_out, const void* idx, int b,
                                             int bag, int d, long long v, void* grad_table,
                                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(grad_table, 0, static_cast<size_t>(v) * d * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(b) * bag * d;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (n + kBackThreads - 1) / kBackThreads;
  if (blocks > kBackMaxBlocks) blocks = kBackMaxBlocks;
  embedding_bag_backward_kernel<<<static_cast<unsigned>(blocks), kBackThreads, 0, s>>>(
      static_cast<const float*>(grad_out), static_cast<const int*>(idx), n, bag, d,
      static_cast<float*>(grad_table));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
