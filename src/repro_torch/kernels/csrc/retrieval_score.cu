// retrieval_score: (C, D) f32 corpus x (D,) f32 query -> (C,) f32 scores,
// the one-user-vs-corpus GEMV of two-tower retrieval (retrieval_cand).
//
// Replaces src/repro/kernels/retrieval_score/kernel.py retrieval_score_pallas
// (_score_kernel).  The TPU kernel ran (block_c, D) x (D, 1) on the matrix
// unit per grid step, and its wrapper padded C to block_c.  Here the ragged
// edge is a bounds check, so no padding exists.
//
// What bounds it on an H100: bytes.  Every corpus element is read once and
// costs one multiply-add (0.5 flop per byte), so the kernel's only job is to
// stream the corpus at the memory rate: C * D * 4 bytes / 3.35 TB/s, 0.32 ms
// at C = 1,048,576 and D = 256.  The design, for Hopper:
//   - one small block per kTurn = kWarps * kRows neighbouring rows (4 KB at
//     D 256), a grid of C / kTurn blocks: the hardware hands the next block
//     to whichever SM frees a slot, so an SM that draws less bandwidth than
//     its neighbours simply takes fewer rows.  (Persistent grids of
//     contiguous per-block ranges, tried first, ran up to 2% slower than
//     such small blocks on some cards, PERF.md.)  An SM holds up to 32 such
//     blocks, 128 KB of loads in flight;
//   - a warp takes kRows rows and issues every 16-byte load of those rows
//     (lane l reads float4 l, l + 32, ...) before the first multiply;
//   - loads take the non-coherent path with no L1 allocation and a 256-byte
//     L2 prefetch: every corpus byte is read once;
//   - the query sits in registers (D <= 512: at most 4 float4 a lane), else
//     in shared memory;
//   - the kRows partial sums fold together across the warp (a transpose-
//     reduce: each shuffle step halves the rows a lane holds), so the kRows
//     scores end on lanes 0 .. kRows - 1 and leave in one coalesced store;
//   - the scores are stored with an L2 evict-last policy, so their lines
//     stay in L2 while the corpus streams past.  With plain stores the
//     kernel ran up to 3% slower, by where its output lay; with the hint it
//     runs as fast as with no stores at all (PERF.md).
// A D that is not a multiple of 4, or a corpus or query off 16-byte
// alignment, takes the same kernel with scalar loads.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 2;       // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 2;        // rows a warp reads
constexpr int kTurn = kWarps * kRows;  // rows a block reads
constexpr int kRegSteps = 4;    // elements of the query a lane holds in registers
constexpr int kSmemSteps = 4;   // a lane's loads per row and pass, query in shared memory
constexpr unsigned kFull = 0xFFFFFFFFu;

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// a corpus load that bypasses L1 and asks L2 to fetch the next 256 bytes
// (volatile: a tail row's load must not be hoisted above its bounds check)
__device__ __forceinline__ float4 load_stream(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ float load_stream(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// a score store whose line L2 keeps ahead of the streamed corpus lines
__device__ __forceinline__ void store_kept(float* p, float v) {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;\n" ::"l"(p), "f"(v), "l"(policy)
               : "memory");
}

__device__ __forceinline__ float fma_dot(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float fma_dot(float a, float b, float acc) { return fmaf(a, b, acc); }

// One step of the transpose-reduce: N values a lane, lanes paired across
// bit OFF.  The lower lane keeps the first N/2 rows and the upper lane the
// last N/2, each adding its partner's half, until one row is left a lane.
template <int N, int OFF, int R>
struct Fold {
  static __device__ __forceinline__ void run(float (&v)[R], int lane) {
    const bool upper = lane & OFF;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float keep = upper ? v[i + N / 2] : v[i];
      const float send = upper ? v[i] : v[i + N / 2];
      v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    Fold<N / 2, OFF / 2, R>::run(v, lane);
  }
};
template <int OFF, int R>
struct Fold<1, OFF, R> {
  static __device__ __forceinline__ void run(float (&)[R], int) {}
};

__host__ __device__ constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }

// Each of v[0 .. R) summed over the warp's 32 lanes: row r's sum is
// returned on lane r (r < R).  After the folds lane l holds row
// l >> (5 - log2 R) over the lanes that share those top bits.
template <int R>
__device__ __forceinline__ float warp_sum_rows(float (&v)[R], int lane) {
  constexpr int kShift = 5 - log2i(R);
  Fold<R, 16, R>::run(v, lane);
  float s = v[0];
#pragma unroll
  for (int off = (1 << kShift) / 2; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return __shfl_sync(kFull, s, (lane & (R - 1)) << kShift);
}

// V: float4 (vector loads, n = D / 4) or float (n = D).  kRegs: the query
// in registers, kSteps elements a lane (n <= 32 * kSteps, one pass a row);
// else the query in shared memory and rows read in passes of 32 * kSteps.
template <typename V, int kSteps, bool kRegs>
__global__ void __launch_bounds__(kThreads)
    retrieval_score_kernel(const float* __restrict__ corpus_f, const float* __restrict__ query_f,
                           int c, int n, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const V* corpus = reinterpret_cast<const V*>(corpus_f);
  const V* query = reinterpret_cast<const V*>(query_f);
  V* q_s = reinterpret_cast<V*>(smem);
  const int lane = threadIdx.x & 31;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * kTurn + (threadIdx.x >> 5) * kRows;
  V q[kRegs ? kSteps : 1];
  if constexpr (kRegs) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int j = lane + 32 * k;
      q[k] = j < n ? query[j] : zero<V>();
    }
  } else {
    for (int j = threadIdx.x; j < n; j += kThreads) q_s[j] = query[j];
    __syncthreads();
  }
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int base = 0; base < n; base += 32 * kSteps) {
    V a[kRows][kSteps];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const V* src = corpus + (row0 + r) * n + base + lane;
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
        a[r][k] = row0 + r < c && base + lane + 32 * k < n ? load_stream(src + 32 * k)
                                                            : zero<V>();
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int j = base + lane + 32 * k;
      V b;
      if constexpr (kRegs)
        b = q[k];
      else
        b = j < n ? q_s[j] : zero<V>();
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fma_dot(a[r][k], b, acc[r]);
    }
  }
  const float s = warp_sum_rows<kRows>(acc, lane);
  if (lane < kRows && row0 + lane < c) store_kept(out + row0 + lane, s);
}

template <typename V, int kSteps, bool kRegs>
int launch(const float* corpus, const float* query, int c, int n, float* out, cudaStream_t s) {
  const size_t smem = kRegs ? 0 : static_cast<size_t>(n) * sizeof(V);
  retrieval_score_kernel<V, kSteps, kRegs>
      <<<(c + kTurn - 1) / kTurn, kThreads, smem, s>>>(corpus, query, c, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: 1 when D % 4 == 0 and the corpus and query are 16-byte aligned (the
// wrapper checks).  D <= 12,288, so the query fits 48 KB of shared memory.
extern "C" int retrieval_score_launch(const void* corpus, const void* query, int c, int d,
                                      int vec, void* out, void* stream) {
  const auto* x = static_cast<const float*>(corpus);
  const auto* q = static_cast<const float*>(query);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    const int n = d / 4;
    if (n <= 32) return launch<float4, 1, true>(x, q, c, n, o, s);
    if (n <= 64) return launch<float4, 2, true>(x, q, c, n, o, s);
    if (n <= 96) return launch<float4, 3, true>(x, q, c, n, o, s);
    if (n <= 32 * kRegSteps) return launch<float4, kRegSteps, true>(x, q, c, n, o, s);
    return launch<float4, kSmemSteps, false>(x, q, c, n, o, s);
  }
  if (d <= 32 * kRegSteps) return launch<float, kRegSteps, true>(x, q, c, d, o, s);
  return launch<float, kSmemSteps, false>(x, q, c, d, o, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
