// retrieval_score: (C, D) f32 corpus x (D,) f32 query -> (C,) f32 scores,
// the one-user-vs-corpus GEMV of two-tower retrieval (retrieval_cand).
//
// Replaces src/repro/kernels/retrieval_score/kernel.py retrieval_score_pallas
// (_score_kernel).  The TPU kernel ran (block_c, D) x (D, 1) on the matrix
// unit per grid step, and its wrapper padded C to block_c.  Here the grid's
// ragged edge is a bounds check, so no padding exists.
//
// What bounds it on an H100: bytes.  Every corpus element is read once and
// costs one multiply-add (0.5 flop per byte), so the kernel's only job is to
// stream the corpus at the memory rate: C * D * 4 bytes / 3.35 TB/s, 0.32 ms
// at C = 1,048,576 and D = 256.  The design: one warp per corpus row, 16-byte
// float4 loads with neighbouring lanes on neighbouring addresses, the query
// staged once per block in shared memory, a shuffle reduction, lane 0
// writes.  Blocks stride over the rows, so a block stages the query once for
// many rows.  A D that is not a multiple of 4, or an unaligned corpus, takes
// scalar loads.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

template <bool kVec>
__global__ void retrieval_score_kernel(const float* __restrict__ corpus,
                                       const float* __restrict__ query, int c, int d,
                                       float* __restrict__ out) {
  extern __shared__ __align__(16) float q_s[];
  for (int i = threadIdx.x; i < d; i += blockDim.x) q_s[i] = query[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarps;
  for (long long row = warp; row < c; row += n_warps) {
    const float* src = corpus + row * d;
    float acc = 0.f;
    if (kVec) {
      const float4* v = reinterpret_cast<const float4*>(src);
      const float4* qv = reinterpret_cast<const float4*>(q_s);
      for (int j = lane; j < (d >> 2); j += 32) {
        const float4 a = __ldg(v + j);
        const float4 b = qv[j];
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
    } else {
      for (int j = lane; j < d; j += 32) acc = fmaf(__ldg(src + j), q_s[j], acc);
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
    if (lane == 0) out[row] = acc;
  }
}

}  // namespace

// vec: 1 when D % 4 == 0 and the corpus is 16-byte aligned (the wrapper
// checks); max_blocks: the grid's cap (a few blocks per SM).
extern "C" int retrieval_score_launch(const void* corpus, const void* query, int c, int d,
                                      int vec, int max_blocks, void* out, void* stream) {
  const auto* x = static_cast<const float*>(corpus);
  const auto* q = static_cast<const float*>(query);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  int blocks = (c + kWarps - 1) / kWarps;
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (vec)
    retrieval_score_kernel<true><<<blocks, kWarps * 32, smem, s>>>(x, q, c, d, o);
  else
    retrieval_score_kernel<false><<<blocks, kWarps * 32, smem, s>>>(x, q, c, d, o);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
