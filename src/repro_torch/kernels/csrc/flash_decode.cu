// flash_decode: one-token GQA attention against a KV cache.
//   q (B, Hq, D), k/v caches (B, S, Hkv, D), cache_len -> (B, Hq, D) in q's
//   type; query head h reads kv head h / n_rep (n_rep = Hq / Hkv), scores
//   are the f32 dot times D^-0.5, positions >= cache_len take no part, and
//   the output is acc / max(l, 1e-30) of the online softmax (m, l, acc),
//   all in f32.  Instantiated for f32 and bf16 (the llama3-8b path).
//
// Replaces src/repro/kernels/flash_decode/kernel.py flash_decode_pallas
// (_flash_decode_kernel).  The TPU kernel ran a (B, S / block_s) grid in
// order, carrying (m, l, acc) in revisited output blocks, with a wrapper
// that padded S to block_s and masked the pad through cache_len.  Blocks on
// an H100 run in no order, so the sequence axis becomes a loop inside a
// block plus a split over S (FlashDecoding): each block streams one range
// of positions for one (batch row, kv head) and writes a partial (m, l,
// acc) for its n_rep query rows; a second, small kernel merges the splits.
// Only positions < cache_len are read, so a ragged S needs no padding.
//
// What bounds it on an H100: bytes.  Each cached K and V element is read
// once for n_rep query rows (2 * n_rep flops per element, about 4 flops per
// byte for llama3's n_rep = 4 in bf16): 2 * B * cache_len * Hkv * D * 2
// bytes / 3.35 TB/s, 0.32 ms at B = 8, cache_len = 32,768, Hkv = 8, D = 128.
// The design: 128 threads a block; a tile of 64 positions of K and V is
// staged in shared memory with 16-byte loads (K rows padded by 16 bytes so
// that the score pass reads them without bank conflicts); the score pass
// gives each thread (query row, position) pairs, one warp per query row
// updates (m, l) and the tile's probabilities, and each thread keeps up to
// 4 (query row, pair of D) accumulators in registers.  The wrapper picks the
// number of splits so that B * Hkv * splits fills the card a few blocks per
// SM deep (at B = 8, Hkv = 8: 9 splits, 576 blocks for 132 SMs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;       // cache positions per shared-memory tile
constexpr int kMaxPairs = 4;    // accumulator pairs per thread: n_rep * D <= 1024
constexpr float kNegInf = -2.0e38f;

// a bf16 is the high half of an f32
__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// acc + the dot of one 16-byte vector of T with the matching f32 query values
__device__ __forceinline__ float dot16(const uint4& k, const float* q, float acc, float) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  acc = fmaf(__uint_as_float(k.x), a.x, acc);
  acc = fmaf(__uint_as_float(k.y), a.y, acc);
  acc = fmaf(__uint_as_float(k.z), a.z, acc);
  return fmaf(__uint_as_float(k.w), a.w, acc);
}
__device__ __forceinline__ float dot16(const uint4& k, const float* q, float acc, __nv_bfloat16) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  const float4 b = *reinterpret_cast<const float4*>(q + 4);
  acc = fmaf(lo_bf16(k.x), a.x, acc);
  acc = fmaf(hi_bf16(k.x), a.y, acc);
  acc = fmaf(lo_bf16(k.y), a.z, acc);
  acc = fmaf(hi_bf16(k.y), a.w, acc);
  acc = fmaf(lo_bf16(k.z), b.x, acc);
  acc = fmaf(hi_bf16(k.z), b.y, acc);
  acc = fmaf(lo_bf16(k.w), b.z, acc);
  return fmaf(hi_bf16(k.w), b.w, acc);
}

// two neighbouring elements as f32
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(lo_bf16(u), hi_bf16(u));
}

// floats of shared memory ahead of the K/V tiles, rounded to 16 bytes
__host__ __device__ __forceinline__ int head_floats(int n_rep, int d) {
  return (n_rep * (d + kTile + 3) + 3) & ~3;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, int s_len, int hkv, int n_rep, int d,
                          int cache_len, int chunk, float scale, float* __restrict__ m_out,
                          float* __restrict__ l_out, float* __restrict__ acc_out) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int b = blockIdx.y / hkv, h = blockIdx.y % hkv;
  const int hq = hkv * n_rep, dv = d / kVec, kstride = d + kVec;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [n_rep][d]
  float* p_s = q_s + n_rep * d;                 // [n_rep][kTile] scores, then probabilities
  float* m_s = p_s + n_rep * kTile;             // [n_rep] running max
  float* l_s = m_s + n_rep;                     // [n_rep] running sum
  float* c_s = l_s + n_rep;                     // [n_rep] this tile's correction
  T* k_s = reinterpret_cast<T*>(q_s + head_floats(n_rep, d));  // [kTile][d + kVec]
  T* v_s = k_s + kTile * kstride;                              // [kTile][d]

  const long long q_row = static_cast<long long>(b) * hq + static_cast<long long>(h) * n_rep;
  for (int i = threadIdx.x; i < n_rep * d; i += kThreads) q_s[i] = to_f32(q[q_row * d + i]);
  for (int g = threadIdx.x; g < n_rep; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int pairs = n_rep * d / 2;
  float acc[kMaxPairs][2];
#pragma unroll
  for (int a = 0; a < kMaxPairs; ++a) acc[a][0] = acc[a][1] = 0.f;

  const long long pos_stride = static_cast<long long>(hkv) * d;  // elements between positions
  const long long base = (static_cast<long long>(b) * s_len * hkv + h) * d;
  const int s_begin = split * chunk;
  const int s_end = min(s_begin + chunk, cache_len);
  __syncthreads();

  for (int t0 = s_begin; t0 < s_end; t0 += kTile) {
    const int n = min(kTile, s_end - t0);
    // stage positions [t0, t0 + n) of this kv head
    for (int i = threadIdx.x; i < n * dv; i += kThreads) {
      const int j = i / dv, c = i - j * dv;
      const long long off = base + (t0 + j) * pos_stride + c * kVec;
      const uint4 kk = __ldg(reinterpret_cast<const uint4*>(k + off));
      const uint4 vv = __ldg(reinterpret_cast<const uint4*>(v + off));
      *reinterpret_cast<uint4*>(k_s + j * kstride + c * kVec) = kk;
      *reinterpret_cast<uint4*>(v_s + j * d + c * kVec) = vv;
    }
    __syncthreads();
    // scores: (query row g, position j) pairs
    for (int i = threadIdx.x; i < n_rep * kTile; i += kThreads) {
      const int g = i / kTile, j = i - g * kTile;
      float s = kNegInf;
      if (j < n) {
        const uint4* kr = reinterpret_cast<const uint4*>(k_s + j * kstride);
        const float* qr = q_s + g * d;
        float dot = 0.f;
        for (int c = 0; c < dv; ++c) dot = dot16(kr[c], qr + c * kVec, dot, T());
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax: one warp per query row
    for (int g = warp; g < n_rep; g += kThreads / 32) {
      float* pr = p_s + g * kTile;
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pr[j]);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = j < n ? expf(pr[j] - m_new) : 0.f;
        pr[j] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g, pair] = acc * corr[g] + sum_j p[g, j] * v[j, pair]
#pragma unroll
    for (int a = 0; a < kMaxPairs; ++a) {
      const int i = threadIdx.x + a * kThreads;
      if (i < pairs) {
        const int g = (2 * i) / d, dd = 2 * i - g * d;
        const float corr = c_s[g];
        const float* pr = p_s + g * kTile;
        float x = acc[a][0] * corr, y = acc[a][1] * corr;
        for (int j = 0; j < n; ++j) {
          const float2 vv = load_pair(v_s + j * d + dd);
          x = fmaf(pr[j], vv.x, x);
          y = fmaf(pr[j], vv.y, y);
        }
        acc[a][0] = x;
        acc[a][1] = y;
      }
    }
    __syncthreads();
  }

  for (int g = threadIdx.x; g < n_rep; g += kThreads) {
    const long long o = (q_row + g) * n_splits + split;
    m_out[o] = m_s[g];
    l_out[o] = l_s[g];
  }
#pragma unroll
  for (int a = 0; a < kMaxPairs; ++a) {
    const int i = threadIdx.x + a * kThreads;
    if (i < pairs) {
      const int g = (2 * i) / d, dd = 2 * i - g * d;
      float* o = acc_out + ((q_row + g) * n_splits + split) * d + dd;
      o[0] = acc[a][0];
      o[1] = acc[a][1];
    }
  }
}

// out[row] = sum_i acc_i * e^(m_i - M) / max(sum_i l_i * e^(m_i - M), 1e-30)
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ m_in,
                                            const float* __restrict__ l_in,
                                            const float* __restrict__ acc_in, int n_splits,
                                            int d, T* __restrict__ out) {
  const long long row = blockIdx.x;  // b * Hq + query head
  const float* m = m_in + row * n_splits;
  const float* l = l_in + row * n_splits;
  float mx = kNegInf;
  for (int i = 0; i < n_splits; ++i) mx = fmaxf(mx, m[i]);
  float den = 0.f;
  for (int i = 0; i < n_splits; ++i) den += l[i] * expf(m[i] - mx);
  den = fmaxf(den, 1e-30f);
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float num = 0.f;
    for (int i = 0; i < n_splits; ++i)
      num += acc_in[(row * n_splits + i) * d + c] * expf(m[i] - mx);
    out[row * d + c] = from_f32<T>(num / den);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, int b, int s_len, int hkv, int n_rep,
           int d, int cache_len, int chunk, int n_splits, float scale, void* m_buf,
           void* l_buf, void* acc_buf, void* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * head_floats(n_rep, d) +
                      sizeof(T) * static_cast<size_t>(kTile) * (2 * d + 16 / sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_decode_split_kernel<T>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto* m = static_cast<float*>(m_buf);
  auto* l = static_cast<float*>(l_buf);
  auto* acc = static_cast<float*>(acc_buf);
  flash_decode_split_kernel<T><<<dim3(n_splits, b * hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), s_len, hkv,
      n_rep, d, cache_len, chunk, scale, m, l, acc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine_kernel<T><<<b * hkv * n_rep, kThreads, 0, stream>>>(
      m, l, acc, n_splits, d, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: 1 for bfloat16 tensors, 0 for float32.  The wrapper checks the
// contract: D % 8 == 0, D <= 256, n_rep * D <= 1024, 1 <= cache_len <= S,
// contiguous 16-byte-aligned tensors, and splits of `chunk` positions that
// are all non-empty; m/l hold B * Hq * n_splits floats, acc that times D.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, int bf16, int b,
                                   int s_len, int hkv, int n_rep, int d, int cache_len,
                                   int chunk, int n_splits, float scale, void* m_buf,
                                   void* l_buf, void* acc_buf, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, b, s_len, hkv, n_rep, d, cache_len, chunk, n_splits,
                                 scale, m_buf, l_buf, acc_buf, out, s);
  return launch<float>(q, k, v, b, s_len, hkv, n_rep, d, cache_len, chunk, n_splits, scale,
                       m_buf, l_buf, acc_buf, out, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
