// csc_probe: the CSC sketch's partition-survival mask.  For each query
// fingerprint and each of the j x k (repetition, hash) pairs, anchor =
// fmix32(fp ^ seed(rep, hk)) & (m - 1); the p bits starting at the anchor
// (bit positions wrapping at m) are ANDed into the row's mask.  Output
// (Q, p) bytes, 1 where the partition survived every anchor.
//
// Replaces src/repro/kernels/csc_probe/kernel.py csc_probe_pallas
// (_csc_kernel).  The TPU kernel held the whole (j, m/32) plane in VMEM
// and gathered a (block, p) matrix of single bits per anchor, writing an
// int32 per bit; here the plane stays in device memory, each anchor reads
// the ceil(p/32) + 1 words that hold its p bits and aligns them with a
// funnel shift, and each bit is written as one byte (the wrapper's bool).
//
// What bounds it on an H100: latency.  At the paper's sizing the plane is
// 16-128 MB, larger than the 50 MB L2, and the anchors are uniformly
// random, so every anchor is a dependent load from device memory; the
// bytes actually moved (a few words per anchor, the mask written once)
// are small.  The design: one thread per fingerprint, so many anchors are
// in flight per SM; each anchor's ceil(p/32) + 1 word loads are issued
// together (they do not depend on each other), the mask is held in
// ceil(p/32) registers, and the row is written as 16-byte vectors when p
// is a multiple of 16.  The word index wraps with a mask (m/32 is a power of
// two), so anchors near m - 1 need no branch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// 4 mask bits -> 4 bytes of 0/1 (little-endian: bit 0 is byte 0)
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) | ((nib & 8u) << 21);
}

template <int R, bool kVec>
__global__ void csc_probe_kernel(const uint32_t* __restrict__ fps, int q,
                                 const uint32_t* __restrict__ bits, int words,
                                 const uint32_t* __restrict__ seeds, int j, int k, int p,
                                 uint8_t* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= q) return;
  const uint32_t fp = fps[row];
  const uint32_t mmask = static_cast<uint32_t>(words) * 32u - 1u;
  const uint32_t wmask = static_cast<uint32_t>(words) - 1u;
  uint32_t acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0xFFFFFFFFu;
  for (int rep = 0; rep < j; ++rep) {
    const uint32_t* plane = bits + static_cast<size_t>(rep) * words;
    for (int hk = 0; hk < k; ++hk) {
      const uint32_t anchor = fmix32(fp ^ __ldg(seeds + rep * k + hk)) & mmask;
      const uint32_t w0 = anchor >> 5;
      const uint32_t off = anchor & 31u;
      uint32_t w[R + 1];
#pragma unroll
      for (int r = 0; r <= R; ++r) w[r] = __ldg(plane + ((w0 + r) & wmask));
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] &= __funnelshift_r(w[r], w[r + 1], off);
    }
  }
  uint8_t* dst = out + static_cast<size_t>(row) * p;
  if (kVec) {  // p % 16 == 0: 16 mask bits per 16-byte store
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 32 * r + 16 * h;
        if (col < p) {
          const uint32_t b = acc[r] >> (16 * h);
          reinterpret_cast<uint4*>(dst + col)[0] =
              make_uint4(spread4(b & 0xFu), spread4((b >> 4) & 0xFu),
                         spread4((b >> 8) & 0xFu), spread4((b >> 12) & 0xFu));
        }
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (int i = 0; i < 32 && 32 * r + i < p; ++i) dst[32 * r + i] = (acc[r] >> i) & 1u;
    }
  }
}

template <int R>
void launch(const uint32_t* fps, int q, const uint32_t* bits, int words, const uint32_t* seeds,
            int j, int k, int p, uint8_t* out, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (q + threads - 1) / threads;
  if (p % 16 == 0)
    csc_probe_kernel<R, true><<<blocks, threads, 0, stream>>>(fps, q, bits, words, seeds, j, k, p, out);
  else
    csc_probe_kernel<R, false><<<blocks, threads, 0, stream>>>(fps, q, bits, words, seeds, j, k, p, out);
}

}  // namespace

// words = m / 32, a power of two >= 2; seeds holds j * k u32 anchor seeds,
// row-major by repetition; 1 <= p <= 256 (the wrapper checks all three);
// out is (q, p) bytes, 16-byte aligned.
extern "C" int csc_probe_launch(const void* fps, int q, const void* bits, int words,
                                const void* seeds, int j, int k, int p, void* out,
                                void* stream) {
  const auto* f = static_cast<const uint32_t*>(fps);
  const auto* b = static_cast<const uint32_t*>(bits);
  const auto* sd = static_cast<const uint32_t*>(seeds);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((p + 31) / 32) {
    case 1: launch<1>(f, q, b, words, sd, j, k, p, o, s); break;
    case 2: launch<2>(f, q, b, words, sd, j, k, p, o, s); break;
    case 3: launch<3>(f, q, b, words, sd, j, k, p, o, s); break;
    case 4: launch<4>(f, q, b, words, sd, j, k, p, o, s); break;
    case 5: launch<5>(f, q, b, words, sd, j, k, p, o, s); break;
    case 6: launch<6>(f, q, b, words, sd, j, k, p, o, s); break;
    case 7: launch<7>(f, q, b, words, sd, j, k, p, o, s); break;
    case 8: launch<8>(f, q, b, words, sd, j, k, p, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
