// token_hash's first design, kept as a contender for
// kernels/token_hash/bench.py (--cu): one thread per row in 256-thread
// blocks, each row read straight from device memory, as uint4 vectors when
// L is a multiple of 16 and the matrix is 16-byte aligned, else one byte per
// step.  Same C interface as csrc/token_hash.cu; the package does not build
// this file.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPolyM32 = 0x9E3779B1u;
constexpr uint32_t kPolySeed = 0x811C9DC5u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t step_word(uint32_t h, uint32_t word, int nbytes) {
  for (int b = 0; b < nbytes; ++b) h = (h * kPolyM32) ^ ((word >> (8 * b)) & 0xFFu);
  return h;
}

template <bool kVec>
__global__ void token_hash_kernel(const uint8_t* __restrict__ tokens, const int* __restrict__ lengths,
                                  int n, int l, uint32_t* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int len = lengths[row];
  const int steps = len < l ? len : l;  // a negative length steps nothing
  const uint8_t* src = tokens + static_cast<size_t>(row) * l;
  uint32_t h = kPolySeed;
  if (kVec) {
    const uint4* vsrc = reinterpret_cast<const uint4*>(src);
    for (int base = 0; base < steps; base += 16) {
      const uint4 v = __ldg(vsrc + (base >> 4));
      const int left = steps - base;
      h = step_word(h, v.x, left < 4 ? left : 4);
      if (left > 4) h = step_word(h, v.y, left < 8 ? left - 4 : 4);
      if (left > 8) h = step_word(h, v.z, left < 12 ? left - 8 : 4);
      if (left > 12) h = step_word(h, v.w, left < 16 ? left - 12 : 4);
    }
  } else {
    for (int j = 0; j < steps; ++j) h = (h * kPolyM32) ^ __ldg(src + j);
  }
  out[row] = fmix32(h ^ static_cast<uint32_t>(len));
}

}  // namespace

extern "C" int token_hash_launch(const void* tokens, const void* lengths, int n, int l,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  const auto* t = static_cast<const uint8_t*>(tokens);
  const auto* len = static_cast<const int*>(lengths);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (l % 16 == 0 && reinterpret_cast<uintptr_t>(tokens) % 16 == 0)
    token_hash_kernel<true><<<blocks, threads, 0, s>>>(t, len, n, l, o);
  else
    token_hash_kernel<false><<<blocks, threads, 0, s>>>(t, len, n, l, o);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
