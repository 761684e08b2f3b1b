// embedding_bag: (V, D) f32 table + (B, BAG) i32 indices -> (B, D) f32 bag
// sums, out[b, d] = sum over j = 0..BAG-1 of table[idx[b, j], d], summed in
// f32 in bag order.  On the model path it is xDeepFM's wide term: D = 1,
// BAG = 39 fields, over the 39M-row wide table.
//
// Replaces src/repro/kernels/embedding_bag/kernel.py embedding_bag_pallas
// (_ebag_kernel).  The TPU kernel walked a (B, BAG) grid whose index map
// steered one (1, D) row DMA per step from scalar-prefetched indices, and
// accumulated into a revisited output block.  Here each bag's loop over j
// is a plain indexed load: a thread reads its own indices.
//
// What bounds it on an H100: bytes, and at the path's shape launch latency.
// A call moves its indices, the B * BAG rows they name and the output;
// nothing else of the table is touched.  The design: a bag gets L lanes,
// L the power of two >= D capped at 32 (a warp per bag for D >= 17, one
// lane per bag and 32 bags a warp for D = 1); the lanes read a row's
// neighbouring elements, so each gathered row is one coalesced access.
// Contract, as the TPU kernel's: 0 <= idx < V (the wrapper checks it only
// on the CPU, where it costs no device sync).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void embedding_bag_kernel(const float* __restrict__ table,
                                     const int* __restrict__ idx, int b, int bag, int d,
                                     int lanes, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = t / lanes;
  if (row >= b) return;
  const int sub = static_cast<int>(t % lanes);
  const int* ids = idx + row * bag;
  for (int col = sub; col < d; col += lanes) {
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < bag; ++j)
      acc += __ldg(table + static_cast<long long>(__ldg(ids + j)) * d + col);
    out[row * d + col] = acc;
  }
}

}  // namespace

extern "C" int embedding_bag_launch(const void* table, const void* idx, int b, int bag,
                                    int d, void* out, void* stream) {
  int lanes = 1;
  while (lanes < d && lanes < 32) lanes <<= 1;
  const int threads = 256;
  const long long total = static_cast<long long>(b) * lanes;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  embedding_bag_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx), b, bag, d, lanes,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
