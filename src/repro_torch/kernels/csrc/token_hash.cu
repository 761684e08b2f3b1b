// token_hash: (N, L) zero-padded u8 token matrix + (N,) i32 lengths -> (N,)
// u32 fingerprints.  Row i hashes h = POLY_SEED, then h = h * POLY_M32 ^ b
// over its first min(len, L) bytes, then fmix32(h ^ len), bit for bit the
// host's np_token_fingerprints (a length past L hashes the L bytes and
// still mixes in the full length; a length <= 0 hashes no byte; N = 0
// launches nothing).
//
// Replaces src/repro/kernels/token_hash/kernel.py token_hash_pallas
// (_token_hash_kernel).  The TPU kernel swept all L columns for a block of
// rows and froze finished rows with a select; its wrapper padded N to the
// block.  Here a row's loop simply stops at its length and the grid's
// ragged edge is a bounds check, so no padding exists.
//
// What bounds it on an H100: latency.  Every matrix byte is read once and
// costs two integer operations, far below the card's byte and operation
// rates; the calls are small (a flush batch of ingest is ~12k rows of 13-30
// bytes, a query wave 1k-6k rows of 3-16), so what a call pays is the
// launch, the round trips to memory and the serial multiply-xor chain of
// its longest row.  The first design gave each thread a row read straight
// from memory in 256-thread blocks: 49 blocks on 132 SMs at the median
// ingest call, and at a width that is not a multiple of 16 one byte load
// per step, issued only once the row's length had arrived (two round
// trips).  The design here, in 64-row blocks (a 12k-row call covers the
// SMs), has two paths, chosen by the width:
// - rows of at most 32 bytes (every ingest call and query wave measured):
//   each thread loads its row's bytes straight from memory, every one at
//   once and independent of the length, so the length and the bytes share
//   one round trip, and no barrier is needed.  Two instances, 16 and 32
//   bytes wide, so that narrow rows do not pay 32 predicated loads;
// - wider rows: the block's rows are one contiguous span of rows x L bytes
//   whatever L is.  The block stages it into shared memory with 16-byte
//   loads, all issued before any is stored, plus byte loads for the
//   unaligned head and tail, then each row hashes on one thread from
//   shared memory, a 4-byte word per four steps.  The staged bytes are
//   XOR-swizzled at 16-byte granularity within each 128-byte line, so rows
//   64 bytes apart do not all fall on two banks.  A span past the window
//   is staged and hashed in windows of kWindow bytes, the row state carried
//   across windows.
// Staging every width measured slower than the direct loads at the shapes
// the port launches: 0.0062-0.0063 against 0.0056-0.0057 ms at 12,456 x 22
// and 0.0059-0.0060 against 0.0053-0.0055 at 4096 x 16; direct loads in
// 32-byte chunks measured slower than staging past 32 bytes: 0.0098
// against 0.0068 at 32,768 x 64 (H100 80GB HBM3, 700 W,
// kernels/token_hash/bench.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPolyM32 = 0x9E3779B1u;
constexpr uint32_t kPolySeed = 0x811C9DC5u;
constexpr int kRows = 64;                    // rows of a block, one thread each
// one window holds a block's span of 64-byte rows from any alignment
constexpr int kWindow = kRows * 64 + 128;
constexpr int kVecPerThread = (kWindow / 16 + kRows - 1) / kRows;
constexpr int kDirectBytes = 32;             // widest row the direct path takes

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// shared-memory position of staged byte x: 16-byte chunks XOR-swizzled
// within their 128-byte line (a bijection on each line, so kWindow is a
// multiple of 128; 16-byte and 4-byte groups stay whole)
__device__ __forceinline__ uint32_t swz(uint32_t x) { return x ^ (((x >> 7) & 7u) << 4); }

__global__ void __launch_bounds__(kRows)
token_hash_staged(const uint8_t* __restrict__ tokens, const int* __restrict__ lengths, int n,
                  int l, uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t stage[kWindow];
  const int r = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const int len = r < rows ? __ldg(lengths + row0 + r) : 0;
  const int steps = len <= 0 ? 0 : (len < l ? len : l);
  const uintptr_t span_lo = reinterpret_cast<uintptr_t>(tokens) + static_cast<size_t>(row0) * l;
  const uintptr_t span_hi = span_lo + static_cast<size_t>(rows) * l;
  const uintptr_t mine_lo = span_lo + static_cast<size_t>(r) * l;
  const uintptr_t mine_hi = mine_lo + steps;
  uint32_t h = kPolySeed;
  for (uintptr_t w = span_lo & ~uintptr_t(15); w < span_hi; w += kWindow) {
    // stage bytes [lo, hi) of the span at offsets from w (16-byte aligned)
    const uintptr_t lo = w > span_lo ? w : span_lo;
    const uintptr_t hi = w + kWindow < span_hi ? w + kWindow : span_hi;
    const uintptr_t vlo = (lo + 15) & ~uintptr_t(15), vhi = hi & ~uintptr_t(15);
    uint4 v[kVecPerThread];
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const uintptr_t g = vlo + 16 * static_cast<uintptr_t>(r + k * kRows);
      if (g < vhi) v[k] = __ldg(reinterpret_cast<const uint4*>(g));
    }
    // the head before the first 16-byte boundary and the tail after the
    // last (when [lo, hi) lies within one 16-byte group, all of it is head)
    const uintptr_t head_hi = vlo < hi ? vlo : hi;
    const uintptr_t tail_lo = vhi > head_hi ? vhi : head_hi;
    uint8_t head = 0, tail = 0;
    if (lo + r < head_hi) head = __ldg(reinterpret_cast<const uint8_t*>(lo + r));
    if (tail_lo + r < hi) tail = __ldg(reinterpret_cast<const uint8_t*>(tail_lo + r));
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const uintptr_t g = vlo + 16 * static_cast<uintptr_t>(r + k * kRows);
      if (g < vhi) *reinterpret_cast<uint4*>(stage + swz(static_cast<uint32_t>(g - w))) = v[k];
    }
    if (lo + r < head_hi) stage[swz(static_cast<uint32_t>(lo + r - w))] = head;
    if (tail_lo + r < hi) stage[swz(static_cast<uint32_t>(tail_lo + r - w))] = tail;
    __syncthreads();
    // this row's bytes within the window, a 4-byte word at a time
    const uintptr_t a = mine_lo > lo ? mine_lo : lo;
    const uintptr_t b = mine_hi < hi ? mine_hi : hi;
    for (uintptr_t q = a & ~uintptr_t(3); q < b; q += 4) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(stage + swz(static_cast<uint32_t>(q - w)));
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (q + k >= a && q + k < b) h = (h * kPolyM32) ^ ((word >> (8 * k)) & 0xFFu);
    }
    if (w + kWindow < span_hi) __syncthreads();  // the next window reuses stage
  }
  if (r < rows) out[row0 + r] = fmix32(h ^ static_cast<uint32_t>(len));
}

template <int kBytes>
__global__ void __launch_bounds__(kRows)
token_hash_direct(const uint8_t* __restrict__ tokens, const int* __restrict__ lengths, int n,
                  int l, uint32_t* __restrict__ out) {
  const int row = blockIdx.x * kRows + threadIdx.x;
  if (row >= n) return;
  const uint8_t* src = tokens + static_cast<size_t>(row) * l;
  const int len = __ldg(lengths + row);
  uint32_t b[kBytes];
#pragma unroll
  for (int j = 0; j < kBytes; ++j) b[j] = j < l ? __ldg(src + j) : 0u;
  const int steps = len <= 0 ? 0 : (len < l ? len : l);
  uint32_t h = kPolySeed;
#pragma unroll
  for (int j = 0; j < kBytes; ++j)
    if (j < steps) h = (h * kPolyM32) ^ b[j];
  out[row] = fmix32(h ^ static_cast<uint32_t>(len));
}

}  // namespace

extern "C" int token_hash_launch(const void* tokens, const void* lengths, int n, int l, void* out,
                                 void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kRows - 1) / kRows;
  auto* kernel = l <= kDirectBytes / 2 ? &token_hash_direct<kDirectBytes / 2>
                 : l <= kDirectBytes   ? &token_hash_direct<kDirectBytes>
                                       : &token_hash_staged;
  kernel<<<blocks, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tokens), static_cast<const int*>(lengths), n, l,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
