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
// What bounds it on an H100: latency.  The bytes a call must move are a
// few words per anchor and the mask, far below a microsecond even for a
// wave of 67k fingerprints; what it cannot avoid is two dependent memory
// round trips, the fingerprint and then the plane words its anchors name,
// plus a launch.  The first design gave a fingerprint one thread that walked
// its j x k anchors in a runtime loop, a seed load in front of each, so a
// per-query call (13-15 fingerprints, one partly filled warp) paid j x k
// plane round trips in series.  The design here has two layouts, both
// with every anchor's R + 1 word loads (R = ceil(p/32)) in flight at once:
// - small calls (a per-query call, up to Q 32,768 at j x k = 4): a group of
//   G = pow2(j x k) lanes (at most 32) per fingerprint, one lane per
//   anchor; the group's masks fold by __shfl_xor_sync (AND is exact in any
//   order), and each lane writes its share of the row;
// - waves: one thread per fingerprint with kSeeds anchors unrolled and a
//   runtime tail; at 67k fingerprints four times the threads cost more
//   than the shorter chains gain (the measured crossover, kGroupMaxLanes).
// Rows are written as 16-byte vectors when p is a multiple of 16.  The
// seeds come by value in the kernel's parameters up to kSeeds anchors
// (j x k <= 8 covers the paper's k = 4 at j <= 2), so no load stands in
// front of the hash; past that they come from the sketch's device array.
// The word index wraps with a mask (m/32 is a power of two), so anchors
// near m - 1 need no branch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeeds = 8;
// a call takes lane groups while Q x G is at most this: half the threads the
// card's 132 SMs hold at once (measured: groups win to Q 32,768 at G = 4,
// a thread per fingerprint wins at 66,994)
constexpr long long kGroupMaxLanes = 1 << 17;

struct Seeds {
  uint32_t v[kSeeds];
};

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

// seeds.v[a] by selects: a parameter array indexed at run time would be
// copied to local memory first
__device__ __forceinline__ uint32_t seed_of(const Seeds& seeds, int a) {
  uint32_t s = seeds.v[0];
#pragma unroll
  for (int i = 1; i < kSeeds; ++i) s = a == i ? seeds.v[i] : s;
  return s;
}

// A's R + 1 words, aligned to its bit offset: acc[r] &= bits 32r..32r+31
// from the anchor on
template <int R>
__device__ __forceinline__ void fold_words(const uint32_t (&w)[R + 1], uint32_t off,
                                           uint32_t (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] &= __funnelshift_r(w[r], w[r + 1], off);
}

// lane g of a group of G writes its share of the row: 16-byte chunks h
// with h % G == g when p % 16 == 0, else bytes i with i % G == g
template <int R, bool kVec>
__device__ __forceinline__ void store_row(uint8_t* dst, const uint32_t (&acc)[R], int p, int g,
                                          int group) {
  if (kVec) {
#pragma unroll
    for (int h = 0; h < 2 * R; ++h) {
      if (16 * h < p && (h & (group - 1)) == g) {
        const uint32_t b = acc[h >> 1] >> (16 * (h & 1));
        reinterpret_cast<uint4*>(dst + 16 * h)[0] =
            make_uint4(spread4(b & 0xFu), spread4((b >> 4) & 0xFu),
                       spread4((b >> 8) & 0xFu), spread4((b >> 12) & 0xFu));
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (int i = g; i < 32 && 32 * r + i < p; i += group)
        dst[32 * r + i] = (acc[r] >> i) & 1u;
    }
  }
}

// Small calls: a group of G lanes per fingerprint, lane g takes anchors g,
// g + G, ...  Every lane of a warp reaches the fold (no early return), and
// G is the same across the grid, so the shuffles see all 32 lanes.
template <int R, bool kVec>
__global__ void __launch_bounds__(kThreads)
csc_probe_group(const uint32_t* __restrict__ fps, int q, const uint32_t* __restrict__ bits,
                int words, Seeds seeds, const uint32_t* __restrict__ dev_seeds, int jk, int k,
                int g_log, int p, uint8_t* __restrict__ out) {
  const int group = 1 << g_log;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = t >> g_log;
  const int g = static_cast<int>(t & (group - 1));
  const bool live = row < q;
  const uint32_t fp = live ? __ldg(fps + row) : 0u;
  const uint32_t mmask = static_cast<uint32_t>(words) * 32u - 1u;
  const uint32_t wmask = static_cast<uint32_t>(words) - 1u;
  uint32_t acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0xFFFFFFFFu;
  for (int a = g; live && a < jk; a += group) {
    const uint32_t seed = jk <= kSeeds ? seed_of(seeds, a) : __ldg(dev_seeds + a);
    const uint32_t* plane = bits + static_cast<size_t>(jk == k ? 0 : a / k) * words;
    const uint32_t anchor = fmix32(fp ^ seed) & mmask;
    uint32_t w[R + 1];
#pragma unroll
    for (int r = 0; r <= R; ++r) w[r] = __ldg(plane + (((anchor >> 5) + r) & wmask));
    fold_words<R>(w, anchor & 31u, acc);
  }
  for (int lane = 1; lane < group; lane <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] &= __shfl_xor_sync(0xFFFFFFFFu, acc[r], lane);
  }
  if (live) store_row<R, kVec>(out + static_cast<size_t>(row) * p, acc, p, g, group);
}

// Waves: one thread per fingerprint, kSeeds anchors at a time unrolled, all
// their word loads issued before the first fold.
template <int R, bool kVec>
__global__ void __launch_bounds__(kThreads)
csc_probe_thread(const uint32_t* __restrict__ fps, int q, const uint32_t* __restrict__ bits,
                 int words, Seeds seeds, const uint32_t* __restrict__ dev_seeds, int jk, int k,
                 int p, uint8_t* __restrict__ out) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= q) return;
  const uint32_t fp = __ldg(fps + row);
  const uint32_t mmask = static_cast<uint32_t>(words) * 32u - 1u;
  const uint32_t wmask = static_cast<uint32_t>(words) - 1u;
  uint32_t acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0xFFFFFFFFu;
  for (int a0 = 0; a0 < jk; a0 += kSeeds) {
    uint32_t w[kSeeds][R + 1], off[kSeeds];
#pragma unroll
    for (int u = 0; u < kSeeds; ++u) {
      const int a = a0 + u;
      off[u] = 0;
#pragma unroll
      for (int r = 0; r <= R; ++r) w[u][r] = 0xFFFFFFFFu;
      if (a < jk) {
        const uint32_t seed = jk <= kSeeds ? seeds.v[u] : __ldg(dev_seeds + a);
        const uint32_t* plane = bits + static_cast<size_t>(jk == k ? 0 : a / k) * words;
        const uint32_t anchor = fmix32(fp ^ seed) & mmask;
        off[u] = anchor & 31u;
#pragma unroll
        for (int r = 0; r <= R; ++r) w[u][r] = __ldg(plane + (((anchor >> 5) + r) & wmask));
      }
    }
#pragma unroll
    for (int u = 0; u < kSeeds; ++u) fold_words<R>(w[u], off[u], acc);
  }
  store_row<R, kVec>(out + static_cast<size_t>(row) * p, acc, p, 0, 1);
}

template <int R, bool kVec>
void launch_layout(const uint32_t* fps, int q, const uint32_t* bits, int words,
                   const Seeds& seeds, const uint32_t* dev_seeds, int jk, int k, int p,
                   uint8_t* out, cudaStream_t stream) {
  int g_log = 0;
  while ((1 << g_log) < jk && g_log < 5) ++g_log;
  const long long lanes = static_cast<long long>(q) << g_log;
  if (lanes <= kGroupMaxLanes) {
    csc_probe_group<R, kVec><<<static_cast<int>((lanes + kThreads - 1) / kThreads), kThreads,
                               0, stream>>>(fps, q, bits, words, seeds, dev_seeds, jk, k, g_log,
                                            p, out);
  } else {
    csc_probe_thread<R, kVec><<<(q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        fps, q, bits, words, seeds, dev_seeds, jk, k, p, out);
  }
}

template <int R>
void launch(const uint32_t* fps, int q, const uint32_t* bits, int words, const Seeds& seeds,
            const uint32_t* dev_seeds, int jk, int k, int p, uint8_t* out,
            cudaStream_t stream) {
  if (p % 16 == 0)
    launch_layout<R, true>(fps, q, bits, words, seeds, dev_seeds, jk, k, p, out, stream);
  else
    launch_layout<R, false>(fps, q, bits, words, seeds, dev_seeds, jk, k, p, out, stream);
}

}  // namespace

// words = m / 32, a power of two >= 2; host_seeds (host memory) and
// dev_seeds (device memory) both hold the j * k u32 anchor seeds, row-major
// by repetition; 1 <= p <= 256 (the wrapper checks all three); out is
// (q, p) bytes, 16-byte aligned.
extern "C" int csc_probe_launch(const void* fps, int q, const void* bits, int words,
                                const void* host_seeds, const void* dev_seeds, int j, int k,
                                int p, void* out, void* stream) {
  const auto* f = static_cast<const uint32_t*>(fps);
  const auto* b = static_cast<const uint32_t*>(bits);
  const auto* ds = static_cast<const uint32_t*>(dev_seeds);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int jk = j * k;
  Seeds seeds = {};
  for (int i = 0; i < jk && i < kSeeds; ++i)
    seeds.v[i] = static_cast<const uint32_t*>(host_seeds)[i];
  switch ((p + 31) / 32) {
    case 1: launch<1>(f, q, b, words, seeds, ds, jk, k, p, o, s); break;
    case 2: launch<2>(f, q, b, words, seeds, ds, jk, k, p, o, s); break;
    case 3: launch<3>(f, q, b, words, seeds, ds, jk, k, p, o, s); break;
    case 4: launch<4>(f, q, b, words, seeds, ds, jk, k, p, o, s); break;
    case 5: launch<5>(f, q, b, words, seeds, ds, jk, k, p, o, s); break;
    case 6: launch<6>(f, q, b, words, seeds, ds, jk, k, p, o, s); break;
    case 7: launch<7>(f, q, b, words, seeds, ds, jk, k, p, o, s); break;
    case 8: launch<8>(f, q, b, words, seeds, ds, jk, k, p, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
