// sketch_probe: batched BBHash MPHF lookup of u32 token fingerprints, and
// the fused segment probe of the query waves.  Two entries share the probe:
// - sketch_probe_launch: (idx, absent) per fingerprint, the MPHF probe;
// - sketch_match_launch: for each fingerprint, the probe, the signature
//   check, the CSF rank and the OR of the segment's posting-plane row into
//   the wave's (Q, W_out) accumulator (the row cut or zero-padded to
//   W_out), so one launch per segment and wave replaces the probe and the
//   ~40 torch ops that followed it.
//
// Replaces src/repro/kernels/sketch_probe/kernel.py sketch_probe_pallas
// (_probe_kernel), together with the fallback resolution that the JAX
// wrapper (ops.py mphf_probe_arrs) ran as jnp around it, and (fused entry)
// the jnp chain the JAX engine jit-compiled around the call:
// immutable_sketch.py match_bitmap_from / _resolve_probe, csf.py
// csf_get_jnp.
//
// What bounds it on an H100: latency.  A probe reads one fingerprint, a
// few 4-byte level words, one 32-byte rank block and a few words of the
// signatures and the CSF, and (fused) moves W plane and accumulator words;
// a segment's sketch (hundreds of KB) stays in L2 after the first wave, so
// at the waves' sizes (1e3..1e5 fingerprints) a call lasts a few
// microseconds, bounded by the launch and by the chain of dependent loads
// each fingerprint walks.  The design shortens that chain:
// - the level table comes by value in the kernel's parameters (kMaxLevels
//   levels, the build's default cascade depth; past that the device arrays
//   serve, in series); every level's position is computed and its word
//   load issued before any is tested, then the first set bit wins.  The
//   first design walked the levels in series, one round trip a level;
// - the hit's rank block (8 words, one aligned 32-byte sector) and its
//   sampled rank load in one round;
// - only fingerprints that missed every level search the sorted fallback
//   keys, from shared memory when there are at most kSmemFallback of them;
// - fused: the signature's two words, the CSF sample offset and the 5
//   words that hold the block's 32 five-bit lengths load in one round; the
//   code's two words in the next; then the warp ORs the plane rows of its
//   present fingerprints with lanes across the W words (a row's 248 bytes
//   at W = 62 coalesced), kRowBatch rows' loads in flight at once, each
//   non-zero word sent to the accumulator as an atomicOr, a reduction done
//   in L2 that the SM does not wait on.  At the term wave's size (4096
//   fingerprints, W 62) that measured 0.0122 ms warm and 0.0172 cold,
//   against 0.0146 and 0.0244 for reading the accumulator and storing it
//   back, and 0.0128 and 0.0130 warm for batches of 8 and of 32 rows (the
//   latter past the registers) (H100 80GB HBM3, 700 W,
//   kernels/sketch_probe/bench.py).  An absent fingerprint moves no plane
//   or accumulator word, a zero plane word no accumulator word.
// Ranks are 32-bit: the MPHF rank is below the key count and the CSF rank
// below 2^30 (csf.py LEN_BITS), so both are exact.  One warp a block, so a
// 4096-fingerprint wave spreads over 128 SMs and the fallback staging needs
// only a warp barrier.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kLevelSeed = 0x5EED1E5u;
constexpr uint32_t kSigSeed = 0x516E4715u;
constexpr int kRankBlockWords = 8;
constexpr int kMaxLevels = 12;       // mphf.py MAX_LEVELS_DEFAULT
constexpr int kSample = 32;          // csf.py SAMPLE
constexpr int kLenWords = 5;         // kSample five-bit lengths = 160 bits
constexpr int kThreads = 32;
constexpr int kSmemFallback = 1024;
constexpr int kRowBatch = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Levels {
  uint32_t bits[kMaxLevels];         // m_l; 0 for an empty or absent level
  uint32_t word_offset[kMaxLevels];
};

struct Mphf {
  const uint32_t* words;
  const uint32_t* block_rank;
  const int* level_bits;             // every level, for those past kMaxLevels
  const int* level_word_offset;
  int n_levels;
  const uint32_t* fb_fps;
  const int* fb_idx;
  int fb_count;
};

struct Sketch {
  const uint32_t* signatures;
  int n_sig_words, sig_bits, n_tokens1;
  const uint32_t* bitseq;
  int n_bitseq_words;
  const uint32_t* lengths;
  int n_len_words;
  const long long* samples;
  const uint32_t* planes;
  int w_seg, n_lists1;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// the low nbits (<= 32) of the bit field at bit pos of words; the second
// word's index is clamped to the array, as the plain version's _peek does
__device__ __forceinline__ uint32_t peek(const uint32_t* words, int n_words, long long pos,
                                         int nbits) {
  const int w = static_cast<int>(pos >> 5);
  const uint64_t lo = __ldg(words + w), hi = __ldg(words + min(w + 1, n_words - 1));
  return static_cast<uint32_t>(((hi << 32 | lo) >> (pos & 31)) & ((1ull << nbits) - 1));
}

// The fallback keys in shared memory when they fit, else in device memory.
// Every lane of the block (one warp) calls it.
__device__ __forceinline__ const uint32_t* stage_fallback(const Mphf& m, uint32_t* sh) {
  if (m.fb_count == 0 || m.fb_count > kSmemFallback) return m.fb_fps;
  for (int j = threadIdx.x; j < m.fb_count; j += kThreads) sh[j] = __ldg(m.fb_fps + j);
  __syncwarp();
  return sh;
}

// (minimal hash, absent) of fp
__device__ __forceinline__ int probe(uint32_t fp, const Levels& lv, const Mphf& m,
                                     const uint32_t* fb, bool& absent) {
  uint32_t word[kMaxLevels], bit[kMaxLevels], wv[kMaxLevels];
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    word[l] = bit[l] = wv[l] = 0;
    if (lv.bits[l]) {
      const uint32_t pos = fmix32(fp ^ (kLevelSeed * static_cast<uint32_t>(l + 1))) % lv.bits[l];
      word[l] = lv.word_offset[l] + (pos >> 5);
      bit[l] = pos & 31u;
      wv[l] = __ldg(m.words + word[l]);
    }
  }
  bool hit = false;
  uint32_t hw = 0, hb = 0, hv = 0;
#pragma unroll
  for (int l = kMaxLevels - 1; l >= 0; --l) {
    if (lv.bits[l] && ((wv[l] >> bit[l]) & 1u)) {
      hit = true;
      hw = word[l];
      hb = bit[l];
      hv = wv[l];
    }
  }
  for (int l = kMaxLevels; !hit && l < m.n_levels; ++l) {
    const uint32_t bits = static_cast<uint32_t>(__ldg(m.level_bits + l));
    if (bits == 0) continue;
    const uint32_t pos = fmix32(fp ^ (kLevelSeed * static_cast<uint32_t>(l + 1))) % bits;
    const uint32_t w = static_cast<uint32_t>(__ldg(m.level_word_offset + l)) + (pos >> 5);
    const uint32_t v = __ldg(m.words + w);
    if ((v >> (pos & 31u)) & 1u) {
      hit = true;
      hw = w;
      hb = pos & 31u;
      hv = v;
    }
  }
  if (hit) {
    // rank = sampled block rank + popcounts of the block's earlier words +
    // the masked popcount of the hit's word (hb < 32: no UB shift)
    const uint32_t block = hw / kRankBlockWords;
    const uint4* blk = reinterpret_cast<const uint4*>(m.words) + 2 * block;
    const uint4 a = __ldg(blk), b = __ldg(blk + 1);
    uint32_t r = __ldg(m.block_rank + block);
    const uint32_t w8[kRankBlockWords] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const uint32_t k = hw % kRankBlockWords;
#pragma unroll
    for (int j = 0; j < kRankBlockWords; ++j) r += j < k ? __popc(w8[j]) : 0;
    r += __popc(hv & ((1u << hb) - 1u));
    absent = false;
    return static_cast<int>(r);
  }
  // collided through every level: lower_bound over the real fallback keys
  int lo = 0, hi = m.fb_count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (fb[mid] < fp) lo = mid + 1; else hi = mid;
  }
  const bool found = lo < m.fb_count && fb[lo] == fp;
  absent = !found;
  return found ? __ldg(m.fb_idx + lo) : 0;
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint32_t* __restrict__ fps, int q, Levels lv, Mphf m, int* __restrict__ out_idx,
             bool* __restrict__ out_absent) {
  __shared__ uint32_t fb_sh[kSmemFallback];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t fp = i < q ? __ldg(fps + i) : 0u;
  const uint32_t* fb = stage_fallback(m, fb_sh);
  if (i >= q) return;
  bool absent;
  out_idx[i] = probe(fp, lv, m, fb, absent);
  out_absent[i] = absent;
}

__global__ void __launch_bounds__(kThreads)
match_kernel(const uint32_t* __restrict__ fps, int q, Levels lv, Mphf m, Sketch s,
             uint32_t* acc, int w_out) {
  __shared__ uint32_t fb_sh[kSmemFallback];
  const int lane = threadIdx.x;
  const int i = blockIdx.x * kThreads + lane;
  const uint32_t fp = i < q ? __ldg(fps + i) : 0u;
  const uint32_t* fb = stage_fallback(m, fb_sh);
  bool present = false;
  int rank = 0;
  if (i < q) {
    bool absent;
    const int idx = min(max(probe(fp, lv, m, fb, absent), 0), s.n_tokens1);
    if (!absent) {
      const int block = idx / kSample;
      const long long sample = __ldg(s.samples + block);
      uint32_t len_words[kLenWords + 1];
#pragma unroll
      for (int k = 0; k < kLenWords; ++k)
        len_words[k] = __ldg(s.lengths + min(kLenWords * block + k, s.n_len_words - 1));
      len_words[kLenWords] = 0;
      const uint32_t sig = peek(s.signatures, s.n_sig_words,
                                static_cast<long long>(idx) * s.sig_bits, s.sig_bits);
      const uint32_t want =
          fmix32(fp ^ kSigSeed) & static_cast<uint32_t>((1ull << s.sig_bits) - 1);
      present = sig == want;
      if (present) {
        // the CSF code of idx: its offset is the sample's plus the lengths
        // of the block's entries before it (idx <= csf n - 1, checked by
        // the wrapper, so no position needs the plain version's clamp)
        const int rel = idx - block * kSample;
        long long off = sample;
        int nbits = 0;
#pragma unroll
        for (int j = 0; j < kSample; ++j) {
          const int len = static_cast<int>(
              __funnelshift_r(len_words[(5 * j) >> 5], len_words[((5 * j) >> 5) + 1],
                              (5 * j) & 31) & 31u);
          off += j < rel ? len : 0;
          nbits = j == rel ? len : nbits;
        }
        rank = min(max(static_cast<int>(peek(s.bitseq, s.n_bitseq_words, off, nbits)), 0),
                   s.n_lists1);
      }
    }
  }
  // the warp's present rows, kRowBatch at a time: lanes across the words
  const int w = min(s.w_seg, w_out);
  unsigned todo = __ballot_sync(kFull, present);
  while (todo) {
    bool ok[kRowBatch];
    const uint32_t* src[kRowBatch];
    uint32_t* dst[kRowBatch];
#pragma unroll
    for (int f = 0; f < kRowBatch; ++f) {
      ok[f] = todo != 0;
      const int from = ok[f] ? __ffs(todo) - 1 : 0;
      todo &= todo - 1;
      const int rk = __shfl_sync(kFull, rank, from);
      src[f] = s.planes + static_cast<size_t>(rk) * s.w_seg;
      dst[f] = acc + static_cast<size_t>(blockIdx.x * kThreads + from) * w_out;
    }
    for (int c0 = 0; c0 < w; c0 += 2 * kThreads) {
      uint32_t p[kRowBatch][2];
#pragma unroll
      for (int f = 0; f < kRowBatch; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + lane + h * kThreads;
          p[f][h] = ok[f] && c < w ? __ldg(src[f] + c) : 0u;
        }
      // a reduction in L2 (no read of the accumulator on the SM); each
      // accumulator row belongs to one fingerprint, so no two lanes meet
#pragma unroll
      for (int f = 0; f < kRowBatch; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (p[f][h]) atomicOr(dst[f] + c0 + lane + h * kThreads, p[f][h]);
    }
  }
}

// host_levels: kMaxLevels level sizes, then kMaxLevels word offsets
Levels levels_of(const void* host_levels) {
  Levels lv;
  const auto* h = static_cast<const uint32_t*>(host_levels);
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.bits[l] = h[l];
    lv.word_offset[l] = h[kMaxLevels + l];
  }
  return lv;
}

Mphf mphf_of(const void* words, const void* block_rank, const void* level_bits,
             const void* level_word_offset, int n_levels, const void* fb_fps, const void* fb_idx,
             int fb_count) {
  return Mphf{static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(block_rank),
              static_cast<const int*>(level_bits), static_cast<const int*>(level_word_offset),
              n_levels, static_cast<const uint32_t*>(fb_fps), static_cast<const int*>(fb_idx),
              fb_count};
}

}  // namespace

extern "C" int sketch_probe_launch(const void* fps, int q, const void* words,
                                   const void* block_rank, const void* host_levels,
                                   const void* level_bits, const void* level_word_offset,
                                   int n_levels, const void* fb_fps, const void* fb_idx,
                                   int fb_count, void* out_idx, void* out_absent, void* stream) {
  if (q <= 0) return 0;
  probe_kernel<<<(q + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(fps), q, levels_of(host_levels),
      mphf_of(words, block_rank, level_bits, level_word_offset, n_levels, fb_fps, fb_idx,
              fb_count),
      static_cast<int*>(out_idx), static_cast<bool*>(out_absent));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sketch_match_launch(
    const void* fps, int q, const void* words, const void* block_rank, const void* host_levels,
    const void* level_bits, const void* level_word_offset, int n_levels, const void* fb_fps,
    const void* fb_idx, int fb_count, const void* signatures, int n_sig_words, int sig_bits,
    int n_tokens1, const void* bitseq, int n_bitseq_words, const void* lengths, int n_len_words,
    const void* samples, const void* planes, int w_seg, int n_lists1, void* acc, int w_out,
    void* stream) {
  if (q <= 0) return 0;
  const Sketch s{static_cast<const uint32_t*>(signatures), n_sig_words, sig_bits, n_tokens1,
                 static_cast<const uint32_t*>(bitseq), n_bitseq_words,
                 static_cast<const uint32_t*>(lengths), n_len_words,
                 static_cast<const long long*>(samples), static_cast<const uint32_t*>(planes),
                 w_seg, n_lists1};
  match_kernel<<<(q + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(fps), q, levels_of(host_levels),
      mphf_of(words, block_rank, level_bits, level_word_offset, n_levels, fb_fps, fb_idx,
              fb_count),
      s, static_cast<uint32_t*>(acc), w_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
