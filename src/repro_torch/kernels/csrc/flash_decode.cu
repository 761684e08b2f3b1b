// flash_decode: one-token GQA attention against a KV cache.
//   q (B, Hq, D), k/v caches (B, S, Hkv, D), cache_len -> (B, Hq, D) in q's
//   type; query head h reads kv head h / n_rep (n_rep = Hq / Hkv), scores
//   are the f32 dot times D^-0.5, soft-capped to cap * tanh(score / cap)
//   where a cap is given, only positions [lo, cache_len) take part (lo > 0
//   for a sliding window: lo = cache_len - window), and the output is
//   acc / max(l, 1e-30) of the online softmax (m, l, acc), all in f32.
//   Instantiated for bf16 (the LM paths) and f32.
//
// Replaces src/repro/kernels/flash_decode/kernel.py:68 flash_decode_pallas
// (_flash_decode_kernel).  The TPU kernel ran a (B, S / block_s) grid in
// order, carrying (m, l, acc) in revisited output blocks, with a wrapper
// that padded S to block_s and masked the pad through cache_len.  Blocks on
// an H100 run in no order, so the sequence axis becomes a loop inside a
// block plus a split over S (FlashDecoding): each block streams one range
// of positions for one (batch row, kv head) and writes a partial (m, l,
// acc) for its n_rep query rows; a second, small kernel merges the splits
// (launched as a programmatic dependent launch, so that its launch
// overlaps the first kernel's run).
// Only positions in [lo, cache_len) are read, so a ragged S needs no
// padding and a window is a shorter range, not a mask over the cache: the
// splits cut the cache_len - lo positions of the window and start at lo.
// (The TPU kernel had neither a window nor a cap; the JAX package decoded
// such layers with its plain jnp decode_attention, of which this kernel
// is the port's only form on the card.)  The soft-cap, where given, is a
// template flag of the bf16 kernel and a block-uniform branch of the f32
// one, so that the path without it runs the code it ran before.
//
// What bounds it on an H100: bytes.  Each cached K and V element is read
// once for n_rep query rows (2 * n_rep flops per element, about 4 flops per
// byte for llama3's n_rep = 4 in bf16, some 1.3% of the tensor cores'
// rate): 2 * B * cache_len * Hkv * D * 2 bytes / 3.35 TB/s, 0.32 ms at
// B = 8, cache_len = 32,768, Hkv = 8, D = 128 (under a window, the
// min(cache_len, window) positions it keeps).  Two things kept a simpler
// design (tile staged, wait, compute, repeat, all on the CUDA cores) below
// that bound: no load was in flight while a block computed, and each K/V
// element was unpacked from bf16 and multiplied once per query row, which
// took most of an SM's issue slots.  The bf16 kernel answers both:
//  - a ring of kStages 64-position K/V tiles in shared memory, kept full by
//    TMA: one thread loads a tile with one cp.async.bulk.tensor per 64
//    columns of K and of V (a tensor map over (D, Hkv, cache_len, B), so
//    positions past cache_len and columns past D arrive as zeros and are
//    never read from memory), completing on the slot's mbarrier.  The load
//    of tile t + kStages - 1 is issued before tile t is computed, so an SM
//    (two blocks at D = 128) keeps about 128 KB of K/V in flight.  The
//    tensor map's 128-byte swizzle keeps the fragment loads free of bank
//    conflicts.  (16-byte cp.async copies from every thread, the first
//    form of this ring, streamed a few percent slower.)
//  - both products on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
//    accumulate), fragments loaded by ldmatrix from the staged tiles.  Each
//    warp owns 16 positions of every tile.  Scores: S^T = K_tile . Q^T,
//    positions on M, D on K, the n_rep query rows of the kv head on N = 8
//    (zero padded; N-tiles when n_rep > 8), Q's fragments held in
//    registers.  Output: O^T += V_tile^T . P^T, D on M, positions on K, V
//    through ldmatrix.trans.  The score accumulator becomes P^T's operand
//    by one movmatrix.trans per 8 x 8 block.  P is rounded to bf16 before
//    that product, as the TPU kernel rounds p.astype(v.dtype); the running
//    (m, l, corr) stay in f32 registers, reduced across lanes by shuffles,
//    in base 2 (scores pre-scaled by log2 e).  Each warp keeps its own
//    (m, l, acc) over the split; the four are merged through shared memory
//    at the end.
// Each K/V element is thus read from shared memory once per tile for all
// n_rep rows, with nothing unpacked in the inner loop.  The wrapper's
// split_plan fills the card in whole waves of the blocks per SM that this
// shared-memory footprint allows.  The f32 instantiation keeps the simpler
// CUDA-core design (no ported model decodes in f32 on the card).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // cache positions per tile, 16 per warp in the bf16 kernel
constexpr int kStages = 3;      // tiles in the bf16 kernel's shared-memory ring
constexpr float kNegInf = -2.0e38f;
constexpr float kLn2 = 0.69314718055994531f;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------------------------- f32
constexpr int kMaxPairs = 4;    // accumulator pairs per thread: n_rep * D <= 1024

// floats of shared memory ahead of the K/V tiles, rounded to 16 bytes
__host__ __device__ __forceinline__ int head_floats(int n_rep, int d) {
  return (n_rep * (d + kTile + 3) + 3) & ~3;
}

__host__ __device__ __forceinline__ size_t f32_smem_bytes(int n_rep, int d) {
  return sizeof(float) * (head_floats(n_rep, d) + static_cast<size_t>(kTile) * (2 * d + 4));
}

// The f32 kernel: a 64-position tile of K and V staged in shared memory with
// 16-byte loads (K rows padded by 16 bytes against bank conflicts); the
// score pass gives each thread (query row, position) pairs, one warp per
// query row updates (m, l) and the tile's probabilities, and each thread
// keeps up to 4 (query row, pair of D) accumulators in registers.
__global__ void __launch_bounds__(kThreads)
flash_decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, int s_len, int hkv, int n_rep, int d,
                        int lo, int cache_len, int chunk, float scale, float cap,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ acc_out) {
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int b = blockIdx.y / hkv, h = blockIdx.y % hkv;
  const int hq = hkv * n_rep, dv = d / 4, kstride = d + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [n_rep][d]
  float* p_s = q_s + n_rep * d;                 // [n_rep][kTile] scores, then probabilities
  float* m_s = p_s + n_rep * kTile;             // [n_rep] running max
  float* l_s = m_s + n_rep;                     // [n_rep] running sum
  float* c_s = l_s + n_rep;                     // [n_rep] this tile's correction
  float* k_s = q_s + head_floats(n_rep, d);     // [kTile][d + 4]
  float* v_s = k_s + kTile * kstride;           // [kTile][d]

  const long long q_row = static_cast<long long>(b) * hq + static_cast<long long>(h) * n_rep;
  for (int i = threadIdx.x; i < n_rep * d; i += kThreads) q_s[i] = q[q_row * d + i];
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
  const int s_begin = lo + split * chunk;
  const int s_end = min(s_begin + chunk, cache_len);
  __syncthreads();

  for (int t0 = s_begin; t0 < s_end; t0 += kTile) {
    const int n = min(kTile, s_end - t0);
    // stage positions [t0, t0 + n) of this kv head
    for (int i = threadIdx.x; i < n * dv; i += kThreads) {
      const int j = i / dv, c = i - j * dv;
      const long long off = base + (t0 + j) * pos_stride + c * 4;
      const float4 kk = __ldg(reinterpret_cast<const float4*>(k + off));
      const float4 vv = __ldg(reinterpret_cast<const float4*>(v + off));
      *reinterpret_cast<float4*>(k_s + j * kstride + c * 4) = kk;
      *reinterpret_cast<float4*>(v_s + j * d + c * 4) = vv;
    }
    __syncthreads();
    // scores: (query row g, position j) pairs
    for (int i = threadIdx.x; i < n_rep * kTile; i += kThreads) {
      const int g = i / kTile, j = i - g * kTile;
      float s = kNegInf;
      if (j < n) {
        const float4* kr = reinterpret_cast<const float4*>(k_s + j * kstride);
        const float* qr = q_s + g * d;
        float dot = 0.f;
        for (int c = 0; c < dv; ++c) {
          const float4 kk = kr[c];
          const float4 qq = *reinterpret_cast<const float4*>(qr + c * 4);
          dot = fmaf(kk.x, qq.x, dot);
          dot = fmaf(kk.y, qq.y, dot);
          dot = fmaf(kk.z, qq.z, dot);
          dot = fmaf(kk.w, qq.w, dot);
        }
        s = dot * scale;
        if (cap > 0.f) s = cap * tanhf(s / cap);  // uniform across the block
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax: one warp per query row
    for (int g = warp; g < n_rep; g += kWarps) {
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
          const float2 vv = *reinterpret_cast<const float2*>(v_s + j * d + dd);
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

// ------------------------------------------------------------------- bf16
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16 x 16, row major) . b (16 x 8, column major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a ring slot's mbarrier: set up, armed with the bytes its loads bring,
// waited on for the phase of one fill
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// one box of a tensor map at coordinates (c0, c1, c2, c3), global ->
// shared, completing on the mbarrier `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// the 8 x 8 bf16 matrix held one row per 4 lanes, transposed across the warp
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// two f32 rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A staged tile is kept as boxes of 64 columns (128 bytes) x kTile rows,
// as the tensor map cuts it, ceil(D / 64) boxes for K and as many for V.
constexpr int kBoxBytes = 128 * kTile;

// Shared memory the bf16 kernel works in: the ring, or the per-warp
// partials merged at the end (NT * 8 rows of D rounded up to 16, plus m
// and l), whichever is larger.
__host__ __device__ __forceinline__ size_t bf16_work_bytes(int nt, int d) {
  const size_t ring = 2ull * kStages * ((d + 63) / 64) * kBoxBytes;
  const size_t merge = sizeof(float) * kWarps * nt * 8 * (((d + 15) & ~15) + 2);
  return ring > merge ? ring : merge;
}
// ... plus the ring's mbarriers, and room to align the ring to the 1024
// bytes that the 128-byte swizzle needs
__host__ __device__ __forceinline__ size_t bf16_smem_bytes(int nt, int d) {
  return 1023 + bf16_work_bytes(nt, d) + 8 * kStages;
}

// NT N-tiles of 8 query rows (n_rep <= 8 NT); D <= 16 MF.  Scores enter
// the base-2 softmax as dot * scale_log2 or, with CAP, as
// cap_log2 * tanh(dot * cap_in) (cap_in = scale / cap, cap_log2 =
// cap * log2 e): the cap is taken on the base-e score, before the base-2
// pre-scale.
template <int NT, int MF, bool CAP>
__global__ void __launch_bounds__(kThreads)
flash_decode_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, int hkv, int n_rep,
                         int d, int lo, int cache_len, int chunk, float scale_log2,
                         float cap_in, float cap_log2, float* __restrict__ m_out,
                         float* __restrict__ l_out, float* __restrict__ acc_out) {
  constexpr int kRows = NT * 8;  // query rows of the N-tiles, n_rep of them real
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int b = blockIdx.y / hkv, h = blockIdx.y % hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // an mma fragment's row and column pair
  const int dp = (d + 15) & ~15;          // D padded to whole mma steps
  const int steps = dp >> 4;              // mma steps over D (<= MF)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring_s = smem_u32(smem);  // [kStages][K, V][box][kTile rows][128 bytes]
  const int boxes = (d + 63) / 64;
  const uint32_t v_bytes = boxes * kBoxBytes;              // V's offset in a stage
  const uint32_t stage_bytes = 2 * v_bytes;
  const uint32_t bar0 = ring_s + static_cast<uint32_t>(bf16_work_bytes(NT, d));  // [kStages]

  const long long q_row = (static_cast<long long>(b) * hkv + h) * n_rep;
  // a window's first split starts at lo, off the 64-position tile: the
  // tensor map takes boxes at any position
  const int s_begin = lo + split * chunk;
  const int s_end = min(s_begin + chunk, cache_len);
  const int n_tiles = (s_end - s_begin + kTile - 1) / kTile;

  // one mbarrier per ring slot; thread 0 copies a tile into its slot with
  // one TMA load per box of K and of V, the barrier counting the bytes
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int tile) {
    if (threadIdx.x != 0 || tile >= n_tiles) return;
    const uint32_t bar = bar0 + 8 * (tile % kStages);
    const uint32_t dst = ring_s + (tile % kStages) * stage_bytes;
    const int t0 = s_begin + tile * kTile;
    mbar_expect_tx(bar, stage_bytes);  // out-of-range rows and columns count too, as zeros
    for (int x = 0; x < boxes; ++x) {
      tma_load_4d(dst + x * kBoxBytes, &tk, x * 64, h, t0, b, bar);
      tma_load_4d(dst + v_bytes + x * kBoxBytes, &tv, x * 64, h, t0, b, bar);
    }
  };

  // Q^T's fragments, f32-exact bf16 as stored: row nt * 8 + g, columns
  // 16 kk + 2t (+1) and 16 kk + 8 + 2t (+1); zero past n_rep and past D
  uint32_t qf[NT][MF][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int row = nt * 8 + g;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(q + (q_row + row) * d);
#pragma unroll
    for (int kk = 0; kk < MF; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[nt][kk][0] = row < n_rep && c < d ? qr[c / 2] : 0u;
      qf[nt][kk][1] = row < n_rep && c + 8 < d ? qr[c / 2 + 4] : 0u;
    }
  }

  // per warp, base-2 online softmax state of rows nt * 8 + 2t (+1), and
  // O^T's accumulators: acc[nt][mf] holds rows (d) 16 mf + g (+8), columns
  // (query rows) nt * 8 + 2t (+1)
  float m[NT][2], l[NT][2], acc[NT][MF][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m[nt][0] = m[nt][1] = kNegInf;
    l[nt][0] = l[nt][1] = 0.f;
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) acc[nt][mf][0] = acc[nt][mf][1] = acc[nt][mf][2] = acc[nt][mf][3] = 0.f;
  }
  // ldmatrix row addresses of this lane within a stage, for mma step kk
  // (D 16 kk ..): matrix lane / 8 of four; K's are (positions 0-7, 8-15)
  // x (D 0-7) then x (D 8-15), V's (transposed) (D 0-7, 8-15) x
  // (positions 0-7) then x (positions 8-15).  A box keeps the 128-byte
  // swizzle: 16-byte chunk c of row r sits at chunk c ^ (r & 7), and the
  // rows this lane reads have r & 7 = r8, so no two lanes of a matrix hit
  // one bank.
  const int mat = lane >> 3, r8 = lane & 7;
  const uint32_t k_row = (16 * warp + r8 + (mat & 1) * 8) * 128;
  const uint32_t v_row = v_bytes + (16 * warp + r8 + (mat >> 1) * 8) * 128;
  auto k_addr = [&](uint32_t stage, int kk) {
    return stage + (kk >> 2) * kBoxBytes + k_row + ((((kk * 2) & 7) + (mat >> 1)) ^ r8) * 16;
  };
  auto v_addr = [&](uint32_t stage, int mf) {
    return stage + (mf >> 2) * kBoxBytes + v_row + ((((mf * 2) & 7) + (mat & 1)) ^ r8) * 16;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();  // every warp is done with tile - 1: its slot takes tile + kStages - 1
    issue(tile + kStages - 1);
    mbar_wait(bar0 + 8 * (tile % kStages), (tile / kStages) & 1);  // tile's bytes landed
    const int valid = s_end - (s_begin + tile * kTile) - 16 * warp;  // this warp's positions
    if (valid <= 0) continue;
    const uint32_t stage = ring_s + (tile % kStages) * stage_bytes;

    // S^T (16 positions x 8 rows per N-tile) = K_tile . Q^T
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MF; ++kk) {
      if (kk < steps) {
        uint32_t a[4];
        ldmatrix_x4(a, k_addr(stage, kk));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(sc[nt], a, qf[nt][kk][0], qf[nt][kk][1]);
      }
    }

    // online softmax over this warp's 16 positions (g and g + 8) for rows
    // 2t and 2t + 1; the 8 lanes of one t hold one row's positions
    const bool ok0 = g < valid, ok1 = g + 8 < valid;
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if constexpr (CAP) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = cap_log2 * tanhf(sc[nt][e] * cap_in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] *= scale_log2;
      }
      const float x0 = ok0 ? sc[nt][0] : kNegInf;
      const float x1 = ok0 ? sc[nt][1] : kNegInf;
      const float x2 = ok1 ? sc[nt][2] : kNegInf;
      const float x3 = ok1 ? sc[nt][3] : kNegInf;
      float mx0 = fmaxf(x0, x2), mx1 = fmaxf(x1, x3);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, off));
      }
      const float mn0 = fmaxf(m[nt][0], mx0), mn1 = fmaxf(m[nt][1], mx1);
      const float c0 = exp2f(m[nt][0] - mn0), c1 = exp2f(m[nt][1] - mn1);
      const float p0 = ok0 ? exp2f(x0 - mn0) : 0.f, p1 = ok0 ? exp2f(x1 - mn1) : 0.f;
      const float p2 = ok1 ? exp2f(x2 - mn0) : 0.f, p3 = ok1 ? exp2f(x3 - mn1) : 0.f;
      l[nt][0] = l[nt][0] * c0 + (p0 + p2);
      l[nt][1] = l[nt][1] * c1 + (p1 + p3);
      m[nt][0] = mn0;
      m[nt][1] = mn1;
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        acc[nt][mf][0] *= c0;
        acc[nt][mf][1] *= c1;
        acc[nt][mf][2] *= c0;
        acc[nt][mf][3] *= c1;
      }
      // P^T's B fragment: positions 2t (+1) and 8 + 2t (+1) of row g
      pb[nt][0] = transpose8x8(pack_bf16(p0, p1));
      pb[nt][1] = transpose8x8(pack_bf16(p2, p3));
    }

    // O^T (D x 8 rows per N-tile) += V_tile^T . P^T
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      if (mf < steps) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, v_addr(stage, mf));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][mf], a, pb[nt][0], pb[nt][1]);
      }
    }
  }

  // merge the four warps' (m, l, acc) through shared memory
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem);       // [warp][kRows][dp]
  float* ml_s = acc_s + kWarps * kRows * dp;           // [warp][kRows][m, l]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float sum = l[nt][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
      if (g == 0) {
        float* ml = ml_s + (warp * kRows + nt * 8 + 2 * t + e) * 2;
        ml[0] = m[nt][e];
        ml[1] = sum;
      }
    }
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      if (mf < steps) {
        float* o = acc_s + (warp * kRows + nt * 8 + 2 * t) * dp + mf * 16 + g;
        o[0] = acc[nt][mf][0];
        o[dp] = acc[nt][mf][1];
        o[8] = acc[nt][mf][2];
        o[dp + 8] = acc[nt][mf][3];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rep * d; i += kThreads) {
    const int row = i / d, c = i - row * d;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[(w * kRows + row) * 2]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ml = ml_s + (w * kRows + row) * 2;
      const float f = exp2f(ml[0] - mx);
      num += acc_s[(w * kRows + row) * dp + c] * f;
      den += ml[1] * f;
    }
    const long long o = (q_row + row) * n_splits + split;
    acc_out[o * d + c] = num;
    if (c == 0) {
      m_out[o] = mx * kLn2;  // the merge kernel works in base e
      l_out[o] = den;
    }
  }
}

// out[row] = sum_i acc_i * e^(m_i - M) / max(sum_i l_i * e^(m_i - M), 1e-30)
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ m_in,
                                            const float* __restrict__ l_in,
                                            const float* __restrict__ acc_in, int n_splits,
                                            int d, T* __restrict__ out) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split kernel's partials
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

struct Args {
  const void *q, *k, *v;
  int b, s_len, hkv, n_rep, d, lo, cache_len, chunk, n_splits;
  float scale, cap;  // cap 0: no soft-cap
  float *m, *l, *acc;
  void* out;
  cudaStream_t stream;
};

// the bf16 kernel's instantiation for (n_rep, D, cap): NT the power of two
// >= n_rep / 8; MF 8 (D <= 128) or 16 when NT is 1, else 16 / NT, which
// n_rep * D <= 1024 always leaves room for
template <bool CAP, typename F> int with_bf16_kernel_of(int n_rep, int d, F&& f) {
  const int nt = (n_rep + 7) / 8;
  if (nt == 1) return d <= 128 ? f(flash_decode_bf16_kernel<1, 8, CAP>, 1)
                               : f(flash_decode_bf16_kernel<1, 16, CAP>, 1);
  if (nt <= 2) return f(flash_decode_bf16_kernel<2, 8, CAP>, 2);
  if (nt <= 4) return f(flash_decode_bf16_kernel<4, 4, CAP>, 4);
  if (nt <= 8) return f(flash_decode_bf16_kernel<8, 2, CAP>, 8);
  return f(flash_decode_bf16_kernel<16, 1, CAP>, 16);
}
template <typename F> int with_bf16_kernel(int n_rep, int d, bool cap, F&& f) {
  return cap ? with_bf16_kernel_of<true>(n_rep, d, f) : with_bf16_kernel_of<false>(n_rep, d, f);
}

// cuTensorMapEncodeTiled, a driver function, reached through the runtime
// so that the library needs no link to the driver
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// K or V as (D, Hkv, cache_len, B), boxes of 64 columns x 1 head x kTile
// positions, 128-byte swizzled, the L2 fetching 256 bytes at a time;
// positions >= cache_len and columns >= D read as zero
int kv_map(CUtensorMap* map, const void* base, int b, int s_len, int hkv, int d, int cache_len) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || !fn) return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(hkv),
                              static_cast<cuuint64_t>(cache_len), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {2ull * d, 2ull * hkv * d, 2ull * s_len * hkv * d};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename K> int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

int launch_split(const Args& a, bool bf16) {
  const dim3 grid(a.n_splits, a.b * a.hkv);
  if (!bf16) {
    const size_t smem = f32_smem_bytes(a.n_rep, a.d);
    if (int err = allow_smem(flash_decode_f32_kernel, smem)) return err;
    flash_decode_f32_kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), a.s_len, a.hkv, a.n_rep, a.d, a.lo, a.cache_len,
        a.chunk, a.scale, a.cap, a.m, a.l, a.acc);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr float kLog2e = 1.4426950408889634f;
  CUtensorMap tk, tv;
  if (int err = kv_map(&tk, a.k, a.b, a.s_len, a.hkv, a.d, a.cache_len)) return err;
  if (int err = kv_map(&tv, a.v, a.b, a.s_len, a.hkv, a.d, a.cache_len)) return err;
  const bool cap = a.cap > 0.f;
  const float cap_in = cap ? a.scale / a.cap : 0.f, cap_log2 = a.cap * kLog2e;
  return with_bf16_kernel(a.n_rep, a.d, cap, [&](auto kernel, int nt) {
    const size_t smem = bf16_smem_bytes(nt, a.d);
    if (int err = allow_smem(kernel, smem)) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), tk, tv, a.hkv, a.n_rep, a.d, a.lo,
        a.cache_len, a.chunk, a.scale * kLog2e, cap_in, cap_log2, a.m, a.l, a.acc);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// bf16: 1 for bfloat16 tensors, 0 for float32.  The wrapper checks the
// contract: D % 8 == 0, D <= 256, n_rep * D <= 1024, 0 <= lo < cache_len <=
// S, cap 0 (none) or > 0, contiguous 16-byte-aligned tensors, and splits
// of `chunk` positions from lo that are all non-empty; m/l hold
// B * Hq * n_splits floats, acc that times D.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, int bf16, int b,
                                   int s_len, int hkv, int n_rep, int d, int lo, int cache_len,
                                   int chunk, int n_splits, float scale, float cap, void* m_buf,
                                   void* l_buf, void* acc_buf, void* out, void* stream) {
  const Args a{q, k, v, b, s_len, hkv, n_rep, d, lo, cache_len, chunk, n_splits, scale, cap,
               static_cast<float*>(m_buf), static_cast<float*>(l_buf),
               static_cast<float*>(acc_buf), out, static_cast<cudaStream_t>(stream)};
  if (int err = launch_split(a, bf16 != 0)) return err;
  const int rows = b * hkv * n_rep;
  // a programmatic dependent launch: the merge kernel is set up while the
  // split kernel runs and waits for it in griddepcontrol.wait
  cudaLaunchAttribute overlap;
  overlap.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = a.stream;
  cfg.attrs = &overlap;
  cfg.numAttrs = 1;
  const float *m = a.m, *l = a.l, *acc = a.acc;
  const cudaError_t err =
      bf16 ? cudaLaunchKernelEx(&cfg, flash_decode_combine_kernel<__nv_bfloat16>, m, l, acc,
                                n_splits, d, static_cast<__nv_bfloat16*>(out))
           : cudaLaunchKernelEx(&cfg, flash_decode_combine_kernel<float>, m, l, acc, n_splits, d,
                                static_cast<float*>(out));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Blocks of the split kernel that one SM holds at once for (n_rep, D, cap
// or none), as the CUDA runtime computes it from registers and shared
// memory: the wrapper's split plan fills the card in waves of this many
// blocks per SM.
extern "C" int flash_decode_blocks_per_sm(int bf16, int n_rep, int d, int cap, int* out) {
  if (!bf16) {
    const size_t smem = f32_smem_bytes(n_rep, d);
    if (int err = allow_smem(flash_decode_f32_kernel, smem)) return err;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, flash_decode_f32_kernel, kThreads, smem));
  }
  return with_bf16_kernel(n_rep, d, cap != 0, [&](auto kernel, int nt) {
    const size_t smem = bf16_smem_bytes(nt, d);
    if (int err = allow_smem(kernel, smem)) return err;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads, smem));
  });
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
