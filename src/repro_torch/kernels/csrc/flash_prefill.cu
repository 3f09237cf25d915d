// Causal GQA flash attention for prefill on Hopper (sm_90a): bf16 on the
// tensor cores (wgmma), f32 on CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_prefill` (`_flash_kernel`) in
// src/repro/kernels/flash_prefill/kernel.py, extended with per-row query
// offsets so that it also serves continuation chunks: row b's queries sit at
// absolute positions q_start[b] .. q_start[b] + Sq - 1 and attend keys
// [0, kv_len[b]) under the causal (and optional sliding-window) mask. With
// q_start = 0 and kv_len = Skv it is the Pallas kernel's function. KV head
// of query head h is h / (H / KH); the softmax runs online in f32 with the
// finite NEG_INF mask.
//
// Layouts (all contiguous):
//   q       (B, H, Sq, dh)    k, v (B, KH, Skv, dh)    out (B, H, Sq, dh)
//   q_start (B,) int32        kv_len (B,) int32
//
// What bounds it on the H100: operations, 4 * dh flops per unmasked
// (query, key) pair, against the dense tensor-core rate (989 TFLOP/s in
// bf16) for long prompts; at 128-token prompts the bytes of Q, K, V and the
// output weigh more (the bound is then set by bytes). The bf16 design (the
// served dtype; dh 32, 64 or 128):
//
// * A grid over (Sq / 64, H, B), heaviest query tiles first; one
//   warpgroup per block owns 64 query rows.
// * Q and 32-row K/V tiles sit in bf16 in 128-byte-swizzled shared memory
//   (hopper.cuh), loaded with 16-byte cp.async; K/V are double-buffered,
//   so tile t+1 loads while tile t is multiplied, with one __syncthreads
//   per tile. At dh 128 that is 49 KB and 114 registers a thread: four
//   blocks share an SM, so the record's 384 blocks run in one wave.
// * S = Q K^T is a chain of wgmma m64n32k16 from shared memory (K's
//   row-major (Skv, dh) layout is already K-major for B). The mask and the
//   online softmax run on the accumulator fragments in registers (row max
//   and sum by quad shuffles, in the log2 domain); no score tile touches
//   shared memory. P is rounded to bf16 in registers, where the
//   accumulator layout is already wgmma's A-fragment layout, and
//   O += P V is a chain of wgmma m64n{64,128}k16 with V from shared memory
//   as an MN-major B.
// * Tiles wholly above the diagonal or outside the window are never
//   loaded; tiles wholly inside both skip the per-element mask.
//
// MLA's prefill (flash_prefill_mla_kernel, the same body) attends with
// query and key rows wider than the value rows: QK 192 columns (nope 128 and
// rope 64), V and the output 128. Q and the two K stages take 192-column
// tiles and the two V stages 128-column ones, 65 KB in all: three blocks
// share an SM. The equal-width instances are the body at DV = DH.
//
// The f32 instantiation (used by the f32 parity checks only) keeps the
// CUDA-core body: f32 tiles in shared memory, a 16 x 16 thread grid,
// serial softmax statistics.
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro_kernels;

// ------------------------------------------------- f32: CUDA-core kernel
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // a 16 x 16 thread grid over the tiles

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)kBlockQ * (DH + 1) + (size_t)kBlockK * (DH + 1) +
         (size_t)kBlockK * DH + (size_t)kBlockQ * (kBlockK + 1) + 3 * kBlockQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int* __restrict__ q_start,
                     const int* __restrict__ kv_len, T* __restrict__ out,
                     int heads, int kv_heads, int seq_q, int seq_k, int causal,
                     int window, float scale) {
  constexpr int QS = DH + 1;        // padded row stride of the Q and K tiles
  constexpr int SS = kBlockK + 1;   // padded row stride of the score tile
  constexpr int CPT = DH / 16;      // output columns per thread

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  extern __shared__ float smem[];
  float* q_s = smem;                      // kBlockQ x QS
  float* k_s = q_s + kBlockQ * QS;        // kBlockK x QS
  float* v_s = k_s + kBlockK * QS;        // kBlockK x DH
  float* s_s = v_s + kBlockK * DH;        // kBlockQ x SS
  float* m_s = s_s + kBlockQ * SS;        // kBlockQ
  float* l_s = m_s + kBlockQ;             // kBlockQ
  float* c_s = l_s + kBlockQ;             // kBlockQ

  const int pos0 = q_start[b];
  const int klen = min(kv_len[b], seq_k);
  const T* qb = q + ((size_t)b * heads + h) * (size_t)seq_q * DH;
  const T* kb = k + ((size_t)b * kv_heads + kh) * (size_t)seq_k * DH;
  const T* vb = v + ((size_t)b * kv_heads + kh) * (size_t)seq_k * DH;
  T* ob = out + ((size_t)b * heads + h) * (size_t)seq_q * DH;

  for (int i = tid; i < kBlockQ * DH; i += kThreads) {
    const int r = i / DH;
    const int d = i - r * DH;
    q_s[r * QS + d] = (q0 + r < seq_q) ? to_f32(qb[(size_t)(q0 + r) * DH + d])
                                       : 0.f;
  }
  if (tid < kBlockQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  // key tiles this query tile can see
  const int rows = min(kBlockQ, seq_q - q0);
  int hi = klen;
  if (causal) hi = min(hi, pos0 + q0 + rows);
  int lo = 0;
  if (window > 0) lo = max(0, pos0 + q0 - window + 1);
  const int t_lo = lo / kBlockK;
  const int t_hi = hi > 0 ? (hi + kBlockK - 1) / kBlockK : 0;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBlockK * DH; i += kThreads) {
      const int r = i / DH;
      const int d = i - r * DH;
      const bool ok = k0 + r < seq_k;
      const size_t src = (size_t)(k0 + r) * DH + d;
      k_s[r * QS + d] = ok ? to_f32(kb[src]) : 0.f;
      v_s[r * DH + d] = ok ? to_f32(vb[src]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < DH; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = k_s[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * c[j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = pos0 + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        bool valid = kpos < klen && q0 + r < seq_q;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && qpos - kpos < window;
        s_s[r * SS + c] = valid ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax statistics, one thread per query row
    if (tid < kBlockQ) {
      float* row = s_s + tid * SS;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int c = 0; c < kBlockK; ++c) m_new = fmaxf(m_new, row[c]);
      float sum = 0.f;
      for (int c = 0; c < kBlockK; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      c_s[tid] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < kBlockK; ++c) {
      float p[4], w[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) w[j] = v_s[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] += p[i] * w[j];
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r < seq_q) {
      const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        ob[(size_t)(q0 + r) * DH + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
      }
    }
  }
}
template <int DH>
int launch_f32(const void* q, const void* k, const void* v,
               const void* q_start, const void* kv_len, void* out, int batch,
               int heads, int kv_heads, int seq_q, int seq_k, int causal,
               int window, float scale, cudaStream_t stream) {
  constexpr int smem = (int)(sizeof(float) * smem_floats<DH>());
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_kernel<float, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_prefill_kernel<float, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_start),
      static_cast<const int*>(kv_len), static_cast<float*>(out), heads,
      kv_heads, seq_q, seq_k, causal, window, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16: wgmma kernel
using bf16 = __nv_bfloat16;
constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kTileQ = 64;       // query rows per block (wgmma's M)
constexpr int kTileK = 32;       // key rows per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct WgTiles {
  static constexpr int kCols = DH < 64 ? 64 : DH;  // stored width
  static constexpr int kQBytes = kTileQ * kCols * 2;
  static constexpr int kKBytes = kTileK * kCols * 2;
  static constexpr int kOutRegs = kCols / 2;  // m64 x kCols f32 accumulator
  static constexpr int kSRegs = kTileK / 2;   // m64 x kTileK f32 scores
};

// Rows row0 .. row0 + ROWS - 1 of a (rows, DH) bf16 matrix into a swizzled
// tile; rows at or past n_rows are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int row0, int n_rows, int tid) {
  constexpr int kChunks = DH / 8;
  for (int i = tid; i < ROWS * kChunks; i += kWgThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const bool ok = row0 + r < n_rows;
    cp_async_16(dst + swizzled_offset(ROWS, r, c),
                src + (size_t)(ok ? row0 + r : 0) * DH + c * 8, ok ? 16 : 0);
  }
}

// s = Q K^T over a 64-row Q tile and a kTileK-row K tile (both swizzled).
template <int DH>
__device__ __forceinline__ void qk_product(float (&s)[WgTiles<DH>::kSRegs],
                                           uint32_t q_tile, uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const uint32_t col = (ks & 3) * 32;  // 16 columns within a 64-col block
    wgmma_ss(
        s, wgmma_desc(q_tile + (ks >> 2) * (kTileQ * 128) + col, 16, 1024),
        wgmma_desc(k_tile + (ks >> 2) * (kTileK * 128) + col, 16, 1024),
        ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// o += P V: P as kTileK / 16 k-steps of A fragments, V a swizzled
// kTileK-row tile.
template <int DH>
__device__ __forceinline__ void pv_product(
    float (&o)[WgTiles<DH>::kOutRegs], const uint32_t (&a)[kTileK / 16][4],
    uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    const uint64_t desc =
        wgmma_desc(v_tile + kk * 16 * 128, kTileK * 128, 1024);
    wgmma_rs_mn(o, a[kk], desc);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// Probabilities (the score accumulator's registers) as bf16 A fragments.
__device__ __forceinline__ void pack_p(const float (&p)[kTileK / 2],
                                       uint32_t (&a)[kTileK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[kk][i] = pack_bf16(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1]);
    }
  }
}

// The first 1024-byte boundary in the block's dynamic shared memory.
__device__ __forceinline__ uint32_t aligned_smem(unsigned char* raw) {
  return (smem_addr(raw) + 1023u) & ~1023u;
}

// The bf16 kernel's body: query and key rows of DH columns, value and
// output rows of DV.
template <int DH, int DV>
__device__ __forceinline__ void flash_prefill_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ q_start,
    const int* __restrict__ kv_len, bf16* __restrict__ out, int heads,
    int kv_heads, int seq_q, int seq_k, int causal, int window,
    float scale_log2) {
  using Ti = WgTiles<DH>;
  using Tv = WgTiles<DV>;
  constexpr int NS = Ti::kSRegs;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ unsigned char wg_smem[];
  const uint32_t q_tile = aligned_smem(wg_smem);
  const uint32_t k_tiles = q_tile + Ti::kQBytes;        // two stages
  const uint32_t v_tiles = k_tiles + 2 * Ti::kKBytes;   // two stages

  const int pos0 = q_start[b];
  const int klen = min(kv_len[b], seq_k);
  const bf16* qb = q + ((size_t)b * heads + h) * (size_t)seq_q * DH;
  const bf16* kb = k + ((size_t)b * kv_heads + kh) * (size_t)seq_k * DH;
  const bf16* vb = v + ((size_t)b * kv_heads + kh) * (size_t)seq_k * DV;
  bf16* ob = out + ((size_t)b * heads + h) * (size_t)seq_q * DV;

  // key tiles this query tile can see
  const int rows = min(kTileQ, seq_q - q0);
  int hi = klen;
  if (causal) hi = min(hi, pos0 + q0 + rows);
  const int lo = window > 0 ? max(0, pos0 + q0 - window + 1) : 0;
  const int t_lo = lo / kTileK;
  const int t_hi = hi > 0 ? (hi + kTileK - 1) / kTileK : 0;

  load_tile<DH, kTileQ>(q_tile, qb, q0, seq_q, tid);
  if (t_lo < t_hi) {
    load_tile<DH, kTileK>(k_tiles, kb, t_lo * kTileK, seq_k, tid);
    load_tile<DV, kTileK>(v_tiles, vb, t_lo * kTileK, seq_k, tid);
  }
  cp_async_commit();

  // this thread's accumulator rows r0 and r0 + 8, columns c0 + 8 j + {0, 1}
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float o[Tv::kOutRegs];
#pragma unroll
  for (int j = 0; j < Tv::kOutRegs; ++j) o[j] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile t visible; everyone is done with tile t-1
    if (t + 1 < t_hi) {
      load_tile<DH, kTileK>(k_tiles + (st ^ 1) * Ti::kKBytes, kb,
                            (t + 1) * kTileK, seq_k, tid);
      load_tile<DV, kTileK>(v_tiles + (st ^ 1) * Tv::kKBytes, vb,
                            (t + 1) * kTileK, seq_k, tid);
    }
    cp_async_commit();

    float s[NS];
    qk_product<DH>(s, q_tile, k_tiles + st * Ti::kKBytes);

    const int k0 = t * kTileK;
    const bool full = k0 + kTileK <= klen &&
                      (!causal || k0 + kTileK - 1 <= pos0 + q0) &&
                      (window <= 0 || pos0 + q0 + kTileQ - 1 - k0 < window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float x = s[j] * scale_log2;
      if (!full) {
        const int qpos = pos0 + q0 + r0 + 8 * ((j >> 1) & 1);
        const int kpos = k0 + 8 * (j >> 2) + c0 + (j & 1);
        bool valid = kpos < klen;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && qpos - kpos < window;
        x = valid ? x : kNegInf;
      }
      s[j] = x;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j] = exp2f(s[j] - m[(j >> 1) & 1]);
      l[(j >> 1) & 1] += s[j];
    }
#pragma unroll
    for (int j = 0; j < Tv::kOutRegs; ++j) o[j] *= corr[(j >> 1) & 1];
    uint32_t a[kTileK / 16][4];
    pack_p(s, a);
    pv_product<DV>(o, a, v_tiles + st * Tv::kKBytes);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + r0 + 8 * r;
    if (row < seq_q) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * DV + 8 * c +
                                           c0) =
            __floats2bfloat162_rn(o[4 * c + 2 * r] * inv,
                                  o[4 * c + 2 * r + 1] * inv);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads)
flash_prefill_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const int* __restrict__ q_start,
                           const int* __restrict__ kv_len,
                           bf16* __restrict__ out, int heads, int kv_heads,
                           int seq_q, int seq_k, int causal, int window,
                           float scale_log2) {
  flash_prefill_wgmma<DH, DH>(q, k, v, q_start, kv_len, out, heads, kv_heads,
                              seq_q, seq_k, causal, window, scale_log2);
}

// MLA's non-absorbed prefill: query and key rows of DH columns (nope and
// rope parts), value and output rows of DV.
template <int DH, int DV>
__global__ void __launch_bounds__(kWgThreads)
flash_prefill_mla_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int* __restrict__ q_start,
                         const int* __restrict__ kv_len,
                         bf16* __restrict__ out, int heads, int kv_heads,
                         int seq_q, int seq_k, int causal, int window,
                         float scale_log2) {
  flash_prefill_wgmma<DH, DV>(q, k, v, q_start, kv_len, out, heads, kv_heads,
                              seq_q, seq_k, causal, window, scale_log2);
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* q_start, const void* kv_len, void* out, int batch,
                int heads, int kv_heads, int seq_q, int seq_k, int causal,
                int window, float scale, cudaStream_t stream) {
  using Ti = WgTiles<DH>;
  constexpr int smem = Ti::kQBytes + 4 * Ti::kKBytes + 1024;  // + alignment
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_wgmma_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq_q + kTileQ - 1) / kTileQ, heads, batch);
  flash_prefill_wgmma_kernel<DH><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_start),
      static_cast<const int*>(kv_len), static_cast<bf16*>(out), heads,
      kv_heads, seq_q, seq_k, causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int DH, int DV>
int launch_mla(const void* q, const void* k, const void* v,
               const void* q_start, const void* kv_len, void* out, int batch,
               int heads, int kv_heads, int seq_q, int seq_k, int causal,
               int window, float scale, cudaStream_t stream) {
  constexpr int smem = WgTiles<DH>::kQBytes + 2 * WgTiles<DH>::kKBytes +
                       2 * WgTiles<DV>::kKBytes + 1024;  // + alignment
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_mla_kernel<DH, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq_q + kTileQ - 1) / kTileQ, heads, batch);
  flash_prefill_mla_kernel<DH, DV><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_start),
      static_cast<const int*>(kv_len), static_cast<bf16*>(out), heads,
      kv_heads, seq_q, seq_k, causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

// The kernel's two products on one 64-row query tile, to hold the
// shared-memory layout and the wgmma descriptors against plain matrix
// products: for Q, K, V of 64 x DH, walked in kTileK-row key tiles as the
// kernel walks them, s = Q K^T (64 x 64, f32) and o = bf16(s) V (64 x DH,
// f32).
template <int DH>
__global__ void __launch_bounds__(kWgThreads)
wgmma_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, float* __restrict__ s_out,
                  float* __restrict__ o_out) {
  using Ti = WgTiles<DH>;
  constexpr int kKeyTiles = kTileQ / kTileK;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t q_tile = aligned_smem(wg_smem);
  const uint32_t k_tiles = q_tile + Ti::kQBytes;
  const uint32_t v_tiles = k_tiles + kKeyTiles * Ti::kKBytes;
  const int tid = threadIdx.x;
  load_tile<DH, kTileQ>(q_tile, q, 0, kTileQ, tid);
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) {
    load_tile<DH, kTileK>(k_tiles + t * Ti::kKBytes, k, t * kTileK, kTileQ,
                          tid);
    load_tile<DH, kTileK>(v_tiles + t * Ti::kKBytes, v, t * kTileK, kTileQ,
                          tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int c0 = 2 * (tid & 3);
  float o[Ti::kOutRegs];
#pragma unroll
  for (int j = 0; j < Ti::kOutRegs; ++j) o[j] = 0.f;
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) {
    float s[Ti::kSRegs];
    qk_product<DH>(s, q_tile, k_tiles + t * Ti::kKBytes);
#pragma unroll
    for (int j = 0; j < Ti::kSRegs; ++j) {
      s_out[(r0 + 8 * ((j >> 1) & 1)) * kTileQ + t * kTileK + 8 * (j >> 2) +
            c0 + (j & 1)] = s[j];
    }
    uint32_t a[kTileK / 16][4];
    pack_p(s, a);
    pv_product<DH>(o, a, v_tiles + t * Ti::kKBytes);
  }
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) {
    o_out[(r0 + 8 * ((j >> 1) & 1)) * DH + 8 * (j >> 2) + c0 + (j & 1)] =
        o[j];
  }
}

template <int DH>
int launch_tile(const void* q, const void* k, const void* v, void* s_out,
                void* o_out, cudaStream_t stream) {
  using Ti = WgTiles<DH>;
  constexpr int smem = Ti::kQBytes + 2 * kTileQ * Ti::kCols * 2 + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgmma_tile_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  wgmma_tile_kernel<DH><<<1, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<float*>(s_out),
      static_cast<float*>(o_out));
  return (int)cudaGetLastError();
}

}  // namespace

#define REPRO_DH_SWITCH(head_dim, CALL)  \
  switch (head_dim) {                    \
    case 32:                             \
      return CALL(32);                   \
    case 64:                             \
      return CALL(64);                   \
    case 128:                            \
      return CALL(128);                  \
    default:                             \
      return (int)cudaErrorInvalidValue; \
  }

// Returns a cudaError_t code; 0 means the kernel was launched. `window` <= 0
// means no sliding window.
extern "C" int flash_prefill(int dtype, const void* q, const void* k,
                             const void* v, const void* q_start,
                             const void* kv_len, void* out, int batch,
                             int heads, int kv_heads, int seq_q, int seq_k,
                             int head_dim, int causal, int window,
                             float scale, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0 ||
      seq_q < 1 || seq_k < 1 || heads > 65535 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_F32(D)                                                         \
  launch_f32<D>(q, k, v, q_start, kv_len, out, batch, heads, kv_heads, seq_q, \
                seq_k, causal, window, scale, s)
#define REPRO_BF16(D)                                                    \
  launch_bf16<D>(q, k, v, q_start, kv_len, out, batch, heads, kv_heads, \
                 seq_q, seq_k, causal, window, scale, s)
  if (dtype == repro_kernels::kFloat32) {
    REPRO_DH_SWITCH(head_dim, REPRO_F32)
  }
  if (dtype == repro_kernels::kBFloat16) {
    REPRO_DH_SWITCH(head_dim, REPRO_BF16)
  }
#undef REPRO_F32
#undef REPRO_BF16
  return (int)cudaErrorInvalidValue;
}

// MLA's prefill (bf16): query and key rows of `head_dim` columns, value and
// output rows of `v_dim`; the one compiled pair is (192, 128), nope 128 plus
// rope 64 against values of 128. Returns a cudaError_t code as
// flash_prefill does.
extern "C" int flash_prefill_mla(const void* q, const void* k, const void* v,
                                 const void* q_start, const void* kv_len,
                                 void* out, int batch, int heads,
                                 int kv_heads, int seq_q, int seq_k,
                                 int head_dim, int v_dim, int causal,
                                 int window, float scale, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0 ||
      seq_q < 1 || seq_k < 1 || heads > 65535 || batch > 65535 ||
      head_dim != 192 || v_dim != 128) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_mla<192, 128>(q, k, v, q_start, kv_len, out, batch, heads,
                              kv_heads, seq_q, seq_k, causal, window, scale,
                              static_cast<cudaStream_t>(stream));
}

// The tile check: q, k, v (64, head_dim) bf16 -> s_out (64, 64) f32 =
// q k^T and o_out (64, head_dim) f32 = bf16(s_out) v.
extern "C" int flash_prefill_tile_check(const void* q, const void* k,
                                        const void* v, void* s_out,
                                        void* o_out, int head_dim,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_TILE(D) launch_tile<D>(q, k, v, s_out, o_out, s)
  REPRO_DH_SWITCH(head_dim, REPRO_TILE)
#undef REPRO_TILE
}
