// Paged GQA decode attention for Hopper (sm_90a): split-KV with
// asynchronous 16-byte copies and a fixed-order merge.
//
// Replaces the Pallas TPU kernel `flash_decode_paged` (`_paged_decode_kernel`)
// in src/repro/kernels/flash_decode/kernel.py. One query token per sequence
// attends that sequence's K/V rows, read straight out of one layer's block
// pool through its int32 block table; rows at positions >= lengths[b] are
// masked with the finite NEG_INF, and the softmax runs online in f32.
//
// Layouts (all contiguous, 16-byte aligned):
//   q        (B, KH*G, dh)            one decode token per sequence
//   k/v pool (N, block_size, KH, dh)  one layer of the engine's pool
//   tables   (B, max_blocks) int32    physical block of each logical block
//   lengths  (B,) int32               valid rows per sequence
//   out      (B, KH*G, dh)
//   scratch  f32, (B, KH*G, splits, dh) partial sums then (B, KH*G, splits,
//            2) partial (max, sum); unused with one split
//
// What bounds it on the H100: the bytes of K/V it reads (2 * len * dh per
// KV head and sequence) against 3.35 TB/s; the arithmetic is ~2 flops per
// byte, far below the ~295 at which the tensor cores would matter. So the
// design spends the card's parallelism and its copy path on moving K/V:
//
// * Split-KV (flash-decoding). The grid is (splits, KH, B); a split is a
//   fixed run of `entries_per_split` table entries (64 rows at the engine's
//   16-row blocks; the wrapper derives it from block_size alone), so the
//   partition depends only on logical position and never on the batch.
//   Splits past a sequence's last entry leave at once and write nothing.
//   Each split writes its f32 (max, sum, acc[G, dh]) to scratch, and a
//   second small kernel merges the splits of each (sequence, head) in split
//   order: no atomics, so two sequences whose tables alias the same blocks
//   get bitwise-equal outputs. With a single split (max_blocks entries fit
//   one run) the first kernel writes the output itself, with the same
//   arithmetic as a one-split merge.
// * Inside a split, 16-row tiles of K and V come into shared memory through
//   a ring of 4 stages of `cp.async.cg` 16-byte copies (a 64-row split is
//   in flight at once), with one __syncthreads per stage.
// * Each warp owns 4 rows of every tile. Lanes hold 16-byte slices of dh
//   (the G query rows sit in registers, pre-scaled by log2(e) / sqrt(dh)),
//   scores are reduced by shuffles, and each warp runs its own online
//   softmax and accumulator in registers. The 4 warps merge through shared
//   memory at the end, in warp order. G is a compile-time parameter (1..8):
//   it sizes the register tiles, and the G heads' shuffle chains then
//   interleave.
//
// lengths[b] == 0 walks the whole table with every row masked: each split
// and each warp then holds max = NEG_INF (finite), so every merge weight is
// exp2(0) = 1 and the result is sum(V) / rows, the uniform average over the
// table's rows that the plain version computes.
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro_kernels::cp_async_16;
using repro_kernels::cp_async_commit;
using repro_kernels::cp_async_wait;
using repro_kernels::from_f32;
using repro_kernels::kNegInf;
using repro_kernels::smem_addr;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;      // query heads per KV head (compiled 1..8)
constexpr int kTileRows = 16;     // rows per pipeline stage
constexpr int kStages = 4;
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// How a warp covers a tile: kLanesPerRow lanes per row, each holding
// kChunksPerLane 16-byte chunks of it; kRowsPerPass rows at a time.
template <typename T, int DH>
struct Geometry {
  static constexpr int kElemsPerChunk = 16 / (int)sizeof(T);
  static constexpr int kChunksPerRow = DH / kElemsPerChunk;
  static constexpr int kLanesPerRow = kChunksPerRow < 32 ? kChunksPerRow : 32;
  static constexpr int kChunksPerLane = kChunksPerRow / kLanesPerRow;
  static constexpr int kElemsPerLane = kChunksPerLane * kElemsPerChunk;
  static constexpr int kRowsPerPass = 32 / kLanesPerRow;
  static constexpr int kPasses =
      kRowsPerWarp > kRowsPerPass ? kRowsPerWarp / kRowsPerPass : 1;
  static constexpr int kTileBytes = kTileRows * DH * (int)sizeof(T);
  static constexpr int kStageBytes = 2 * kTileBytes;  // K tile, then V tile
};

__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Table entries walked for a sequence: those holding its rows, or all of
// them when its length is 0 (the fully masked, uniform-average case).
__device__ __forceinline__ int walked_entries(int len, int block_size,
                                              int max_blocks) {
  const int n = len > 0 ? (len + block_size - 1) / block_size : max_blocks;
  return n < max_blocks ? n : max_blocks;
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ tables,
                          const int* __restrict__ lengths,
                          T* __restrict__ out, float* __restrict__ part,
                          int batch, int kv_heads, int block_size,
                          int max_blocks, int entries_per_split,
                          float scale_log2) {
  using Geo = Geometry<T, DH>;
  constexpr int EPL = Geo::kElemsPerLane;
  constexpr int EPC = Geo::kElemsPerChunk;
  constexpr int LPR = Geo::kLanesPerRow;

  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = lengths[b];
  const int n_entries = walked_entries(len, block_size, max_blocks);
  const int e0 = split * entries_per_split;
  if (e0 >= n_entries) return;  // past the sequence's last entry
  const int e1 = min(e0 + entries_per_split, n_entries);
  const int row0 = e0 * block_size;  // logical position of the split's row 0
  const int rows = (e1 - e0) * block_size;
  const int n_tiles = (rows + kTileRows - 1) / kTileRows;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem_base = smem_addr(smem);
  const int* table = tables + (size_t)b * max_blocks;
  const size_t row_stride = (size_t)kv_heads * DH;

  // Tile t's rows into stage t % kStages; always one commit group per call.
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const uint32_t stage = smem_base + (t % kStages) * Geo::kStageBytes;
      for (int i = tid; i < kTileRows * Geo::kChunksPerRow; i += kThreads) {
        const int r = i / Geo::kChunksPerRow;
        const int c = i - r * Geo::kChunksPerRow;
        if (t * kTileRows + r < rows) {
          const int pos = row0 + t * kTileRows + r;
          const int entry = pos / block_size;
          const size_t src =
              ((size_t)table[entry] * block_size + (pos - entry * block_size)) *
                  row_stride +
              (size_t)kh * DH + (size_t)c * EPC;
          const uint32_t dst = stage + (uint32_t)i * 16;
          cp_async_16(dst, k_pool + src);
          cp_async_16(dst + Geo::kTileBytes, v_pool + src);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) issue(s);

  // this lane's query slices, pre-scaled into the log2 domain
  const int rig = lane / LPR;   // row of this lane within a pass
  const int slot = lane % LPR;  // which chunks of the row it holds
  const int heads = kv_heads * G;
  const T* qb = q + ((size_t)b * heads + (size_t)kh * G) * DH;
  float qr[G][EPL];
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int cc = 0; cc < Geo::kChunksPerLane; ++cc) {
      float f[EPC];
      unpack(*reinterpret_cast<const uint4*>(
                 qb + (size_t)g * DH + (slot + cc * LPR) * EPC),
             f, qb);
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        qr[g][cc * EPC + e] = f[e] * scale_log2;
        acc[g][cc * EPC + e] = 0.f;
      }
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's part)
    __syncthreads();               // ... everyone's; stage of t-1 is free
    if (t > 0) issue(t + kStages - 1);
    const T* ks = reinterpret_cast<const T*>(
        smem + (t % kStages) * Geo::kStageBytes);
    const T* vs = ks + kTileRows * DH;
#pragma unroll
    for (int p = 0; p < Geo::kPasses; ++p) {
      const int r_in_warp = p * Geo::kRowsPerPass + rig;
      const int r = warp * kRowsPerWarp + r_in_warp;  // row in the tile
      const bool present =
          r_in_warp < kRowsPerWarp && t * kTileRows + r < rows;
      const int pos = row0 + t * kTileRows + r;
      float kf[EPL], vf[EPL];
#pragma unroll
      for (int cc = 0; cc < Geo::kChunksPerLane; ++cc) {
        if (present) {
          const int off = r * DH + (slot + cc * LPR) * EPC;
          unpack(*reinterpret_cast<const uint4*>(ks + off), kf + cc * EPC, ks);
          unpack(*reinterpret_cast<const uint4*>(vs + off), vf + cc * EPC, vs);
        } else {
#pragma unroll
          for (int e = 0; e < EPC; ++e) kf[cc * EPC + e] = vf[cc * EPC + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s += qr[g][e] * kf[e];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
        }
        // absent rows (past the split, or idle lanes) drop out exactly;
        // masked rows take the finite NEG_INF
        s = present ? (pos < len ? s : kNegInf) : -INFINITY;
        float mp = s;
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1) {
          mp = fmaxf(mp, __shfl_xor_sync(0xffffffffu, mp, off));
        }
        const float m_new = fmaxf(m[g], mp);
        const float corr = exp2f(m[g] - m_new);
        const float pr = exp2f(s - m_new);
        l[g] = l[g] * corr + pr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * corr + pr * vf[e];
        m[g] = m_new;
      }
    }
  }

  // sum each warp's rows (lanes that share a slot), then merge the warps
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages: reuse them
  float* ms = reinterpret_cast<float*>(smem);  // [warp][g]
  float* ls = ms + kWarps * G;                 // [warp][g]
  float* as = ls + kWarps * G;                 // [warp][g][DH]
  if (rig == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int cc = 0; cc < Geo::kChunksPerLane; ++cc) {
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          as[(warp * G + g) * DH + (slot + cc * LPR) * EPC + e] =
              acc[g][cc * EPC + e];
        }
      }
      if (slot == 0) {
        ms[warp * G + g] = m[g];
        ls[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  const int n_splits = gridDim.x;
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH;
    const int d = i - g * DH;
    float mx = ms[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, ms[w * G + g]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wgt = exp2f(ms[w * G + g] - mx);
      sum += wgt * ls[w * G + g];
      a += wgt * as[(w * G + g) * DH + d];
    }
    const size_t head = (size_t)b * heads + (size_t)kh * G + g;
    if (n_splits == 1) {
      out[head * DH + d] = from_f32<T>(a / fmaxf(sum, 1e-30f));
    } else {
      const size_t pi = head * n_splits + split;
      part[pi * DH + d] = a;
      if (d == 0) {
        float* ml = part + (size_t)batch * heads * n_splits * DH;
        ml[pi * 2] = mx;
        ml[pi * 2 + 1] = sum;
      }
    }
  }
}

// Merges the splits of one (sequence, head) in split order.
template <typename T, int DH>
__global__ void paged_decode_combine_kernel(const float* __restrict__ part,
                                            const int* __restrict__ lengths,
                                            T* __restrict__ out, int batch,
                                            int heads, int block_size,
                                            int max_blocks,
                                            int entries_per_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_splits = (max_blocks + entries_per_split - 1) / entries_per_split;
  const int n_entries = walked_entries(lengths[b], block_size, max_blocks);
  const int ns = (n_entries + entries_per_split - 1) / entries_per_split;
  const size_t head = (size_t)b * heads + h;
  const float* acc = part + head * n_splits * DH;
  const float* ml = part + (size_t)batch * heads * n_splits * DH +
                    head * n_splits * 2;
  float mx = ml[0];
  for (int s = 1; s < ns; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float wgt = exp2f(ml[2 * s] - mx);
      sum += wgt * ml[2 * s + 1];
      a += wgt * acc[(size_t)s * DH + d];
    }
    out[head * DH + d] = from_f32<T>(a / fmaxf(sum, 1e-30f));
  }
}

template <typename T, int DH, int G>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* out, void* scratch,
           int batch, int kv_heads, int block_size, int max_blocks,
           int entries_per_split, float scale, cudaStream_t stream) {
  constexpr int smem = kStages * Geometry<T, DH>::kStageBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_split_kernel<T, DH, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_splits = (max_blocks + entries_per_split - 1) / entries_per_split;
  if (n_splits > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_splits, kv_heads, batch);
  paged_decode_split_kernel<T, DH, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out),
      static_cast<float*>(scratch), batch, kv_heads, block_size, max_blocks,
      entries_per_split, scale * kLog2e);
  if (n_splits > 1) {
    paged_decode_combine_kernel<T, DH>
        <<<dim3(kv_heads * G, batch), DH < 128 ? DH : 128, 0, stream>>>(
            static_cast<const float*>(scratch),
            static_cast<const int*>(lengths), static_cast<T*>(out), batch,
            kv_heads * G, block_size, max_blocks, entries_per_split);
  }
  return (int)cudaGetLastError();
}

// One instantiation per (head_dim, group).
#define REPRO_PAGED_ARGS                                                   \
  q, k_pool, v_pool, tables, lengths, out, scratch, batch, kv_heads,       \
      block_size, max_blocks, entries_per_split, scale, s
#define REPRO_PAGED_GROUPS(T, D)                 \
  switch (group) {                               \
    case 1: return launch<T, D, 1>(REPRO_PAGED_ARGS); \
    case 2: return launch<T, D, 2>(REPRO_PAGED_ARGS); \
    case 3: return launch<T, D, 3>(REPRO_PAGED_ARGS); \
    case 4: return launch<T, D, 4>(REPRO_PAGED_ARGS); \
    case 5: return launch<T, D, 5>(REPRO_PAGED_ARGS); \
    case 6: return launch<T, D, 6>(REPRO_PAGED_ARGS); \
    case 7: return launch<T, D, 7>(REPRO_PAGED_ARGS); \
    case 8: return launch<T, D, 8>(REPRO_PAGED_ARGS); \
    default: return (int)cudaErrorInvalidValue;  \
  }

template <typename T>
int dispatch(int head_dim, int group, const void* q, const void* k_pool,
             const void* v_pool, const void* tables, const void* lengths,
             void* out, void* scratch, int batch, int kv_heads,
             int block_size, int max_blocks, int entries_per_split,
             float scale, cudaStream_t s) {
  switch (head_dim) {
    case 32: REPRO_PAGED_GROUPS(T, 32)
    case 64: REPRO_PAGED_GROUPS(T, 64)
    case 128: REPRO_PAGED_GROUPS(T, 128)
    case 256: REPRO_PAGED_GROUPS(T, 256)
    default: return (int)cudaErrorInvalidValue;
  }
}
#undef REPRO_PAGED_GROUPS
#undef REPRO_PAGED_ARGS

}  // namespace

// Returns a cudaError_t code; 0 means the kernels were launched. `scratch`
// holds batch * heads * splits * (head_dim + 2) floats, splits =
// ceil(max_blocks / entries_per_split); it may be null with one split.
extern "C" int paged_decode(int dtype, const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* lengths, void* out, void* scratch,
                            int batch, int kv_heads, int group, int head_dim,
                            int block_size, int max_blocks,
                            int entries_per_split, float scale, void* stream) {
  if (group < 1 || group > kMaxGroup || block_size < 1 || max_blocks < 1 ||
      batch < 1 || batch > 65535 || kv_heads < 1 || kv_heads > 65535 ||
      entries_per_split < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro_kernels::kFloat32) {
    return dispatch<float>(head_dim, group, q, k_pool, v_pool, tables,
                           lengths, out, scratch, batch, kv_heads, block_size,
                           max_blocks, entries_per_split, scale, s);
  }
  if (dtype == repro_kernels::kBFloat16) {
    return dispatch<__nv_bfloat16>(head_dim, group, q, k_pool, v_pool, tables,
                                   lengths, out, scratch, batch, kv_heads,
                                   block_size, max_blocks, entries_per_split,
                                   scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
