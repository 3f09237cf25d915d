// GQA decode attention over contiguous or ring KV lanes for Hopper (sm_90a):
// split-KV over the lane with asynchronous 16-byte copies and a fixed-order
// merge.
//
// Replaces the Pallas TPU kernel `flash_decode` (`_decode_kernel`) in
// src/repro/kernels/flash_decode/kernel.py. One query token per sequence
// attends the W-row K/V lane of that sequence's slot. Where the Pallas kernel
// took the validity and window mask as an additive f32 bias of shape (B, W),
// this kernel computes it from the row's position: lane row j holds the
// token at position p = pos - ((pos - j) mod W) (the current token included,
// written by the caller before the call), and the key counts when p >= 0 and,
// with a window, pos - p < window. That is the reference's ring semantics: an
// append buffer while pos < W, a ring once pos >= W. The softmax runs online
// in f32 with the finite NEG_INF mask.
//
// Layouts (all contiguous, 16-byte aligned):
//   q      (B, KH*G, dh)      one decode token per sequence
//   k/v    (S, KH, W, dh)     one layer of the engine's lanes, heads first
//   slots  (B,) int32         lane slot of each sequence
//   pos    (B,) int32         absolute position of each sequence's token
//   out    (B, KH*G, dh)
//   scratch f32, (B, KH*G, splits, dh) partial sums then (B, KH*G, splits,
//           2) partial (max, sum); unused with one split
//
// What bounds it on the H100: the bytes of the lane it reads (2 * rows * dh
// per KV head and sequence, rows = min(pos + 1, W)) against 3.35 TB/s; the
// arithmetic is ~2 flops per byte. The design is paged decode's
// (flash_decode_paged.cu), on the simplest addressing there is. This file
// repeats its split walk and merge inline: through a header shared by both
// kernels, the paged kernel compiled to slower code.
//
// * Split-KV. The grid is (splits, KH, B); a split is a fixed run of
//   `split_rows` lane rows (64; the wrapper derives it from W alone), so a
//   row's partition never depends on the batch. Only rows < min(pos + 1, W)
//   hold tokens: splits past them leave at once and write nothing. With a
//   window, a split whose rows all lie outside it leaves too (its merge
//   weight would be exactly 0); that too depends on pos alone. A second
//   kernel merges the live splits of each (sequence, head) in split order.
// * A 16-row tile of a heads-first lane is one contiguous run of 16 * dh
//   elements, streamed through 4 stages of `cp.async.cg` 16-byte copies.
// * The mask needs no `%` per row: with r = pos % W (once per block), row j
//   lies back = r - j (j <= r) or r - j + W (j > r) positions before pos.
// * Warp-wide scores and a per-warp online softmax in registers, G compiled
//   in (1..8), as in paged decode.
#include <climits>
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

// Whether lane rows j0 .. j1-1 (all walked) hold a key within the window;
// r = pos % W is the current token's row. Without a window every walked
// row counts.
__device__ __forceinline__ bool split_live(int j0, int j1, int r, int width,
                                           int window) {
  if (window <= 0) return true;
  int nearest = INT_MAX;  // the fewest positions back of any of its rows
  if (j0 <= r) nearest = r - min(j1 - 1, r);
  if (j1 - 1 > r) nearest = min(nearest, r - (j1 - 1) + width);
  return nearest < window;
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(kThreads)
ring_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ slots,
                         const int* __restrict__ positions,
                         T* __restrict__ out, float* __restrict__ part,
                         int batch, int kv_heads, int width, int window,
                         int split_rows, float scale_log2) {
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

  const int pos = positions[b];
  const int walked = pos + 1 < width ? pos + 1 : width;
  const int j0 = split * split_rows;
  if (j0 >= walked) return;  // rows past pos hold no token yet
  const int j1 = min(j0 + split_rows, walked);
  const int r = pos % width;  // lane row of the current token
  if (!split_live(j0, j1, r, width, window)) return;
  const int rows = j1 - j0;
  const int n_tiles = (rows + kTileRows - 1) / kTileRows;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem_base = smem_addr(smem);
  const size_t base =
      (((size_t)slots[b] * kv_heads + kh) * width + j0) * (size_t)DH;

  // Tile t (rows 16t .. 16t+15 of the split, contiguous in the lane) into
  // stage t % kStages; always one commit group per call.
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const uint32_t stage = smem_base + (t % kStages) * Geo::kStageBytes;
      const size_t tile = base + (size_t)t * kTileRows * DH;
      for (int i = tid; i < kTileRows * Geo::kChunksPerRow; i += kThreads) {
        if (t * kTileRows + i / Geo::kChunksPerRow < rows) {
          const uint32_t dst = stage + (uint32_t)i * 16;
          cp_async_16(dst, k + tile + (size_t)i * EPC);
          cp_async_16(dst + Geo::kTileBytes, v + tile + (size_t)i * EPC);
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
      const int rt = warp * kRowsPerWarp + r_in_warp;  // row in the tile
      const bool present =
          r_in_warp < kRowsPerWarp && t * kTileRows + rt < rows;
      // lane row j lies `back` positions before pos: no % per row
      const int j = j0 + t * kTileRows + rt;
      const int back = j <= r ? r - j : r - j + width;
      const bool valid = window <= 0 || back < window;
      float kf[EPL], vf[EPL];
#pragma unroll
      for (int cc = 0; cc < Geo::kChunksPerLane; ++cc) {
        if (present) {
          const int off = rt * DH + (slot + cc * LPR) * EPC;
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
        // rows outside the window take the finite NEG_INF
        s = present ? (valid ? s : kNegInf) : -INFINITY;
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

// Merges the live splits of one (sequence, head) in split order.
template <typename T, int DH>
__global__ void ring_decode_combine_kernel(const float* __restrict__ part,
                                           const int* __restrict__ positions,
                                           T* __restrict__ out, int batch,
                                           int heads, int width, int window,
                                           int split_rows) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_splits = (width + split_rows - 1) / split_rows;
  const int pos = positions[b];
  const int walked = pos + 1 < width ? pos + 1 : width;
  const int r = pos % width;
  const int ns = (walked + split_rows - 1) / split_rows;
  const size_t head = (size_t)b * heads + h;
  const float* acc = part + head * n_splits * DH;
  const float* ml = part + (size_t)batch * heads * n_splits * DH +
                    head * n_splits * 2;
  // the split holding the current token's row is always live
  float mx = -INFINITY;
  for (int s = 0; s < ns; ++s) {
    if (split_live(s * split_rows, min((s + 1) * split_rows, walked), r,
                   width, window)) {
      mx = fmaxf(mx, ml[2 * s]);
    }
  }
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < ns; ++s) {
      if (!split_live(s * split_rows, min((s + 1) * split_rows, walked), r,
                      width, window)) {
        continue;  // wrote nothing
      }
      const float wgt = exp2f(ml[2 * s] - mx);
      sum += wgt * ml[2 * s + 1];
      a += wgt * acc[(size_t)s * DH + d];
    }
    out[head * DH + d] = from_f32<T>(a / fmaxf(sum, 1e-30f));
  }
}

template <typename T, int DH, int G>
int launch(const void* q, const void* k, const void* v, const void* slots,
           const void* positions, void* out, void* scratch, int batch,
           int kv_heads, int width, int window, int split_rows, float scale,
           cudaStream_t stream) {
  constexpr int smem = kStages * Geometry<T, DH>::kStageBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ring_decode_split_kernel<T, DH, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_splits = (width + split_rows - 1) / split_rows;
  if (n_splits > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_splits, kv_heads, batch);
  ring_decode_split_kernel<T, DH, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(slots),
      static_cast<const int*>(positions), static_cast<T*>(out),
      static_cast<float*>(scratch), batch, kv_heads, width, window,
      split_rows, scale * kLog2e);
  if (n_splits > 1) {
    ring_decode_combine_kernel<T, DH>
        <<<dim3(kv_heads * G, batch), DH < 128 ? DH : 128, 0, stream>>>(
            static_cast<const float*>(scratch),
            static_cast<const int*>(positions), static_cast<T*>(out), batch,
            kv_heads * G, width, window, split_rows);
  }
  return (int)cudaGetLastError();
}

// One instantiation per (head_dim, group).
#define REPRO_RING_ARGS                                                     \
  q, k, v, slots, positions, out, scratch, batch, kv_heads, width, window, \
      split_rows, scale, s
#define REPRO_RING_GROUPS(T, D)                      \
  switch (group) {                                   \
    case 1: return launch<T, D, 1>(REPRO_RING_ARGS); \
    case 2: return launch<T, D, 2>(REPRO_RING_ARGS); \
    case 3: return launch<T, D, 3>(REPRO_RING_ARGS); \
    case 4: return launch<T, D, 4>(REPRO_RING_ARGS); \
    case 5: return launch<T, D, 5>(REPRO_RING_ARGS); \
    case 6: return launch<T, D, 6>(REPRO_RING_ARGS); \
    case 7: return launch<T, D, 7>(REPRO_RING_ARGS); \
    case 8: return launch<T, D, 8>(REPRO_RING_ARGS); \
    default: return (int)cudaErrorInvalidValue;      \
  }

template <typename T>
int dispatch(int head_dim, int group, const void* q, const void* k,
             const void* v, const void* slots, const void* positions,
             void* out, void* scratch, int batch, int kv_heads, int width,
             int window, int split_rows, float scale, cudaStream_t s) {
  switch (head_dim) {
    case 32: REPRO_RING_GROUPS(T, 32)
    case 64: REPRO_RING_GROUPS(T, 64)
    case 128: REPRO_RING_GROUPS(T, 128)
    default: return (int)cudaErrorInvalidValue;
  }
}
#undef REPRO_RING_GROUPS
#undef REPRO_RING_ARGS

}  // namespace

// Returns a cudaError_t code; 0 means the kernels were launched. `window` <= 0
// means no sliding window. `scratch` holds batch * heads * splits *
// (head_dim + 2) floats, splits = ceil(width / split_rows); it may be null
// with one split.
extern "C" int ring_decode(int dtype, const void* q, const void* k,
                           const void* v, const void* slots,
                           const void* positions, void* out, void* scratch,
                           int batch, int kv_heads, int group, int head_dim,
                           int width, int window, int split_rows, float scale,
                           void* stream) {
  if (batch < 1 || batch > 65535 || kv_heads < 1 || kv_heads > 65535 ||
      group < 1 || group > kMaxGroup || width < 1 || split_rows < 1 ||
      split_rows % kTileRows != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro_kernels::kFloat32) {
    return dispatch<float>(head_dim, group, q, k, v, slots, positions, out,
                           scratch, batch, kv_heads, width, window,
                           split_rows, scale, s);
  }
  if (dtype == repro_kernels::kBFloat16) {
    return dispatch<__nv_bfloat16>(head_dim, group, q, k, v, slots,
                                   positions, out, scratch, batch, kv_heads,
                                   width, window, split_rows, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
