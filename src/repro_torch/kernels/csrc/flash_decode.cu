// GQA decode attention over contiguous or ring KV lanes for Hopper (sm_90a),
// plain CUDA cores.
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
// Layouts (all contiguous):
//   q      (B, KH*G, dh)      one decode token per sequence
//   k/v    (S, KH, W, dh)     one layer of the engine's lanes, heads first
//   slots  (B,) int32         lane slot of each sequence
//   pos    (B,) int32         absolute position of each sequence's token
//   out    (B, KH*G, dh)
//
// What bounds it on the H100: the bytes of the lane it reads (2 * rows * dh
// per KV head and sequence, rows = min(pos + 1, W)) against 3.35 TB/s; the
// arithmetic is ~2 flops per byte. The simple design: one thread block per
// (sequence, KV head) walks the lane in 64-row tiles in order, stages each
// K/V tile in shared memory once and serves all G query heads of the KV head
// from it, so each K/V byte is read from device memory once; a fixed
// reduction order and no atomics make the result bitwise reproducible. Rows
// past pos are never loaded before the lane wraps. It leaves most of the
// card idle at small B * KH (B=8, KH=5 is 40 blocks on 132 SMs: split-KV
// with a fixed-order combine is for a later change) and uses no vectorized
// or asynchronous loads.
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

using repro_kernels::from_f32;
using repro_kernels::kNegInf;
using repro_kernels::to_f32;

constexpr int kThreads = 128;
constexpr int kTile = 64;     // lane rows per shared-memory tile
constexpr int kMaxGroup = 8;  // query heads per KV head

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)kMaxGroup * DH + (size_t)kTile * (DH + 1) +
         (size_t)kTile * DH + (size_t)kMaxGroup * kTile + 3 * kMaxGroup;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
ring_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ slots,
                   const int* __restrict__ positions, T* __restrict__ out,
                   int kv_heads, int group, int width, int window,
                   float scale) {
  constexpr int KS = DH + 1;               // padded row stride of the K tile
  constexpr int kGroupSets = kThreads / DH;  // threads per output column
  constexpr int kGPerThread = (kMaxGroup + kGroupSets - 1) / kGroupSets;

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;                  // group x DH
  float* k_s = q_s + kMaxGroup * DH;  // kTile x KS
  float* v_s = k_s + kTile * KS;      // kTile x DH
  float* p_s = v_s + kTile * DH;      // group x kTile
  float* m_s = p_s + kMaxGroup * kTile;
  float* l_s = m_s + kMaxGroup;
  float* c_s = l_s + kMaxGroup;

  const int heads = kv_heads * group;
  const size_t q_off = ((size_t)b * heads + (size_t)kh * group) * DH;
  for (int i = tid; i < group * DH; i += kThreads) {
    q_s[i] = to_f32(q[q_off + i]);
  }
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int pos = positions[b];
  const size_t lane = ((size_t)slots[b] * kv_heads + kh) * (size_t)width * DH;
  const T* kb = k + lane;
  const T* vb = v + lane;
  // rows past pos hold no token until the lane wraps
  const int rows = pos + 1 < width ? pos + 1 : width;

  const int d_col = tid % DH;
  const int g_set = tid / DH;
  float acc[kGPerThread];
#pragma unroll
  for (int i = 0; i < kGPerThread; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < rows; t0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTile * DH; i += kThreads) {
      const int r = i / DH;
      const int d = i - r * DH;
      const bool ok = t0 + r < rows;
      const size_t src = (size_t)(t0 + r) * DH + d;
      k_s[r * KS + d] = ok ? to_f32(kb[src]) : 0.f;
      v_s[r * DH + d] = ok ? to_f32(vb[src]) : 0.f;
    }
    __syncthreads();

    // scores, one thread per (query head, row)
    for (int pr = tid; pr < group * kTile; pr += kThreads) {
      const int g = pr / kTile;
      const int r = pr - g * kTile;
      const int j = t0 + r;
      int back = (pos - j) % width;  // how far back row j's token lies
      if (back < 0) back += width;
      const int p = pos - back;
      bool valid = j < rows && p >= 0;
      if (window > 0) valid = valid && back < window;
      float s = 0.f;
      for (int d = 0; d < DH; ++d) s += q_s[g * DH + d] * k_s[r * KS + d];
      p_s[g * kTile + r] = valid ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax statistics, one thread per query head
    if (tid < group) {
      float* row = p_s + tid * kTile;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int r = 0; r < kTile; ++r) m_new = fmaxf(m_new, row[r]);
      float sum = 0.f;
      for (int r = 0; r < kTile; ++r) {
        const float e = expf(row[r] - m_new);
        row[r] = e;
        sum += e;
      }
      const float corr = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      c_s[tid] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V: thread owns column d_col of heads g_set + n*sets
#pragma unroll
    for (int i = 0; i < kGPerThread; ++i) {
      const int g = g_set + i * kGroupSets;
      if (g < group) {
        const float* prow = p_s + g * kTile;
        float a = acc[i] * c_s[g];
        for (int r = 0; r < kTile; ++r) a += prow[r] * v_s[r * DH + d_col];
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kGPerThread; ++i) {
    const int g = g_set + i * kGroupSets;
    if (g < group) {
      const float denom = fmaxf(l_s[g], 1e-30f);
      out[q_off + (size_t)g * DH + d_col] = from_f32<T>(acc[i] / denom);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* slots,
           const void* positions, void* out, int batch, int kv_heads,
           int group, int width, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      ring_decode_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kv_heads, batch);
  ring_decode_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(slots),
      static_cast<const int*>(positions), static_cast<T*>(out), kv_heads,
      group, width, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int head_dim, const void* q, const void* k, const void* v,
                const void* slots, const void* positions, void* out,
                int batch, int kv_heads, int group, int width, int window,
                float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, slots, positions, out, batch, kv_heads,
                           group, width, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, slots, positions, out, batch, kv_heads,
                           group, width, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, slots, positions, out, batch, kv_heads,
                            group, width, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t code; 0 means the kernel was launched. `window` <= 0
// means no sliding window.
extern "C" int ring_decode(int dtype, const void* q, const void* k,
                           const void* v, const void* slots,
                           const void* positions, void* out, int batch,
                           int kv_heads, int group, int head_dim, int width,
                           int window, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || kv_heads < 1 || kv_heads > 65535 ||
      group < 1 || group > kMaxGroup || width < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro_kernels::kFloat32) {
    return dispatch_dh<float>(head_dim, q, k, v, slots, positions, out, batch,
                              kv_heads, group, width, window, scale, s);
  }
  if (dtype == repro_kernels::kBFloat16) {
    return dispatch_dh<__nv_bfloat16>(head_dim, q, k, v, slots, positions,
                                      out, batch, kv_heads, group, width,
                                      window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
