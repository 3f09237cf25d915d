// Causal GQA flash attention for prefill on Hopper (sm_90a), plain CUDA
// cores with shared-memory tiles and f32 accumulation.
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
// (query, key) pair, against the dense tensor-core rate; this first version
// runs them on CUDA cores in f32, far below that rate. The simple design:
// a grid over (Sq / 64, H, B); each block keeps its 64 x dh query tile in
// shared memory and walks 64-row K/V tiles in order up to its causal limit
// (tiles wholly above the diagonal or outside the window are never loaded),
// each thread holding a 4 x (dh / 16) slice of the output accumulator in
// registers. No tensor cores, TMA or pipelining yet: work for a later change.
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

using repro_kernels::from_f32;
using repro_kernels::kNegInf;
using repro_kernels::to_f32;

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

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* q_start,
           const void* kv_len, void* out, int batch, int heads, int kv_heads,
           int seq_q, int seq_k, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_prefill_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_start),
      static_cast<const int*>(kv_len), static_cast<T*>(out), heads, kv_heads,
      seq_q, seq_k, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int head_dim, const void* q, const void* k, const void* v,
                const void* q_start, const void* kv_len, void* out, int batch,
                int heads, int kv_heads, int seq_q, int seq_k, int causal,
                int window, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, q_start, kv_len, out, batch, heads,
                           kv_heads, seq_q, seq_k, causal, window, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, q_start, kv_len, out, batch, heads,
                           kv_heads, seq_q, seq_k, causal, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, q_start, kv_len, out, batch, heads,
                            kv_heads, seq_q, seq_k, causal, window, scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

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
  if (dtype == repro_kernels::kFloat32) {
    return dispatch_dh<float>(head_dim, q, k, v, q_start, kv_len, out, batch,
                              heads, kv_heads, seq_q, seq_k, causal, window,
                              scale, s);
  }
  if (dtype == repro_kernels::kBFloat16) {
    return dispatch_dh<__nv_bfloat16>(head_dim, q, k, v, q_start, kv_len, out,
                                      batch, heads, kv_heads, seq_q, seq_k,
                                      causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
