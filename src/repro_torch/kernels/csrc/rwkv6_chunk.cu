// Chunked linear attention with data-dependent decay for Hopper (sm_90a),
// plain CUDA cores in f32.
//
// Replaces the Pallas TPU kernel `rwkv6_chunk` (`_rwkv_kernel`) in
// src/repro/kernels/rwkv6_chunk/kernel.py, and also returns the final state,
// which the Pallas kernel left to the XLA path. Two recurrences:
//   rwkv: S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//         o_t = q_t S_{t-1} + (q_t . (u * k_t)) v_t
//   ssd:  S_t = a_t S_{t-1} + k_t v_t^T,  o_t = q_t S_t
// computed chunk by chunk: per chunk the inclusive and exclusive cumulative
// sums of the log-decay, the strictly lower intra-chunk score matrix, the
// read of the carried state, the diagonal term and the state update, all in
// f32 (the algorithm of repro/models/linear_attn.py).
//
// Layouts (all contiguous):
//   q, k   (B, H, T, dk)          storage type T
//   v, out (B, H, T, dv)          storage type T
//   lw     (B, H, T, lw_dim) f32  lw_dim = dk (rwkv) or 1 (ssd: one scalar
//                                 decay per step, never broadcast in memory)
//   bonus  (H, dk) f32            rwkv only (null for ssd)
//   state  (B, H, dk, dv) f32     written: the state after the last step
// T is a multiple of the chunk (the wrapper pads with zero k, v and zero
// log-decay, which leaves the state unchanged); dk, dv <= 64.
//
// What bounds it on the H100: bytes at the main path's shapes (each input
// read once, the output and final state written once); the arithmetic is
// O(C * (dk + dv)) flops per step. The simple design: the Pallas grid's
// sequential chunk axis becomes a loop inside one thread block per
// (batch, head), which carries the f32 (dk x dv) state in shared memory
// across chunks; each chunk's tiles are staged in shared memory once and all
// products run on CUDA cores in a fixed order (no atomics, so results are
// bitwise reproducible). Tensor cores (`wgmma`) for the three chunk products,
// and overlapping the next chunk's loads with this chunk's math, are work
// for a later change.
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

using repro_kernels::from_f32;
using repro_kernels::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxDim = 64;  // dk and dv

template <int C>
constexpr size_t smem_floats() {
  return 3 * (size_t)C * (kMaxDim + 1)  // q, k (then decayed), k_tail
         + (size_t)C * kMaxDim          // v
         + 2 * (size_t)C * kMaxDim      // log-decay and its inclusive sum
         + (size_t)C * (C + 1)          // intra-chunk scores
         + (size_t)kMaxDim * kMaxDim    // carried state
         + C;                           // diagonal term
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
linear_attn_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ lw,
                         const float* __restrict__ bonus, T* __restrict__ out,
                         float* __restrict__ state, int heads, int seq,
                         int dk, int dv, int lw_dim, int rwkv) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ld = dk + 1;     // padded row stride of the (C, dk) tiles
  constexpr int AS = C + 1;  // padded row stride of the score tile

  extern __shared__ float smem[];
  float* q_s = smem;                       // C x ld
  float* k_s = q_s + C * ld;               // C x ld
  float* kt_s = k_s + C * ld;              // C x ld
  float* v_s = kt_s + C * ld;              // C x dv
  float* lw_s = v_s + C * dv;              // C x lw_dim
  float* inc_s = lw_s + C * lw_dim;        // C x lw_dim
  float* att_s = inc_s + C * lw_dim;       // C x AS
  float* st_s = att_s + C * AS;            // dk x dv
  float* dg_s = st_s + dk * dv;            // C

  const size_t bh = (size_t)b * heads + h;
  const T* qb = q + bh * (size_t)seq * dk;
  const T* kb = k + bh * (size_t)seq * dk;
  const T* vb = v + bh * (size_t)seq * dv;
  const float* lwb = lw + bh * (size_t)seq * lw_dim;
  T* ob = out + bh * (size_t)seq * dv;

  for (int i = tid; i < dk * dv; i += kThreads) st_s[i] = 0.f;

  for (int t0 = 0; t0 < seq; t0 += C) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < C * dk; i += kThreads) {
      const int t = i / dk;
      const int d = i - t * dk;
      const size_t src = (size_t)(t0 + t) * dk + d;
      q_s[t * ld + d] = to_f32(qb[src]);
      k_s[t * ld + d] = to_f32(kb[src]);
    }
    for (int i = tid; i < C * dv; i += kThreads) {
      v_s[i] = to_f32(vb[(size_t)t0 * dv + i]);
    }
    for (int i = tid; i < C * lw_dim; i += kThreads) {
      lw_s[i] = lwb[(size_t)t0 * lw_dim + i];
    }
    __syncthreads();

    // inclusive cumulative log-decay, one thread per column, in order
    if (tid < lw_dim) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        run += lw_s[t * lw_dim + tid];
        inc_s[t * lw_dim + tid] = run;
      }
    }
    // diagonal coefficient: q.(u*k) (rwkv) or q.k (ssd), undecayed
    for (int t = tid; t < C; t += kThreads) {
      float s = 0.f;
      for (int d = 0; d < dk; ++d) {
        const float u = rwkv ? bonus[(size_t)h * dk + d] : 1.f;
        s += q_s[t * ld + d] * u * k_s[t * ld + d];
      }
      dg_s[t] = s;
    }
    __syncthreads();

    // decayed operands: q to t-1 (rwkv) or through t (ssd), k undone at j,
    // k carried from j to the chunk's end
    for (int i = tid; i < C * dk; i += kThreads) {
      const int t = i / dk;
      const int d = i - t * dk;
      const int cd = lw_dim == 1 ? 0 : d;
      const float inc = inc_s[t * lw_dim + cd];
      const float tot = inc_s[(C - 1) * lw_dim + cd];
      const float qv = q_s[t * ld + d];
      const float kv = k_s[t * ld + d];
      q_s[t * ld + d] = qv * expf(rwkv ? inc - lw_s[t * lw_dim + cd] : inc);
      k_s[t * ld + d] = kv * expf(-inc);
      kt_s[t * ld + d] = kv * expf(tot - inc);
    }
    __syncthreads();

    // strictly lower intra-chunk scores q_dec[t] . k_dec[j], j < t
    for (int i = tid; i < C * C; i += kThreads) {
      const int t = i / C;
      const int j = i - t * C;
      float a = 0.f;
      if (j < t) {
        for (int d = 0; d < dk; ++d) a += q_s[t * ld + d] * k_s[j * ld + d];
      }
      att_s[t * AS + j] = a;
    }
    __syncthreads();

    // out = q_dec S + att V + diag * v
    for (int i = tid; i < C * dv; i += kThreads) {
      const int t = i / dv;
      const int e = i - t * dv;
      float inter = 0.f;
      for (int d = 0; d < dk; ++d) inter += q_s[t * ld + d] * st_s[d * dv + e];
      float intra = 0.f;
      for (int j = 0; j < t; ++j) intra += att_s[t * AS + j] * v_s[j * dv + e];
      ob[(size_t)(t0 + t) * dv + e] =
          from_f32<T>(inter + intra + dg_s[t] * v_s[t * dv + e]);
    }
    __syncthreads();

    // S = S * exp(total decay) + k_tail^T V
    for (int i = tid; i < dk * dv; i += kThreads) {
      const int d = i / dv;
      const int e = i - d * dv;
      const float tot = inc_s[(C - 1) * lw_dim + (lw_dim == 1 ? 0 : d)];
      float upd = 0.f;
      for (int j = 0; j < C; ++j) upd += kt_s[j * ld + d] * v_s[j * dv + e];
      st_s[i] = st_s[i] * expf(tot) + upd;
    }
  }
  __syncthreads();
  float* sb = state + bh * (size_t)dk * dv;
  for (int i = tid; i < dk * dv; i += kThreads) sb[i] = st_s[i];
}

template <typename T, int C>
int launch(const void* q, const void* k, const void* v, const float* lw,
           const float* bonus, void* out, float* state, int batch, int heads,
           int seq, int dk, int dv, int lw_dim, int rwkv,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<C>();
  cudaError_t err = cudaFuncSetAttribute(
      linear_attn_chunk_kernel<T, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(heads, batch);
  linear_attn_chunk_kernel<T, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, bonus, static_cast<T*>(out), state, heads,
      seq, dk, dv, lw_dim, rwkv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_chunk(int chunk, const void* q, const void* k, const void* v,
                   const float* lw, const float* bonus, void* out,
                   float* state, int batch, int heads, int seq, int dk, int dv,
                   int lw_dim, int rwkv, cudaStream_t stream) {
  switch (chunk) {
    case 32:
      return launch<T, 32>(q, k, v, lw, bonus, out, state, batch, heads, seq,
                           dk, dv, lw_dim, rwkv, stream);
    case 64:
      return launch<T, 64>(q, k, v, lw, bonus, out, state, batch, heads, seq,
                           dk, dv, lw_dim, rwkv, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t code; 0 means the kernel was launched. `mode` is 1
// for rwkv (vector decay, bonus, o_t reads S_{t-1}) and 0 for ssd.
extern "C" int linear_attn_chunk(int dtype, int mode, int chunk,
                                 const void* q, const void* k, const void* v,
                                 const void* lw, int lw_dim,
                                 const void* bonus, void* out, void* state,
                                 int batch, int heads, int seq, int dk,
                                 int dv, void* stream) {
  if ((chunk != 32 && chunk != 64) || batch < 1 ||
      heads < 1 || batch > 65535 || heads > 65535 || seq < 1 ||
      seq % chunk != 0 || dk < 1 || dk > kMaxDim || dv < 1 ||
      dv > kMaxDim || (lw_dim != 1 && lw_dim != dk) ||
      (mode == 1 && bonus == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lwf = static_cast<const float*>(lw);
  const float* uf = static_cast<const float*>(bonus);
  float* st = static_cast<float*>(state);
  if (dtype == repro_kernels::kFloat32) {
    return dispatch_chunk<float>(chunk, q, k, v, lwf, uf, out, st, batch,
                                 heads, seq, dk, dv, lw_dim, mode, s);
  }
  if (dtype == repro_kernels::kBFloat16) {
    return dispatch_chunk<__nv_bfloat16>(chunk, q, k, v, lwf, uf, out, st,
                                         batch, heads, seq, dk, dv, lw_dim,
                                         mode, s);
  }
  return (int)cudaErrorInvalidValue;
}
