// Paged GQA decode attention for Hopper (sm_90a), plain CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_decode_paged` (`_paged_decode_kernel`)
// in src/repro/kernels/flash_decode/kernel.py. One query token per sequence
// attends that sequence's K/V rows, read straight out of one layer's block
// pool through its int32 block table; rows at positions >= lengths[b] are
// masked with the finite NEG_INF, and the softmax runs online in f32.
//
// Layouts (all contiguous):
//   q        (B, KH*G, dh)            one decode token per sequence
//   k/v pool (N, block_size, KH, dh)  one layer of the engine's pool
//   tables   (B, max_blocks) int32    physical block of each logical block
//   lengths  (B,) int32               valid rows per sequence
//   out      (B, KH*G, dh)
//
// What bounds it on the H100: the bytes of K/V it reads (2 * len * dh per
// KV head and sequence) against 3.35 TB/s; the arithmetic is ~2 flops per
// byte. The simple design: one thread block per (sequence, KV head) walks
// the table in order over ceil(len / block_size) blocks, stages each K/V
// block in shared memory once and serves all G query heads of the KV head
// from it, so every K/V byte is read from device memory once. The walk is
// sequential with a fixed reduction order and no atomics, which keeps two
// sequences whose tables alias the same blocks bitwise equal. It leaves
// parallelism on the table at small B*KH (no split-KV) and uses no
// vectorized or asynchronous loads: work for a later change.
//
// lengths[b] == 0 walks the whole table with every row masked, which (with
// the finite NEG_INF) is the uniform average over the table rows, exactly
// as the plain version computes it.
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

using repro_kernels::from_f32;
using repro_kernels::kNegInf;
using repro_kernels::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;      // query heads per KV head
constexpr int kMaxDhPerThread = 2;  // head_dim <= 256

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int kv_heads, int group, int head_dim, int block_size,
                    int max_blocks, float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                          // group * head_dim
  float* k_s = q_s + group * head_dim;        // block_size * head_dim
  float* v_s = k_s + block_size * head_dim;   // block_size * head_dim
  float* p_s = v_s + block_size * head_dim;   // group * block_size
  float* m_s = p_s + group * block_size;      // kMaxGroup
  float* l_s = m_s + kMaxGroup;               // kMaxGroup
  float* c_s = l_s + kMaxGroup;               // kMaxGroup

  const int heads = kv_heads * group;
  const size_t q_off = ((size_t)b * heads + (size_t)kh * group) * head_dim;
  for (int i = tid; i < group * head_dim; i += kThreads) {
    q_s[i] = to_f32(q[q_off + i]);
  }
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int len = lengths[b];
  int n_blocks = len > 0 ? (len + block_size - 1) / block_size : max_blocks;
  if (n_blocks > max_blocks) n_blocks = max_blocks;

  float acc[kMaxGroup][kMaxDhPerThread];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int i = 0; i < kMaxDhPerThread; ++i) acc[g][i] = 0.f;
  }

  const size_t row_stride = (size_t)kv_heads * head_dim;
  const size_t block_stride = (size_t)block_size * row_stride;
  for (int j = 0; j < n_blocks; ++j) {
    __syncthreads();  // the previous block's readers are done with k_s/v_s/p_s
    const size_t base = (size_t)tables[(size_t)b * max_blocks + j] *
                            block_stride + (size_t)kh * head_dim;
    for (int i = tid; i < block_size * head_dim; i += kThreads) {
      const int r = i / head_dim;
      const int d = i - r * head_dim;
      k_s[i] = to_f32(k_pool[base + r * row_stride + d]);
      v_s[i] = to_f32(v_pool[base + r * row_stride + d]);
    }
    __syncthreads();

    // scores: one warp per (query head, row), lanes split head_dim
    for (int pr = warp; pr < group * block_size; pr += kWarps) {
      const int g = pr / block_size;
      const int r = pr - g * block_size;
      float part = 0.f;
      for (int d = lane; d < head_dim; d += 32) {
        part += q_s[g * head_dim + d] * k_s[r * head_dim + d];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      if (lane == 0) {
        p_s[pr] = (j * block_size + r < len) ? part * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax statistics, one thread per query head
    if (tid < group) {
      float* row = p_s + tid * block_size;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int r = 0; r < block_size; ++r) m_new = fmaxf(m_new, row[r]);
      float sum = 0.f;
      for (int r = 0; r < block_size; ++r) {
        const float p = expf(row[r] - m_new);
        row[r] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = m_new;
      c_s[tid] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V, each thread owning head_dim columns
#pragma unroll
    for (int i = 0; i < kMaxDhPerThread; ++i) {
      const int d = tid + i * kThreads;
      if (d < head_dim) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < group) {
            const float* prow = p_s + g * block_size;
            float a = acc[g][i] * c_s[g];
            for (int r = 0; r < block_size; ++r) {
              a += prow[r] * v_s[r * head_dim + d];
            }
            acc[g][i] = a;
          }
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kMaxDhPerThread; ++i) {
    const int d = tid + i * kThreads;
    if (d < head_dim) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          const float denom = fmaxf(l_s[g], 1e-30f);
          out[q_off + (size_t)g * head_dim + d] = from_f32<T>(acc[g][i] / denom);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* out, int batch,
           int kv_heads, int group, int head_dim, int block_size,
           int max_blocks, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)group * head_dim +
                       2 * (size_t)block_size * head_dim +
                       (size_t)group * block_size + 3 * kMaxGroup);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kv_heads, batch);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), kv_heads, group,
      head_dim, block_size, max_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code; 0 means the kernel was launched.
extern "C" int paged_decode(int dtype, const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* lengths, void* out, int batch,
                            int kv_heads, int group, int head_dim,
                            int block_size, int max_blocks, float scale,
                            void* stream) {
  if (group < 1 || group > kMaxGroup || head_dim < 1 ||
      head_dim > kThreads * kMaxDhPerThread || block_size < 1 ||
      max_blocks < 1 || batch < 1 || kv_heads < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro_kernels::kFloat32) {
    return launch<float>(q, k_pool, v_pool, tables, lengths, out, batch,
                         kv_heads, group, head_dim, block_size, max_blocks,
                         scale, s);
  }
  if (dtype == repro_kernels::kBFloat16) {
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out,
                                 batch, kv_heads, group, head_dim, block_size,
                                 max_blocks, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
