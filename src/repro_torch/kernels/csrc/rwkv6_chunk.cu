// Chunked linear attention with data-dependent decay for Hopper (sm_90a):
// chunk products on tensor cores in 3xTF32, double-buffered async loads.
//
// Replaces the Pallas TPU kernel `rwkv6_chunk` (`_rwkv_kernel`) in
// src/repro/kernels/rwkv6_chunk/kernel.py, and also returns the final state,
// which the Pallas kernel left to the XLA path. Two recurrences:
//   rwkv: S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//         o_t = q_t S_{t-1} + (q_t . (u * k_t)) v_t
//   ssd:  S_t = a_t S_{t-1} + k_t v_t^T,  o_t = q_t S_t
// computed chunk by chunk: per chunk the inclusive cumulative sum of the
// log-decay, the decayed operands, the strictly lower intra-chunk score
// matrix, the read of the carried state, the diagonal term and the state
// update, all in f32 (the algorithm of repro/models/linear_attn.py).
//
// Layouts (all contiguous, 16-byte aligned):
//   q, k   (B, H, T, dk)          storage type T
//   v, out (B, H, T, dv)          storage type T
//   lw     (B, H, T, lw_dim) f32  lw_dim = dk (rwkv) or 1 (ssd: one scalar
//                                 decay per step, never broadcast in memory)
//   bonus  (H, dk) f32            rwkv only (null for ssd)
//   state  (B, H, dk, dv) f32     written: the state after the last step
// T is a multiple of the chunk C (32 or 64; the wrapper pads with zero k, v
// and zero log-decay, which leaves the state unchanged); dk is 16, 32 or 64
// (compiled in) and dv a multiple of 8 up to 64.
//
// What bounds it on the H100: bytes at the main path's shapes (each input
// read once, the output and final state written once); the chunk products
// are ~C (dk + dv) flops per step and element, too many for CUDA cores in
// f32 to stay under the byte bound, and they need f32-grade accuracy: the
// decayed operands carry exp(+-inc) factors up to e^64, so one TF32 (or
// bf16) product, with three decimal digits, misses the 5e-4 tolerance.
// The design:
//
// * One block (4 warps) per (batch, head) loops over the chunks, since the
//   f32 (dk x dv) state carries across them; it lives in shared memory.
//   Shared memory is sized from the call's (C, dk, dv, lw_dim), so Hymba's
//   SSD heads (dk 16, dv 64, C 64, bf16) take 52 KB and four blocks share
//   an SM.
// * Chunk c+1's q, k, v and log-decay are copied with cp.async into the
//   second of two stages while chunk c computes.
// * The inclusive log-decay sum is a warp shuffle scan (rows l and l + 32
//   on lane l, Hillis-Steele over the 32 lanes, then the carry): a fixed
//   order. In ssd mode one warp scans the single column and leaves three
//   factors per row; in rwkv mode the warps scan four columns at a time and
//   write the decayed operands directly.
// * The four chunk products run on tensor cores (mma.sync m16n8k8, TF32 in,
//   f32 accumulate) in 3xTF32, the split done by integer rounding of the
//   bits (cvt.rna's result in two instructions). Warp w owns rows 16w ..
//   16w+15 of the chunk, with its Q_dec fragments held in registers (dk is
//   compiled in): it computes their scores Q_dec K_dec^T two 8-column
//   tiles at a time up to the diagonal, masks them in registers (zero
//   above, the diagonal term on the diagonal), turns each into an A
//   fragment by shuffles and multiplies it into att V at once, so the
//   score matrix never touches shared memory; then Q_dec S into the same
//   accumulators. The state update K_tail^T V gives each warp two 8-column
//   tiles of every 16-row tile. Independent products are issued pass by
//   pass (all lo x hi, then all hi x lo, then all hi x hi) so that they
//   overlap; bf16 V is exact in TF32, so its hi x lo pass (exact zeros) is
//   skipped.
// * The diagonal term takes one 16-byte chunk of a row per lane, summed
//   over the row's lanes by shuffles.
// Fixed reduction orders and no atomics: results are bitwise reproducible.
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro_kernels::cp_async_16;
using repro_kernels::cp_async_commit;
using repro_kernels::cp_async_wait;
using repro_kernels::d_to_a;
using repro_kernels::mma_3xtf32;
using repro_kernels::mma_3xtf32_n;
using repro_kernels::smem_addr;
using repro_kernels::Tf32A;
using repro_kernels::Tf32B;
using repro_kernels::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 64;          // dk and dv
constexpr int kMaxDvTiles = kMaxDim / 8;

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Shared memory of one call, in bytes from the start; every region starts
// on 16 bytes. Row strides are padded so that the fragment loads of
// mma.sync hit 32 distinct banks.
struct Layout {
  int ldr, ldv, ldl;        // raw q/k, v (elements of T) and lw (floats)
  int ldk, ldt, lds;        // q_dec/k_dec, k_tail and state (floats)
  int q_raw, k_raw, v_raw, lw_raw, stage;  // offsets within a stage; size
  int qd, kd, kt, st, fac, tot, dg, u, bytes;

  __host__ __device__ Layout(int chunk, int dk, int dv, int lw_dim,
                             int elem) {
    ldr = dk + 16 / elem;
    ldv = dv + 8;
    ldl = lw_dim == 1 ? 1 : lw_dim + 4;
    ldk = dk + 4;
    ldt = dk + 8;
    lds = dv + 8;
    q_raw = 0;
    k_raw = q_raw + align16(chunk * ldr * elem);
    v_raw = k_raw + align16(chunk * ldr * elem);
    lw_raw = v_raw + align16(chunk * ldv * elem);
    stage = lw_raw + align16(chunk * ldl * 4);
    qd = 2 * stage;
    kd = qd + align16(chunk * ldk * 4);
    kt = kd + align16(chunk * ldk * 4);
    st = kt + align16(chunk * ldt * 4);
    fac = st + align16(dk * lds * 4);
    tot = fac + align16(3 * chunk * 4);
    dg = tot + align16(dk * 4);
    u = dg + align16(chunk * 4);
    bytes = u + align16(dk * 4);
  }
};

// Copies `rows` rows of `row_bytes` (a multiple of 16) from global memory
// into shared memory rows `stride` bytes apart, asynchronously.
__device__ __forceinline__ void copy_rows(uint32_t dst, const void* src,
                                          int rows, int row_bytes,
                                          int stride) {
  const int per_row = row_bytes / 16;
  const char* s = static_cast<const char*>(src);
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = i - r * per_row;
    cp_async_16(dst + r * stride + c * 16, s + (size_t)r * row_bytes + c * 16);
  }
}

// Inclusive sum over the 32 lanes, Hillis-Steele: a fixed order.
__device__ __forceinline__ float warp_scan(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 3xTF32 fragments from shared memory, for the tile at (row r0, k k0) of A
// or (k k0, column n0) of B; g = lane / 4, c = lane % 4.
// A stored row-major: A(i, j) at a[i * ld + j].
__device__ __forceinline__ Tf32A frag_a(const float* a, int ld, int r0,
                                        int k0, int g, int c) {
  const float* p = a + (r0 + g) * ld + k0 + c;
  const float f[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
  return Tf32A(f);
}
// A stored transposed: A(i, j) at a[j * ld + i].
__device__ __forceinline__ Tf32A frag_at(const float* a, int ld, int r0,
                                         int k0, int g, int c) {
  const float* p = a + (k0 + c) * ld + r0 + g;
  const float f[4] = {p[0], p[8], p[4 * ld], p[4 * ld + 8]};
  return Tf32A(f);
}
// B stored k-major: B(k, n) at b[k * ld + n]; bf16 values are exact in
// TF32 (no lo part).
__device__ __forceinline__ Tf32B frag_b(const float* b, int ld, int k0,
                                        int n0, int g, int c) {
  const float* p = b + (k0 + c) * ld + n0 + g;
  return Tf32B(p[0], p[4 * ld]);
}
__device__ __forceinline__ Tf32B frag_b(const __nv_bfloat16* b, int ld,
                                        int k0, int n0, int g, int c) {
  const __nv_bfloat16* p = b + (k0 + c) * ld + n0 + g;
  return Tf32B::exact(to_f32(p[0]), to_f32(p[4 * ld]));
}
// B stored n-major: B(k, n) at b[n * ld + k].
__device__ __forceinline__ Tf32B frag_bt(const float* b, int ld, int k0,
                                         int n0, int g, int c) {
  const float* p = b + (n0 + g) * ld + k0 + c;
  return Tf32B(p[0], p[4]);
}

// A 16-byte chunk of T values as floats.
__device__ __forceinline__ void load_chunk(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Four floats to 16-byte-aligned shared memory.
__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

// DK (16, 32 or 64) is compiled in: it sets the k-steps of the products,
// the state's row tiles and the warp's register tiles. dv is a run-time
// multiple of 8 up to 64 (the kernel's tiles are 64 wide; columns past dv
// multiply zeros and are never stored).
template <typename T, int C, int DK>
__global__ void __launch_bounds__(kThreads, DK <= 16 ? 4 : 1)
linear_attn_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ lw,
                         const float* __restrict__ bonus, T* __restrict__ out,
                         float* __restrict__ state, int heads, int seq,
                         int dv, int lw_dim, int rwkv) {
  constexpr int R = C / 32;         // scan rows per lane
  constexpr int KS = DK / 8;        // k-steps over dk
  constexpr int MT = DK / 16;       // 16-row tiles of the state
  constexpr int NT = kMaxDvTiles;   // 8-column tiles of the output
  constexpr int NV = NT / kWarps;   // of the state per warp
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = DK / EPC;     // chunks per row of q or k
  constexpr bool kExactV = sizeof(T) == 2;  // bf16 V: no lo part
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int ndv = dv / 8;
  const Layout L(C, DK, dv, lw_dim, (int)sizeof(T));

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = smem_addr(smem);
  float* qd = reinterpret_cast<float*>(smem + L.qd);
  float* kd = reinterpret_cast<float*>(smem + L.kd);
  float* kt = reinterpret_cast<float*>(smem + L.kt);
  float* st = reinterpret_cast<float*>(smem + L.st);
  float* fac = reinterpret_cast<float*>(smem + L.fac);
  float* tot_s = reinterpret_cast<float*>(smem + L.tot);
  float* dg = reinterpret_cast<float*>(smem + L.dg);
  float* u_s = reinterpret_cast<float*>(smem + L.u);

  const size_t bh = (size_t)b * heads + h;
  const T* qb = q + bh * (size_t)seq * DK;
  const T* kb = k + bh * (size_t)seq * DK;
  const T* vb = v + bh * (size_t)seq * dv;
  const float* lwb = lw + bh * (size_t)seq * lw_dim;
  T* ob = out + bh * (size_t)seq * dv;
  const int n_chunks = seq / C;

  // chunk c's raw inputs into stage c % 2; always one commit group
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const uint32_t s = sbase + (c & 1) * L.stage;
      const size_t t0 = (size_t)c * C;
      const int e = (int)sizeof(T);
      copy_rows(s + L.q_raw, qb + t0 * DK, C, DK * e, L.ldr * e);
      copy_rows(s + L.k_raw, kb + t0 * DK, C, DK * e, L.ldr * e);
      copy_rows(s + L.v_raw, vb + t0 * dv, C, dv * e, L.ldv * e);
      if (lw_dim == 1) {
        copy_rows(s + L.lw_raw, lwb + t0, 1, C * 4, 0);
      } else {
        copy_rows(s + L.lw_raw, lwb + t0 * lw_dim, C, lw_dim * 4, L.ldl * 4);
      }
    }
    cp_async_commit();
  };
  issue(0);

  for (int i = tid; i < DK * L.lds; i += kThreads) st[i] = 0.f;
  if (rwkv) {
    for (int i = tid; i < DK; i += kThreads) u_s[i] = bonus[(size_t)h * DK + i];
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();  // chunk c has landed (this thread's copies)
    __syncthreads();     // ... everyone's; chunk c-1 is finished
    issue(c + 1);        // into the stage chunk c-1 used
    const unsigned char* sg = smem + (c & 1) * L.stage;
    const T* q_r = reinterpret_cast<const T*>(sg + L.q_raw);
    const T* k_r = reinterpret_cast<const T*>(sg + L.k_raw);
    const T* v_r = reinterpret_cast<const T*>(sg + L.v_raw);
    const float* lw_r = reinterpret_cast<const float*>(sg + L.lw_raw);

    // inclusive log-decay sum: lane holds rows lane + 32 i, i < R
    if (lw_dim == 1) {
      if (warp == 0) {
        float carry = 0.f, inc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          inc[i] = carry + warp_scan(lw_r[lane + 32 * i], lane);
          carry = __shfl_sync(0xffffffffu, inc[i], 31);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int t = lane + 32 * i;
          fac[t] = expf(inc[i]);                // q: decayed through t
          fac[C + t] = expf(-inc[i]);           // k: decay undone at t
          fac[2 * C + t] = expf(carry - inc[i]);  // k: carried to the end
        }
        if (lane == 0) tot_s[0] = carry;
      }
    } else {
      // four columns a group, all of a warp's groups interleaved; q to t - 1
      // (the exclusive sum), k undone at t, k carried to the chunk's end
#pragma unroll
      for (int cg = 0; cg < DK / 16; ++cg) {
        const int col = 4 * warp + 16 * cg;
        float carry[4] = {0.f, 0.f, 0.f, 0.f};
        float x[R][4], inc[R][4];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          load_chunk(lw_r + (lane + 32 * i) * L.ldl + col, x[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            inc[i][j] = carry[j] + warp_scan(x[i][j], lane);
            carry[j] = __shfl_sync(0xffffffffu, inc[i][j], 31);
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int t = lane + 32 * i;
          float fq[4], fk[4], ft[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float qv = to_f32(q_r[t * L.ldr + col + j]);
            const float kv = to_f32(k_r[t * L.ldr + col + j]);
            fq[j] = qv * expf(inc[i][j] - x[i][j]);
            fk[j] = kv * expf(-inc[i][j]);
            ft[j] = kv * expf(carry[j] - inc[i][j]);
          }
          store4(qd + t * L.ldk + col, fq);
          store4(kd + t * L.ldk + col, fk);
          store4(kt + t * L.ldt + col, ft);
        }
        if (lane == 0) store4(tot_s + col, carry);
      }
    }
    __syncthreads();

    // the diagonal term (and, in ssd mode, the decayed operands): one
    // 16-byte chunk of a row per lane, the row's chunks on CPR neighbouring
    // lanes, summed by shuffles
    for (int i = tid; i < C * CPR; i += kThreads) {
      const int t = i / CPR;
      const int d0 = (i - t * CPR) * EPC;
      float qv[EPC], kv[EPC];
      load_chunk(q_r + t * L.ldr + d0, qv);
      load_chunk(k_r + t * L.ldr + d0, kv);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < EPC; ++e) s += qv[e] * (rwkv ? u_s[d0 + e] : 1.f) * kv[e];
      if (!rwkv) {
#pragma unroll
        for (int e0 = 0; e0 < EPC; e0 += 4) {
          float fq[4], fk[4], ft[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            fq[e] = qv[e0 + e] * fac[t];
            fk[e] = kv[e0 + e] * fac[C + t];
            ft[e] = kv[e0 + e] * fac[2 * C + t];
          }
          store4(qd + t * L.ldk + d0 + e0, fq);
          store4(kd + t * L.ldk + d0 + e0, fk);
          store4(kt + t * L.ldt + d0 + e0, ft);
        }
      }
#pragma unroll
      for (int off = CPR / 2; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (d0 == 0) dg[t] = s;
    }
    __syncthreads();

    // warp w's output rows: att V up to the diagonal, then Q_dec S
    const int m0 = 16 * warp;
    if (m0 < C) {
      Tf32A aq[KS];  // the warp's rows of Q_dec, for every k-step
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) aq[ks] = frag_a(qd, L.ldk, m0, 8 * ks, g, c4);
      float o[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;
      }
      // two 8-column score tiles at a time
      for (int j0 = 0; j0 < m0 + 16; j0 += 16) {
        float sc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const Tf32B kf[2] = {frag_bt(kd, L.ldk, 8 * ks, j0, g, c4),
                               frag_bt(kd, L.ldk, 8 * ks, j0 + 8, g, c4)};
          mma_3xtf32_n(sc, aq[ks], kf);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          // strictly lower scores, the diagonal term on the diagonal
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = m0 + g + 8 * (i >> 1);
            const int col = j0 + 8 * jj + 2 * c4 + (i & 1);
            sc[jj][i] = col < row ? sc[jj][i] : (col == row ? dg[row] : 0.f);
          }
          float a[4];
          d_to_a(sc[jj], a);
          Tf32B vf[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            vf[nt] = nt < ndv ? frag_b(v_r, L.ldv, j0 + 8 * jj, 8 * nt, g, c4)
                              : Tf32B(0.f, 0.f);
          }
          mma_3xtf32_n<kExactV>(o, Tf32A(a), vf);
        }
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        Tf32B sf[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          sf[nt] = nt < ndv ? frag_b(st, L.lds, 8 * ks, 8 * nt, g, c4)
                            : Tf32B(0.f, 0.f);
        }
        mma_3xtf32_n(o, aq[ks], sf);
      }
      T* orow = ob + ((size_t)c * C + m0 + g) * dv;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < ndv) {
          const int e = 8 * nt + 2 * c4;
          store2(orow + e, o[nt][0], o[nt][1]);
          store2(orow + 8 * dv + e, o[nt][2], o[nt][3]);
        }
      }
    }
    __syncthreads();  // every warp has read the state

    // S = S * exp(total decay) + K_tail^T V: warp w takes the state's
    // column tiles w and w + 4 (8 columns of dv each) in every 16-row tile
    // of dk, all in flight at each k-step
    float ua[MT * NV][4] = {};
#pragma unroll 2
    for (int j0 = 0; j0 < C; j0 += 8) {
      Tf32B vcol[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int nt = warp + kWarps * v;
        vcol[v] = nt < ndv ? frag_b(v_r, L.ldv, j0, 8 * nt, g, c4)
                           : Tf32B(0.f, 0.f);
      }
      Tf32A ka[MT * NV];
      Tf32B vf[MT * NV];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const Tf32A a = frag_at(kt, L.ldt, 16 * mt, j0, g, c4);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          ka[mt * NV + v] = a;
          vf[mt * NV + v] = vcol[v];
        }
      }
      mma_3xtf32_n<kExactV>(ua, ka, vf);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int nt = warp + kWarps * v;
        if (nt < ndv) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = 16 * mt + g + 8 * (i >> 1);
            const int e = 8 * nt + 2 * c4 + (i & 1);
            float* sp = st + d * L.lds + e;
            *sp = *sp * expf(tot_s[lw_dim == 1 ? 0 : d]) + ua[mt * NV + v][i];
          }
        }
      }
    }
  }
  __syncthreads();
  float* sb = state + bh * (size_t)DK * dv;
  for (int i = tid; i < DK * dv; i += kThreads) {
    const int d = i / dv;
    sb[i] = st[d * L.lds + (i - d * dv)];
  }
}

constexpr int kTileN = 64, kTileLd = kTileN + 4, kTileLdc = kTileN + 8;
constexpr int kTileSmem = (2 * kTileN * kTileLd + kTileN * kTileLdc) * 4;

// The kernel's fragment loads and 3xTF32 products on bare 64 x 64 f32
// tiles, one warp per 16 rows: S = A B^T (A row-major, B n-major, as
// Q_dec K_dec^T), O = S C with S's accumulators re-laid out as A fragments
// (as att V), U = A^T C (A read transposed, as K_tail^T V).
__global__ void __launch_bounds__(kThreads)
tile_check_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ cm, float* __restrict__ s,
                  float* __restrict__ o, float* __restrict__ u) {
  extern __shared__ __align__(16) float tiles[];
  float* a_s = tiles;
  float* b_s = a_s + kTileN * kTileLd;
  float* c_s = b_s + kTileN * kTileLd;
  constexpr int N = kTileN, LD = kTileLd, LDC = kTileLdc;
  for (int i = threadIdx.x; i < N * N; i += kThreads) {
    const int r = i / N, col = i - r * N;
    a_s[r * LD + col] = a[i];
    b_s[r * LD + col] = b[i];
    c_s[r * LDC + col] = cm[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c4 = lane & 3, m0 = 16 * warp;
  float acc[N / 8][4] = {};
  for (int j0 = 0; j0 < N; j0 += 8) {
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < N; k0 += 8) {
      mma_3xtf32(sc, frag_a(a_s, LD, m0, k0, g, c4),
                 frag_bt(b_s, LD, k0, j0, g, c4));
    }
    store2(s + (m0 + g) * N + j0 + 2 * c4, sc[0], sc[1]);
    store2(s + (m0 + g + 8) * N + j0 + 2 * c4, sc[2], sc[3]);
    float f[4];
    d_to_a(sc, f);
    const Tf32A af(f);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      mma_3xtf32(acc[nt], af, frag_b(c_s, LDC, j0, 8 * nt, g, c4));
    }
  }
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    store2(o + (m0 + g) * N + 8 * nt + 2 * c4, acc[nt][0], acc[nt][1]);
    store2(o + (m0 + g + 8) * N + 8 * nt + 2 * c4, acc[nt][2], acc[nt][3]);
  }
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < N; j0 += 8) {
      mma_3xtf32(d, frag_at(a_s, LD, m0, j0, g, c4),
                 frag_b(c_s, LDC, j0, 8 * nt, g, c4));
    }
    store2(u + (m0 + g) * N + 8 * nt + 2 * c4, d[0], d[1]);
    store2(u + (m0 + g + 8) * N + 8 * nt + 2 * c4, d[2], d[3]);
  }
}

// The largest shared memory of a call of this instance, allowed once.
template <typename T, int C, int DK>
cudaError_t allow_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      linear_attn_chunk_kernel<T, C, DK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout(C, DK, kMaxDim, DK, (int)sizeof(T)).bytes);
  return attr;
}

struct Launch {
  const void *q, *k, *v;
  const float *lw, *bonus;
  void* out;
  float* state;
  int batch, heads, seq, dv, lw_dim, rwkv;
  cudaStream_t stream;

  template <typename T, int C, int DK>
  int run() const {
    const cudaError_t attr = allow_smem<T, C, DK>();
    if (attr != cudaSuccess) return (int)attr;
    const Layout L(C, DK, dv, lw_dim, (int)sizeof(T));
    linear_attn_chunk_kernel<T, C, DK>
        <<<dim3(heads, batch), kThreads, L.bytes, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), lw, bonus, static_cast<T*>(out), state,
            heads, seq, dv, lw_dim, rwkv);
    return (int)cudaGetLastError();
  }
};

// Dynamic shared memory of a call and the blocks that fit on one SM.
struct Occupancy {
  int dv, lw_dim;
  int *smem, *blocks;

  template <typename T, int C, int DK>
  int run() const {
    const cudaError_t attr = allow_smem<T, C, DK>();
    if (attr != cudaSuccess) return (int)attr;
    *smem = Layout(C, DK, dv, lw_dim, (int)sizeof(T)).bytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, linear_attn_chunk_kernel<T, C, DK>, kThreads, *smem);
  }
};

// f.run<T, C, DK>() for the compiled instance of (dtype, chunk, dk).
template <typename T, int C, typename F>
int by_dk(int dk, const F& f) {
  switch (dk) {
    case 16: return f.template run<T, C, 16>();
    case 32: return f.template run<T, C, 32>();
    case 64: return f.template run<T, C, 64>();
    default: return (int)cudaErrorInvalidValue;
  }
}
template <typename F>
int by_instance(int dtype, int chunk, int dk, const F& f) {
  const bool f32 = dtype == repro_kernels::kFloat32;
  if (!f32 && dtype != repro_kernels::kBFloat16) {
    return (int)cudaErrorInvalidValue;
  }
  switch (chunk) {
    case 32: return f32 ? by_dk<float, 32>(dk, f)
                        : by_dk<__nv_bfloat16, 32>(dk, f);
    case 64: return f32 ? by_dk<float, 64>(dk, f)
                        : by_dk<__nv_bfloat16, 64>(dk, f);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t code; 0 means the kernel was launched. `mode` is 1
// for rwkv (vector decay, bonus, o_t reads S_{t-1}) and 0 for ssd. dk is
// 16, 32 or 64; dv a multiple of 8 up to 64.
extern "C" int linear_attn_chunk(int dtype, int mode, int chunk,
                                 const void* q, const void* k, const void* v,
                                 const void* lw, int lw_dim,
                                 const void* bonus, void* out, void* state,
                                 int batch, int heads, int seq, int dk,
                                 int dv, void* stream) {
  if ((chunk != 32 && chunk != 64) || batch < 1 ||
      heads < 1 || batch > 65535 || heads > 65535 || seq < 1 ||
      seq % chunk != 0 || dv < 8 || dv > kMaxDim || dv % 8 != 0 ||
      lw_dim != (mode == 1 ? dk : 1) || (mode == 1 && bonus == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Launch f{q, k, v, static_cast<const float*>(lw),
                 static_cast<const float*>(bonus), out,
                 static_cast<float*>(state), batch, heads, seq, dv, lw_dim,
                 mode, static_cast<cudaStream_t>(stream)};
  return by_instance(dtype, chunk, dk, f);
}

// The bare tile check (tile_check_kernel): a, b, c (64, 64) f32 in; s, o, u
// (64, 64) f32 out. Returns a cudaError_t code.
extern "C" int linear_attn_tile_check(const void* a, const void* b,
                                      const void* c, void* s, void* o,
                                      void* u, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      tile_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTileSmem);
  if (attr != cudaSuccess) return (int)attr;
  tile_check_kernel<<<1, kThreads, kTileSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(s),
      static_cast<float*>(o), static_cast<float*>(u));
  return (int)cudaGetLastError();
}

// The dynamic shared memory (bytes) of a call at (chunk, dk, dv, lw_dim)
// and how many of its blocks fit on one SM. Returns a cudaError_t code.
extern "C" int linear_attn_occupancy(int dtype, int chunk, int dk, int dv,
                                     int lw_dim, int* smem, int* blocks) {
  return by_instance(dtype, chunk, dk, Occupancy{dv, lw_dim, smem, blocks});
}
