// Hopper (sm_90a) building blocks shared by the port's kernels: 16-byte
// asynchronous copies (cp.async), warpgroup matrix multiplies (wgmma) on
// bf16 tiles kept in 128-byte-swizzled shared memory, and warp-level TF32
// products (mma.sync) in three passes for f32-grade results (3xTF32).
//
// Tile layout ("swizzled tile" below). A tile of R rows by C bf16 columns
// (C a multiple of 64) is stored as C / 64 column blocks of R rows x 128
// bytes, one after another; inside a block, the 16-byte chunk c (0..7) of
// row r sits at chunk c ^ (r % 8). That is the hardware's 128-byte swizzle,
// which wgmma undoes when its descriptor says so. Every tile starts at a
// multiple of 1024 bytes in shared memory, where the swizzle pattern
// starts over. Narrower tiles (C = 32) are stored 64 columns wide and the
// extra columns never read.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace repro_kernels {

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes from global to shared memory asynchronously; with
// `bytes` == 0 nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Orders this thread's shared-memory writes before later reads by the
// async proxy (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `chunk` (0 .. C/8-1) of row `row` in a
// swizzled tile of `rows` rows.
__device__ __forceinline__ uint32_t swizzled_offset(int rows, int row,
                                                    int chunk) {
  return (uint32_t)((chunk >> 3) * rows * 128 + row * 128 +
                    (((chunk & 7) ^ (row & 7)) << 4));
}

// -------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle. For a K-major operand
// (K contiguous: Q and K in S = Q K^T) `lead` is unused (16) and `stride`
// is the distance between 8-row groups (1024). For an MN-major operand
// (N contiguous: V in O = P V) `lead` is the distance between 64-column
// blocks and `stride` the distance between groups of 8 rows along K.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator fragment of m64nNk16 (f32): register j of thread t holds
// row 16 * (t / 32) + (t % 32) / 4 + 8 * ((j / 2) % 2) and column
// 8 * (j / 4) + 2 * (t % 4) + j % 2. The A fragment from registers (four
// b32 of two bf16 each) has the same row/column pattern over 16 columns,
// so accumulator registers 8k .. 8k+7 of S, packed in pairs, are the A
// fragment of k-step k of P V.

#define REPRO_WGMMA_D32                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define REPRO_WGMMA_OUT32(d)                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// D(64x32) (+)= A(64x16, shared, K-major) B(16x32, shared, K-major);
// scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D(64xN) += A(64x16, registers) B(16xN, shared, MN-major), N = 64 or 128
// by the accumulator's size.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_mn(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef REPRO_WGMMA_D32
#undef REPRO_WGMMA_OUT32

// ------------------------------------------------------- mma.sync, 3xTF32
// Fragments of mma.m16n8k8 with TF32 operands, for lane l of a warp, with
// g = l / 4 and c = l % 4:
//   A (16 x 8):  a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4)
//   B (8 x 8):   b0 (c, g), b1 (c + 4, g)          (row = k, column = n)
//   D (16 x 8):  d0 (g, 2c), d1 (g, 2c + 1), d2 (g + 8, 2c), d3 (g + 8,
//                2c + 1)
// 3xTF32: an f32 operand x splits into hi = tf32(x) and lo = tf32(x - hi),
// both rounded to nearest (as cvt.rna), and a b ~ a_lo b_hi + a_hi b_lo +
// a_hi b_hi; the dropped a_lo b_lo and the rounding of lo leave about 2^-21
// of the product, against 2^-11 for one TF32 product.
// cvt.rna.tf32.f32 on the bits, in two integer operations: add half of the
// 13 dropped mantissa bits to the magnitude, then clear them (round to
// nearest, ties away from zero; the same result for every finite value
// below the overflow edge).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// D(16x8) += A(16x8) B(8x8), TF32 in, f32 accumulate. Not volatile: the
// compiler may interleave independent products to hide their latency.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An f32 A fragment (a[0..3]) and B fragment (b[0..1]) as split operands.
struct Tf32A {
  uint32_t hi[4], lo[4];
  Tf32A() = default;
  __device__ __forceinline__ explicit Tf32A(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(a[i], hi[i], lo[i]);
  }
};
struct Tf32B {
  uint32_t hi[2], lo[2];
  Tf32B() = default;
  __device__ __forceinline__ Tf32B(float b0, float b1) {
    tf32_split(b0, hi[0], lo[0]);
    tf32_split(b1, hi[1], lo[1]);
  }
  // Values that TF32 holds exactly (bf16 ones): hi is the value, lo is 0.
  __device__ __forceinline__ static Tf32B exact(float b0, float b1) {
    Tf32B b;
    b.hi[0] = __float_as_uint(b0);
    b.hi[1] = __float_as_uint(b1);
    b.lo[0] = b.lo[1] = 0u;
    return b;
  }
};

// D += A B in 3xTF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Tf32A& a,
                                           const Tf32B& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// D[i] += A[i] B[i] in 3xTF32 for N independent tiles, pass by pass, so
// that each pass's N products are in flight together (each D[i] still
// sums its terms in mma_3xtf32's order). kExactB: every B is exact in TF32
// (lo == 0), so the a_hi b_lo pass, which adds exact zeros, is skipped.
template <bool kExactB = false, int N>
__device__ __forceinline__ void mma_3xtf32_n(float (&d)[N][4],
                                             const Tf32A (&a)[N],
                                             const Tf32B (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a[i].lo, b[i].hi);
  if (!kExactB) {
#pragma unroll
    for (int i = 0; i < N; ++i) mma_tf32(d[i], a[i].hi, b[i].lo);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a[i].hi, b[i].hi);
}

// The same with one A for every tile.
template <bool kExactB = false, int N>
__device__ __forceinline__ void mma_3xtf32_n(float (&d)[N][4],
                                             const Tf32A& a,
                                             const Tf32B (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a.lo, b[i].hi);
  if (!kExactB) {
#pragma unroll
    for (int i = 0; i < N; ++i) mma_tf32(d[i], a.hi, b[i].lo);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a.hi, b[i].hi);
}

// The D fragment of one 16x8 tile, re-laid out as the A fragment of the
// same 16x8 tile (for a product that consumes it along k), by shuffles
// inside each group of four lanes.
__device__ __forceinline__ void d_to_a(const float (&d)[4], float (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int src0 = (lane & ~3) | (c >> 1);  // holds columns 2(c/2), +1
  const int src4 = src0 + 2;                // holds column c + 4
  const bool odd = c & 1;
  float x0 = __shfl_sync(0xffffffffu, d[0], src0);
  float x1 = __shfl_sync(0xffffffffu, d[1], src0);
  float y0 = __shfl_sync(0xffffffffu, d[2], src0);
  float y1 = __shfl_sync(0xffffffffu, d[3], src0);
  a[0] = odd ? x1 : x0;
  a[1] = odd ? y1 : y0;
  x0 = __shfl_sync(0xffffffffu, d[0], src4);
  x1 = __shfl_sync(0xffffffffu, d[1], src4);
  y0 = __shfl_sync(0xffffffffu, d[2], src4);
  y1 = __shfl_sync(0xffffffffu, d[3], src4);
  a[2] = odd ? x1 : x0;
  a[3] = odd ? y1 : y0;
}

// Two floats as one b32 of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace repro_kernels
