// Paged latent (MLA) decode attention for Hopper (sm_90a): split-KV over a
// block pool of latent rows, every row read once for all heads, both
// products on the tensor cores (mma.sync), with a fixed-order merge.
//
// Replaces no TPU kernel: the JAX package has no latent attention. It is
// the decode kernel of DeepSeek-V3-style multi-head latent attention
// (arXiv:2405.04434 §2.1) in its absorbed form: the caller folds each
// head's key up-projection into its query, so that every head attends the
// cached latent rows [c_kv | k_pe] themselves, and unfolds the value
// up-projection from the result. K is the whole row (KD = 576 columns), V
// its first VD = 512 (c_kv); one query token per sequence; rows at
// positions >= lengths[b] are masked with the finite NEG_INF; the softmax
// runs online in f32 with the caller's scale (1/sqrt(qk head dim), not
// 1/sqrt(KD)). bf16 only.
//
// Layouts (all contiguous, 16-byte aligned):
//   q        (B, H, KD)             the absorbed queries, H = 16 or 64
//   pool     (N, block_size, KD)    one layer of the engine's latent pool
//   tables   (B, max_blocks) int32  physical block of each logical block
//   lengths  (B,) int32             valid rows per sequence
//   out      (B, H, VD)
//   scratch  f32, (B, H, splits, VD) partial sums then (B, H, splits, 2)
//            partial (max, sum); unused with one split
//
// What bounds it on the H100: bytes, KD * 2 per cached row, read once for
// all H heads, against 3.35 TB/s. The arithmetic, H * (KD + VD)
// multiply-adds a row (30 flops a byte at 16 heads, 121 at 64, against a
// ridge near 295), would hold CUDA cores near or past the bandwidth line,
// so both products run on the tensor cores: each 16 heads are exactly the
// M = 16 of mma.m16n8k16, and a 16-row tile of the pool is the N of
// S = Q K^T and the K of O = P V. The design:
//
// * Split-KV (flash-decoding) as the paged GQA kernel: the grid is
//   (splits, B), a split a fixed run of `entries_per_split` table entries
//   (64 rows at 16-row blocks, from block_size alone), so the partition
//   depends only on logical position and never on the batch. Splits past a
//   sequence's last entry leave at once. Each split writes its f32 (max,
//   sum, acc[VD]) per head to scratch, and a second kernel merges each
//   (sequence, head) in split order: no atomics, so aliased tables give
//   bitwise-equal outputs. With one split the first kernel writes the
//   output itself.
// * The queries (H x KD) and 16-row tiles of the pool sit in shared memory
//   with rows padded to KD + 8 columns (successive rows 4 banks apart, so
//   ldmatrix reads them without conflicts); the tiles come through a ring
//   of 4 stages of cp.async 16-byte copies (a 64-row split in flight at
//   once), rows past the split zero-filled.
// * Four warps for each 16 heads (one M-tile): 4 at 16 heads, 16 at 64,
//   all over the same shared tiles, so that a CTA reads each row once for
//   every head. Each warp computes its M-tile's scores S (16 heads x 16
//   rows) by itself, KD / 16 k-steps of two m16n8k16 products in two
//   accumulator chains, operands by ldmatrix; runs the online softmax on
//   the accumulator fragments (row max and sum by quad shuffles, log2
//   domain); rounds P to bf16 in registers, where the accumulator layout
//   is already the A fragment of P V; and accumulates O over its own 128
//   of the VD value columns (16 n-tiles, V read by ldmatrix.trans from the
//   same tile). At 64 heads the CTA holds 150 KB of shared memory and 512
//   threads, one CTA an SM.
//
// lengths[b] == 0 walks the whole table with every row masked: every
// split's max is the finite NEG_INF, so the result is the uniform average
// of the table's rows, as the plain version computes.
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro_kernels::cp_async_16;
using repro_kernels::cp_async_commit;
using repro_kernels::cp_async_wait;
using repro_kernels::kNegInf;
using repro_kernels::pack_bf16;
using repro_kernels::smem_addr;
using bf16 = __nv_bfloat16;

constexpr int kMH = 16;         // heads of one M-tile: the M of m16n8k16
constexpr int kKD = 576;        // latent row: kv_lora_rank 512 + rope 64
constexpr int kVD = 512;        // V: the row's first kv_lora_rank columns
constexpr int kStride = kKD + 8;  // padded shared-memory row, in elements
constexpr int kTileWarps = 4;   // warps of one M-tile, over VD's columns
constexpr int kTileRows = 16;   // rows per pipeline stage
constexpr int kStages = 4;
constexpr int kChunksPerRow = kKD * 2 / 16;
constexpr int kTileBytes = kTileRows * kStride * 2;
constexpr int kVColsPerWarp = kVD / kTileWarps;    // 128
constexpr int kNTiles = kVColsPerWarp / 8;         // 16 n-tiles of O
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kKD % 32 == 0 && kVD % (16 * kTileWarps) == 0, "tile shapes");

// The shape of one instance: kMT M-tiles of 16 heads.
template <int kMT>
struct Heads {
  static constexpr int kH = kMH * kMT;
  static constexpr int kThreads = 32 * kTileWarps * kMT;
  static constexpr int kQBytes = kH * kStride * 2;
  static constexpr int kSmem = kQBytes + kStages * kTileBytes;
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// D(16x8) += A(16x16) B(16x8), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int walked_entries(int len, int block_size,
                                              int max_blocks) {
  const int n = len > 0 ? (len + block_size - 1) / block_size : max_blocks;
  return n < max_blocks ? n : max_blocks;
}

template <int kMT>
__global__ void __launch_bounds__(Heads<kMT>::kThreads)
latent_decode_split_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ pool,
                           const int* __restrict__ tables,
                           const int* __restrict__ lengths,
                           bf16* __restrict__ out, float* __restrict__ part,
                           int batch, int block_size, int max_blocks,
                           int entries_per_split, float scale_log2) {
  constexpr int kH = Heads<kMT>::kH;
  constexpr int kThreads = Heads<kMT>::kThreads;
  constexpr int kQBytes = Heads<kMT>::kQBytes;
  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the warp's M-tile (heads 16 mt ..) and its quarter of the value columns
  const int mt = kMT == 1 ? 0 : warp / kTileWarps;
  const int wq = kMT == 1 ? warp : warp % kTileWarps;
  const int g = lane >> 2;  // accumulator row (head) 16 mt + g and + 8
  const int c = lane & 3;   // accumulator columns 2c, 2c + 1

  const int len = lengths[b];
  const int n_entries = walked_entries(len, block_size, max_blocks);
  const int e0 = split * entries_per_split;
  if (e0 >= n_entries) return;  // past the sequence's last entry
  const int e1 = min(e0 + entries_per_split, n_entries);
  const int row0 = e0 * block_size;
  const int rows = (e1 - e0) * block_size;
  const int n_tiles = (rows + kTileRows - 1) / kTileRows;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t q_s = smem_addr(smem);
  const uint32_t tiles_s = q_s + kQBytes;
  const int* table = tables + (size_t)b * max_blocks;

  // the queries, one commit group
  const bf16* qb = q + (size_t)b * kH * kKD;
  for (int i = tid; i < kH * kChunksPerRow; i += kThreads) {
    const int r = i / kChunksPerRow;
    const int ch = i - r * kChunksPerRow;
    cp_async_16(q_s + r * kStride * 2 + ch * 16, qb + r * kKD + ch * 8);
  }
  cp_async_commit();
  // Tile t's rows into stage t % kStages, rows past the split zero-filled;
  // always one commit group per call.
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const uint32_t stage = tiles_s + (t % kStages) * kTileBytes;
      for (int i = tid; i < kTileRows * kChunksPerRow; i += kThreads) {
        const int r = i / kChunksPerRow;
        const int ch = i - r * kChunksPerRow;
        const bool present = t * kTileRows + r < rows;
        const int pos = row0 + t * kTileRows + (present ? r : 0);
        const int entry = pos / block_size;
        const bf16* src = pool + ((size_t)table[entry] * block_size +
                                  (pos - entry * block_size)) * kKD;
        cp_async_16(stage + r * kStride * 2 + ch * 16, src + ch * 8,
                    present ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) issue(st);

  // ldmatrix lane addresses (bytes, before the k-step's or n-tile's
  // offset): A = Q (rows = heads), B = K rows (n = tile row, k = column),
  // Bt = V rows (k = tile row, n = column)
  const int mi = lane >> 3;   // which of the four 8 x 8 matrices
  const int mr = lane & 7;    // its row
  const uint32_t a_off =
      (mt * kMH + (mi & 1) * 8 + mr) * kStride * 2 + (mi >> 1) * 16;
  const uint32_t b_off =
      ((mi >> 1) * 8 + mr) * kStride * 2 + (mi & 1) * 16;
  const uint32_t v_off = ((mi & 1) * 8 + mr) * kStride * 2 +
                         (wq * kVColsPerWarp + (mi >> 1) * 8) * 2;

  float o[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // heads g, g + 8
  float l[2] = {0.f, 0.f};          // this thread's part of the sums

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // the queries and tile t have landed
    __syncthreads();               // ... everyone's; stage of t-1 is free
    if (t > 0) issue(t + kStages - 1);
    const uint32_t tile = tiles_s + (t % kStages) * kTileBytes;

    // S = Q K^T: two chains over alternate k-steps, n-tiles 0 and 1
    float s[2][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < kKD / 16; ++ks) {
      uint32_t a[4], bk[4];
      ldsm_x4(q_s + a_off + ks * 32, a);
      ldsm_x4(tile + b_off + ks * 32, bk);
      mma(s[ks & 1][0], a, bk[0], bk[1]);
      mma(s[ks & 1][1], a, bk[2], bk[3]);
    }
    // scores of tile rows 8 nt + 2c + e for heads g (i = 0) and g + 8
    float p[2][4];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = t * kTileRows + 8 * nt + 2 * c + (e & 1);
        float x = (s[0][nt][e] + s[1][nt][e]) * scale_log2;
        x = rr < rows ? (row0 + rr < len ? x : kNegInf) : -INFINITY;
        p[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[nt][e] = exp2f(p[nt][e] - m[e >> 1]);
        l[e >> 1] += p[nt][e];
      }
    }
    // P as the A fragment of O += P V (k = tile row)
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                            pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]),
                            pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < kNTiles; j += 2) {
      uint32_t bv[4];
      ldsm_x4_t(tile + v_off + j * 16, bv);
      mma(o[j], pa, bv[0], bv[1]);
      mma(o[j + 1], pa, bv[2], bv[3]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int col0 = wq * kVColsPerWarp + 2 * c;
  const int h0 = mt * kMH + g;
  if (gridDim.x == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      bf16* oh = out + ((size_t)b * kH + h0 + 8 * i) * kVD + col0;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(oh + 8 * j) =
            __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
      }
    }
    return;
  }
  const int n_splits = gridDim.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t pi = ((size_t)b * kH + h0 + 8 * i) * n_splits + split;
    float* a = part + pi * kVD + col0;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      *reinterpret_cast<float2*>(a + 8 * j) =
          make_float2(o[j][2 * i], o[j][2 * i + 1]);
    }
    if (wq == 0 && c == 0) {
      float* ml = part + (size_t)batch * kH * n_splits * kVD;
      ml[pi * 2] = m[i];
      ml[pi * 2 + 1] = l[i];
    }
  }
}

// Merges the splits of one (sequence, head) in split order.
template <int kH>
__global__ void latent_decode_combine_kernel(const float* __restrict__ part,
                                             const int* __restrict__ lengths,
                                             bf16* __restrict__ out,
                                             int batch, int block_size,
                                             int max_blocks,
                                             int entries_per_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_splits = (max_blocks + entries_per_split - 1) / entries_per_split;
  const int n_entries = walked_entries(lengths[b], block_size, max_blocks);
  const int ns = (n_entries + entries_per_split - 1) / entries_per_split;
  const size_t head = (size_t)b * kH + h;
  const float* acc = part + head * n_splits * kVD;
  const float* ml = part + (size_t)batch * kH * n_splits * kVD +
                    head * n_splits * 2;
  float mx = ml[0];
  for (int s = 1; s < ns; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int d = threadIdx.x; d < kVD; d += blockDim.x) {
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float wgt = exp2f(ml[2 * s] - mx);
      sum += wgt * ml[2 * s + 1];
      a += wgt * acc[(size_t)s * kVD + d];
    }
    out[head * kVD + d] = __float2bfloat16(a / fmaxf(sum, 1e-30f));
  }
}

template <int kMT>
int launch(const void* q, const void* pool, const void* tables,
           const void* lengths, void* out, void* scratch, int batch,
           int block_size, int max_blocks, int entries_per_split,
           float scale, cudaStream_t s) {
  using Shape = Heads<kMT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      latent_decode_split_kernel<kMT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int n_splits = (max_blocks + entries_per_split - 1) / entries_per_split;
  if (n_splits > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  latent_decode_split_kernel<kMT>
      <<<dim3(n_splits, batch), Shape::kThreads, Shape::kSmem, s>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(pool),
          static_cast<const int*>(tables), static_cast<const int*>(lengths),
          static_cast<bf16*>(out), static_cast<float*>(scratch), batch,
          block_size, max_blocks, entries_per_split, scale * kLog2e);
  if (n_splits > 1) {
    latent_decode_combine_kernel<Shape::kH>
        <<<dim3(Shape::kH, batch), 128, 0, s>>>(
            static_cast<const float*>(scratch),
            static_cast<const int*>(lengths), static_cast<bf16*>(out), batch,
            block_size, max_blocks, entries_per_split);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code; 0 means the kernels were launched. The
// compiled shapes are MLA's at kv_lora_rank 512 and rope dim 64 with 16
// heads (Moonlight) or 64 (Kimi K2) (k_dim 576, v_dim 512), bf16.
// `scratch` holds batch * heads * splits * (v_dim + 2) floats, splits =
// ceil(max_blocks / entries_per_split); it may be null with one split.
extern "C" int latent_decode(int dtype, const void* q, const void* pool,
                             const void* tables, const void* lengths,
                             void* out, void* scratch, int batch, int heads,
                             int k_dim, int v_dim, int block_size,
                             int max_blocks, int entries_per_split,
                             float scale, void* stream) {
  if (dtype != repro_kernels::kBFloat16 || (heads != 16 && heads != 64) ||
      k_dim != kKD || v_dim != kVD || block_size < 1 || max_blocks < 1 ||
      batch < 1 || batch > 65535 || entries_per_split < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return heads == 16
             ? launch<1>(q, pool, tables, lengths, out, scratch, batch,
                         block_size, max_blocks, entries_per_split, scale, s)
             : launch<4>(q, pool, tables, lengths, out, scratch, batch,
                         block_size, max_blocks, entries_per_split, scale, s);
}
