// Each routed MoE slot's place within its expert, for Hopper (sm_90a): the
// number of earlier slots of its group routed to the same expert, in
// slot-major order (slot j of token t is slot j*T + t of its group).
//
// Replaces no TPU kernel. The JAX package counts these places with a one-hot
// `cumsum` over the tokens that it leaves to XLA (`apply_moe` in
// src/repro/models/moe.py), and the port's plain version
// (`slot_positions_plain` in kernels/moe_route/ops.py) with one over all the
// slots. On the card PyTorch scans such a one-hot along a dimension that is
// not the innermost: one thread per (group, expert) column walks the k*T
// slots one after another, 4,096 dependent steps of ~0.15-0.2 us for a
// 512-token group at top-8.
//
// Layouts:
//   gate_idx (G, T, k) int64, the router's experts, innermost dimension
//            contiguous; the group and token strides are arguments (the
//            router leaves a view of its sorted indices)
//   pos      (G, k*T) int64, contiguous
//
// What bounds it on the H100: bytes, 16 a slot (its expert read, its place
// written), 64 KB for a 512-token group at top-8: 0.02 us at 3.35 TB/s. In
// practice latency bounds it, so the design keeps the serial part short:
// * One CTA per group, a thread per slot, the slots walked in tiles of
//   blockDim (up to 1,024) in slot-major order. Each expert's running count
//   lives in shared memory (int32, E <= 1024).
// * Within a warp, a slot's rank among the lanes routed to its expert is
//   __popc(__match_any_sync(...) & lanemask_lt); the lowest of those lanes
//   writes the warp's count for the expert into a byte of a (E, 32) table.
// * Across warps, a slot adds the bytes of the warps before its own in its
//   expert's row: 32 bytes read as two 16-byte words, summed with __dp4a.
//   Before the next tile one thread per expert adds the row's total to the
//   running count and clears the row.
// * A tile so costs three barriers and a few shared loads whatever E is; the
//   next tile's experts are loaded before them. The places are exact
//   integers that depend on no atomic's order. The block size follows k*T:
//   one warp for a decode group of k slots, 1,024 threads for a 512-token
//   first chunk (four tiles).
// * It allocates nothing and does not synchronise, so a CUDA graph
//   captures it with the rest of a step.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxExperts = 1024;
constexpr int kMaxThreads = 1024;
constexpr int kRowBytes = 32;  // a row of the per-warp counts: a byte a warp

// The expert of slot s, or -1 past the group's slots or out of [0, E).
__device__ __forceinline__ int expert_of(const int64_t* idx, int s, int slots,
                                         int tokens, int experts,
                                         long long token_stride) {
  if (s >= slots) return -1;
  const int j = s / tokens, t = s - j * tokens;
  const long long e = idx[t * token_stride + j];
  return e >= 0 && e < experts ? static_cast<int>(e) : -1;
}

// The sum of the first `n` bytes (n <= 32) of a 16-byte-aligned 32-byte row.
__device__ __forceinline__ unsigned row_sum(const uint8_t* row, int n) {
  const uint4 lo = reinterpret_cast<const uint4*>(row)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(row)[1];
  const unsigned words[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  unsigned sum = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int left = n - 4 * q;  // bytes of this word to count
    const unsigned keep = left >= 4 ? 0xffffffffu
                          : left <= 0 ? 0u
                                      : (1u << (8 * left)) - 1u;
    sum = __dp4a(words[q] & keep, 0x01010101u, sum);
  }
  return sum;
}

__global__ void __launch_bounds__(kMaxThreads)
    slot_positions_kernel(const int64_t* __restrict__ gate_idx,
                          int64_t* __restrict__ pos, int tokens, int top_k,
                          int experts, long long group_stride,
                          long long token_stride) {
  __shared__ int count[kMaxExperts];
  __shared__ __align__(16) uint8_t warp_count[kMaxExperts * kRowBytes];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slots = tokens * top_k;
  const int64_t* idx = gate_idx + blockIdx.x * group_stride;
  int64_t* out = pos + static_cast<long long>(blockIdx.x) * slots;
  uint4* rows = reinterpret_cast<uint4*>(warp_count);
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < experts * (kRowBytes / 16); i += blockDim.x) {
    rows[i] = zero;
  }
  for (int e = tid; e < experts; e += blockDim.x) count[e] = 0;
  const unsigned below = (1u << lane) - 1u;  // lanemask_lt
  int e = expert_of(idx, tid, slots, tokens, experts, token_stride);
  __syncthreads();

  for (int base = 0; base < slots; base += blockDim.x) {
    const bool more = base + static_cast<int>(blockDim.x) < slots;
    const int next = more ? expert_of(idx, base + blockDim.x + tid, slots,
                                      tokens, experts, token_stride)
                          : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(peers & below);
    if (e >= 0 && rank == 0) {
      warp_count[e * kRowBytes + warp] = static_cast<uint8_t>(__popc(peers));
    }
    __syncthreads();
    const int s = base + tid;
    if (e >= 0) {
      out[s] = count[e] + row_sum(warp_count + e * kRowBytes, warp) + rank;
    } else if (s < slots) {
      out[s] = -1;  // an expert out of range: no place
    }
    __syncthreads();
    if (more) {
      for (int x = tid; x < experts; x += blockDim.x) {
        count[x] += row_sum(warp_count + x * kRowBytes, kRowBytes);
        rows[2 * x] = zero;
        rows[2 * x + 1] = zero;
      }
      __syncthreads();
    }
    e = next;
  }
}

}  // namespace

extern "C" int moe_slot_positions(const void* gate_idx, void* pos, int groups,
                                  int tokens, int top_k, int experts,
                                  long long group_stride,
                                  long long token_stride, void* stream) {
  if (groups < 1 || tokens < 1 || top_k < 1 || experts < 1 ||
      experts > kMaxExperts ||
      static_cast<long long>(tokens) * top_k > INT_MAX - kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slots = tokens * top_k;
  const int threads =
      slots >= kMaxThreads ? kMaxThreads : (slots + 31) / 32 * 32;
  slot_positions_kernel<<<groups, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(gate_idx), static_cast<int64_t*>(pos),
      tokens, top_k, experts, group_stride, token_stride);
  return static_cast<int>(cudaGetLastError());
}
