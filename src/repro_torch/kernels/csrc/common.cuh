// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel accumulates in f32 whatever its storage type: loads convert
// to f32 (or feed bf16 tensor-core products with f32 accumulators) and
// stores round back.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_kernels {

// Finite mask value, as in the reference kernels: a fully masked row then
// averages its values uniformly instead of producing NaN.
constexpr float kNegInf = -1e30f;

// Storage dtype codes passed from Python (see kernels/build.py).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace repro_kernels

extern "C" const char* repro_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
