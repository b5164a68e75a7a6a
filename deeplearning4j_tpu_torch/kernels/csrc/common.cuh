// Shared helpers for the port's attention kernels: dtype conversion and
// the masking constant of the JAX flash kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dl4j {

// The JAX flash kernel masks scores with -1e30, not -inf
// (deeplearning4j_tpu/kernels/flash_attention.py:39).
constexpr float kNegInf = -1e30f;

// -inf for scores that are absent rather than masked: exp(-inf - m) == 0
// exactly, and the running max never takes it.
__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// dtype codes shared with the Python wrappers (kernels/flash_attention.py)
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

}  // namespace dl4j
