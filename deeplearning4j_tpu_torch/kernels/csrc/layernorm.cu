// Row LayerNorm on Hopper: for each row of x (rows, D),
//   out = γ·(x − μ)/√(σ² + ε) + β,   μ = mean(x),  σ² = mean((x − μ)²)
// in f32 math, out in x's type (f32 or bf16); γ, β f32. The kernel also
// writes each row's μ and 1/√(σ² + ε) (f32) for the closed-form backward.
//
// Replaces: deeplearning4j_tpu/kernels/layernorm.py::_ln_kernel (:21,
// pallas_call at :45 in _ln_forward). As there, σ² is the mean of squared
// deviations, not E[x²] − μ².
//
// What bounds it on the H100: bytes, one read and one write of each
// element (about 8 flops each): at 4096 × 768 f32, 25.2 MB, 0.0075 ms at
// 3.35 TB/s.
//
// Design: one warp per row, 8 rows a block. Each lane takes every 32nd
// element; the mean, the variance and the normalised output are three
// passes over the row, the second and third served by L1 (a 768-wide f32
// row is 3 KB). Warp sums use a butterfly of shuffles, in which every lane
// adds the same pairs in the same order: deterministic, and each lane
// holds the same total.
#include "common.cuh"

namespace dl4j {
namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ out,
                 float* __restrict__ mean_out, float* __restrict__ rstd_out,
                 int rows, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) s += to_f32(xr[i]);
  const float mean = warp_sum(s) / D;
  float v = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float d = to_f32(xr[i]) - mean;
    v += d * d;
  }
  const float var = warp_sum(v) / D;
  const float inv = 1.0f / sqrtf(var + eps);
  T* orow = out + (size_t)row * D;
  for (int i = lane; i < D; i += 32) {
    const float d = to_f32(xr[i]) - mean;
    orow[i] = from_f32<T>(d * inv * gamma[i] + beta[i]);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = inv;
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* g, const float* b, void* out,
                   float* mean, float* rstd, int rows, int D, float eps,
                   cudaStream_t stream) {
  const int grid = (rows + kWarps - 1) / kWarps;
  layernorm_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(out), mean, rstd, rows,
      D, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dl4j

// x (rows, D) contiguous in `dtype` (0 f32, 1 bf16); gamma, beta (D,) f32;
// out (rows, D) in `dtype`; mean, rstd (rows,) f32. rows, D > 0. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int dl4j_layernorm(const void* x, const void* gamma,
                              const void* beta, void* out, void* mean,
                              void* rstd, int dtype, int rows, int D,
                              float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dl4j::launch<float>(x, g, b, out, m, r, rows, D, eps, st);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(x, g, b, out, m, r, rows, D, eps, st);
  return cudaErrorInvalidValue;
}
