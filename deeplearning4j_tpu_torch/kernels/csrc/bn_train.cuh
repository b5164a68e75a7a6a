// Shared pieces of the conv1x1+BN training kernels (matmul_stats.cu,
// bn_grad_stats.cu, bn_conv_grads.cu): BN's input gradient as the JAX
// kernel forms it, and the fixed-order reduction of per-block partial sums.
//
// Determinism: sums that cross blocks (Σy, Σy², dγ, dβ, dW) are written as
// one partial per block and summed by `sum_partials` in a fixed order; no
// float atomics, so a re-run gives the same bits.
#pragma once

#include "common.cuh"

namespace dl4j {
namespace bn {

// BN's input gradient dy = k1·dz − (y − μ)·k2 − c (the relu mask already
// folded into dz), rounded to the activation type T before it enters a
// product, as the JAX kernel casts it to x.dtype
// (deeplearning4j_tpu/kernels/pointwise_conv.py:279).
template <typename T>
__device__ __forceinline__ float bn_dy(T y, T dz, float mu, float k1,
                                       float k2, float c) {
  const float v = k1 * to_f32(dz) - (to_f32(y) - mu) * k2 - c;
  return to_f32(from_f32<T>(v));
}

// out[b][col] = Σ_{s < S} part[(b·S + s)·C + col], for b = blockIdx.y.
// 32 threads per column each add every 32nd partial in order, then one
// thread adds their 32 sums in order: the same order on every run.
__global__ void __launch_bounds__(1024)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int S, long long C) {
  __shared__ float red[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long col = (long long)blockIdx.x * 32 + tx;
  const float* p = part + (size_t)blockIdx.y * S * C;
  float acc = 0.f;
  if (col < C) {
    for (int s = ty; s < S; s += 32) acc += p[(size_t)s * C + col];
  }
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < C) {
    float t = 0.f;
    for (int i = 0; i < 32; ++i) t += red[i][tx];
    out[(size_t)blockIdx.y * C + col] = t;
  }
}

inline cudaError_t sum_partials(const float* part, float* out, int S,
                                long long C, int batches,
                                cudaStream_t stream) {
  const dim3 block(32, 32);
  const dim3 grid((unsigned)((C + 31) / 32), (unsigned)batches);
  sum_partials_kernel<<<grid, block, 0, stream>>>(part, out, S, C);
  return cudaGetLastError();
}

}  // namespace bn
}  // namespace dl4j
