// Shared pieces of the conv1x1+BN training kernels (matmul_stats.cu,
// bn_grad_stats.cu, bn_conv_grads.cu): the SIMT tile product, BN's input
// gradient as the JAX kernel forms it, and the fixed-order reduction of
// per-block partial sums.
//
// The tile product: a block of 256 threads owns a 128 × 64 output tile and
// walks the contraction in slices of 16. Each kernel stages its own A
// slice (128 rows × 16) and B slice (16 × 64 columns) in shared memory as
// f32, in whatever order its operands are laid out, then `mac_stage`
// accumulates: thread (tx, ty) owns rows ty*4..+3 and 64+ty*4..+3 and
// columns tx*4..+3, read as 16-byte vectors. Operands past a ragged edge
// are staged as zeros, so nothing is padded in device memory.
//
// Determinism: sums that cross blocks (Σy, Σy², dγ, dβ, dW) are written as
// one partial per block and summed by `sum_partials` in a fixed order; no
// float atomics, so a re-run gives the same bits.
#pragma once

#include "common.cuh"

namespace dl4j {
namespace bn {

constexpr int kThreads = 256;
constexpr int kBM = 128;            // tile rows
constexpr int kBN = 64;             // tile columns
constexpr int kSlices = 16;         // contraction values staged per step
constexpr int kAStride = kBM + 4;   // keeps 16-byte rows, spreads banks
constexpr int kBStride = kBN + 4;

struct __align__(16) Stage {
  float a[kSlices][kAStride];  // A slice, contraction-major: a[s][row]
  float b[kSlices][kBStride];  // B slice: b[s][col]
};

// The tile row of thread row `ty`'s i-th accumulator row.
__device__ __forceinline__ int tile_row(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}

// acc[i][j] += Σ_s A[row_i, s] · B[s, col_j] over one staged slice.
__device__ __forceinline__ void mac_stage(const Stage& st, int tx, int ty,
                                          float acc[8][4]) {
#pragma unroll
  for (int s = 0; s < kSlices; ++s) {
    const float4 a0 = *reinterpret_cast<const float4*>(&st.a[s][ty * 4]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&st.a[s][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&st.b[s][tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

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
