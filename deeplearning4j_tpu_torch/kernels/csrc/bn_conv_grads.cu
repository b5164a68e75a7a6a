// Both conv gradients of a conv1x1+BN pair on Hopper, with BN's input
// gradient formed on chip:
//   dy = k1·dz − (y − μ)·k2 − c     (per column; rounded to x's type)
//   dX = dy · wᵀ   (M, K) in x's type
//   dW = xᵀ · dy   (K, N) f32
// x (M, K), y and dz (M, N), w (K, N) row-major in f32 or bf16 (any relu
// mask already folded into dz); k1, k2, c, μ (N,) f32.
//
// Replaces: deeplearning4j_tpu/kernels/pointwise_conv.py::_bwd_gemm_kernel
// (:262, pallas_call at :338 in bn_conv_grads), the second half of
// fused_conv1x1_bn's backward. dy never goes to device memory: that is the
// kernel's reason to exist.
//
// What bounds it on the H100: 4·M·K·N flops against (2·M·K + 2·M·N + K·N)
// values: at res2 _c (M = 100,352, K = 64, N = 256, f32) 6.58 GFLOP,
// 0.098 ms at 67 TFLOP/s, bound by operations. f32 FMA here; the tensor
// cores are later work.
//
// Design: the JAX kernel's one grid (K tiles outer, M tiles inner, dW
// accumulated in VMEM across the M steps) does not carry over: an f32 dW
// accumulator of 64 × 2048 (res5 _c) is 512 KB, more than a block's
// 227 KB, and Hopper's blocks run in parallel. So two block roles, two
// launches, both forming dy from (y, dz, μ, k1, k2, c) as they stage it:
// - dX: a block owns a 128 × 64 tile of dX (M rows × K columns) and walks
//   N; A = dy (staged along N, contiguous in y and dz), B = wᵀ.
// - dW: a block owns a 128 × 64 tile of dW (K rows × N columns) for one of
//   S splits of M and walks its rows; A = xᵀ (staged along K, contiguous
//   in x), B = dy (staged along N). Each split writes its own f32 partial;
//   a third launch sums the S partials in a fixed order (no atomics).
// Rows past M stage as zeros in both roles, so they add nothing to dW and
// are never written to dX. The tile product is bn_train.cuh's.
#include "bn_train.cuh"

namespace dl4j {
namespace {

using namespace bn;

constexpr int kTargetBlocks = 264;  // two per SM over 132 SMs

int splits_for(int M, int K, int N) {
  const int tiles = ((K + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  int s = (kTargetBlocks + tiles - 1) / tiles;
  const int most = (M + 63) / 64;  // at least 64 rows a split
  if (s > most) s = most;
  return s < 1 ? 1 : s;
}

struct Bn {
  const float* k1;
  const float* k2;
  const float* c;
  const float* mu;
};

__device__ __forceinline__ void zero(float acc[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ y, const T* __restrict__ dz,
             const T* __restrict__ w, Bn bn, T* __restrict__ dx, int M,
             int K, int N) {
  __shared__ Stage st;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int k0 = blockIdx.y * kBN;
  float acc[8][4];
  zero(acc);

  for (int n0 = 0; n0 < N; n0 += kSlices) {
    // A[m][s] = dy(m0 + m, n0 + s): consecutive threads along N
#pragma unroll
    for (int i = 0; i < kBM * kSlices / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int m = idx / kSlices, s = idx % kSlices;
      const int row = m0 + m, n = n0 + s;
      float v = 0.f;
      if (row < M && n < N) {
        const size_t o = (size_t)row * N + n;
        v = bn_dy(y[o], dz[o], bn.mu[n], bn.k1[n], bn.k2[n], bn.c[n]);
      }
      st.a[s][m] = v;
    }
    // B[s][kk] = w[k0 + kk, n0 + s]: consecutive threads along N
#pragma unroll
    for (int i = 0; i < kBN * kSlices / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int s = idx % kSlices, kk = idx / kSlices;
      const int k = k0 + kk, n = n0 + s;
      st.b[s][kk] = (k < K && n < N) ? to_f32(w[(size_t)k * N + n]) : 0.f;
    }
    __syncthreads();
    mac_stage(st, tx, ty, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_row(ty, i);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      if (col < K) dx[(size_t)row * K + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_dw_kernel(const T* __restrict__ x, const T* __restrict__ y,
             const T* __restrict__ dz, Bn bn, float* __restrict__ part,
             int M, int K, int N, int rows_per_split) {
  __shared__ Stage st;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int r0 = split * rows_per_split;
  const int r1 = min(M, r0 + rows_per_split);
  float acc[8][4];
  zero(acc);

  for (int mb = r0; mb < r1; mb += kSlices) {
    // A[kk][s] = x[mb + s, k0 + kk]: consecutive threads along K
#pragma unroll
    for (int i = 0; i < kBM * kSlices / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int kk = idx % kBM, s = idx / kBM;
      const int row = mb + s, k = k0 + kk;
      st.a[s][kk] = (row < r1 && k < K) ? to_f32(x[(size_t)row * K + k])
                                        : 0.f;
    }
    // B[s][nn] = dy(mb + s, n0 + nn): consecutive threads along N
#pragma unroll
    for (int i = 0; i < kBN * kSlices / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int s = idx / kBN, nn = idx % kBN;
      const int row = mb + s, n = n0 + nn;
      float v = 0.f;
      if (row < r1 && n < N) {
        const size_t o = (size_t)row * N + n;
        v = bn_dy(y[o], dz[o], bn.mu[n], bn.k1[n], bn.k2[n], bn.c[n]);
      }
      st.b[s][nn] = v;
    }
    __syncthreads();
    mac_stage(st, tx, ty, acc);
    __syncthreads();
  }

  float* p = part + (size_t)split * K * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + tile_row(ty, i);
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) p[(size_t)k * N + n] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* dz,
                   const void* w, Bn bn, void* dx, float* dw, float* part,
                   int M, int K, int N, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* dzt = static_cast<const T*>(dz);
  const dim3 gx((M + kBM - 1) / kBM, (K + kBN - 1) / kBN);
  bn_dx_kernel<T><<<gx, kThreads, 0, stream>>>(
      yt, dzt, static_cast<const T*>(w), bn, static_cast<T*>(dx), M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int S = splits_for(M, K, N);
  int rows = (M + S - 1) / S;
  rows = (rows + kSlices - 1) / kSlices * kSlices;
  const dim3 gw((K + kBM - 1) / kBM, (N + kBN - 1) / kBN, S);
  bn_dw_kernel<T><<<gw, kThreads, 0, stream>>>(xt, yt, dzt, bn, part, M, K,
                                                N, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(part, dw, S, (long long)K * N, 1, stream);
}

}  // namespace
}  // namespace dl4j

// Floats of scratch `dl4j_bn_conv_grads` needs for the dW partials.
extern "C" long long dl4j_bn_conv_grads_scratch(int M, int K, int N) {
  return (long long)dl4j::splits_for(M, K, N) * K * N;
}

// x (M, K), y and dz (M, N), w (K, N) contiguous in `dtype` (0 f32,
// 1 bf16); k1, k2, c, mu (N,) f32; dx (M, K) in `dtype`; dw (K, N) f32;
// part: dl4j_bn_conv_grads_scratch floats. M, K, N > 0. Launches on
// `stream` (three kernels) and returns cudaGetLastError().
extern "C" int dl4j_bn_conv_grads(const void* x, const void* y,
                                  const void* dz, const void* w,
                                  const void* k1, const void* k2,
                                  const void* c, const void* mu, void* dx,
                                  void* dw, void* part, int dtype, int M,
                                  int K, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  const dl4j::Bn bn{static_cast<const float*>(k1),
                    static_cast<const float*>(k2),
                    static_cast<const float*>(c),
                    static_cast<const float*>(mu)};
  float* d = static_cast<float*>(dw);
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dl4j::launch<float>(x, y, dz, w, bn, dx, d, p, M, K, N, st);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(x, y, dz, w, bn, dx, d, p, M, K, N,
                                       st);
  return cudaErrorInvalidValue;
}
