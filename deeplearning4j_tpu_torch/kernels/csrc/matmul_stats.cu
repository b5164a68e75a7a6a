// GEMM with a BatchNorm-statistics epilogue on Hopper:
//   y = x @ w,  s1[n] = Σ_rows y[:, n],  s2[n] = Σ_rows y[:, n]²
// x (M, K) and w (K, N) row-major in f32 or bf16; y (M, N) in the same
// type; s1, s2 f32, taken over y AS STORED (in bf16, over the rounded
// value), as the JAX kernel sums the cast value seen downstream.
//
// Replaces: deeplearning4j_tpu/kernels/pointwise_conv.py::_fwd_kernel
// (:47, pallas_call at :81 in matmul_stats), the forward of
// fused_conv1x1_bn: the training BN's statistics pass over y disappears.
//
// What bounds it on the H100: 2·M·K·N flops against (M·K + K·N + M·N)·size
// bytes. At ResNet-50's res2 _c (M = 100,352, K = 64, N = 256, f32) that is
// 3.29 GFLOP, 0.049 ms at 67 TFLOP/s, against 0.038 ms of bytes: bound by
// operations. This first kernel does its math in f32 FMA; the tensor
// cores are later work.
//
// Design: the TPU kernel carries Σy and Σy² in VMEM across its sequential
// grid. Hopper's blocks run in parallel and in no order, so each block
// (a 128 × 64 tile of y, bn_train.cuh's product) reduces its own tile's
// columns in registers and shared memory and writes one partial per
// column; a second launch sums the partials of the M tiles in a fixed
// order (no atomics: a re-run gives the same bits). Ragged M, N and K are
// zero at staging and never stored, so rows past M add nothing.
#include "bn_train.cuh"

namespace dl4j {
namespace {

using namespace bn;

template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, float* __restrict__ part, int M,
                    int K, int N) {
  __shared__ Stage st;
  __shared__ float red[2][16][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kSlices) {
    // x[m0 + m, k0 + s]: consecutive threads along K (contiguous)
#pragma unroll
    for (int i = 0; i < kBM * kSlices / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int m = idx / kSlices, s = idx % kSlices;
      const int row = m0 + m, k = k0 + s;
      st.a[s][m] = (row < M && k < K) ? to_f32(x[(size_t)row * K + k]) : 0.f;
    }
    // w[k0 + s, n0 + n]: consecutive threads along N (contiguous)
#pragma unroll
    for (int i = 0; i < kBN * kSlices / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int s = idx / kBN, n = idx % kBN;
      const int k = k0 + s, col = n0 + n;
      st.b[s][n] = (k < K && col < N) ? to_f32(w[(size_t)k * N + col]) : 0.f;
    }
    __syncthreads();
    mac_stage(st, tx, ty, acc);
    __syncthreads();
  }

  // store y, and sum the stored values of this thread's 8 rows per column
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_row(ty, i);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= N) continue;
      const T v = from_f32<T>(acc[i][j]);
      y[(size_t)row * N + col] = v;
      const float f = to_f32(v);
      s1[j] += f;
      s2[j] += f * f;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx * 4 + j] = s1[j];
    red[1][ty][tx * 4 + j] = s2[j];
  }
  __syncthreads();
  // one thread per (stat, column) adds the 16 row groups in order
  if (tid < 2 * kBN) {
    const int which = tid / kBN, c = tid % kBN, col = n0 + c;
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) t += red[which][r][c];
    if (col < N)
      part[((size_t)which * gridDim.x + blockIdx.x) * N + col] = t;
  }
}

int m_tiles(int M) { return (M + kBM - 1) / kBM; }

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, float* part,
                   float* stats, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid(m_tiles(M), (N + kBN - 1) / kBN);
  matmul_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      part, M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(part, stats, m_tiles(M), N, 2, stream);
}

}  // namespace
}  // namespace dl4j

// Floats of scratch `dl4j_matmul_stats` needs for the partial sums.
extern "C" long long dl4j_matmul_stats_scratch(int M, int K, int N) {
  return 2LL * dl4j::m_tiles(M) * N;
}

// x (M, K), w (K, N) contiguous in `dtype` (0 f32, 1 bf16); y (M, N) in
// `dtype`; part: dl4j_matmul_stats_scratch floats; stats (2, N) f32
// receives Σy and Σy². M, K, N > 0. Launches on `stream` (two kernels) and
// returns cudaGetLastError().
extern "C" int dl4j_matmul_stats(const void* x, const void* w, void* y,
                                 void* part, void* stats, int dtype, int M,
                                 int K, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  float* s = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dl4j::launch<float>(x, w, y, p, s, M, K, N, st);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(x, w, y, p, s, M, K, N, st);
  return cudaErrorInvalidValue;
}
