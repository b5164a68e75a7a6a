// BatchNorm's parameter gradients in one read of (y, dz) on Hopper:
//   dγ[n] = Σ_rows dz·(y − μ[n])·r[n],   dβ[n] = Σ_rows dz
// y, dz (M, N) row-major in f32 or bf16 (any relu mask already folded into
// dz by the caller); μ, r (N,) f32; dγ, dβ f32.
//
// Replaces: deeplearning4j_tpu/kernels/pointwise_conv.py::_bwd_stats_kernel
// (:206, pallas_call at :237 in bn_grad_stats), the first half of
// fused_conv1x1_bn's backward.
//
// What bounds it on the H100: bytes. It reads 2·M·N values and does 4
// flops per pair: at res2 _c (M = 100,352, N = 256, f32) 205.5 MB, 0.061 ms
// at 3.35 TB/s.
//
// Design: a column reduction over up to 100,352 rows. The TPU kernel walks
// the rows in its sequential grid with the sums resident in VMEM. Here the
// rows are cut into S splits and the columns into groups of 32: a block of
// 32 × 8 threads owns one (split, column group), each warp reads 32
// consecutive columns of one row (coalesced), each thread sums every 8th
// row of its split, the 8 row sums are added in order in shared memory,
// and one partial per (split, column) goes out. A second launch sums the S
// partials in a fixed order (no atomics: re-runs give the same bits). S is
// chosen so about 1056 blocks (8 per SM) are in flight, with at least 64
// rows a split.
#include "bn_train.cuh"

namespace dl4j {
namespace {

constexpr int kCols = 32;
constexpr int kRows = 8;
constexpr int kTargetBlocks = 1056;

int splits_for(int M, int N) {
  const int groups = (N + kCols - 1) / kCols;
  int s = (kTargetBlocks + groups - 1) / groups;
  const int most = (M + 63) / 64;
  if (s > most) s = most;
  return s < 1 ? 1 : s;
}

template <typename T>
__global__ void __launch_bounds__(kCols * kRows)
bn_grad_stats_kernel(const T* __restrict__ y, const T* __restrict__ dz,
                     const float* __restrict__ mu,
                     const float* __restrict__ r, float* __restrict__ part,
                     int M, int N, int rows_per_split) {
  __shared__ float red[2][kRows][kCols + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kCols + tx;
  const int split = blockIdx.y;
  const int r0 = split * rows_per_split;
  const int r1 = min(M, r0 + rows_per_split);
  float dg = 0.f, db = 0.f;
  if (col < N) {
    const float m = mu[col], rr = r[col];
    for (int row = r0 + ty; row < r1; row += kRows) {
      const size_t o = (size_t)row * N + col;
      const float d = to_f32(dz[o]);
      const float xhat = (to_f32(y[o]) - m) * rr;
      db += d;
      dg += d * xhat;
    }
  }
  red[0][ty][tx] = dg;
  red[1][ty][tx] = db;
  __syncthreads();
  if (ty < 2 && col < N) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) t += red[ty][i][tx];
    part[((size_t)ty * gridDim.y + split) * N + col] = t;
  }
}

template <typename T>
cudaError_t launch(const void* y, const void* dz, const float* mu,
                   const float* r, float* part, float* out, int M, int N,
                   cudaStream_t stream) {
  const int S = splits_for(M, N);
  const int rows = (M + S - 1) / S;
  const dim3 grid((N + kCols - 1) / kCols, S);
  const dim3 block(kCols, kRows);
  bn_grad_stats_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(dz), mu, r, part, M, N,
      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return bn::sum_partials(part, out, S, N, 2, stream);
}

}  // namespace
}  // namespace dl4j

// Floats of scratch `dl4j_bn_grad_stats` needs for the partial sums.
extern "C" long long dl4j_bn_grad_stats_scratch(int M, int N) {
  return 2LL * dl4j::splits_for(M, N) * N;
}

// y, dz (M, N) contiguous in `dtype` (0 f32, 1 bf16); mu, r (N,) f32;
// part: dl4j_bn_grad_stats_scratch floats; out (2, N) f32 receives dγ and
// dβ. M, N > 0. Launches on `stream` (two kernels) and returns
// cudaGetLastError().
extern "C" int dl4j_bn_grad_stats(const void* y, const void* dz,
                                  const void* mu, const void* r, void* part,
                                  void* out, int dtype, int M, int N,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || N <= 0) return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mu);
  const float* rr = static_cast<const float*>(r);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dl4j::launch<float>(y, dz, m, rr, p, o, M, N, st);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(y, dz, m, rr, p, o, M, N, st);
  return cudaErrorInvalidValue;
}
