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
// What bounds it on the H100: 2·M·K·N operations against
// (M·K + K·N + M·N)·size bytes. f32 runs as 3×TF32 (6·M·K·N at 495
// TFLOP/s), bf16 at 989 TFLOP/s. At ResNet-50's res2 _c (M = 100,352,
// K = 64, N = 256, f32) that is 0.038 ms of bytes against 0.020 ms of
// operations; at res5 _c (1,568 × 512 × 2,048) 0.020 ms of operations
// against 0.018 ms of bytes.
//
// Design: the forward product of mma_tile.cuh on the tensor cores, as in
// matmul_epilogue.cu — persistent blocks walking BM × BN tiles chosen by
// fwd_plan through a 3-stage cp.async ring; mma.sync bf16, and f32 as
// 3×TF32 with each slice summed apart in f32. The statistics come from the
// accumulator fragments: each value is rounded to T as it is stored, and
// v and v² are summed over the thread's rows, then across the 8 lanes that
// share its columns (__shfl_xor), then across the warps of a tile column
// through shared memory in a fixed order; one partial per (M tile, column)
// goes out. The TPU kernel carries Σy and Σy² across its sequential grid;
// Hopper's blocks run in parallel, so a second launch (bn_train.cuh's
// sum_partials) adds the partials of the M tiles in a fixed order: no
// float atomics, a re-run gives the same bits. Ragged M, N and K are zero
// at staging and never stored.
#include "bn_train.cuh"
#include "mma_tile.cuh"

namespace dl4j {
namespace {

template <typename T>
struct StatsArgs {
  const T* x;
  const T* w;
  T* y;
  float* part;  // (2, tiles_m, N)
  int M, K, N, tiles_m, tiles_n, vec_x, vec_w;
};

// Shared memory: the ring, then the warps' column sums, [2][WR][BN].
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(mma::kThreads, 1)
matmul_stats_kernel(StatsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = mma::FwdCfg<T, BM, BN>;
  using G = typename C::G;
  float* red = reinterpret_cast<float*>(smem + C::kSmem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp / G::WC;
  const int rb = wr * G::MI * 16;
  const int cb = (warp % G::WC) * G::NI * 8;
  auto finish = [&](const mma::FwdItem& it, float (&acc)[G::MI][G::NI][4]) {
    float s1[G::NI / 2][4] = {}, s2[G::NI / 2][4] = {};
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = it.m0 + rb + mi * 16 + g + 8 * h;
        if (row >= a.M) continue;
#pragma unroll
        for (int j = 0; j < G::NI / 2; ++j) {
          const int col = it.n0 + cb + 16 * j + 4 * t;
          float q[4];
          mma::fwd_run<2>(acc, mi, j, h, q);
          T v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[e] = from_f32<T>(q[e]);
            const float f = to_f32(v[e]);
            s1[j][e] += f;
            s2[j][e] += f * f;
          }
          if (col < a.N)
            mma::store4(a.y, (size_t)row * a.N + col, col, a.N, v);
        }
      }
    }
    // over the warp's 8 row groups (the lanes that share t), then its rows
#pragma unroll
    for (int j = 0; j < G::NI / 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int m = 4; m < 32; m *= 2) {
          s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], m);
          s2[j][e] += __shfl_xor_sync(0xffffffffu, s2[j][e], m);
        }
        if (g == 0) {
          const int c = cb + 16 * j + 4 * t + e;
          red[wr * BN + c] = s1[j][e];
          red[(G::WR + wr) * BN + c] = s2[j][e];
        }
      }
    }
    __syncthreads();
    // one thread per (statistic, column) adds the warp rows in order
    if (threadIdx.x < 2 * BN) {
      const int which = threadIdx.x / BN, c = threadIdx.x % BN;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < G::WR; ++r) s += red[(which * G::WR + r) * BN + c];
      const int col = it.n0 + c;
      if (col < a.N)
        a.part[((size_t)which * a.tiles_m + it.tm) * a.N + col] = s;
    }
  };
  auto extra = [](int, const mma::FwdItem&) {};
  mma::fwd_walk<T, BM, BN>(a.x, a.w, a.M, a.K, a.N, a.tiles_n,
                           a.tiles_m * a.tiles_n, a.vec_x, a.vec_w, smem,
                           extra, finish);
}

template <typename T, int BM, int BN>
cudaError_t launch_tile(const StatsArgs<T>& a, int blocks,
                        cudaStream_t stream) {
  using C = mma::FwdCfg<T, BM, BN>;
  constexpr int smem = C::kSmem + 2 * C::G::WR * BN * 4;
  static_assert(smem <= 232448, "ring does not fit a block's shared memory");
  auto kernel = matmul_stats_kernel<T, BM, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, mma::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, float* part,
                   float* stats, int M, int K, int N, cudaStream_t stream) {
  const mma::FwdPlan p = mma::fwd_plan(M, K, N);
  StatsArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.w = static_cast<const T*>(w);
  a.y = static_cast<T*>(y);
  a.part = part;
  a.M = M;
  a.K = K;
  a.N = N;
  a.tiles_m = p.tiles_m;
  a.tiles_n = p.tiles_n;
  a.vec_x = (K * sizeof(T)) % 16 == 0 && mma::aligned16(x);
  a.vec_w = (N * sizeof(T)) % 16 == 0 && mma::aligned16(w);
  cudaError_t err;
  if (p.bm == 128 && p.bn == 128)
    err = launch_tile<T, 128, 128>(a, p.blocks, stream);
  else if (p.bm == 128)
    err = launch_tile<T, 128, 64>(a, p.blocks, stream);
  else if (p.bn == 128)
    err = launch_tile<T, 64, 128>(a, p.blocks, stream);
  else
    err = launch_tile<T, 64, 64>(a, p.blocks, stream);
  if (err != cudaSuccess) return err;
  return bn::sum_partials(part, stats, p.tiles_m, N, 2, stream);
}

}  // namespace
}  // namespace dl4j

// Floats of scratch `dl4j_matmul_stats` needs for the partial sums.
extern "C" long long dl4j_matmul_stats_scratch(int M, int K, int N) {
  return 2LL * dl4j::mma::fwd_plan(M, K, N).tiles_m * N;
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
