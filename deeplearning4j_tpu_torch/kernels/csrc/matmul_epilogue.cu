// GEMM with a fused inference epilogue on Hopper:
//   out = act((x @ w) · scale[n] + shift[n] [+ residual])
// x (M, K) and w (K, N) row-major; f32 or bf16 inputs accumulate in f32,
// int8 × int8 accumulates exactly in int32 (__dp4a). scale/shift are f32,
// the residual (optional) and the output are f32 or bf16; act is identity
// or relu. The folded inference BatchNorm of a conv1x1+BN pair is
// (scale, shift) = (γ·rsqrt(var+ε), β − γ·μ·rsqrt(var+ε)).
//
// Replaces: deeplearning4j_tpu/kernels/pointwise_conv.py::_epilogue_kernel
// and _int8_epilogue_kernel (:116-139, pallas_call at :168 in
// _matmul_epilogue_call). As there, ONE kernel body serves both
// precisions: the accumulator type comes from the input type's traits,
// and the epilogue below is shared, so the fp and int8 inference paths
// cannot drift apart.
//
// What bounds it on the H100: 2·M·K·N flops against (M·K + K·N)·size +
// M·N·size (+ the residual) bytes. At ResNet-50's 1×1 convs (K, N 64…2048,
// M = B·H·W) it is bound by operations in f32 (res2 _c at B = 32:
// 3.29 GFLOP, 0.049 ms at 67 TFLOP/s against 0.038 ms of bytes). This
// first kernel does its math in f32 FMA (or dp4a) out of shared memory;
// mma/wgmma on the tensor cores are later work.
//
// Design: the TPU kernel holds a whole (block_m, K) slab and the whole
// weight in VMEM. A Hopper block has far less fast memory, so the grid
// is (M tiles × N tiles) of 128 × 64 outputs (N reaches 2048 at res5) and
// each block loops over K in slices of 16 values (64 for int8): the x
// and w slices are staged through shared memory as 32-bit words (f32, or
// four packed int8), and each of 256 threads accumulates an 8 × 4 patch
// in registers, reading its operands as 16-byte vectors. M tails, N tails
// and a K that is not a multiple of the slice are zero-filled at staging,
// so nothing is padded in device memory. The epilogue runs on the
// accumulators in registers and casts on the store.
#include "common.cuh"

namespace dl4j {
namespace {

constexpr int kInt8 = 2;      // dtype code of int8 inputs (kernels/pointwise_conv.py)
constexpr int kThreads = 256;
constexpr int kBM = 128;      // rows of x per block
constexpr int kBN = 64;       // columns of w per block
constexpr int kSlices = 16;   // 32-bit words of K staged per step
constexpr int kAStride = kBM + 4;   // keeps 16-byte rows, spreads banks
constexpr int kBStride = kBN + 4;

// How one input type is staged and multiplied.
template <typename TIn>
struct Traits {
  using Word = float;
  using Acc = float;
  static constexpr int kPack = 1;  // K values per 32-bit word
  __device__ static Word a_word(const TIn* __restrict__ x, int row, int k,
                                int M, int K) {
    return (row < M && k < K) ? to_f32(x[(size_t)row * K + k]) : 0.f;
  }
  __device__ static Word b_word(const TIn* __restrict__ w, int k, int col,
                                int K, int N) {
    return (k < K && col < N) ? to_f32(w[(size_t)k * N + col]) : 0.f;
  }
  __device__ static Acc mac(Word a, Word b, Acc c) { return fmaf(a, b, c); }
};

template <>
struct Traits<int8_t> {
  using Word = int;
  using Acc = int;
  static constexpr int kPack = 4;
  // x[row, k..k+3] packed little-endian; values past K are zero
  __device__ static Word a_word(const int8_t* __restrict__ x, int row, int k,
                                int M, int K) {
    unsigned v = 0;
    if (row < M) {
      const int8_t* p = x + (size_t)row * K;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < K) v |= (unsigned)(uint8_t)p[k + j] << (8 * j);
    }
    return (int)v;
  }
  // w[k..k+3, col] packed little-endian
  __device__ static Word b_word(const int8_t* __restrict__ w, int k, int col,
                                int K, int N) {
    unsigned v = 0;
    if (col < N) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < K) v |= (unsigned)(uint8_t)w[(size_t)(k + j) * N + col]
                            << (8 * j);
    }
    return (int)v;
  }
  __device__ static Acc mac(Word a, Word b, Acc c) { return __dp4a(a, b, c); }
};

__device__ __forceinline__ void load4(const float* p, float* d) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
__device__ __forceinline__ void load4(const int* p, int* d) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
matmul_epilogue_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift,
                       const TOut* __restrict__ res, TOut* __restrict__ out,
                       int M, int K, int N, int relu) {
  using Tr = Traits<TIn>;
  using Word = typename Tr::Word;
  using Acc = typename Tr::Acc;
  __shared__ __align__(16) Word as[kSlices][kAStride];  // x slice, k-major
  __shared__ __align__(16) Word bs[kSlices][kBStride];  // w slice

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // columns tx*4 .. tx*4+3
  const int ty = tid / 16;   // rows ty*4 .. +3 and 64+ty*4 .. +3
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  Acc acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);
  }

  for (int k0 = 0; k0 < K; k0 += kSlices * Tr::kPack) {
#pragma unroll
    for (int i = 0; i < kBM * kSlices / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int m = idx / kSlices;
      const int s = idx % kSlices;
      as[s][m] = Tr::a_word(x, m0 + m, k0 + s * Tr::kPack, M, K);
    }
#pragma unroll
    for (int i = 0; i < kBN * kSlices / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int s = idx / kBN;
      const int n = idx % kBN;
      bs[s][n] = Tr::b_word(w, k0 + s * Tr::kPack, n0 + n, K, N);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
      Word a[8], b[4];
      load4(&as[s][ty * 4], a);
      load4(&as[s][64 + ty * 4], a + 4);
      load4(&bs[s][tx * 4], b);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = Tr::mac(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // the shared epilogue: acc·scale + shift (+ residual) (relu), cast on store
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= N) continue;
      const size_t o = (size_t)row * N + col;
      float v = static_cast<float>(acc[i][j]) * scale[col] + shift[col];
      if (res != nullptr) v += to_f32(res[o]);
      if (relu) v = fmaxf(v, 0.f);
      out[o] = from_f32<TOut>(v);
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* shift, const void* res, void* out, int M,
                   int K, int N, int relu, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  matmul_epilogue_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(w), scale, shift,
      static_cast<const TOut*>(res), static_cast<TOut*>(out), M, K, N, relu);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_in(const void* x, const void* w, const float* scale,
                      const float* shift, const void* res, void* out,
                      int out_dtype, int M, int K, int N, int relu,
                      cudaStream_t stream) {
  if (out_dtype == kFloat32)
    return launch<TIn, float>(x, w, scale, shift, res, out, M, K, N, relu,
                              stream);
  if (out_dtype == kBFloat16)
    return launch<TIn, __nv_bfloat16>(x, w, scale, shift, res, out, M, K, N,
                                      relu, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dl4j

// x (M, K) and w (K, N) contiguous in `in_dtype` (0 f32, 1 bf16, 2 int8);
// scale, shift (N,) f32; res (M, N) in `out_dtype` or null; out (M, N) in
// `out_dtype` (0 f32, 1 bf16). M, K, N > 0. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int dl4j_matmul_epilogue(const void* x, const void* w,
                                    const void* scale, const void* shift,
                                    const void* res, void* out, int in_dtype,
                                    int out_dtype, int M, int K, int N,
                                    int relu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == dl4j::kFloat32)
    return dl4j::launch_in<float>(x, w, s, b, res, out, out_dtype, M, K, N,
                                  relu, st);
  if (in_dtype == dl4j::kBFloat16)
    return dl4j::launch_in<__nv_bfloat16>(x, w, s, b, res, out, out_dtype, M,
                                          K, N, relu, st);
  if (in_dtype == dl4j::kInt8)
    return dl4j::launch_in<int8_t>(x, w, s, b, res, out, out_dtype, M, K, N,
                                   relu, st);
  return cudaErrorInvalidValue;
}
