// Fused ResNet bottleneck block for inference on Hopper, BN folded:
//   h1 = relu(x @ W1 + b1)              1×1 reduce,  C → M
//   h2 = relu(conv3×3(h1, W2) + b2)     SAME, as 9 shifted products, M → M
//   y  = relu(h2 @ W3 + b3 + x)         1×1 expand,  M → C, residual
// x and y (B, H, W, C) NHWC; W1 (C, M), W2 (3, 3, M, M) HWIO, W3 (M, C), all
// in the activation dtype (f32 or bf16); biases f32. Products accumulate
// in f32; h1 and h2 are rounded to the activation dtype, as the JAX
// kernel casts them.
//
// Replaces: deeplearning4j_tpu/kernels/residual_block.py::_block_kernel
// (:38, pallas_call at :72 in _run), reached through `bottleneck_block`.
//
// What bounds it on the H100: 2·B·H·W·(C·M + 9·M² + M·C) flops against
// |x| + |y| + |W| bytes; at ResNet-50's identity blocks it is bound by
// operations in f32 (res4 at B = 32: 13.95 GFLOP, 0.208 ms at 67 TFLOP/s).
// The kernel does its math in f32 FMA out of shared memory, off the tensor
// cores (mma/wgmma are later work), and reads x once and writes y once:
// h1 and h2 never leave the SM.
//
// Design: the TPU kernel tiles by batch and keeps a whole image's h1 in
// VMEM. On Hopper a 56×56×64 f32 h1 is 802 KB, over the 227 KB of shared
// memory a block can have, so a block owns R output rows of one image
// (blockIdx.y = image, blockIdx.x = row group) with a one-row halo:
//   1. h1 for image rows r0−1 … r0+R (zero outside the image, which is the
//      SAME padding of the 3×3 conv) into shared memory;
//   2. h2 for rows r0 … r0+R−1, the 3×3 conv as one product of depth 9·M
//      whose operand is read from h1 at the nine shifts (zero past the
//      left and right edges), into shared memory;
//   3. y = relu(h2 @ W3 + b3 + x), written straight to device memory.
// R = 2 (`kRows`): shared memory holds (2R + 2)·W·M f32 = 86 KB at every
// ResNet-50 stage (W·M = 3,584), so two blocks fit on one SM, and h1 of
// the halo rows is recomputed by the neighbouring block: phase 1 does
// (R+2)/R = 2× its share, 23.5 % more flops over the whole block (C = 4M).
// Each phase is a block-wide product in tiles of TR × TC outputs
// (64×64, 32×128 or 16×256, picked by the phase's row count, so the small
// res5 row groups waste little), staged through shared memory 16 depth
// values at a time; each of 256 threads owns a 4 × 4 patch. The weights
// stream from device memory and L2 (W2 at res5 is 9.4 MB).
#include "common.cuh"

namespace dl4j {
namespace {

constexpr int kThreads = 256;
constexpr int kSlices = 16;   // depth values staged per step
constexpr int kRows = 2;      // output rows per block (R)

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// out(p, n) for p < P, n < N of the product A (P × K) · B (K × N): A is read
// through `a_at(p, k)`, B is row-major in device memory; `epi(p, n, acc)`
// consumes each sum. Tiles of TR rows × (4096 / TR) columns; 256 threads in
// a (TR/4) × (TC/4) grid, each a 4 × 4 patch.
template <int TR, typename T, typename AFn, typename EpiFn>
__device__ void block_gemm(int P, int K, int N, const T* __restrict__ B,
                           AFn a_at, EpiFn epi, float* as, float* bs) {
  constexpr int TC = 4096 / TR;
  constexpr int AS = TR + 4;   // stride of the staged A slice (k-major)
  constexpr int BS = TC + 4;
  constexpr int kCols = TC / 4;      // threads along the columns
  const int tid = threadIdx.x;
  const int tx = tid % kCols;
  const int ty = tid / kCols;
  for (int p0 = 0; p0 < P; p0 += TR) {
    for (int n0 = 0; n0 < N; n0 += TC) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      for (int k0 = 0; k0 < K; k0 += kSlices) {
        __syncthreads();  // the previous slices are consumed
#pragma unroll
        for (int i = 0; i < TR * kSlices / kThreads; ++i) {
          const int idx = tid + i * kThreads;
          const int m = idx / kSlices;
          const int s = idx % kSlices;
          as[s * AS + m] =
              (p0 + m < P && k0 + s < K) ? a_at(p0 + m, k0 + s) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < TC * kSlices / kThreads; ++i) {
          const int idx = tid + i * kThreads;
          const int s = idx / TC;
          const int n = idx % TC;
          bs[s * BS + n] = (k0 + s < K && n0 + n < N)
                               ? to_f32(B[(size_t)(k0 + s) * N + n0 + n])
                               : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int s = 0; s < kSlices; ++s) {
          const float4 a = *reinterpret_cast<const float4*>(
              &as[s * AS + ty * 4]);
          const float4 b = *reinterpret_cast<const float4*>(
              &bs[s * BS + tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty * 4 + i;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          if (n < N) epi(p, n, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // this phase's outputs are visible to the next
}

// The tile shape for a phase of P rows: 64×64 unless P is small.
template <typename T, typename AFn, typename EpiFn>
__device__ void phase(int P, int K, int N, const T* __restrict__ B, AFn a_at,
                      EpiFn epi, float* as, float* bs) {
  if (P > 32)
    block_gemm<64>(P, K, N, B, a_at, epi, as, bs);
  else if (P > 16)
    block_gemm<32>(P, K, N, B, a_at, epi, as, bs);
  else
    block_gemm<16>(P, K, N, B, a_at, epi, as, bs);
}

// floats of shared memory for the staged slices of the widest tile shape
constexpr int kStageFloats = kSlices * (64 + 4) + kSlices * (256 + 4);

template <typename T>
__global__ void __launch_bounds__(kThreads)
bottleneck_block_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                        const float* __restrict__ b1,
                        const T* __restrict__ w2,
                        const float* __restrict__ b2,
                        const T* __restrict__ w3,
                        const float* __restrict__ b3, T* __restrict__ y,
                        int H, int W, int C, int M, int h1_floats,
                        int h2_floats) {
  extern __shared__ __align__(16) float smem[];
  float* h1 = smem;                       // (kRows + 2) · W rows × M
  float* h2 = h1 + h1_floats;             // kRows · W rows × M
  float* as = h2 + h2_floats;
  float* bs = as + kSlices * (64 + 4);

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, H - r0);          // output rows of this block
  const T* xb = x + (size_t)b * H * W * C;

  // 1. h1 of image rows r0-1 .. r0+rows (halo rows outside the image: 0)
  const int P1 = (rows + 2) * W;
  phase(P1, C, M, w1,
        [&](int p, int k) {
          const int r = r0 - 1 + p / W;
          return (r >= 0 && r < H)
                     ? to_f32(xb[((size_t)r * W + p % W) * C + k])
                     : 0.f;
        },
        [&](int p, int n, float acc) {
          const int r = r0 - 1 + p / W;
          h1[(size_t)p * M + n] =
              (r >= 0 && r < H) ? round_to<T>(fmaxf(acc + b1[n], 0.f)) : 0.f;
        },
        as, bs);

  // 2. h2 = relu(Σ_taps shifted h1 · W2[dy, dx] + b2): depth 9·M, W2 read
  //    as the (9·M, M) matrix its HWIO layout already is
  const int P2 = rows * W;
  phase(P2, 9 * M, M, w2,
        [&](int p, int kk) {
          const int t = kk / M;
          const int k = kk - t * M;
          const int dy = t / 3;
          const int wc = p % W + t - 3 * dy - 1;
          return (wc >= 0 && wc < W)
                     ? h1[((size_t)(p / W + dy) * W + wc) * M + k]
                     : 0.f;
        },
        [&](int p, int n, float acc) {
          h2[(size_t)p * M + n] = round_to<T>(fmaxf(acc + b2[n], 0.f));
        },
        as, bs);

  // 3. y = relu(h2 @ W3 + b3 + x) for the block's rows
  const size_t base = ((size_t)b * H + r0) * W;
  phase(P2, M, C, w3,
        [&](int p, int k) { return h2[(size_t)p * M + k]; },
        [&](int p, int n, float acc) {
          const size_t o = (base + p) * C + n;
          y[o] = from_f32<T>(fmaxf(acc + b3[n] + to_f32(x[o]), 0.f));
        },
        as, bs);
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const float* b1,
                   const void* w2, const float* b2, const void* w3,
                   const float* b3, void* y, int B, int H, int W, int C,
                   int M, cudaStream_t stream) {
  // h1 and h2 rounded up to whole 16-byte vectors so the staged slices
  // after them stay aligned
  const int h1_floats = ((kRows + 2) * W * M + 3) / 4 * 4;
  const int h2_floats = (kRows * W * M + 3) / 4 * 4;
  const size_t smem = sizeof(float) * (h1_floats + h2_floats + kStageFloats);
  auto kernel = bottleneck_block_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kRows - 1) / kRows, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<const T*>(w3), b3,
      static_cast<T*>(y), H, W, C, M, h1_floats, h2_floats);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dl4j

// x, y (B, H, W, C); w1 (C, M); w2 (3, 3, M, M); w3 (M, C), all contiguous in
// `dtype` (0 f32, 1 bf16); b1, b2 (M,) and b3 (C,) f32. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int dl4j_bottleneck_block(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* w3,
                                     const void* b3, void* y, int dtype,
                                     int B, int H, int W, int C, int M,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || M <= 0)
    return cudaErrorInvalidValue;
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* fb3 = static_cast<const float*>(b3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dl4j::launch<float>(x, w1, fb1, w2, fb2, w3, fb3, y, B, H, W, C, M,
                               s);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(x, w1, fb1, w2, fb2, w3, fb3, y, B, H,
                                       W, C, M, s);
  return cudaErrorInvalidValue;
}
