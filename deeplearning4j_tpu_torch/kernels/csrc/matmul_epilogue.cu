// GEMM with a fused inference epilogue on Hopper:
//   out = act((x @ w) · scale[n] + shift[n] [+ residual])
// x (M, K) and w (K, N) row-major; f32 or bf16 inputs accumulate in f32,
// int8 × int8 accumulates exactly in int32. scale/shift are f32, the
// residual (optional) and the output are f32 or bf16; act is identity or
// relu. The folded inference BatchNorm of a conv1x1+BN pair is
// (scale, shift) = (γ·rsqrt(var+ε), β − γ·μ·rsqrt(var+ε)).
//
// Replaces: deeplearning4j_tpu/kernels/pointwise_conv.py::_epilogue_kernel
// and _int8_epilogue_kernel (:116-139, pallas_call at :168 in
// _matmul_epilogue_call). As there, the fp and int8 routes share their
// epilogue: both apply it through `epilogue`, the one place an int32 sum
// becomes a float, so they cannot drift apart.
//
// What bounds it on the H100: 2·M·K·N operations against
// (M·K + K·N + M·N (+ M·N of residual))·size bytes. f32 runs as 3×TF32
// (mma_tile.cuh), three tensor-core products per f32 product: 6·M·K·N at
// 495 TFLOP/s; bf16 runs 2·M·K·N at 989 TFLOP/s, int8 at 1,979 TOP/s. At
// ResNet-50's B=32 shapes f32 is bound by bytes where K is 64 (res2 _c
// 100,352 × 64 × 256: 0.038 ms of bytes against 0.020 ms of operations)
// and by operations where K and N are ≥ 512 (res5 _c 1,568 × 512 × 2,048:
// 0.020 ms against 0.018 ms); bf16 is bound by bytes at every shape but
// res5's, and int8 (1-byte inputs, f32 out) by bytes at every shape.
//
// Design: the forward product of mma_tile.cuh on the tensor cores, one
// kernel template for the three routes — mma.sync bf16; f32 as 3×TF32 with
// each slice's products summed apart and added to the accumulator in f32,
// so K = 2,048 keeps f32's accuracy; int8 through mma.sync.m16n8k32 s8 × s8
// into int32 accumulators, in slices of 128 contraction values, w's
// fragments transposed from 32-bit words of four rows by __byte_perm.
// Persistent blocks (one per SM) walk BM × BN output tiles through a
// 3-stage cp.async ring of x and w slices, so a tile's epilogue overlaps
// the next tile's first copies; the tile comes from (M, K, N) (fwd_plan:
// 128 × 128 unless narrower tiles fill far more SMs, or N ≤ 64). Ragged
// M, N and K are zero-filled by the copy and never stored; rows whose byte
// length is not a multiple of 16 (int8: K or N not a multiple of 16) are
// copied element by element. Each tile's scale and shift ride with its
// first slice into a small buffer beside the ring (one per tile in
// flight), and the epilogue runs on the accumulators in registers: each
// thread holds 4 (f32, bf16) or 8 (int8) adjacent columns of a row, so it
// stores the output 16 bytes (f32) or 8 bytes (bf16) at a time, reading
// the residual per element beside them.
#include "mma_tile.cuh"

namespace dl4j {
namespace {

constexpr int kInt8 = 2;  // dtype code of int8 inputs (kernels/pointwise_conv.py)

// The epilogue of every route: acc·scale + shift (+ residual) (relu),
// cast; an int32 sum becomes a float here and nowhere else.
template <typename TOut, typename A>
__device__ __forceinline__ TOut epilogue(A acc, float scale, float shift,
                                         const TOut* res, size_t o,
                                         int relu) {
  float v = static_cast<float>(acc) * scale + shift;
  if (res != nullptr) v += to_f32(res[o]);
  if (relu) v = fmaxf(v, 0.f);
  return from_f32<TOut>(v);
}

template <typename T, typename TOut>
struct EpiArgs {
  const T* x;
  const T* w;
  const float* scale;
  const float* shift;
  const TOut* res;
  TOut* out;
  int M, K, N, relu, tiles_n, tiles, vec_x, vec_w;
};

// Shared memory: the ring, then mma::kStages buffers of one tile's scale
// and shift (BN each).
template <typename T, typename TOut, int BM, int BN>
__global__ void __launch_bounds__(mma::kThreads, 1)
matmul_epilogue_kernel(EpiArgs<T, TOut> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = mma::FwdCfg<T, BM, BN>;
  using G = typename C::G;
  using A = typename mma::Acc<T>::type;
  constexpr int F = C::F, R = 2 * F;  // a thread's run of R columns
  float* vecs = reinterpret_cast<float*>(smem + C::kSmem);
  auto buf = [&](const mma::FwdItem& it) {
    return vecs + (it.idx % mma::kStages) * 2 * BN;
  };
  auto extra = [&](int, const mma::FwdItem& it) {
    const int tid = threadIdx.x;
    if (tid < 2 * BN) {
      const int n = it.n0 + tid % BN;
      const float* src = tid < BN ? a.scale : a.shift;
      mma::cp4(buf(it) + tid, n < a.N ? src + n : src, n < a.N);
    }
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rb = (warp / G::WC) * G::MI * 16;
  const int cb = (warp % G::WC) * G::NI * 8;
  auto finish = [&](const mma::FwdItem& it, A (&acc)[G::MI][G::NI][4]) {
    // the tile's first slice, and with it scale and shift, landed before
    // its first product
    const float* v = buf(it);
    float sc[G::NI / F][R], sh[G::NI / F][R];
#pragma unroll
    for (int j = 0; j < G::NI / F; ++j) {
#pragma unroll
      for (int e = 0; e < R; ++e) {
        sc[j][e] = v[cb + 8 * F * j + R * t + e];
        sh[j][e] = v[BN + cb + 8 * F * j + R * t + e];
      }
    }
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = it.m0 + rb + mi * 16 + g + 8 * h;
        if (row >= a.M) continue;
#pragma unroll
        for (int j = 0; j < G::NI / F; ++j) {
          const int col = it.n0 + cb + 8 * F * j + R * t;
          if (col >= a.N) continue;
          const size_t o = (size_t)row * a.N + col;
          A q[R];
          mma::fwd_run<F>(acc, mi, j, h, q);
#pragma unroll
          for (int c = 0; c < R; c += 4) {
            TOut r[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              r[e] = col + c + e < a.N
                         ? epilogue(q[c + e], sc[j][c + e], sh[j][c + e],
                                    a.res, o + c + e, a.relu)
                         : from_f32<TOut>(0.f);
            if (col + c < a.N) mma::store4(a.out, o + c, col + c, a.N, r);
          }
        }
      }
    }
  };
  mma::fwd_walk<T, BM, BN>(a.x, a.w, a.M, a.K, a.N, a.tiles_n, a.tiles,
                           a.vec_x, a.vec_w, smem, extra, finish);
}

template <typename T, typename TOut, int BM, int BN>
cudaError_t launch_tile(const EpiArgs<T, TOut>& a, int blocks,
                        cudaStream_t stream) {
  constexpr int smem =
      mma::FwdCfg<T, BM, BN>::kSmem + mma::kStages * 2 * BN * 4;
  static_assert(smem <= 232448, "ring does not fit a block's shared memory");
  auto kernel = matmul_epilogue_kernel<T, TOut, BM, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, mma::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename TOut>
cudaError_t launch_mma(const void* x, const void* w, const float* scale,
                       const float* shift, const void* res, void* out, int M,
                       int K, int N, int relu, cudaStream_t stream) {
  const mma::FwdPlan p = mma::fwd_plan(M, K, N, mma::Slice<T>::kDepth);
  EpiArgs<T, TOut> a;
  a.x = static_cast<const T*>(x);
  a.w = static_cast<const T*>(w);
  a.scale = scale;
  a.shift = shift;
  a.res = static_cast<const TOut*>(res);
  a.out = static_cast<TOut*>(out);
  a.M = M;
  a.K = K;
  a.N = N;
  a.relu = relu;
  a.tiles_n = p.tiles_n;
  a.tiles = p.tiles_m * p.tiles_n;
  a.vec_x = (K * sizeof(T)) % 16 == 0 && mma::aligned16(x);
  a.vec_w = (N * sizeof(T)) % 16 == 0 && mma::aligned16(w);
  if (p.bm == 128 && p.bn == 128)
    return launch_tile<T, TOut, 128, 128>(a, p.blocks, stream);
  if (p.bm == 128) return launch_tile<T, TOut, 128, 64>(a, p.blocks, stream);
  if (p.bn == 128) return launch_tile<T, TOut, 64, 128>(a, p.blocks, stream);
  return launch_tile<T, TOut, 64, 64>(a, p.blocks, stream);
}

template <typename TOut>
cudaError_t launch_out(const void* x, const void* w, const float* scale,
                       const float* shift, const void* res, void* out,
                       int in_dtype, int M, int K, int N, int relu,
                       cudaStream_t stream) {
  if (in_dtype == kFloat32)
    return launch_mma<float, TOut>(x, w, scale, shift, res, out, M, K, N,
                                   relu, stream);
  if (in_dtype == kBFloat16)
    return launch_mma<__nv_bfloat16, TOut>(x, w, scale, shift, res, out, M,
                                           K, N, relu, stream);
  if (in_dtype == kInt8)
    return launch_mma<int8_t, TOut>(x, w, scale, shift, res, out, M, K, N,
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
  if (out_dtype == dl4j::kFloat32)
    return dl4j::launch_out<float>(x, w, s, b, res, out, in_dtype, M, K, N,
                                   relu, st);
  if (out_dtype == dl4j::kBFloat16)
    return dl4j::launch_out<__nv_bfloat16>(x, w, s, b, res, out, in_dtype, M,
                                           K, N, relu, st);
  return cudaErrorInvalidValue;
}

// The tile the forward GEMMs (this kernel and matmul_stats.cu) pick for
// (M, K, N) on the current device, as BM · 1000 + BN: the f32/bf16 route,
// or this kernel's int8 route where `int8` is non-zero.
extern "C" int dl4j_fwd_tile(int M, int K, int N, int int8) {
  const dl4j::mma::FwdPlan p = dl4j::mma::fwd_plan(
      M, K, N, int8 ? dl4j::mma::kBK8 : dl4j::mma::kBK);
  return p.bm * 1000 + p.bn;
}
