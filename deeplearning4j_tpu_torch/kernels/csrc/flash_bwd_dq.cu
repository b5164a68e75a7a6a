// Flash-attention backward, dQ on Hopper:
//   dQ = scale · Σ_k dS·K,  dS = P∘(dO·Vᵀ − Δ),  P = exp(S − L)
// over (B·H, T, D), recomputing P from the forward's saved logsumexp L, with
// Δ = rowsum(dO∘O) computed beforehand by the wrapper. dQ is written once,
// in the input dtype.
//
// Replaces: deeplearning4j_tpu/kernels/flash_attention.py::
// _flash_bwd_dq_kernel (:232), driven by _flash_backward (pallas_call at
// :355).
//
// What bounds it on the H100: per valid (query, key) pair it does 6·D
// flops (S, dO·Vᵀ and dS·K) and it reads Q, dO, K and V once each, so at
// the fine-tune shape (B=32, H=12, T=128, D=64) it is bound by operations
// (~2 GFLOP against ~25 MB). This first kernel does its math in f32 FMA
// (67 TFLOP/s peak) out of shared memory, not on the tensor cores; mma/wgmma
// are later work.
//
// Design: the TPU kernel walks K/V tiles along a sequential grid axis and
// carries dQ in VMEM scratch. Blocks on Hopper run in no order, so one block
// owns one (b·h, 64-row query tile) and loops over the K/V tiles itself:
// Q (pre-scaled) and dO are staged once, each K/V tile is staged into
// shared memory, every thread recomputes a 4 × 4 patch of P and dS in
// registers, dS goes through shared memory, and each thread accumulates
// its 4 × D/16 patch of dQ in registers. No atomics: each dQ row is owned by
// one block, so two runs give bit-identical results. Causal key tiles
// wholly above the query tile's diagonal are skipped, as the TPU kernel
// skips them (:262-265).
#include "flash_bwd.cuh"

namespace dl4j {
namespace {

using namespace bwd;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const uint8_t* __restrict__ kv_mask, T* __restrict__ dq,
                    int H, int Tq, int Tk, int causal, float scale) {
  static_assert(D % kSide == 0, "head dim must be a multiple of 16");
  constexpr int S = D + 1;
  constexpr int kCols = D / kSide;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * S;
  float* ks = dos + kTile * S;
  float* vs = ks + kTile * S;
  float* dss = vs + kTile * S;
  float* lse_s = dss + kTile * kPStride;
  float* delta_s = lse_s + kTile;
  uint8_t* valid = reinterpret_cast<uint8_t*>(delta_s + kTile);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kTile;
  const int nq = min(kTile, Tq - q0);
  const int ty = threadIdx.x / kSide;
  const int tx = threadIdx.x % kSide;

  const size_t qoff = ((size_t)bh * Tq + q0) * D;
  stage<T, D>(qs, q + qoff, nq, scale);
  stage<T, D>(dos, dout + qoff, nq, 1.f);
  stage_rows(lse_s, delta_s, lse + (size_t)bh * Tq + q0,
             delta + (size_t)bh * Tq + q0, nq);

  float acc[kPatch][kCols];
#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(Tk, q0 + kTile) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int nk = min(kTile, Tk - k0);
    __syncthreads();  // the previous K/V and dS tiles are fully consumed
    const size_t koff = ((size_t)bh * Tk + k0) * D;
    stage<T, D>(ks, k + koff, nk, 1.f);
    stage<T, D>(vs, v + koff, nk, 1.f);
    stage_keys(valid, kv_mask, b, Tk, k0, nk);
    __syncthreads();

    float p[kPatch][kPatch];
    float ds[kPatch][kPatch];
    probs<D>(qs, dos, ks, vs, lse_s, delta_s, valid, nq, nk, q0, k0, causal,
             p, ds);
#pragma unroll
    for (int i = 0; i < kPatch; ++i) {
#pragma unroll
      for (int j = 0; j < kPatch; ++j)
        dss[(ty + kSide * i) * kPStride + tx + kSide * j] = ds[i][j];
    }
    __syncthreads();

    // dQ patch += dS (rows) · K (columns); keys past nk have dS == 0
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float kr[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kr[j] = ks[c * S + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kPatch; ++i) {
        const float a = dss[(ty + kSide * i) * kPStride + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a, kr[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
    const int r = ty + kSide * i;
    if (r >= nq) continue;
    T* row = dq + qoff + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      row[tx + kSide * j] = from_f32<T>(scale * acc[i][j]);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const uint8_t* kv_mask, void* dq, int BH, int H, int Tq,
                     int Tk, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>(4, 1);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kTile - 1) / kTile, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kv_mask, static_cast<T*>(dq), H, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const uint8_t* kv_mask, void* dq, int BH, int H, int Tq,
                   int Tk, int D, int causal, float scale,
                   cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, dout, lse, delta, kv_mask, dq, BH, H,
                             Tq, Tk, causal, scale, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, dout, lse, delta, kv_mask, dq, BH, H,
                             Tq, Tk, causal, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, dout, lse, delta, kv_mask, dq, BH, H,
                             Tq, Tk, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// q, dout, dq: (BH, Tq, D); k, v: (BH, Tk, D), all contiguous in `dtype`;
// lse, delta: (BH, Tq) f32; kv_mask: (B, Tk) bytes or null. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* kv_mask,
                                 void* dq, int dtype, int BH, int H, int Tq,
                                 int Tk, int D, int causal, float scale,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dl4j::launch<float>(q, k, v, dout, l, dl, mask, dq, BH, H, Tq, Tk,
                               D, causal, scale, s);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(q, k, v, dout, l, dl, mask, dq, BH, H,
                                       Tq, Tk, D, causal, scale, s);
  return cudaErrorInvalidValue;
}
