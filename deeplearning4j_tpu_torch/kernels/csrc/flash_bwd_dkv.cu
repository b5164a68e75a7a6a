// Flash-attention backward, dK and dV on Hopper:
//   dK = scale · Σ_q dSᵀ·Q,  dV = Σ_q Pᵀ·dO,
//   dS = P∘(dO·Vᵀ − Δ),  P = exp(S − L)
// over (B·H, T, D), recomputing P from the forward's saved logsumexp L, with
// Δ = rowsum(dO∘O) computed beforehand by the wrapper. dK and dV are
// written once each, in the input dtype.
//
// Replaces: deeplearning4j_tpu/kernels/flash_attention.py::
// _flash_bwd_dkv_kernel (:272), driven by _flash_backward (pallas_call at
// :379).
//
// What bounds it on the H100: per valid (query, key) pair it does 8·D
// flops (S, dO·Vᵀ, dSᵀ·Q and Pᵀ·dO) and it reads Q, dO, K and V once each,
// so at the fine-tune shape (B=32, H=12, T=128, D=64) it is bound by
// operations. This first kernel does its math in f32 FMA out of shared
// memory, not on the tensor cores; mma/wgmma are later work.
//
// Design: the TPU kernel walks query tiles along a sequential grid axis
// and carries dK/dV in VMEM scratch. Here one block owns one (b·h, 64-key
// tile) and loops over the query tiles itself: K and V are staged once,
// each Q (pre-scaled) / dO tile with its lse and Δ is staged into shared
// memory, every thread recomputes a 4 × 4 patch of P and dS, both go
// through shared memory, and each thread accumulates its 4 × D/16 patches
// of dK and dV in registers. Q is staged multiplied by the scale, so
// dSᵀ·Q_scaled is already scale·dSᵀ·Q. No atomics: each dK/dV row is owned
// by one block, so two runs give bit-identical results. Causal query tiles
// wholly above the key tile's diagonal are skipped, as the TPU kernel skips
// them (:308-311). Masked and absent keys get P = dS = 0, so their dK and
// dV come back as exact zeros.
#include "flash_bwd.cuh"

namespace dl4j {
namespace {

using namespace bwd;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const uint8_t* __restrict__ kv_mask, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, int causal,
                     float scale) {
  static_assert(D % kSide == 0, "head dim must be a multiple of 16");
  constexpr int S = D + 1;
  constexpr int kCols = D / kSide;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * S;
  float* ks = dos + kTile * S;
  float* vs = ks + kTile * S;
  float* ps = vs + kTile * S;
  float* dss = ps + kTile * kPStride;
  float* lse_s = dss + kTile * kPStride;
  float* delta_s = lse_s + kTile;
  uint8_t* valid = reinterpret_cast<uint8_t*>(delta_s + kTile);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * kTile;
  const int nk = min(kTile, Tk - k0);
  const int ty = threadIdx.x / kSide;
  const int tx = threadIdx.x % kSide;

  const size_t koff = ((size_t)bh * Tk + k0) * D;
  stage<T, D>(ks, k + koff, nk, 1.f);
  stage<T, D>(vs, v + koff, nk, 1.f);
  stage_keys(valid, kv_mask, b, Tk, k0, nk);

  float dka[kPatch][kCols];
  float dva[kPatch][kCols];
#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dka[i][j] = 0.f;
      dva[i][j] = 0.f;
    }
  }

  // causal: query tiles that end before this key tile starts see none of
  // its keys
  const int q_start = causal ? (k0 / kTile) * kTile : 0;
  for (int q0 = q_start; q0 < Tq; q0 += kTile) {
    const int nq = min(kTile, Tq - q0);
    __syncthreads();  // the previous Q/dO, P and dS tiles are fully consumed
    const size_t qoff = ((size_t)bh * Tq + q0) * D;
    stage<T, D>(qs, q + qoff, nq, scale);
    stage<T, D>(dos, dout + qoff, nq, 1.f);
    stage_rows(lse_s, delta_s, lse + (size_t)bh * Tq + q0,
               delta + (size_t)bh * Tq + q0, nq);
    __syncthreads();

    float p[kPatch][kPatch];
    float ds[kPatch][kPatch];
    probs<D>(qs, dos, ks, vs, lse_s, delta_s, valid, nq, nk, q0, k0, causal,
             p, ds);
#pragma unroll
    for (int i = 0; i < kPatch; ++i) {
#pragma unroll
      for (int j = 0; j < kPatch; ++j) {
        const int at = (ty + kSide * i) * kPStride + tx + kSide * j;
        ps[at] = p[i][j];
        dss[at] = ds[i][j];
      }
    }
    __syncthreads();

    // this thread's key rows ty + 16·i: dV += Pᵀ·dO, dK += dSᵀ·Q_scaled;
    // query rows past nq have P == dS == 0
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float g[kCols], a[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        g[j] = dos[r * S + tx + kSide * j];
        a[j] = qs[r * S + tx + kSide * j];
      }
#pragma unroll
      for (int i = 0; i < kPatch; ++i) {
        const float pc = ps[r * kPStride + ty + kSide * i];
        const float dc = dss[r * kPStride + ty + kSide * i];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          dva[i][j] = fmaf(pc, g[j], dva[i][j]);
          dka[i][j] = fmaf(dc, a[j], dka[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
    const int c = ty + kSide * i;
    if (c >= nk) continue;
    T* krow = dk + koff + (size_t)c * D;
    T* vrow = dv + koff + (size_t)c * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      krow[tx + kSide * j] = from_f32<T>(dka[i][j]);
      vrow[tx + kSide * j] = from_f32<T>(dva[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const uint8_t* kv_mask, void* dk, void* dv, int BH,
                     int H, int Tq, int Tk, int causal, float scale,
                     cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>(4, 2);
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + kTile - 1) / kTile, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kv_mask, static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const uint8_t* kv_mask, void* dk, void* dv, int BH, int H,
                   int Tq, int Tk, int D, int causal, float scale,
                   cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, dout, lse, delta, kv_mask, dk, dv, BH,
                             H, Tq, Tk, causal, scale, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, dout, lse, delta, kv_mask, dk, dv, BH,
                             H, Tq, Tk, causal, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, dout, lse, delta, kv_mask, dk, dv, BH,
                             H, Tq, Tk, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// q, dout: (BH, Tq, D); k, v, dk, dv: (BH, Tk, D), all contiguous in
// `dtype`; lse, delta: (BH, Tq) f32; kv_mask: (B, Tk) bytes or null.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* kv_mask,
                                  void* dk, void* dv, int dtype, int BH,
                                  int H, int Tq, int Tk, int D, int causal,
                                  float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dl4j::launch<float>(q, k, v, dout, l, dl, mask, dk, dv, BH, H, Tq,
                               Tk, D, causal, scale, s);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(q, k, v, dout, l, dl, mask, dk, dv,
                                       BH, H, Tq, Tk, D, causal, scale, s);
  return cudaErrorInvalidValue;
}
