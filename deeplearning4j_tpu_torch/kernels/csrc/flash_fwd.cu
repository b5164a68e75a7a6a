// Flash-attention forward on Hopper: softmax(Q·Kᵀ/√d)·V over (B·H, T, D)
// with an optional causal mask and an optional (B, Tk) key-validity mask.
// Emits O in the input dtype and the per-row logsumexp in f32.
//
// Replaces: deeplearning4j_tpu/kernels/flash_attention.py::_flash_fwd_kernel
// (:42), driven by _flash_forward (pallas_call at :163).
//
// What bounds it on the H100: at the encode shape (B=8, H=12, T=512,
// D=64) the work is 4·B·H·T²·D ≈ 6.4 GFLOP over ≈ 13 MB of f32 Q/K/V/O,
// so it is bound by operations, not bytes. This first kernel does its math
// in f32 FMA (67 TFLOP/s peak), not on the tensor cores; wgmma/TMA are the
// later work that moves it toward the bf16 tensor-core roofline.
//
// Design: the TPU kernel walks K/V tiles along a sequential grid axis and
// carries (acc, l, m) in VMEM scratch between grid steps. Blocks on Hopper
// run in no order, so here one block owns one (b·h, 64-row query tile)
// and loops over the K/V tiles itself. Each thread owns one query row: the
// scaled query, the f32 accumulator and the running max/sum live in its
// registers, and K/V tiles are staged once per block in shared memory,
// where every thread of a warp reads the same key (a broadcast). The
// online-softmax rescale happens once per 16 keys. Causal tiles wholly
// above the diagonal are never loaded. Invalid query rows are zeroed, and
// their lse set to the 1e30 sentinel, by the Python wrapper, as in the JAX
// wrapper (:189-202).
#include "common.cuh"

namespace dl4j {
namespace {

constexpr int kBlockQ = 64;  // query rows per block: one per thread
constexpr int kBlockK = 64;  // keys staged per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax rescale

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Tq,
                 int Tk, int causal, float scale) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];
  __shared__ bool valid[kBlockK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = q0 + threadIdx.x;
  const bool live = row < Tq;

  float qr[D];
  float acc[D];
  {
    const T* qrow = q + ((size_t)bh * Tq + (live ? row : 0)) * D;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 x = load4(qrow + d);
      qr[d] = x.x * scale;
      qr[d + 1] = x.y * scale;
      qr[d + 2] = x.z * scale;
      qr[d + 3] = x.w * scale;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  // causal: key tiles wholly above this query tile's diagonal contribute
  // nothing (the TPU kernel's pl.when skip, :97-100)
  const int k_end = causal ? min(Tk, q0 + kBlockQ) : Tk;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    const int nk = min(kBlockK, k_end - k0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x * 4; i < kBlockK * D; i += kBlockQ * 4) {
      const int r = i / D;
      const int c = i % D;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (r < nk) {
        kx = load4(kb + (size_t)(k0 + r) * D + c);
        vx = load4(vb + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(&ks[r][c]) = kx;
      *reinterpret_cast<float4*>(&vs[r][c]) = vx;
    }
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      valid[threadIdx.x] = threadIdx.x < nk &&
                           (kv_mask == nullptr || kv_mask[(size_t)b * Tk + key]);
    }
    __syncthreads();
    if (!live) continue;

    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float s[kChunk];
      float mc = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kx = *reinterpret_cast<const float4*>(&ks[j][d]);
          dot = fmaf(qr[d], kx.x, dot);
          dot = fmaf(qr[d + 1], kx.y, dot);
          dot = fmaf(qr[d + 2], kx.z, dot);
          dot = fmaf(qr[d + 3], kx.w, dot);
        }
        const bool ok = valid[j] && (!causal || k0 + j <= row);
        // keys past the tile's end are absent (-inf: p == 0 exactly);
        // masked keys take the TPU kernel's -1e30
        s[jj] = j >= nk ? neg_inf() : (ok ? dot : kNegInf);
        mc = fmaxf(mc, s[jj]);
      }
      const float alpha = expf(m - mc);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - mc);
        l += p;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vx = *reinterpret_cast<const float4*>(&vs[j0 + jj][d]);
          acc[d] = fmaf(p, vx.x, acc[d]);
          acc[d + 1] = fmaf(p, vx.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vx.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vx.w, acc[d + 3]);
        }
      }
      m = mc;
    }
  }

  if (live) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = o + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f32<T>(acc[d] / lc);
    lse[(size_t)bh * Tq + row] = m + logf(lc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* kv_mask, void* o, float* lse, int BH, int H,
                   int Tq, int Tk, int D, int causal, float scale,
                   cudaStream_t stream) {
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, BH);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  switch (D) {
    case 16:
      flash_fwd_kernel<T, 16><<<grid, kBlockQ, 0, stream>>>(
          qt, kt, vt, kv_mask, ot, lse, H, Tq, Tk, causal, scale);
      break;
    case 32:
      flash_fwd_kernel<T, 32><<<grid, kBlockQ, 0, stream>>>(
          qt, kt, vt, kv_mask, ot, lse, H, Tq, Tk, causal, scale);
      break;
    case 64:
      flash_fwd_kernel<T, 64><<<grid, kBlockQ, 0, stream>>>(
          qt, kt, vt, kv_mask, ot, lse, H, Tq, Tk, causal, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace dl4j

// q, o: (BH, Tq, D); k, v: (BH, Tk, D), all contiguous in `dtype`;
// kv_mask: (B, Tk) bytes or null; lse: (BH, Tq) f32. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              const void* kv_mask, void* o, void* lse,
                              int dtype, int BH, int H, int Tq, int Tk, int D,
                              int causal, float scale, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dl4j::launch<float>(q, k, v, mask, o, lse_f, BH, H, Tq, Tk, D,
                               causal, scale, s);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(q, k, v, mask, o, lse_f, BH, H, Tq,
                                       Tk, D, causal, scale, s);
  return cudaErrorInvalidValue;
}
