// Single-query decode attention on Hopper: for each (b, h), one query row
// attends a (C, D) K/V cache under a (B, C) cache-validity mask. Rows with
// no valid key come back as zeros.
//
// Replaces: the decode shape of
// deeplearning4j_tpu/kernels/flash_attention.py::_flash_fwd_kernel (:42),
// which flash_attention_decode(impl="pallas") (:645-650) drives with the
// one query padded into a 128-row tile.
//
// What bounds it on the H100: a decode step reads every valid cache row
// once and does 4·D operations per row, about one operation per byte in
// f32. That is far below the card's ~295 operations per byte, so the
// kernel is bound by the bytes of the K/V cache (3.35 TB/s).
//
// Design: padding one query to a 128-row tile would waste 127/128 of the
// work, so the decode shape gets its own kernel. One block of 8 warps owns
// one (b, h). Each warp walks its share of the cache four rows at a time:
// a lane holds D/32 elements of the query and of its accumulator, reads
// the same D/32 elements of four K and V rows (consecutive lanes on
// consecutive addresses), and a warp shuffle finishes each dot product.
// Masked rows are never read. Each warp keeps its own running max, sum and
// accumulator; the eight partial softmaxes are merged through shared
// memory at the end. The reduction over C stays inside the block.
#include "common.cuh"

namespace dl4j {
namespace {

constexpr int kWarps = 8;
constexpr int kGroup = 4;  // cache rows a warp loads together

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    T* __restrict__ o, int H, int C, float scale) {
  static_assert(D % 32 == 0 && D <= kWarps * 32, "D must be 32, 64 or 128");
  constexpr int E = D / 32;  // elements of a row held by one lane
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float qv[E];
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = to_f32(q[(size_t)bh * D + lane * E + e]) * scale;
    acc[e] = 0.f;
  }
  float m = neg_inf();
  float l = 0.f;

  const T* kb = k + (size_t)bh * C * D + lane * E;
  const T* vb = v + (size_t)bh * C * D + lane * E;
  const uint8_t* mb = mask + (size_t)b * C;

  for (int c0 = warp * kGroup; c0 < C; c0 += kWarps * kGroup) {
    float kx[kGroup][E];
    float vx[kGroup][E];
    bool ok[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int c = c0 + g;
      ok[g] = c < C && mb[c] != 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kx[g][e] = ok[g] ? to_f32(kb[(size_t)c * D + e]) : 0.f;
        vx[g][e] = ok[g] ? to_f32(vb[(size_t)c * D + e]) : 0.f;
      }
    }
    float s[kGroup];
    float mc = m;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(qv[e], kx[g][e], dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[g] = ok[g] ? dot : neg_inf();
      mc = fmaxf(mc, s[g]);
    }
    if (mc == neg_inf()) continue;  // no valid row yet (uniform per warp)
    const float alpha = expf(m - mc);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float p = expf(s[g] - mc);
      l += p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vx[g][e], acc[e]);
    }
    m = mc;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[e];
  __syncthreads();

  const int d = threadIdx.x;
  if (d < D) {
    float mx = neg_inf();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float out = 0.f;  // an empty row stays zero
    if (mx != neg_inf()) {
      float den = 0.f;
      float num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (sm_m[w] == neg_inf()) continue;
        const float f = expf(sm_m[w] - mx);
        den = fmaf(sm_l[w], f, den);
        num = fmaf(sm_acc[w][d], f, num);
      }
      out = num / den;
    }
    o[(size_t)bh * D + d] = from_f32<T>(out);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, int BH, int H, int C, int D,
                   float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  switch (D) {
    case 32:
      flash_decode_kernel<T, 32><<<BH, kWarps * 32, 0, stream>>>(
          qt, kt, vt, mask, ot, H, C, scale);
      break;
    case 64:
      flash_decode_kernel<T, 64><<<BH, kWarps * 32, 0, stream>>>(
          qt, kt, vt, mask, ot, H, C, scale);
      break;
    case 128:
      flash_decode_kernel<T, 128><<<BH, kWarps * 32, 0, stream>>>(
          qt, kt, vt, mask, ot, H, C, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace dl4j

// q, o: (BH, D); k, v: (BH, C, D), all contiguous in `dtype`; mask: (B, C)
// bytes. Launches on `stream` and returns cudaGetLastError().
extern "C" int dl4j_flash_decode(const void* q, const void* k, const void* v,
                                 const void* mask, void* o, int dtype, int BH,
                                 int H, int C, int D, float scale, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dl4j::launch<float>(q, k, v, mb, o, BH, H, C, D, scale, s);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(q, k, v, mb, o, BH, H, C, D, scale, s);
  return cudaErrorInvalidValue;
}
