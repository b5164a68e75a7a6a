// Shared parts of the two flash-attention backward kernels
// (flash_bwd_dq.cu, flash_bwd_dkv.cu): staging of 64-row tiles into shared
// memory, and the recomputation of P = exp(S − L) and dS = P∘(dO·Vᵀ − Δ)
// for one 64 × 64 (query, key) tile — the counterpart of `_recompute_p`
// and the shared first half of both TPU kernels
// (deeplearning4j_tpu/kernels/flash_attention.py:209-229, :248-256,
// :291-302).
//
// A block has 256 threads in a 16 × 16 grid. Thread (ty, tx) owns the 4 × 4
// patch of a 64 × 64 tile at rows ty + 16·i and columns tx + 16·j
// (i, j < 4); in the product phases it owns the same rows and the columns
// tx + 16·j of a D-wide tile (j < D/16). Tiles sit in shared memory as f32
// with a row stride of D + 1 (or 65), so the 16 threads of a half-warp that
// read one column of 16 rows hit 16 different banks.
#pragma once

#include "common.cuh"

namespace dl4j {
namespace bwd {

constexpr int kTile = 64;     // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kSide = 16;     // threads along each side of the 16 × 16 grid
constexpr int kPatch = kTile / kSide;   // 4 rows (and keys) per thread
constexpr int kPStride = kTile + 1;     // row stride of the P and dS tiles

// Stage rows [0, n) of a row-major (n, D) matrix into a kTile × (D + 1) f32
// tile, multiplied by `mul`; rows n..kTile-1 are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int n, float mul) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * (D + 1) + c] = r < n ? to_f32(src[(size_t)r * D + c]) * mul : 0.f;
  }
}

// Stage the lse and Δ of query rows [0, n) of a tile; rows past n read 0
// (their P is forced to 0 below).
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int n) {
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    lse_s[r] = r < n ? lse[r] : 0.f;
    delta_s[r] = r < n ? delta[r] : 0.f;
  }
}

// Validity of keys [k0, k0 + n) of batch row b under the key mask (null:
// every key is valid); keys past n are absent.
__device__ __forceinline__ void stage_keys(uint8_t* valid,
                                           const uint8_t* __restrict__ kv_mask,
                                           int b, int Tk, int k0, int n) {
  if (threadIdx.x < kTile) {
    const int c = threadIdx.x;
    valid[c] = c < n &&
               (kv_mask == nullptr || kv_mask[(size_t)b * Tk + k0 + c]);
  }
}

// P and dS of this thread's 4 × 4 patch of the (query tile at q0, key tile
// at k0). `qs` holds Q already multiplied by the softmax scale, as the TPU
// kernel scales q before the product. Masked keys (key mask, or above the
// diagonal when causal) take the score −1e30, as in the TPU kernel, so a
// valid row gets exactly 0 there, and a row whose lse is the +1e30
// sentinel (an invalid query row) gets 0 everywhere. Query rows past nq
// and keys past nk are absent and get P = dS = 0.
template <int D>
__device__ __forceinline__ void probs(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, const uint8_t* valid, int nq,
    int nk, int q0, int k0, int causal, float p[kPatch][kPatch],
    float ds[kPatch][kPatch]) {
  constexpr int S = D + 1;
  const int ty = threadIdx.x / kSide;
  const int tx = threadIdx.x % kSide;
  float s[kPatch][kPatch];
  float dp[kPatch][kPatch];
#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
#pragma unroll
    for (int j = 0; j < kPatch; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[kPatch], g[kPatch], kk[kPatch], vv[kPatch];
#pragma unroll
    for (int i = 0; i < kPatch; ++i) {
      a[i] = qs[(ty + kSide * i) * S + d];
      g[i] = dos[(ty + kSide * i) * S + d];
      kk[i] = ks[(tx + kSide * i) * S + d];
      vv[i] = vs[(tx + kSide * i) * S + d];
    }
#pragma unroll
    for (int i = 0; i < kPatch; ++i) {
#pragma unroll
      for (int j = 0; j < kPatch; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
    const int r = ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kPatch; ++j) {
      const int c = tx + kSide * j;
      if (r >= nq || c >= nk) {
        p[i][j] = 0.f;
        ds[i][j] = 0.f;
        continue;
      }
      const bool ok = valid[c] && (!causal || k0 + c <= q0 + r);
      const float pv = expf((ok ? s[i][j] : kNegInf) - lse_s[r]);
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - delta_s[r]);
    }
  }
}

// Shared-memory bytes of a kernel that keeps `tiles` D-wide tiles and
// `ptiles` 64 × 64 tiles, plus the row and key vectors.
template <int D>
constexpr size_t smem_bytes(int tiles, int ptiles) {
  return sizeof(float) * ((size_t)tiles * kTile * (D + 1) +
                          (size_t)ptiles * kTile * kPStride + 2 * kTile) +
         kTile;
}

}  // namespace bwd
}  // namespace dl4j
