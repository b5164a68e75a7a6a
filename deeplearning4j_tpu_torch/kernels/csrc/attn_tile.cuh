// The attention tile of the port's flash kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu) on Hopper's tensor cores, built on
// mma_tile.cuh.
//
// A warp owns 16 query rows of one (b·h); a block has 1, 2 or 4 warps
// (`warps_per_block` picks them at launch). The warp keeps its rows' A
// fragments (Q, and dO in the backward) in registers for the whole walk
// over the K/V tiles, which a ring of mma::kStages stages of shared memory
// brings in by cp.async (`stage_kv`, driven by mma::walk). flash_bwd_dkv.cu
// swaps the roles: a warp owns 16 key rows (K and V kept as A fragments)
// and walks tiles of query rows (Q and dO staged as B operands), so the
// fragments' rows are keys and their columns queries (`mask_scores_t`).
// Every product is an mma.sync over the warp's 16 rows:
// - `scores`: S = A·Kᵀ (or dP = dO·Vᵀ) for a tile of BK keys, with K
//   row-major as the B operand: the thread's accumulator fragments hold
//   rows g and g + 8 at keys 8j + 2t and 8j + 2t + 1 (g = lane / 4,
//   t = lane % 4).
// - `accumulate`: acc += P·V (or dQ += dS·K), with P taken straight from
//   those accumulator fragments as the A operand, so P and dS never leave
//   registers.
//
// Two routes, by the operand type T:
// - bf16: mma.sync.m16n8k16 → f32, BK = 64 keys. K and V fragments come
//   from ldmatrix (V transposed by ldmatrix.trans); rows are padded to
//   D + 8 values, so the 8 rows of each 8 × 8 matrix fall in distinct
//   banks. P is rounded to bf16 for the P·V product: two adjacent n8
//   accumulator fragments pack into one k16 A fragment.
// - f32: 3×TF32 (mma_tile.cuh's split and mma_tf32), BK = 32 keys, so the
//   ring stays at 51 KB and the score fragments at 16 registers. The
//   contraction of P·V is relabelled: A slot (g, t) takes key 2t and slot
//   (g, t + 4) takes key 2t + 1, so a0..a3 = c0, c2, c1, c3 of the score
//   fragment, and V's B fragment reads rows 2t and 2t + 1. Rows are padded
//   to D + 4 floats: the score reads (8 rows g × 4 columns t) and the P·V
//   reads (rows 2t × 8 columns g) both meet no bank conflict.
#pragma once

#include "mma_tile.cuh"

namespace dl4j {
namespace attn {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;

// Keys per K/V tile and the row stride (in T) of a staged tile.
template <typename T, int D>
struct Tile;
template <int D>
struct Tile<float, D> {
  static constexpr int BK = 32;
  static constexpr int S = D + 4;
  static constexpr int kStage = 2 * BK * S * 4;  // K, then V
};
template <int D>
struct Tile<__nv_bfloat16, D> {
  static constexpr int BK = 64;
  static constexpr int S = D + 8;
  static constexpr int kStage = 2 * BK * S * 2;
};

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)mma::kStages * Tile<T, D>::kStage;
}

// Stage keys [k0, k0 + BK) of K and V ((Tk, D) row-major each) into one
// ring stage: K's rows, then V's. Keys ≥ Tk stage as zeros (src-size 0:
// nothing is read). Rows are 16-byte multiples (D ≥ 16) and the bases
// 16-byte aligned (the wrapper's `_aligned`), so every copy is 16 bytes.
template <typename T, int D, int NT>
__device__ __forceinline__ void stage_kv(T* ks, const T* k, const T* v, int k0,
                                         int Tk) {
  using C = Tile<T, D>;
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int CH = D / E;
  static_assert(C::BK * CH % NT == 0, "tile not a whole number of rounds");
  T* vs = ks + C::BK * C::S;
#pragma unroll
  for (int i = 0; i < C::BK * CH / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / CH, c = (idx % CH) * E;
    const bool in = k0 + r < Tk;
    const size_t off = in ? (size_t)(k0 + r) * D + c : 0;
    mma::cp16(ks + r * C::S + c, k + off, in);
    mma::cp16(vs + r * C::S + c, v + off, in);
  }
}

// -- the warp's A fragments -----------------------------------------------------
// f32: rows r0 + g and r0 + g + 8 of a (n, D) matrix, times `mul`, as the
// m16n8k8 fragments of the D/8 contraction steps: v[kk] = (g, 8kk + t),
// (g + 8, 8kk + t), (g, 8kk + t + 4), (g + 8, 8kk + t + 4). Rows ≥ n are 0.
template <typename T, int D>
struct Rows;

template <int D>
struct Rows<float, D> {
  float v[D / 8][4];

  __device__ __forceinline__ void load(const float* x, int r0, int n,
                                       float mul) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      const float* row = x + (size_t)(r < n ? r : 0) * D + t;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        v[kk][h] = r < n ? row[8 * kk] * mul : 0.f;
        v[kk][2 + h] = r < n ? row[8 * kk + 4] * mul : 0.f;
      }
    }
  }

  // step kk's fragment as TF32 hi and lo
  __device__ __forceinline__ void get(int kk, uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) mma::split(v[kk][e], hi[e], lo[e]);
  }
};

// bf16: the m16n8k16 fragments of the D/16 contraction steps, as pairs:
// v[kk] = (g, 16kk + 2t..+1), (g + 8, 16kk + 2t..), (g, 16kk + 2t + 8..),
// (g + 8, 16kk + 2t + 8..). `mul` is not applied: bf16 scores are scaled
// after the product, in f32.
template <int D>
struct Rows<__nv_bfloat16, D> {
  uint32_t v[D / 16][4];

  __device__ __forceinline__ void load(const __nv_bfloat16* x, int r0, int n,
                                       float) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      const __nv_bfloat16* row = x + (size_t)(r < n ? r : 0) * D + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        v[kk][h] = r < n ? *reinterpret_cast<const uint32_t*>(row + 16 * kk)
                         : 0u;
        v[kk][2 + h] =
            r < n ? *reinterpret_cast<const uint32_t*>(row + 16 * kk + 8)
                  : 0u;
      }
    }
  }
};

// f32 fragments split into TF32 hi and lo once, for operands that every
// key tile reuses (Q).
template <int D>
struct Split {
  uint32_t hi[D / 8][4], lo[D / 8][4];

  __device__ __forceinline__ void load(const float* x, int r0, int n,
                                       float mul) {
    Rows<float, D> raw;
    raw.load(x, r0, n, mul);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) raw.get(kk, hi[kk], lo[kk]);
  }

  __device__ __forceinline__ void get(int kk, uint32_t (&h)[4],
                                      uint32_t (&l)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = hi[kk][e];
      l[e] = lo[kk][e];
    }
  }
};

// The fragments a kernel keeps for the whole walk: f32 split once, bf16
// as loaded.
template <typename T, int D>
struct Kept {
  using type = Split<D>;
};
template <int D>
struct Kept<__nv_bfloat16, D> {
  using type = Rows<__nv_bfloat16, D>;
};

// -- shared-memory fragment loads -------------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// -- the products -----------------------------------------------------------------
// s = A · Kᵀ over a staged tile of BK keys (row stride S): s[j] holds keys
// 8j + 2t, 8j + 2t + 1 of rows g (s[j][0..1]) and g + 8 (s[j][2..3]).
// f32, 3×TF32: A is `Split` (hi and lo kept) or `Rows` (split here).
template <int D, class A>
__device__ __forceinline__ void scores(const A& a, const float* ks,
                                       float (&s)[Tile<float, D>::BK / 8][4]) {
  using C = Tile<float, D>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < C::BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    a.get(kk, ah, al);
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j) {
      const float* row = ks + (8 * j + g) * C::S + 8 * kk + t;
      uint32_t bh[2], bl[2];
      mma::split(row[0], bh[0], bl[0]);
      mma::split(row[4], bh[1], bl[1]);
      mma::mma_tf32(s[j], al, bh);
      mma::mma_tf32(s[j], ah, bl);
      mma::mma_tf32(s[j], ah, bh);
    }
  }
}

// bf16: K's B fragments by ldmatrix, two key blocks of 8 per load.
template <int D>
__device__ __forceinline__ void scores(
    const Rows<__nv_bfloat16, D>& a, const __nv_bfloat16* ks,
    float (&s)[Tile<__nv_bfloat16, D>::BK / 8][4]) {
  using C = Tile<__nv_bfloat16, D>;
  const int lane = threadIdx.x % 32, mt = lane / 8, r = lane % 8;
#pragma unroll
  for (int j = 0; j < C::BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int jj = 0; jj < C::BK / 16; ++jj) {
      // matrices: (keys 16jj, d 16kk), (16jj, 16kk + 8), (16jj + 8, 16kk),
      // (16jj + 8, 16kk + 8) -> b0, b1 of key block 2jj, then of 2jj + 1
      uint32_t b[4];
      ldsm_x4(b, ks + (16 * jj + r + 8 * (mt / 2)) * C::S + 16 * kk +
                     8 * (mt % 2));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma::mma_bf16(s[2 * jj], a.v[kk], b0);
      mma::mma_bf16(s[2 * jj + 1], a.v[kk], b1);
    }
  }
}

// acc += P · V over a staged tile (V row-major, keys by d), P in the
// layout `scores` leaves. acc[n] holds columns 8n + 2t, 8n + 2t + 1 of rows
// g (acc[n][0..1]) and g + 8 (acc[n][2..3]).
// f32, 3×TF32, with the relabelled contraction (header note).
template <int D>
__device__ __forceinline__ void accumulate(
    const float (&p)[Tile<float, D>::BK / 8][4], const float* vs,
    float (&acc)[D / 8][4]) {
  using C = Tile<float, D>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < C::BK / 8; ++j) {
    uint32_t ah[4], al[4];
    mma::split(p[j][0], ah[0], al[0]);
    mma::split(p[j][2], ah[1], al[1]);
    mma::split(p[j][1], ah[2], al[2]);
    mma::split(p[j][3], ah[3], al[3]);
    const float* col = vs + (8 * j + 2 * t) * C::S + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bh[2], bl[2];
      mma::split(col[8 * n], bh[0], bl[0]);
      mma::split(col[C::S + 8 * n], bh[1], bl[1]);
      mma::mma_tf32(acc[n], al, bh);
      mma::mma_tf32(acc[n], ah, bl);
      mma::mma_tf32(acc[n], ah, bh);
    }
  }
}

// bf16: P rounded to bf16 pairs; V's B fragments by ldmatrix.trans.
template <int D>
__device__ __forceinline__ void accumulate(
    const float (&p)[Tile<__nv_bfloat16, D>::BK / 8][4],
    const __nv_bfloat16* vs, float (&acc)[D / 8][4]) {
  using C = Tile<__nv_bfloat16, D>;
  const int lane = threadIdx.x % 32, mt = lane / 8, r = lane % 8;
#pragma unroll
  for (int j = 0; j < C::BK / 16; ++j) {
    const uint32_t a[4] = {mma::pack_bf16(p[2 * j][0], p[2 * j][1]),
                           mma::pack_bf16(p[2 * j][2], p[2 * j][3]),
                           mma::pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           mma::pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      // matrices: (keys 16j, d 16nn), (16j + 8, 16nn), (16j, 16nn + 8),
      // (16j + 8, 16nn + 8), transposed -> b0, b1 of column block 2nn,
      // then of 2nn + 1
      uint32_t b[4];
      ldsm_x4_trans(b, vs + (16 * j + r + 8 * (mt % 2)) * C::S + 16 * nn +
                           8 * (mt / 2));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma::mma_bf16(acc[2 * nn], a, b0);
      mma::mma_bf16(acc[2 * nn + 1], a, b1);
    }
  }
}

// -- keys ---------------------------------------------------------------------------
// The validity of a tile's BK keys (key < Tk and, with a key mask,
// mask[key]), read a tile ahead by each warp (lane l: keys k0 + l and
// k0 + l + 32) and gathered by a ballot into one word: bit c is key k0 + c.
template <int BK>
struct Keys {
  bool v0 = false, v1 = false;

  __device__ __forceinline__ void load(const uint8_t* mask, int Tk, int k0) {
    const int c = k0 + threadIdx.x % 32;
    v0 = c < Tk && (mask == nullptr || mask[c]);
    if (BK > 32) v1 = c + 32 < Tk && (mask == nullptr || mask[c + 32]);
  }

  __device__ __forceinline__ uint64_t bits() const {
    const uint64_t lo = __ballot_sync(kFull, v0);
    return BK > 32 ? lo | (uint64_t)__ballot_sync(kFull, v1) << 32 : lo;
  }
};

// Scores that the masks remove, in place: keys ≥ Tk are absent (−inf:
// p == 0 exactly), keys the key mask or causality removes take −1e30, as
// in the JAX kernel (flash_attention.py:80-85). `rows` are the thread's
// two query rows. A tile whose keys are all valid for every row of the
// warp (the common case) is left as it is without a test per score.
template <int NJ>
__device__ __forceinline__ void mask_scores(float (&s)[NJ][4], uint64_t bits,
                                            int k0, int Tk, int causal,
                                            const int (&rows)[2]) {
  const int t = threadIdx.x % 4;
  const int r0 = rows[0] - threadIdx.x % 32 / 4;  // the warp's first row
  const uint64_t all = NJ == 8 ? ~0ull : (1ull << (8 * NJ % 64)) - 1;
  if (bits == all && k0 + 8 * NJ <= Tk && !(causal && k0 + 8 * NJ - 1 > r0))
    return;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      const int key = k0 + c;
      if (key >= Tk) {
        s[j][e] = neg_inf();
      } else if (!((bits >> c) & 1) || (causal && key > rows[e >> 1])) {
        s[j][e] = kNegInf;
      }
    }
  }
}

// The masks of the dK/dV walk on Sᵀ = K·Qᵀ, in place: rows are the
// thread's two keys (`kv`: present, key < Tk, and not removed by the key
// mask), columns the queries q0 + 8j + 2t (+1). A key that `kv` drops
// (rows ≥ Tk are never stored) and, under causality, a query before the
// key take −1e30, as in the JAX kernel; queries ≥ Tq are absent (−inf:
// p == 0 exactly). A tile whose queries are all present and see every one
// of the warp's 16 keys (`all_keys`) is left as it is.
template <int NJ>
__device__ __forceinline__ void mask_scores_t(float (&s)[NJ][4],
                                              const bool (&kv)[2],
                                              bool all_keys, int q0, int Tq,
                                              int causal,
                                              const int (&keys)[2]) {
  const int t = threadIdx.x % 4;
  const int r0 = keys[0] - threadIdx.x % 32 / 4;  // the warp's first key
  if (all_keys && q0 + 8 * NJ <= Tq && !(causal && q0 < r0 + 15)) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + 8 * j + 2 * t + (e & 1);
      const int h = e >> 1;
      if (qi >= Tq) {
        s[j][e] = neg_inf();
      } else if (!kv[h] || (causal && qi < keys[h])) {
        s[j][e] = kNegInf;
      }
    }
  }
}

// The row's value over the quad of threads that hold it.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Two adjacent values of an output row, as one 8-byte (f32) or 4-byte
// (bf16) store; D is even and rows are aligned.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// -- launch ---------------------------------------------------------------------------
// Warps per block: the most (4, then 2) that still give every SM of the
// card a block at this (B·H, Tq); else 1. BERT's fine-tune and encode
// shapes (B·H = 384 or 96, T ≥ 128) take 4; prefill (12 heads, 128 rows)
// takes 1, 96 blocks instead of 24 blocks of 4 warps.
inline int warps_per_block(int BH, int Tq, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    sms = 132;
  for (int nw = kMaxWarps; nw > 1; nw /= 2) {
    if ((long long)BH * ((Tq + 16 * nw - 1) / (16 * nw)) >= sms) return nw;
  }
  return 1;
}

// Launch `kernel` over (query tiles of 16·nw rows, BH) blocks of 32·nw
// threads with `smem` bytes of dynamic shared memory.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int nw, int BH, int Tq, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + 16 * nw - 1) / (16 * nw), BH);
  kernel<<<grid, 32 * nw, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace dl4j
