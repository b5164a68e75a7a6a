// Flash-attention forward on Hopper's tensor cores: softmax(Q·Kᵀ/√d)·V over
// (B·H, T, D) with an optional causal mask and an optional (B, Tk)
// key-validity mask. Emits O in the input dtype and the per-row logsumexp
// in f32.
//
// Replaces: deeplearning4j_tpu/kernels/flash_attention.py::_flash_fwd_kernel
// (:42), driven by _flash_forward (pallas_call at :163).
//
// What bounds it on the H100: 4·D flops per valid (query, key) pair
// against Q, K, V and O read or written once. bf16 runs them at 989
// TFLOP/s and is bound by bytes at every shape the BERT paths give it
// (prefill 1×12×128², encode 8×12×512², fine-tune 32×12×128²). f32 runs
// as 3×TF32, three TF32 products per f32 product at 495 TFLOP/s: those
// operations bound it at the encode shape (0.0156 ms), bytes at prefill
// (0.00047 ms) and at the fine-tune shape (0.0120 ms) (chip_smoke.py's
// bounds).
//
// Design (attn_tile.cuh holds the tile), against what held the first
// version (one thread per query row, f32 FMA) back:
// - The tensor cores in both dtypes: mma.sync bf16, and 3×TF32 for f32,
//   since one TF32 pass misses the f32 gate by an order of magnitude
//   (tests/test_torch_tf32_split.py). Each warp owns 16 query rows; its Q
//   fragments, scaled, are split into TF32 hi and lo once per block and
//   stay in registers. Each key tile's P·V product is summed apart and
//   added in f32 (acc·alpha + pv), so the mma chain stays short.
// - Small grids: a block has 4, 2 or 1 warps, picked at launch so that
//   B·H × query tiles reaches every SM (attn::warps_per_block): prefill at
//   12 heads × 128 rows runs 96 one-warp blocks, not 24 blocks.
// - Loads overlap math: K/V tiles come through a 3-stage cp.async ring
//   (mma::walk), so tile j + 2 is in flight while tile j is multiplied.
// - P stays in registers: the score fragments of S = Q·Kᵀ become the A
//   operand of P·V (bf16: two n8 fragments packed into one k16 fragment,
//   with P rounded to bf16 where the JAX kernel keeps f32 (:92-95), which
//   the bf16 gate of 2e-2 absorbs: an O of magnitude 2–4 may come out one
//   bf16 step, 2^-6, from the plain version; f32: the contraction
//   relabelled, a0..a3 = c0, c2, c1, c3). The online softmax
//   runs on the fragments: row max and sum across the quad by shuffles,
//   one rescale per key tile.
// - Tiles the masks empty are skipped where the skip is exact: a warp
//   skips a key tile none of whose keys is valid for its rows once each of
//   its rows has seen a valid key (its m is above −1e30, so the tile's p
//   are exactly 0 and alpha exactly 1). A row that has seen none (a fully
//   padded example) still walks every tile and comes out as the mean of
//   V, as the plain version gives it. Causal tiles wholly above the block's
//   diagonal are never loaded (the TPU kernel's pl.when skip, :97-100).
// Each output row has one owner and the key walk is not split, so every
// re-run gives the same bits. Invalid query rows are zeroed, and their lse
// set to the 1e30 sentinel, by the Python wrapper, as in the JAX wrapper.
//
// Head dims: D = 16, 32, 64 and 128 have their own tile (the wrapper pads a
// smaller D to the next). A wider D, padded by the wrapper to a multiple
// of 128, runs `flash_fwd_wide_kernel` (attn_tile.cuh's note): of the two
// ways to keep a 16 × D f32 accumulator and Q's TF32 split out of one
// warp's registers, this one splits O's columns into 128-wide chunks, one
// per block (grid dimension z), and sums S = Q·Kᵀ over D chunk by chunk
// in each of them, rather than computing P once and sharing it through
// shared memory. It keeps the narrow tile, its ring of three 128-column
// stages (101 KB f32, 104 KB bf16: K's chunk, and V's output chunk on a
// tile's last slice) and its one owner per output element, needs no
// block-wide barrier between the warps' softmax and the P·V product, and
// takes any D (D = 512's K and V rows would not fit three stages whole).
// It pays in recomputed scores: the S products run once per output
// chunk, 2·D·(DC + 1) flops a pair for the 4·D the function needs (2.5×
// at D = 512). Every chunk's block sums S in the same order, so they
// agree on m and l, and the block of chunk 0 writes the lse.
//
// flash_fwd.cu builds the float32 instantiations and flash_fwd_bf16.cu the
// bfloat16 ones, as two libraries whose nvcc runs in parallel.
#pragma once

#include "attn_tile.cuh"

namespace dl4j {
namespace {

template <typename T, int D, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Tq,
                 int Tk, int causal, float scale) {
  using C = attn::Tile<T, D>;
  constexpr int BK = C::BK, NJ = BK / 8, ND = D / 8;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 16 * NW;
  const int r0 = q0 + threadIdx.x / 32 * 16;  // the warp's first row
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int rows[2] = {r0 + g, r0 + g + 8};
  const bool warp_live = r0 < Tq;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const uint8_t* mrow =
      kv_mask == nullptr ? nullptr : kv_mask + (size_t)(bh / H) * Tk;

  // Q carries the scale in f32 (as the JAX kernel scales q before the
  // product); bf16 scores are scaled after it
  typename attn::Kept<T, D>::type qa;
  qa.load(q + (size_t)bh * Tq * D, r0, Tq, scale);
  float acc[ND][4] = {};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's columns only; summed at the end
  attn::Keys<BK> keys;
  keys.load(mrow, Tk, 0);

  const int k_end = causal ? min(Tk, q0 + 16 * NW) : Tk;
  struct Item {
    int slices;
  };
  auto stage = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * C::kStage);
  };
  mma::walk(
      1, [&](int) { return Item{(k_end + BK - 1) / BK}; },
      [&](int slot, const Item&, int i) {
        attn::stage_kv<T, D, 32 * NW>(stage(slot), kb, vb, i * BK, Tk);
      },
      [&](int slot, const Item&, int i) {
        if (!warp_live) return;
        const int k0 = i * BK;
        const uint64_t bits = keys.bits();
        keys.load(mrow, Tk, k0 + BK);
        const bool none = bits == 0 || (causal && k0 > r0 + 15);
        const bool seen = (m[0] > kNegInf || rows[0] >= Tq) &&
                          (m[1] > kNegInf || rows[1] >= Tq);
        if (__all_sync(attn::kFull, none && seen)) return;

        const T* ks = stage(slot);
        const T* vs = ks + BK * C::S;
        float s[NJ][4];
        attn::scores<D>(qa, ks, s);
        if constexpr (!kF32) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] *= scale;
          }
        }
        attn::mask_scores(s, bits, k0, Tk, causal, rows);

        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = m[h];
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
          mx = attn::quad_max(mx);
          alpha[h] = expf(m[h] - mx);
          m[h] = mx;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            s[j][2 * h] = expf(s[j][2 * h] - mx);
            s[j][2 * h + 1] = expf(s[j][2 * h + 1] - mx);
            sum += s[j][2 * h] + s[j][2 * h + 1];
          }
          l[h] = l[h] * alpha[h] + sum;
        }

        if constexpr (kF32) {
          float pv[ND][4] = {};
          attn::accumulate<D>(s, vs, pv);
#pragma unroll
          for (int n = 0; n < ND; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
          }
        } else {
#pragma unroll
          for (int n = 0; n < ND; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
          }
          attn::accumulate<D>(s, vs, acc);
        }
      },
      [&](const Item&) {});

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lc = fmaxf(attn::quad_sum(l[h]), 1e-30f);
    if (rows[h] >= Tq) continue;
    T* orow = o + ((size_t)bh * Tq + rows[h]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      attn::store2(orow + 8 * n, acc[n][2 * h] / lc, acc[n][2 * h + 1] / lc);
    if (t == 0) lse[(size_t)bh * Tq + rows[h]] = m[h] + logf(lc);
  }
}

// The wide kernel (D = 128·DC > 128, attn_tile.cuh's note): this block
// writes output columns [128·oc, 128·oc + 128), oc = blockIdx.z. Slice i of
// the walk is key tile i / DC and K's column chunk i % DC; the tile's last
// slice also stages V's chunk oc.
template <typename T, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const uint8_t* __restrict__ kv_mask, T* __restrict__ o,
                      float* __restrict__ lse, int H, int Tq, int Tk,
                      int causal, float scale, int DC) {
  constexpr int W = attn::kWideChunk;
  using C = attn::Tile<T, W>;
  constexpr int BK = C::BK, NJ = BK / 8, ND = W / 8;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int D = W * DC;  // the row stride
  const int oc = blockIdx.z;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 16 * NW;
  const int r0 = q0 + threadIdx.x / 32 * 16;  // the warp's first row
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int rows[2] = {r0 + g, r0 + g + 8};
  const bool warp_live = r0 < Tq;
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const uint8_t* mrow =
      kv_mask == nullptr ? nullptr : kv_mask + (size_t)(bh / H) * Tk;

  float acc[ND][4] = {};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's columns only; summed at the end
  attn::Keys<BK> keys;
  keys.load(mrow, Tk, 0);
  float s[NJ][4];     // S of the key tile, summed over its chunks
  uint64_t bits = 0;  // the key tile's validity (its first slice reads it)
  bool skip = false;  // the warp skips the key tile

  const int k_end = causal ? min(Tk, q0 + 16 * NW) : Tk;
  struct Item {
    int slices;
  };
  auto stage = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * C::kStage);
  };
  mma::walk(
      1, [&](int) { return Item{(k_end + BK - 1) / BK * DC}; },
      [&](int slot, const Item&, int i) {
        const int kt = i / DC, kc = i - kt * DC;
        attn::stage_rows<T, W, 32 * NW>(stage(slot), kb + kc * W, kt * BK,
                                        Tk, D);
        if (kc == DC - 1)
          attn::stage_rows<T, W, 32 * NW>(stage(slot) + BK * C::S,
                                          vb + oc * W, kt * BK, Tk, D);
      },
      [&](int slot, const Item&, int i) {
        if (!warp_live) return;
        const int kt = i / DC, kc = i - kt * DC;
        const int k0 = kt * BK;
        const T* ks = stage(slot);
        if (kc == 0) {
          bits = keys.bits();
          keys.load(mrow, Tk, k0 + BK);
          const bool none = bits == 0 || (causal && k0 > r0 + 15);
          const bool seen = (m[0] > kNegInf || rows[0] >= Tq) &&
                            (m[1] > kNegInf || rows[1] >= Tq);
          skip = __all_sync(attn::kFull, none && seen);
        }
        if (skip) return;
        // Q's chunk, read where it is multiplied (f32: times the scale)
        {
          attn::Rows<T, W> qc;
          qc.load(qb + kc * W, r0, Tq, scale, D);
          attn::scores_chunk<W>(qc, ks, s, kc == 0);
        }
        if (kc != DC - 1) return;

        const T* vs = ks + BK * C::S;
        if constexpr (!kF32) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] *= scale;
          }
        }
        attn::mask_scores(s, bits, k0, Tk, causal, rows);

        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = m[h];
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
          mx = attn::quad_max(mx);
          alpha[h] = expf(m[h] - mx);
          m[h] = mx;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            s[j][2 * h] = expf(s[j][2 * h] - mx);
            s[j][2 * h + 1] = expf(s[j][2 * h + 1] - mx);
            sum += s[j][2 * h] + s[j][2 * h + 1];
          }
          l[h] = l[h] * alpha[h] + sum;
        }

        if constexpr (kF32) {
          float pv[ND][4] = {};
          attn::accumulate<W>(s, vs, pv);
#pragma unroll
          for (int n = 0; n < ND; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
          }
        } else {
#pragma unroll
          for (int n = 0; n < ND; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
          }
          attn::accumulate<W>(s, vs, acc);
        }
      },
      [&](const Item&) {});

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lc = fmaxf(attn::quad_sum(l[h]), 1e-30f);
    if (rows[h] >= Tq) continue;
    T* orow = o + ((size_t)bh * Tq + rows[h]) * D + oc * W + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      attn::store2(orow + 8 * n, acc[n][2 * h] / lc, acc[n][2 * h + 1] / lc);
    if (t == 0 && oc == 0) lse[(size_t)bh * Tq + rows[h]] = m[h] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const uint8_t* kv_mask, void* o, float* lse, int BH,
                     int H, int Tq, int Tk, int causal, float scale,
                     int device, cudaStream_t stream) {
  const int nw = attn::warps_per_block(BH, Tq, device);
  constexpr size_t smem = attn::smem_bytes<T, D>();
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  switch (nw) {
    case 4:
      return attn::launch(flash_fwd_kernel<T, D, 4>, 4, BH, Tq, 1, smem,
                          stream, qt, kt, vt, kv_mask, ot, lse, H, Tq, Tk,
                          causal, scale);
    case 2:
      return attn::launch(flash_fwd_kernel<T, D, 2>, 2, BH, Tq, 1, smem,
                          stream, qt, kt, vt, kv_mask, ot, lse, H, Tq, Tk,
                          causal, scale);
    default:
      return attn::launch(flash_fwd_kernel<T, D, 1>, 1, BH, Tq, 1, smem,
                          stream, qt, kt, vt, kv_mask, ot, lse, H, Tq, Tk,
                          causal, scale);
  }
}

// D = 128·DC: DC column chunks, one per block (grid dimension z), of
// attn::kWideWarps warps.
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const uint8_t* kv_mask, void* o, float* lse, int BH,
                        int H, int Tq, int Tk, int causal, float scale,
                        int DC, cudaStream_t stream) {
  constexpr int nw = attn::kWideWarps;
  return attn::launch(flash_fwd_wide_kernel<T, nw>, nw, BH, Tq, DC,
                      attn::smem_bytes<T, attn::kWideChunk>(), stream,
                      static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), kv_mask, static_cast<T*>(o),
                      lse, H, Tq, Tk, causal, scale, DC);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* kv_mask, void* o, float* lse, int BH, int H,
                   int Tq, int Tk, int D, int causal, float scale, int device,
                   cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, kv_mask, o, lse, BH, H, Tq, Tk, causal,
                             scale, device, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, kv_mask, o, lse, BH, H, Tq, Tk, causal,
                             scale, device, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, kv_mask, o, lse, BH, H, Tq, Tk, causal,
                             scale, device, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, kv_mask, o, lse, BH, H, Tq, Tk, causal,
                             scale, device, stream);
    default:
      if (D <= attn::kWideChunk || D % attn::kWideChunk != 0 ||
          D / attn::kWideChunk > 65535)
        return cudaErrorInvalidValue;
      return launch_wide<T>(q, k, v, kv_mask, o, lse, BH, H, Tq, Tk, causal,
                            scale, D / attn::kWideChunk, stream);
  }
}

}  // namespace
}  // namespace dl4j
