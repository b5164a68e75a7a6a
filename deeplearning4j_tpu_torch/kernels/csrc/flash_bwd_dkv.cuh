// Flash-attention backward, dK and dV on Hopper's tensor cores:
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
// flops (Sᵀ, dPᵀ = V·dOᵀ, Pᵀ·dO and dSᵀ·Q) and it reads Q, dO, K and V once
// each and writes dK and dV. f32 runs as 3×TF32, 24·D TF32 flops a pair at
// 495 TFLOP/s: bytes bound it at the fine-tune shape (B=32, H=12, T=128,
// D=64 with its padding) and those operations at the encode shape
// (8×12×512²). bf16 (989 TFLOP/s) is bound by bytes at both
// (chip_smoke.py's bounds).
//
// Design: the tile of flash_bwd_dq.cu (attn_tile.cuh) with keys and
// queries swapped, against what held the first version (f32 FMA out of
// shared memory, P and dS through shared memory, scalar staging) back:
// - A warp owns 16 key rows, a block 4, 2 or 1 warps (picked from
//   (B·H, Tk) by attn::warps_per_block), and the block walks the query
//   tiles. The warp keeps K (times the scale, f32: split into TF32 hi and
//   lo once) and V (f32: raw, split at each use) as A fragments in
//   registers for the whole walk.
// - Each query tile's Q and dO rows come through the 3-stage cp.async
//   ring (attn::stage_kv), with the tile's lse and Δ in the same stage.
// - The four products on the tensor cores: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with
//   the staged Q and dO rows as B operands (attn::scores; keys are the
//   fragment rows, queries its columns, so L and Δ are read per column),
//   then dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ taken straight from
//   the score fragments as A operands (attn::accumulate: f32 relabelled,
//   bf16 packed in pairs). P and dS never leave registers.
// - f32 adds each 8-query step's products into dK and dV in f32
//   (attn::accumulate<D, true>): the tensor cores truncate what they add
//   to the accumulator they are given, and chained straight into dK and
//   dV over a walk of 3 × T/8 steps that truncation built up with the
//   sum. At the causal 2×12×2048² f32 block, where the first keys' dK
//   and dV reach ~5, chained sums came out 1.285e-4 from f64 and the
//   step's sums 5.6e-6, nearer than the plain f32 version's 8.6e-6; they
//   cost 14–20 % of the kernel's time at every f32 shape (H100). A
//   separate sum per tile (as flash_bwd_dq.cu keeps) would take 64 more
//   registers a thread; the step's sum takes 4. The CPU emulation of both
//   orders (tests/test_torch_tf32_split.py) rounds every add to nearest,
//   so it cannot show the truncation.
// - Skips that change no bit: causal query tiles that end before the
//   block's first key are never walked (the TPU kernel's skip, :308-311); a
//   tile whose queries all carry the +1e30 lse sentinel (padded rows of a
//   self-attention example: P is exactly 0) is skipped; a warp none of
//   whose keys the tile's queries may see (key mask, Tk, causality) skips
//   the tile unless one of its queries is degenerate (lse ≤ −1e29: all of
//   its visible keys are masked, and P = 1 on masked keys). Masked keys
//   still get their dK and dV written, as zeros when nothing reached them.
// Each dK/dV row has one owner, with no atomics and no split of the query
// walk, so two runs give bit-identical results.
//
// Head dims past 128 (padded by the wrapper to a multiple of 128) run the
// wide kernel of flash_fwd.cu's design (attn_tile.cuh's note): a block owns
// one 128-column chunk of dK and dV (grid dimension z), so the warp's two
// accumulators stay 16 keys × 128 columns, and walks DC slices per query
// tile, each staging one column chunk of Q and of dO with the tile's lse
// and Δ. Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ sum over the chunks in registers, with
// K's and V's chunks read where they are multiplied. The chunks run in
// the order oc + 1, …, oc (mod DC), so the tile's last slice holds the Q
// and dO chunks oc that dK's and dV's chunk need. The f32 sums stay
// rounded per 8-query step, and each block's order is fixed, so re-runs
// stay bit-identical.
//
// flash_bwd_dkv.cu builds the float32 instantiations and flash_bwd_dkv_bf16.cu the
// bfloat16 ones, as two libraries whose nvcc runs in parallel.
#pragma once

#include "attn_tile.cuh"

namespace dl4j {
namespace {

// A ring stage: the query tile's Q rows and dO rows (attn::stage_kv's
// layout), then its BK lse and BK Δ values.
template <typename T, int D>
struct Stage {
  static constexpr int kRows = attn::Tile<T, D>::kStage;
  static constexpr int kBytes = kRows + 2 * attn::Tile<T, D>::BK * 4;
};

template <typename T, int D, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const uint8_t* __restrict__ kv_mask, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, int causal,
                     float scale) {
  using C = attn::Tile<T, D>;
  using St = Stage<T, D>;
  constexpr int BK = C::BK, NJ = BK / 8, ND = D / 8;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * 16 * NW;       // the block's first key
  const int r0 = k0 + threadIdx.x / 32 * 16;  // the warp's first key
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int keys[2] = {r0 + g, r0 + g + 8};
  const bool warp_live = r0 < Tk;
  const size_t koff = (size_t)bh * Tk * D;
  const T* qb = q + (size_t)bh * Tq * D;
  const T* gb = dout + (size_t)bh * Tq * D;
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;

  typename attn::Kept<T, D>::type ka;  // K·scale in f32; bf16 scales Sᵀ
  ka.load(k + koff, r0, Tk, scale);
  attn::Rows<T, D> va;  // V
  va.load(v + koff, r0, Tk, 1.f);
  bool kv[2];  // the thread's two keys: present and not masked
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kv[h] = keys[h] < Tk &&
            (kv_mask == nullptr || kv_mask[(size_t)(bh / H) * Tk + keys[h]]);
  }
  const bool any_key = __any_sync(attn::kFull, kv[0] || kv[1]);
  const bool all_keys = __all_sync(attn::kFull, kv[0] && kv[1]);
  float dka[ND][4] = {}, dva[ND][4] = {};

  // causal: query tiles that end before the block's first key see none of
  // its keys
  const int q_start = causal ? k0 / BK * BK : 0;
  struct Item {
    int slices;
  };
  auto stage = [&](int slot) { return smem + slot * St::kBytes; };
  mma::walk(
      1, [&](int) { return Item{(Tq - q_start + BK - 1) / BK}; },
      [&](int slot, const Item&, int i) {
        const int q0 = q_start + i * BK;
        attn::stage_kv<T, D, 32 * NW>(reinterpret_cast<T*>(stage(slot)), qb,
                                      gb, q0, Tq);
        float* rows = reinterpret_cast<float*>(stage(slot) + St::kRows);
        for (int c = threadIdx.x; c < 2 * BK; c += 32 * NW) {
          const int qi = q0 + c % BK;
          const bool in = qi < Tq;
          mma::cp4(rows + c, (c < BK ? lb : db) + (in ? qi : 0), in);
        }
      },
      [&](int slot, const Item&, int i) {
        if (!warp_live) return;
        const int q0 = q_start + i * BK;
        const T* qs = reinterpret_cast<const T*>(stage(slot));
        const T* gs = qs + BK * C::S;
        const float* ls =
            reinterpret_cast<const float*>(stage(slot) + St::kRows);
        const float* dls = ls + BK;
        // the tile's queries: any not carrying the +1e30 sentinel, any
        // degenerate
        bool live = false, degen = false;
#pragma unroll
        for (int c = lane; c < BK; c += 32) {
          if (q0 + c < Tq) {
            live |= ls[c] < 1e29f;
            degen |= ls[c] <= -1e29f;
          }
        }
        if (!__any_sync(attn::kFull, live)) return;
        const bool none = !any_key || (causal && r0 > q0 + BK - 1);
        if (none && !__any_sync(attn::kFull, degen)) return;

        float s[NJ][4], dp[NJ][4];
        attn::scores<D>(ka, qs, s);
        if constexpr (!kF32) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] *= scale;
          }
        }
        attn::mask_scores_t(s, kv, all_keys, q0, Tq, causal, keys);
        attn::scores<D>(va, gs, dp);
        // Pᵀ = exp(Sᵀ − L) per query column (0 for absent queries, whose
        // score is −inf)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 L = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[j][2 * h] = expf(s[j][2 * h] - L.x);
            s[j][2 * h + 1] = expf(s[j][2 * h + 1] - L.y);
          }
        }
        attn::accumulate<D, true>(s, gs, dva);
        // dSᵀ = Pᵀ∘(dPᵀ − Δ), in place
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 dl =
              *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[j][2 * h] *= dp[j][2 * h] - dl.x;
            s[j][2 * h + 1] *= dp[j][2 * h + 1] - dl.y;
          }
        }
        attn::accumulate<D, true>(s, qs, dka);
      },
      [&](const Item&) {});

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= Tk) continue;
    T* krow = dk + koff + (size_t)keys[h] * D + 2 * t;
    T* vrow = dv + koff + (size_t)keys[h] * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      attn::store2(krow + 8 * n, scale * dka[n][2 * h],
                   scale * dka[n][2 * h + 1]);
      attn::store2(vrow + 8 * n, dva[n][2 * h], dva[n][2 * h + 1]);
    }
  }
}

// The wide kernel (D = 128·DC > 128, attn_tile.cuh's note): this block
// writes dK's and dV's columns [128·oc, 128·oc + 128), oc = blockIdx.z.
// Slice i of the walk is query tile i / DC and the column chunk
// (oc + 1 + i % DC) mod DC of Q and dO, with the tile's lse and Δ, so the
// tile's last slice holds the chunks oc that Pᵀ·dO and dSᵀ·Q need.
template <typename T, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const uint8_t* __restrict__ kv_mask,
                          T* __restrict__ dk, T* __restrict__ dv, int H,
                          int Tq, int Tk, int causal, float scale, int DC) {
  constexpr int W = attn::kWideChunk;
  using C = attn::Tile<T, W>;
  using St = Stage<T, W>;
  constexpr int BK = C::BK, NJ = BK / 8, ND = W / 8;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int D = W * DC;  // the row stride
  const int oc = blockIdx.z;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * 16 * NW;       // the block's first key
  const int r0 = k0 + threadIdx.x / 32 * 16;  // the warp's first key
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int keys[2] = {r0 + g, r0 + g + 8};
  const bool warp_live = r0 < Tk;
  const size_t koff = (size_t)bh * Tk * D;
  const T* qb = q + (size_t)bh * Tq * D;
  const T* gb = dout + (size_t)bh * Tq * D;
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;

  bool kv[2];  // the thread's two keys: present and not masked
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kv[h] = keys[h] < Tk &&
            (kv_mask == nullptr || kv_mask[(size_t)(bh / H) * Tk + keys[h]]);
  }
  const bool any_key = __any_sync(attn::kFull, kv[0] || kv[1]);
  const bool all_keys = __all_sync(attn::kFull, kv[0] && kv[1]);
  float dka[ND][4] = {}, dva[ND][4] = {};
  float s[NJ][4], dp[NJ][4];  // Sᵀ and dPᵀ of the tile, over its chunks
  bool skip = false;          // the warp skips the query tile

  // causal: query tiles that end before the block's first key see none of
  // its keys
  const int q_start = causal ? k0 / BK * BK : 0;
  struct Item {
    int slices;
  };
  auto stage = [&](int slot) { return smem + slot * St::kBytes; };
  auto chunk = [&](int j) { return (oc + 1 + j) % DC; };
  mma::walk(
      1, [&](int) { return Item{(Tq - q_start + BK - 1) / BK * DC}; },
      [&](int slot, const Item&, int i) {
        const int qt = i / DC, kc = chunk(i - qt * DC);
        const int q0 = q_start + qt * BK;
        attn::stage_kv<T, W, 32 * NW>(reinterpret_cast<T*>(stage(slot)),
                                      qb + kc * W, gb + kc * W, q0, Tq, D);
        float* rows = reinterpret_cast<float*>(stage(slot) + St::kRows);
        for (int c = threadIdx.x; c < 2 * BK; c += 32 * NW) {
          const int qi = q0 + c % BK;
          const bool in = qi < Tq;
          mma::cp4(rows + c, (c < BK ? lb : db) + (in ? qi : 0), in);
        }
      },
      [&](int slot, const Item&, int i) {
        if (!warp_live) return;
        const int qt = i / DC, j = i - qt * DC, kc = chunk(j);
        const int q0 = q_start + qt * BK;
        const T* qs = reinterpret_cast<const T*>(stage(slot));
        const T* gs = qs + BK * C::S;
        const float* ls =
            reinterpret_cast<const float*>(stage(slot) + St::kRows);
        const float* dls = ls + BK;
        if (j == 0) {
          // the tile's queries: any not carrying the +1e30 sentinel, any
          // degenerate
          bool live = false, degen = false;
#pragma unroll
          for (int c = lane; c < BK; c += 32) {
            if (q0 + c < Tq) {
              live |= ls[c] < 1e29f;
              degen |= ls[c] <= -1e29f;
            }
          }
          const bool none = !any_key || (causal && r0 > q0 + BK - 1);
          skip = !__any_sync(attn::kFull, live) ||
                 (none && !__any_sync(attn::kFull, degen));
        }
        if (skip) return;
        // K's chunk (f32: times the scale) and V's, read where they are
        // multiplied
        {
          attn::Rows<T, W> kc_rows;
          kc_rows.load(k + koff + kc * W, r0, Tk, scale, D);
          attn::scores_chunk<W>(kc_rows, qs, s, j == 0);
        }
        {
          attn::Rows<T, W> vc_rows;
          vc_rows.load(v + koff + kc * W, r0, Tk, 1.f, D);
          attn::scores_chunk<W>(vc_rows, gs, dp, j == 0);
        }
        if (j != DC - 1) return;
        if constexpr (!kF32) {
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[jj][e] *= scale;
          }
        }
        attn::mask_scores_t(s, kv, all_keys, q0, Tq, causal, keys);
        // Pᵀ = exp(Sᵀ − L) per query column (0 for absent queries, whose
        // score is −inf)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float2 L =
              *reinterpret_cast<const float2*>(ls + 8 * jj + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[jj][2 * h] = expf(s[jj][2 * h] - L.x);
            s[jj][2 * h + 1] = expf(s[jj][2 * h + 1] - L.y);
          }
        }
        // qs and gs hold the chunks oc of Q and dO
        attn::accumulate<W, true>(s, gs, dva);
        // dSᵀ = Pᵀ∘(dPᵀ − Δ), in place
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float2 dl =
              *reinterpret_cast<const float2*>(dls + 8 * jj + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[jj][2 * h] *= dp[jj][2 * h] - dl.x;
            s[jj][2 * h + 1] *= dp[jj][2 * h + 1] - dl.y;
          }
        }
        attn::accumulate<W, true>(s, qs, dka);
      },
      [&](const Item&) {});

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= Tk) continue;
    T* krow = dk + koff + (size_t)keys[h] * D + oc * W + 2 * t;
    T* vrow = dv + koff + (size_t)keys[h] * D + oc * W + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      attn::store2(krow + 8 * n, scale * dka[n][2 * h],
                   scale * dka[n][2 * h + 1]);
      attn::store2(vrow + 8 * n, dva[n][2 * h], dva[n][2 * h + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const uint8_t* kv_mask, void* dk, void* dv, int BH,
                     int H, int Tq, int Tk, int causal, float scale,
                     int device, cudaStream_t stream) {
  const int nw = attn::warps_per_block(BH, Tk, device);
  constexpr size_t smem = (size_t)mma::kStages * Stage<T, D>::kBytes;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  switch (nw) {
    case 4:
      return attn::launch(flash_bwd_dkv_kernel<T, D, 4>, 4, BH, Tk, 1, smem,
                          stream, qt, kt, vt, gt, lse, delta, kv_mask, dkt,
                          dvt, H, Tq, Tk, causal, scale);
    case 2:
      return attn::launch(flash_bwd_dkv_kernel<T, D, 2>, 2, BH, Tk, 1, smem,
                          stream, qt, kt, vt, gt, lse, delta, kv_mask, dkt,
                          dvt, H, Tq, Tk, causal, scale);
    default:
      return attn::launch(flash_bwd_dkv_kernel<T, D, 1>, 1, BH, Tk, 1, smem,
                          stream, qt, kt, vt, gt, lse, delta, kv_mask, dkt,
                          dvt, H, Tq, Tk, causal, scale);
  }
}

// D = 128·DC: DC column chunks of dK and dV, one per block (grid
// dimension z), of attn::kWideWarps warps.
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, const uint8_t* kv_mask, void* dk,
                        void* dv, int BH, int H, int Tq, int Tk, int causal,
                        float scale, int DC, cudaStream_t stream) {
  constexpr int nw = attn::kWideWarps;
  return attn::launch(
      flash_bwd_dkv_wide_kernel<T, nw>, nw, BH, Tk, DC,
      (size_t)mma::kStages * Stage<T, attn::kWideChunk>::kBytes, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      kv_mask, static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, causal,
      scale, DC);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const uint8_t* kv_mask, void* dk, void* dv, int BH, int H,
                   int Tq, int Tk, int D, int causal, float scale, int device,
                   cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, dout, lse, delta, kv_mask, dk, dv, BH,
                             H, Tq, Tk, causal, scale, device, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, dout, lse, delta, kv_mask, dk, dv, BH,
                             H, Tq, Tk, causal, scale, device, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, dout, lse, delta, kv_mask, dk, dv, BH,
                             H, Tq, Tk, causal, scale, device, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, dout, lse, delta, kv_mask, dk, dv, BH,
                             H, Tq, Tk, causal, scale, device, stream);
    default:
      if (D <= attn::kWideChunk || D % attn::kWideChunk != 0 ||
          D / attn::kWideChunk > 65535)
        return cudaErrorInvalidValue;
      return launch_wide<T>(q, k, v, dout, lse, delta, kv_mask, dk, dv, BH, H,
                            Tq, Tk, causal, scale, D / attn::kWideChunk,
                            stream);
  }
}

}  // namespace
}  // namespace dl4j
