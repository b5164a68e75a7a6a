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
// - f32 accumulates each tile's products straight into dK and dV: the
//   mma chain is at most 3 × T/8 steps long (192 at T = 512), and a
//   separate sum per tile (as flash_bwd_dq.cu keeps) would take 64 more
//   registers a thread; the CPU emulation of both orders holds the f32
//   gate (tests/test_torch_tf32_split.py).
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
        attn::accumulate<D>(s, gs, dva);
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
        attn::accumulate<D>(s, qs, dka);
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
      return attn::launch(flash_bwd_dkv_kernel<T, D, 4>, 4, BH, Tk, smem,
                          stream, qt, kt, vt, gt, lse, delta, kv_mask, dkt,
                          dvt, H, Tq, Tk, causal, scale);
    case 2:
      return attn::launch(flash_bwd_dkv_kernel<T, D, 2>, 2, BH, Tk, smem,
                          stream, qt, kt, vt, gt, lse, delta, kv_mask, dkt,
                          dvt, H, Tq, Tk, causal, scale);
    default:
      return attn::launch(flash_bwd_dkv_kernel<T, D, 1>, 1, BH, Tk, smem,
                          stream, qt, kt, vt, gt, lse, delta, kv_mask, dkt,
                          dvt, H, Tq, Tk, causal, scale);
  }
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
                               Tk, D, causal, scale, device, s);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(q, k, v, dout, l, dl, mask, dk, dv,
                                       BH, H, Tq, Tk, D, causal, scale,
                                       device, s);
  return cudaErrorInvalidValue;
}
