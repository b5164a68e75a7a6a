// Flash-attention backward, dQ on Hopper's tensor cores:
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
// flops (S, dO·Vᵀ and dS·K) and it reads Q, dO, K and V once each. f32 runs
// as 3×TF32, 18·D TF32 flops a pair at 495 TFLOP/s: bytes bound it at the
// fine-tune shape (B=32, H=12, T=128, D=64 with its padding: 0.0148 ms)
// and those operations at the encode shape (8×12×512²: 0.0234 ms). bf16
// (989 TFLOP/s) is bound by bytes at both (chip_smoke.py's bounds).
//
// Design: the tile of flash_fwd.cu (attn_tile.cuh), against what held the
// first version (f32 FMA out of shared memory, dS through shared memory,
// scalar staging) back:
// - The three products on the tensor cores: S = Q·Kᵀ and dP = dO·Vᵀ with K
//   and V row-major as B operands, then dQ += dS·K with dS as the A
//   operand straight from dP's accumulator fragments (bf16: packed pairs;
//   f32: the contraction relabelled as in the forward's P·V) and K read
//   transposed (ldmatrix.trans in bf16). P and dS never leave registers.
//   f32 runs as 3×TF32; each key tile's dS·K is summed apart and added to
//   dQ in f32.
// - Registers: Q (scaled) stays split into TF32 hi and lo for the walk;
//   dO stays as raw f32 fragments and is split at each use (both split
//   would take 32 more registers). At D = 64 the f32 thread fits in 255
//   registers with no spill at 4 warps a block, the fine-tune and encode
//   shapes' choice; 1 and 2 warps spill 136 and 8 bytes (-Xptxas -v).
//   lse and Δ of the thread's two rows stay in registers.
// - K/V through the forward's 3-stage cp.async ring, with its padded
//   strides and its choice of 4, 2 or 1 warps per block.
// - Tiles the key mask empties are skipped: a warp skips a tile none of
//   whose keys is valid for its rows unless one of its rows has lse ≤
//   −1e29 (a degenerate row, all of whose visible keys are masked, for
//   which P = 1 on masked keys); for every other row P = exp(−1e30 − L)
//   is exactly 0 on those keys, the +1e30 sentinel of invalid rows
//   included, so the skip leaves dQ's bits as they were.
// Each dQ row has one owner, with no atomics and no split of the key walk,
// so two runs give bit-identical results. Causal key tiles wholly above
// the query tile's diagonal are skipped, as the TPU kernel skips them
// (:262-265).
#include "attn_tile.cuh"

namespace dl4j {
namespace {

template <typename T, int D, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const uint8_t* __restrict__ kv_mask, T* __restrict__ dq,
                    int H, int Tq, int Tk, int causal, float scale) {
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
  const size_t qoff = (size_t)bh * Tq * D;

  typename attn::Kept<T, D>::type qa;  // Q·scale in f32; bf16 scales S
  qa.load(q + qoff, r0, Tq, scale);
  attn::Rows<T, D> da;  // dO
  da.load(dout + qoff, r0, Tq, 1.f);
  float L[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < Tq;
    L[h] = in ? lse[(size_t)bh * Tq + rows[h]] : 0.f;
    dl[h] = in ? delta[(size_t)bh * Tq + rows[h]] : 0.f;
  }
  const bool degenerate =
      __any_sync(attn::kFull, L[0] <= -1e29f || L[1] <= -1e29f);
  float acc[ND][4] = {};
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
        if ((bits == 0 || (causal && k0 > r0 + 15)) && !degenerate) return;

        const T* ks = stage(slot);
        const T* vs = ks + BK * C::S;
        float s[NJ][4], dp[NJ][4];
        attn::scores<D>(qa, ks, s);
        if constexpr (!kF32) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] *= scale;
          }
        }
        attn::mask_scores(s, bits, k0, Tk, causal, rows);
        attn::scores<D>(da, vs, dp);
        // P = exp(S − L) (0 for absent keys, whose score is −inf), then
        // dS = P∘(dP − Δ) in place
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            s[j][e] = expf(s[j][e] - L[h]) * (dp[j][e] - dl[h]);
          }
        }
        if constexpr (kF32) {
          float part[ND][4] = {};
          attn::accumulate<D>(s, ks, part);
#pragma unroll
          for (int n = 0; n < ND; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
          }
        } else {
          attn::accumulate<D>(s, ks, acc);
        }
      },
      [&](const Item&) {});

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= Tq) continue;
    T* row = dq + qoff + (size_t)rows[h] * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      attn::store2(row + 8 * n, scale * acc[n][2 * h],
                   scale * acc[n][2 * h + 1]);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const uint8_t* kv_mask, void* dq, int BH, int H, int Tq,
                     int Tk, int causal, float scale, int device,
                     cudaStream_t stream) {
  const int nw = attn::warps_per_block(BH, Tq, device);
  constexpr size_t smem = attn::smem_bytes<T, D>();
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  switch (nw) {
    case 4:
      return attn::launch(flash_bwd_dq_kernel<T, D, 4>, 4, BH, Tq, smem,
                          stream, qt, kt, vt, gt, lse, delta, kv_mask, dqt, H,
                          Tq, Tk, causal, scale);
    case 2:
      return attn::launch(flash_bwd_dq_kernel<T, D, 2>, 2, BH, Tq, smem,
                          stream, qt, kt, vt, gt, lse, delta, kv_mask, dqt, H,
                          Tq, Tk, causal, scale);
    default:
      return attn::launch(flash_bwd_dq_kernel<T, D, 1>, 1, BH, Tq, smem,
                          stream, qt, kt, vt, gt, lse, delta, kv_mask, dqt, H,
                          Tq, Tk, causal, scale);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const uint8_t* kv_mask, void* dq, int BH, int H, int Tq,
                   int Tk, int D, int causal, float scale, int device,
                   cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, dout, lse, delta, kv_mask, dq, BH, H,
                             Tq, Tk, causal, scale, device, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, dout, lse, delta, kv_mask, dq, BH, H,
                             Tq, Tk, causal, scale, device, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, dout, lse, delta, kv_mask, dq, BH, H,
                             Tq, Tk, causal, scale, device, stream);
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
                               D, causal, scale, device, s);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(q, k, v, dout, l, dl, mask, dq, BH, H,
                                       Tq, Tk, D, causal, scale, device, s);
  return cudaErrorInvalidValue;
}
