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
// of 128, runs `flash_fwd_wide_kernel` on attn_wide.cuh's Hopper tile: a
// block of 64 query rows and G = 256 output columns (a wider D splits its
// columns over grid z), two consumer warpgroups and a producer
// warpgroup. The warpgroups split S = Q·Kᵀ over D's 128-column chunks
// and add their partials through shared memory, so the scores run D/G
// times: 2·D·(D/G + 1) flops a pair, 4·D wherever D ≤ 256 (6·D at 512,
// 10·D at 1024), in place of the 128-column-chunk design's 2·D·(DC + 1)
// (DC = D/128: 10·D at 512, 18·D at 1024). Q comes from device memory
// once a block and stays in shared memory while it fits beside the ring
// (bf16 D ≤ 1152, f32 D ≤ 640); past that each key tile restages its
// chunks from L2. K and V arrive by TMA through the ring.
// What bounds it: bf16 (wgmma, 989 TFLOP/s) by bytes at the one-head
// layers' shapes (32×1×512² at D = 256, 16×1×512² at D = 512); f32 (3×TF32
// on mma.sync, three TF32 products per f32 product at 495 TFLOP/s) by
// those operations there; both by bytes at the learned queries' Tq = 4
// (chip_smoke.py's bounds, which count 4·D a pair).
// Budget a block (227 KB of shared memory, 65,536 registers): bf16 64
// keys a tile, the exchange 32 KB, Q 16 KB a chunk, ring stages of 16 KB
// (D = 256: 10 stages, 512: 8, 1024: 4); f32 32 keys a tile, the exchange
// 16 KB, Q 32 KB a chunk, stages of 16 KB (D = 256: 9, 512: 5). Registers:
// 168 a thread at launch, setmaxnreg then gives the consumers 232 and the
// producer 40; a consumer holds O (64 registers for its 128 columns), S
// (bf16 32, f32 16) and P. -Xptxas -v (chip_smoke.py's build phase logs
// it): bf16 no spill, f32 8 bytes.
// flash_fwd.cu builds the float32 instantiations and flash_fwd_bf16.cu the
// bfloat16 ones, as two libraries whose nvcc runs in parallel.
#pragma once

#include "attn_wide.cuh"

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

// The wide kernel (D = 128·DC > 128, attn_wide.cuh's note): 64 query rows
// and output chunks [oc0, oc1) of one (b·h). Per visited key tile the ring
// carries K's DC chunks (slices 0 … DC − 1, each with Q's chunk when Q is
// not resident), then V's output chunks.
template <typename T>
__global__ void __launch_bounds__(wide::kThreads, 1)
flash_fwd_wide_kernel(const __grid_constant__ wide::Maps maps,
                      const uint8_t* __restrict__ kv_mask, T* __restrict__ o,
                      float* __restrict__ lse, int H, int Tq, int Tk, int DC,
                      int causal, float scale, const wide::Plan plan) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int BK = kF32 ? 32 : 64, NJ = BK / 8;
  constexpr int CPW = wide::kCpw;  // output chunks a warpgroup
  constexpr int kSlice = BK * wide::kChunk * (int)sizeof(T);
  constexpr int kQChunk = wide::kRows * wide::kChunk * (int)sizeof(T);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  wide::Smem sm(smem_raw, plan);

  const int bh = blockIdx.y, q0 = blockIdx.x * wide::kRows;
  const int oc0 = blockIdx.z * plan.cpb, oc1 = min(DC, oc0 + plan.cpb);
  const int warp = threadIdx.x / 32;
  const uint8_t* mrow =
      kv_mask == nullptr ? nullptr : kv_mask + (size_t)(bh / H) * Tk;
  const int k_end = causal ? min(Tk, q0 + wide::kRows) : Tk;
  const int tiles = (k_end + BK - 1) / BK;
  wide::Schedule<BK> walk{mrow, Tk, q0, causal, false};
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  if (warp >= wide::kProducerWarp) {
    wide::producer_regs();
    if (warp != wide::kProducerWarp) return;
    const bool lead = threadIdx.x % 32 == 0;
    if (plan.resident && lead) {
      wide::mbar_expect(sm.qbar, DC * kQChunk);
      for (int c = 0; c < DC; ++c)
        wide::load_chunk<T>(sm.qres + c * kQChunk, &maps.q, sm.qbar, c, q0,
                            bh, wide::kRows);
    }
    int n = 0;
    for (int kt = 0; kt < tiles; ++kt) {
      uint64_t bits;
      if (!walk.visit(kt, bits)) continue;
      if (lead) {
        for (int c = 0; c < DC; ++c, ++n) {
          unsigned char* st =
              sm.acquire(n, kSlice + (plan.resident ? 0 : kQChunk));
          wide::load_chunk<T>(st, &maps.k, sm.bar(n), c, kt * BK, bh, BK);
          if (!plan.resident)
            wide::load_chunk<T>(st + kSlice, &maps.q, sm.bar(n), c, q0, bh,
                                wide::kRows);
        }
        for (int oc = oc0; oc < oc1; ++oc, ++n)
          wide::load_chunk<T>(sm.acquire(n, kSlice), &maps.v, sm.bar(n), oc,
                              kt * BK, bh, BK);
      }
    }
    return;
  }

  wide::consumer_regs();
  const bool tr = threadIdx.x % 128 == 0;  // WIDE_TRACE's thread a group
  if (tr) WIDE_TRACE(1024 * (threadIdx.x / 128) + 1020);
  const int wg = warp / 4, wr = warp % 4 * 16;  // the warp's rows wr..
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  // f32: a warp whose rows are all past Tq skips its products (bf16's
  // products are the warpgroup's)
  const bool live = !kF32 || q0 + wr < Tq;
  float acc[CPW][16][4] = {};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's columns only; summed at the end
  if (plan.resident) wide::mbar_wait(sm.qbar, 0);
  if (tr) WIDE_TRACE(1024 * wg + 1021);
  int n = 0;
  for (int kt = 0; kt < tiles; ++kt) {
    uint64_t bits;
    if (!walk.visit(kt, bits)) continue;
    const int k0 = kt * BK;
    if (tr) WIDE_TRACE(1024 * wg + 8 * kt);
    // this warpgroup's share of S = Q·Kᵀ: chunks wg, wg + 2, … (bf16: one
    // product group a chunk, the next issued before the last is waited on)
    float s[NJ][4] = {};
    if constexpr (!kF32) {
      wide::keep(s);
      wide::wg_fence();
    }
    int prev = -1;  // bf16: the slice the group in flight reads
    for (int c = wg; c < DC; c += wide::kGroups) {
      const int i = n + c;
      sm.wait(i);
      if (tr && c == wg) WIDE_TRACE(1024 * wg + 8 * kt + 1);
      const T* ks = reinterpret_cast<const T*>(sm.stage(i));
      const T* qc = reinterpret_cast<const T*>(
          plan.resident ? sm.qres + c * kQChunk : sm.stage(i) + kSlice);
      if constexpr (kF32) {
        if (live) wide::scores_f32<BK>(qc, scale, ks, s, c == wg, wr);
        sm.release(i);
      } else {
        wide::wg_fence();
        wide::scores_bf16<BK>(qc, ks, s, c != wg);
        wide::wg_commit();
        if (prev >= 0) {
          wide::wg_wait<1>();
          sm.release(prev);
        }
        prev = i;
      }
    }
    if constexpr (!kF32) {
      wide::wg_wait();
      wide::keep(s);
      sm.release(prev);
    }
    n += DC;
    if (tr) WIDE_TRACE(1024 * wg + 8 * kt + 2);
    wide::exchange(s, sm.xbuf);
    if (tr) WIDE_TRACE(1024 * wg + 8 * kt + 3);
    if constexpr (!kF32) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
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

    if (tr) WIDE_TRACE(1024 * wg + 8 * kt + 4);
    // O += P·V over this warpgroup's output chunks
    uint32_t pa[kF32 ? 1 : BK / 16][4];
    if constexpr (!kF32) wide::pack_p<BK>(s, pa);
#pragma unroll
    for (int slot = 0; slot < CPW; ++slot) {
      const int oc = oc0 + wg + wide::kGroups * slot;
      if (oc >= oc1) continue;
      const int i = n + oc - oc0;
      sm.wait(i);
      if (tr && slot == 0) WIDE_TRACE(1024 * wg + 8 * kt + 5);
      const T* vs = reinterpret_cast<const T*>(sm.stage(i));
#pragma unroll
      for (int nn = 0; nn < 16; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[slot][nn][e] *= alpha[e >> 1];
      if constexpr (kF32) {
        if (live) wide::accumulate_f32<BK>(s, vs, acc[slot]);
      } else {
        wide::accumulate_bf16<BK>(pa, vs, acc[slot]);
      }
      sm.release(i);
    }
    n += oc1 - oc0;
    if (tr) WIDE_TRACE(1024 * wg + 8 * kt + 6);
  }

  if (tr) WIDE_TRACE(1024 * wg + 1022);
  const int D = DC * wide::kChunk;  // the row stride
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lc = fmaxf(attn::quad_sum(l[h]), 1e-30f);
    if (rows[h] >= Tq) continue;
#pragma unroll
    for (int slot = 0; slot < CPW; ++slot) {
      const int oc = oc0 + wg + wide::kGroups * slot;
      if (oc >= oc1) continue;
      T* orow = o + ((size_t)bh * Tq + rows[h]) * D + oc * wide::kChunk + 2 * t;
#pragma unroll
      for (int nn = 0; nn < 16; ++nn)
        attn::store2(orow + 8 * nn, acc[slot][nn][2 * h] / lc,
                     acc[slot][nn][2 * h + 1] / lc);
    }
    if (t == 0 && wg == 0 && blockIdx.z == 0)
      lse[(size_t)bh * Tq + rows[h]] = m[h] + logf(lc);
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

// D = 128·DC: the plan of attn_wide.cuh (bf16: 64 keys a tile; f32: 32;
// wide::kCpb output chunks a block) and the operands' tensor maps.
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const uint8_t* kv_mask, void* o, float* lse, int BH,
                        int H, int Tq, int Tk, int D, int causal, float scale,
                        cudaStream_t stream) {
  constexpr int esz = sizeof(T);
  constexpr int BK = esz == 4 ? 32 : 64;
  const int DC = D / wide::kChunk;
  const wide::Plan p = wide::plan(esz, BK, wide::kCpb, 1, false, DC);
  wide::Maps maps;
  if (!wide::encode(&maps.q, q, esz, D, Tq, BH, wide::kRows) ||
      !wide::encode(&maps.k, k, esz, D, Tk, BH, BK) ||
      !wide::encode(&maps.v, v, esz, D, Tk, BH, BK))
    return cudaErrorInvalidValue;
  maps.g = maps.q;
  return wide::launch(flash_fwd_wide_kernel<T>, p, BH, Tq, stream, maps,
                      kv_mask, static_cast<T*>(o), lse, H, Tq, Tk, DC,
                      causal, scale, p);
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
      if (D <= wide::kChunk || D % wide::kChunk != 0)
        return cudaErrorInvalidValue;
      return launch_wide<T>(q, k, v, kv_mask, o, lse, BH, H, Tq, Tk, D,
                            causal, scale, stream);
  }
}

}  // namespace
}  // namespace dl4j
