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
//
// Head dims past 128 (padded by the wrapper to a multiple of 128) run
// `flash_bwd_dq_wide_kernel` on attn_wide.cuh's Hopper tile, the
// forward's design: 64 query rows and G = 256 columns of dQ a block, the
// two consumer warpgroups splitting S = Q·Kᵀ and dP = dO·Vᵀ over D's
// chunks and adding their partials through shared memory, dS = P∘(dP − Δ)
// formed in registers and dQ += dS·K over each warpgroup's own columns.
// The score products run D/G times: 2·D·(2·D/G + 1) flops a pair, 6·D
// wherever D ≤ 256 (10·D at 512), in place of the 128-column-chunk
// design's (4·DC + 2)·D (18·D at 512; flash_bwd_dkv's wide kernel keeps
// it). Q and dO stay in shared memory while they fit beside the ring
// (bf16 D ≤ 512, f32 D = 256); past that each key tile restages their
// chunks from L2. The K slices of the block's output chunks stay in the
// ring until dS·K has read them, so they come last in each tile's order.
// What bounds it: bf16 by bytes at the paths' shapes; f32 (3×TF32) by its
// TF32 operations at D ≥ 256 with full tiles.
// Budget a block: 32 keys a tile, the exchange (S and dP) 32 KB; bf16 Q
// and dO 32 KB a chunk, stages of 8 KB (D = 256: 16 stages, 512: 8;
// restaged past 512: 24 KB, 8); f32 64 KB a chunk, stages of 16 KB (D =
// 256: 4; restaged past 256: 48 KB, 4). Registers as the forward's: 168
// at launch, consumers 232 and producer 40 by setmaxnreg; a consumer holds
// dQ (64 registers), S and dP (16 each) and dS. -Xptxas -v: bf16 no spill,
// f32 348 bytes.
// flash_bwd_dq.cu builds the float32 instantiations and flash_bwd_dq_bf16.cu the
// bfloat16 ones, as two libraries whose nvcc runs in parallel.
#pragma once

#include "attn_wide.cuh"

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

// The wide kernel (D = 128·DC > 128, attn_wide.cuh's note): 64 query rows
// and dQ's output chunks [oc0, oc1) of one (b·h). Per visited key tile the
// ring carries 2·DC slices: K's and V's chunk c (each with Q's or dO's
// chunk c when those are not resident) for every other chunk c, then V's
// output chunks, then K's. The warpgroup of chunk c multiplies both into
// its partial S and dP; it keeps K's output chunks until dS·K has read
// them. Those come last, so the ring (at least cpb + 2 stages) never
// waits on a held stage for a slice of the same tile.
template <typename T>
__global__ void __launch_bounds__(wide::kThreads, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ wide::Maps maps,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const uint8_t* __restrict__ kv_mask,
                         T* __restrict__ dq, int H, int Tq, int Tk, int DC,
                         int causal, float scale, const wide::Plan plan) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int BK = 32, NJ = BK / 8;
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
  if (threadIdx.x == 0) sm.init();
  // a degenerate row (lse ≤ −1e29: every visible key masked, P = 1 on
  // them) makes the block walk every tile
  const int r = q0 + threadIdx.x;
  const bool degenerate = __syncthreads_or(
      threadIdx.x < wide::kRows && r < Tq &&
      lse[(size_t)bh * Tq + r] <= -1e29f);
  wide::Schedule<BK> walk{mrow, Tk, q0, causal, degenerate};
  // a tile's slices: chunk(j) for slice j, and slice_k(c) / slice_v(c)
  const int no = oc1 - oc0;
  auto chunk = [&](int j) {
    if (j >= 2 * (DC - no)) return oc0 + (j - 2 * (DC - no)) % no;
    j /= 2;
    return j < oc0 ? j : j + no;
  };
  auto out = [&](int c) { return c >= oc0 && c < oc1; };
  auto slice_k = [&](int c) {
    return out(c) ? 2 * DC - no + (c - oc0) : 2 * (c < oc0 ? c : c - no);
  };
  auto slice_v = [&](int c) {
    return out(c) ? 2 * (DC - no) + (c - oc0)
                  : 2 * (c < oc0 ? c : c - no) + 1;
  };

  if (warp >= wide::kProducerWarp) {
    wide::producer_regs();
    if (warp != wide::kProducerWarp) return;
    const bool lead = threadIdx.x % 32 == 0;
    if (plan.resident && lead) {
      wide::mbar_expect(sm.qbar, 2 * DC * kQChunk);
      for (int c = 0; c < DC; ++c) {
        wide::load_chunk<T>(sm.qres + c * kQChunk, &maps.q, sm.qbar, c, q0,
                            bh, wide::kRows);
        wide::load_chunk<T>(sm.qres + (DC + c) * kQChunk, &maps.g, sm.qbar,
                            c, q0, bh, wide::kRows);
      }
    }
    const uint32_t bytes = kSlice + (plan.resident ? 0 : kQChunk);
    int n = 0;
    for (int kt = 0; kt < tiles; ++kt) {
      uint64_t bits;
      if (!walk.visit(kt, bits) || !lead) continue;
      for (int j = 0; j < 2 * DC; ++j, ++n) {
        const int c = chunk(j);
        const bool is_k = j < 2 * (DC - no) ? j % 2 == 0 : j >= 2 * DC - no;
        unsigned char* st = sm.acquire(n, bytes);
        wide::load_chunk<T>(st, is_k ? &maps.k : &maps.v, sm.bar(n), c,
                            kt * BK, bh, BK);
        if (!plan.resident)
          wide::load_chunk<T>(st + kSlice, is_k ? &maps.q : &maps.g,
                              sm.bar(n), c, q0, bh, wide::kRows);
      }
    }
    return;
  }

  wide::consumer_regs();
  const int wg = warp / 4, wr = warp % 4 * 16;  // the warp's rows wr..
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  // f32: a warp whose rows are all past Tq skips its products (bf16's
  // products are the warpgroup's)
  const bool live = !kF32 || q0 + wr < Tq;
  float L[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < Tq;
    L[h] = in ? lse[(size_t)bh * Tq + rows[h]] : 0.f;
    dl[h] = in ? delta[(size_t)bh * Tq + rows[h]] : 0.f;
  }
  float acc[CPW][16][4] = {};
  if (plan.resident) wide::mbar_wait(sm.qbar, 0);
  int n = 0;
  for (int kt = 0; kt < tiles; ++kt) {
    uint64_t bits;
    if (!walk.visit(kt, bits)) continue;
    const int k0 = kt * BK;
    // this warpgroup's share of S = Q·Kᵀ and dP = dO·Vᵀ: chunks wg, wg + 2,
    // …, taken in the ring's order (each warpgroup waits on its slices in
    // order, so the ring cannot stall on a slice not yet consumed): the
    // other chunks' K and V, then the output chunks' V, then their K. bf16
    // runs one product group a slice, the next issued before the last is
    // waited on.
    float s[NJ][4] = {}, dp[NJ][4] = {};
    bool s_first = true, dp_first = true;
    int prev = -1;      // bf16: the slice the group in flight reads
    bool drop = false;  // and whether it is released after it
    auto part = [&](float (&x)[NJ][4], bool& first, int i, int c, bool is_k) {
      sm.wait(i);
      const T* xs = reinterpret_cast<const T*>(sm.stage(i));
      const T* a = reinterpret_cast<const T*>(
          plan.resident ? sm.qres + (is_k ? c : DC + c) * kQChunk
                        : sm.stage(i) + kSlice);
      const bool release = !(is_k && out(c));  // else dS·K reads it
      if constexpr (kF32) {
        if (live) wide::scores_f32<BK>(a, is_k ? scale : 1.f, xs, x, first, wr);
        if (release) sm.release(i);
      } else {
        wide::wg_fence();
        wide::scores_bf16<BK>(a, xs, x, !first);
        wide::wg_commit();
        if (prev >= 0) {
          wide::wg_wait<1>();
          if (drop) sm.release(prev);
        }
        prev = i;
        drop = release;
      }
      first = false;
    };
    if constexpr (!kF32) {
      wide::keep(s);
      wide::keep(dp);
      wide::wg_fence();
    }
    for (int c = wg; c < DC; c += wide::kGroups) {
      if (out(c)) continue;
      part(s, s_first, n + slice_k(c), c, true);
      part(dp, dp_first, n + slice_v(c), c, false);
    }
    for (int c = oc0 + wg; c < oc1; c += wide::kGroups)
      part(dp, dp_first, n + slice_v(c), c, false);
    for (int c = oc0 + wg; c < oc1; c += wide::kGroups)
      part(s, s_first, n + slice_k(c), c, true);
    if constexpr (!kF32) {
      wide::wg_wait();
      wide::keep(s);
      wide::keep(dp);
      if (drop) sm.release(prev);
    }
    wide::exchange(s, sm.xbuf, dp);
    if constexpr (!kF32) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    }
    attn::mask_scores(s, bits, k0, Tk, causal, rows);
    // P = exp(S − L) (0 for absent keys, whose score is −inf), then
    // dS = P∘(dP − Δ) in place
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = expf(s[j][e] - L[e >> 1]) * (dp[j][e] - dl[e >> 1]);

    // dQ += dS·K over this warpgroup's output chunks (their K slices held)
    uint32_t pa[kF32 ? 1 : BK / 16][4];
    if constexpr (!kF32) wide::pack_p<BK>(s, pa);
#pragma unroll
    for (int slot = 0; slot < CPW; ++slot) {
      const int oc = oc0 + wg + wide::kGroups * slot;
      if (oc >= oc1) continue;
      const int i = n + slice_k(oc);
      const T* ks = reinterpret_cast<const T*>(sm.stage(i));
      if constexpr (kF32) {
        if (live) wide::accumulate_f32<BK>(s, ks, acc[slot]);
      } else {
        wide::accumulate_bf16<BK>(pa, ks, acc[slot]);
      }
      sm.release(i);
    }
    n += 2 * DC;
  }

  const int D = DC * wide::kChunk;  // the row stride
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= Tq) continue;
#pragma unroll
    for (int slot = 0; slot < CPW; ++slot) {
      const int oc = oc0 + wg + wide::kGroups * slot;
      if (oc >= oc1) continue;
      T* row = dq + ((size_t)bh * Tq + rows[h]) * D + oc * wide::kChunk + 2 * t;
#pragma unroll
      for (int nn = 0; nn < 16; ++nn)
        attn::store2(row + 8 * nn, scale * acc[slot][nn][2 * h],
                     scale * acc[slot][nn][2 * h + 1]);
    }
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
      return attn::launch(flash_bwd_dq_kernel<T, D, 4>, 4, BH, Tq, 1, smem,
                          stream, qt, kt, vt, gt, lse, delta, kv_mask, dqt, H,
                          Tq, Tk, causal, scale);
    case 2:
      return attn::launch(flash_bwd_dq_kernel<T, D, 2>, 2, BH, Tq, 1, smem,
                          stream, qt, kt, vt, gt, lse, delta, kv_mask, dqt, H,
                          Tq, Tk, causal, scale);
    default:
      return attn::launch(flash_bwd_dq_kernel<T, D, 1>, 1, BH, Tq, 1, smem,
                          stream, qt, kt, vt, gt, lse, delta, kv_mask, dqt, H,
                          Tq, Tk, causal, scale);
  }
}

// D = 128·DC: the plan of attn_wide.cuh (32 keys a tile, wide::kCpb
// output chunks a block) and the operands' tensor maps.
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, const uint8_t* kv_mask, void* dq,
                        int BH, int H, int Tq, int Tk, int D, int causal,
                        float scale, cudaStream_t stream) {
  constexpr int esz = sizeof(T);
  const int DC = D / wide::kChunk;
  const wide::Plan p = wide::plan(esz, 32, wide::kCpb, 2, true, DC);
  wide::Maps maps;
  if (!wide::encode(&maps.q, q, esz, D, Tq, BH, wide::kRows) ||
      !wide::encode(&maps.k, k, esz, D, Tk, BH, 32) ||
      !wide::encode(&maps.v, v, esz, D, Tk, BH, 32) ||
      !wide::encode(&maps.g, dout, esz, D, Tq, BH, wide::kRows))
    return cudaErrorInvalidValue;
  return wide::launch(flash_bwd_dq_wide_kernel<T>, p, BH, Tq, stream, maps,
                      lse, delta, kv_mask, static_cast<T*>(dq), H, Tq, Tk,
                      DC, causal, scale, p);
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
    case 128:
      return launch_d<T, 128>(q, k, v, dout, lse, delta, kv_mask, dq, BH, H,
                             Tq, Tk, causal, scale, device, stream);
    default:
      if (D <= wide::kChunk || D % wide::kChunk != 0)
        return cudaErrorInvalidValue;
      return launch_wide<T>(q, k, v, dout, lse, delta, kv_mask, dq, BH, H, Tq,
                            Tk, D, causal, scale, stream);
  }
}

}  // namespace
}  // namespace dl4j
