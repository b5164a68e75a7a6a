// Both conv gradients of a conv1x1+BN pair on Hopper's tensor cores, with
// BN's input gradient formed in registers:
//   dy = k1·dz − (y − μ)·k2 − c     (per column; rounded to x's type)
//   dX = dy · wᵀ   (M, K) in x's type
//   dW = xᵀ · dy   (K, N) f32
// x (M, K), y and dz (M, N), w (K, N) row-major in f32 or bf16 (any relu
// mask already folded into dz); k1, k2, c, μ (N,) f32.
//
// Replaces: deeplearning4j_tpu/kernels/pointwise_conv.py::_bwd_gemm_kernel
// (:262, pallas_call at :338 in bn_conv_grads), the second half of
// fused_conv1x1_bn's backward. dy never goes to device memory: that is the
// kernel's reason to exist.
//
// What bounds it on the H100: 4·M·K·N flops against (2·M·K + 2·M·N + K·N)
// values. f32 runs as 3×TF32 (mma_tile.cuh), three tensor-core products per
// f32 product: 12·M·K·N at 495 TFLOP/s. bf16 runs 4·M·K·N at 989 TFLOP/s.
// At ResNet-50's B=32 shapes f32 is bound by those operations where K and
// N are both ≥ 256 (res5 _c 1,568 × 512 × 2,048: 0.040 ms against 0.015
// ms of bytes) and by bytes where K or N is 64 (res2 _c 100,352 × 64 ×
// 256: 0.077 ms of bytes against 0.040 ms); bf16 is bound by bytes at
// every shape of the step.
//
// Design, against what held the SIMT version (two launches of 128 × 64
// tiles, f32 FMA, a third launch for the dW sum) back:
// - Tensor cores in both dtypes: mma.sync bf16, and 3×TF32 for f32 (one
//   TF32 pass would miss f32's accuracy), through mma_tile.cuh's engine:
//   256 threads, each warp a (16·MI) × (8·NI) tile, fragments read as
//   64-bit words from padded shared memory without bank conflicts. Each
//   slice's products are summed apart and added to the accumulator in f32,
//   so long contractions keep f32's accuracy.
// - A ring of 3 stages of raw operand tiles (x, w, y, dz and the four BN
//   vectors), filled by cp.async while an earlier slice is multiplied.
//   Ragged tails are zero-filled by the copy; rows whose byte length is
//   not a multiple of 16 (N = 9 or 130; K = 12 in bf16) are copied
//   element by element.
// - dy formed in registers as each fragment is built, from the raw y and
//   dz in shared memory, rounded to T before the product (and before the
//   TF32 split) as bn_train.cuh's bn_dy rounds it:
//   - dX role: dy is operand A; k1, k2, c, μ follow the contraction
//     column n and are staged with each slice. Two warps across a
//     128-column tile each form their rows' dy, so dy is still formed once
//     per 64 columns of K, as in the SIMT version (8 times at res5 _c); a
//     wider warp tile would form it less often but needs more registers
//     than 3×TF32 leaves.
//   - dW role: dy is operand B; its column n is the output column, so the
//     thread keeps its columns' k1, k2, c, μ in registers for the item.
// - One launch for both roles, one wave of persistent blocks (one per SM:
//   the f32 ring takes 186 KB): blocks [0, w_workers) walk dW items, the
//   rest dX items, each block its items one after another through one
//   ring, so the next item's loads overlap this one's last products and
//   its stores. The dW blocks share the card with the dX blocks (res5's
//   dX alone made 104 blocks for 132 SMs). Tiles are chosen from (K, N):
//   a dW tile is 64 rows where K ≤ 64 and 64 columns where N ≤ 64, a dX
//   tile 64 columns where K ≤ 64, so no half-tile of zeros is staged.
//   Both roles cut their contraction (dX: N, dW: M) into items of at most
//   one length L; L and the split of blocks between the roles come from a
//   model of the walk and of the partials' traffic (make_plan): dX splits
//   N only where its own tiles are too few to fill the card.
// - A second launch adds the dW partials and, where dX was split, the dX
//   partials in a fixed order, and casts dX to T: two launches per call,
//   no float atomics, the same bits on every run.
#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "bn_train.cuh"
#include "mma_tile.cuh"

namespace dl4j {
namespace {

using mma::kBK;
using mma::kStages;
using mma::kThreads;

constexpr int kMinLength = 128;  // shortest contraction of an item

// Tile shapes and the shared-memory layout of one ring stage, for operand
// type T, a dX tile of 128 × XBN (M × K) and a dW tile of WBM × WBN (K × N).
// Row strides are padded so that the fragment reads below meet no bank
// conflicts: dX rows by 32 bytes (f32 40 words, bf16 24 words: 8·g mod 32
// apart), dW rows by 8 elements.
template <typename T, int XBN, int WBM, int WBN>
struct Cfg {
  static constexpr int XBM = 128;
  static constexpr int SX = kBK + 32 / (int)sizeof(T);  // dX y, dz, w rows
  static constexpr int SXW = WBM + 8;                   // dW x rows
  static constexpr int SN = WBN + 8;                    // dW y, dz rows
  static constexpr int kDx =
      (2 * XBM + XBN) * SX * (int)sizeof(T) + 4 * kBK * (int)sizeof(float);
  static constexpr int kDw = kBK * (SXW + 2 * SN) * (int)sizeof(T);
  static constexpr int kStage = kDx > kDw ? kDx : kDw;
  static constexpr int kSmem = kStages * kStage;
  // dX: A = dy costs more to form than B = w, so 2 warps across (each dy
  // row formed by 2 warps, not 4); dW: B = dy, so 4 across where 128 wide
  using GX = mma::Geom<XBM, XBN, 2>;
  using GW = mma::Geom<WBM, WBN, WBN / 32>;
};

template <typename T>
struct Args {
  const T* x;
  const T* y;
  const T* dz;
  const T* w;
  const float* k1;
  const float* k2;
  const float* c;
  const float* mu;
  T* dx;
  float* part_w;   // (w_splits, K, N)
  float* part_x;   // (x_parts, M, K) where x_parts > 1
  int M, K, N;
  int w_tiles_n, w_tiles, w_items, w_rows, w_workers;
  int x_tiles_k, x_tiles, x_items, x_len, x_parts, x_workers;
  int vec_k, vec_n;  // rows of K (x) / of N (y, dz, w) take 16-byte copies
};

// Two adjacent outputs (o, o + 1) of a row of length `len` at column `col`,
// as one store where both exist and o is even (then 8-byte aligned for
// f32, 4-byte for bf16).
template <typename T>
__device__ __forceinline__ void store2(T* p, size_t o, int col, int len,
                                       float v0, float v1) {
  if (col + 1 < len && o % 2 == 0) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(p + o) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p + o) =
          __floats2bfloat162_rn(v0, v1);
    }
  } else {
    p[o] = from_f32<T>(v0);
    if (col + 1 < len) p[o + 1] = from_f32<T>(v1);
  }
}

template <typename V, typename T>
__device__ __forceinline__ V ld(const T* p) {
  return *reinterpret_cast<const V*>(p);
}

// dX role: A = dy (rows m, contraction n), B = wᵀ (contraction n, cols k).
// The contraction is read in pairs: f32 fragment slots t and t + 4 hold
// slice columns 2t and 2t + 1 (bf16: slots 2t, 2t+1, 2t+8, 2t+9 hold
// 4t … 4t + 3), in A and B alike, so each thread reads 64-bit words.
template <typename T, class C, int MI, int NI>
struct DxOps {
  const T* y;
  const T* dz;
  const T* w;
  const float* v;  // k1, k2, c, μ of the slice's columns, kBK each

  __device__ __forceinline__ void frags(int kk, int rb, int cb,
                                        float (&a)[MI][4],
                                        float (&b)[NI][2]) const {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int s = kk + 2 * t;
    const float2 k1 = ld<float2>(v + s), k2 = ld<float2>(v + kBK + s);
    const float2 c = ld<float2>(v + 2 * kBK + s);
    const float2 mu = ld<float2>(v + 3 * kBK + s);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = (rb + mi * 16 + g + 8 * h) * C::SX + s;
        const float2 yv = ld<float2>(y + o), dv = ld<float2>(dz + o);
        a[mi][h] = bn::bn_dy(yv.x, dv.x, mu.x, k1.x, k2.x, c.x);
        a[mi][2 + h] = bn::bn_dy(yv.y, dv.y, mu.y, k1.y, k2.y, c.y);
      }
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const float2 wv = ld<float2>(w + (cb + ni * 8 + g) * C::SX + s);
      b[ni][0] = wv.x;
      b[ni][1] = wv.y;
    }
  }

  __device__ __forceinline__ void frags(int kk, int rb, int cb,
                                        uint32_t (&a)[MI][4],
                                        uint32_t (&b)[NI][2]) const {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int s = kk + 4 * t;
    const float4 k1 = ld<float4>(v + s), k2 = ld<float4>(v + kBK + s);
    const float4 c = ld<float4>(v + 2 * kBK + s);
    const float4 mu = ld<float4>(v + 3 * kBK + s);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = (rb + mi * 16 + g + 8 * h) * C::SX + s;
        const uint2 yw = ld<uint2>(y + o), dw = ld<uint2>(dz + o);
        const __nv_bfloat162* yv = reinterpret_cast<const __nv_bfloat162*>(&yw);
        const __nv_bfloat162* dv = reinterpret_cast<const __nv_bfloat162*>(&dw);
        a[mi][h] = mma::pack_bf16(
            bn::bn_dy(yv[0].x, dv[0].x, mu.x, k1.x, k2.x, c.x),
            bn::bn_dy(yv[0].y, dv[0].y, mu.y, k1.y, k2.y, c.y));
        a[mi][2 + h] = mma::pack_bf16(
            bn::bn_dy(yv[1].x, dv[1].x, mu.z, k1.z, k2.z, c.z),
            bn::bn_dy(yv[1].y, dv[1].y, mu.w, k1.w, k2.w, c.w));
      }
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const uint2 wv = ld<uint2>(w + (cb + ni * 8 + g) * C::SX + s);
      b[ni][0] = wv.x;
      b[ni][1] = wv.y;
    }
  }
};

// dW role: A = xᵀ (rows k, contraction m), B = dy (contraction m, cols n).
// The output is read in pairs: fragment rows g and g + 8 are tile rows
// 2g and 2g + 1 of the warp's 16, and column fragments 2j and 2j + 1 at
// column g are tile columns 16j + 2g and 16j + 2g + 1, so x, y and dz are
// read as 64-bit (f32) or 32-bit (bf16) words; the epilogue maps back.
template <typename T, class C, int MI, int NI>
struct DwOps {
  const T* x;
  const T* y;
  const T* dz;
  float v[NI][4];  // k1, k2, c, μ of the thread's columns

  __device__ __forceinline__ float dy(T yv, T dv, int ni) const {
    return bn::bn_dy(yv, dv, v[ni][3], v[ni][0], v[ni][1], v[ni][2]);
  }

  __device__ __forceinline__ void frags(int kk, int rb, int cb,
                                        float (&a)[MI][4],
                                        float (&b)[NI][2]) const {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int p = rb + mi * 16 + 2 * g;
      const float2 x0 = ld<float2>(x + (kk + t) * C::SXW + p);
      const float2 x1 = ld<float2>(x + (kk + t + 4) * C::SXW + p);
      a[mi][0] = x0.x;
      a[mi][1] = x0.y;
      a[mi][2] = x1.x;
      a[mi][3] = x1.y;
    }
#pragma unroll
    for (int j = 0; j < NI / 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = (kk + t + 4 * h) * C::SN + cb + 16 * j + 2 * g;
        const float2 yv = ld<float2>(y + o), dv = ld<float2>(dz + o);
        b[2 * j][h] = dy(yv.x, dv.x, 2 * j);
        b[2 * j + 1][h] = dy(yv.y, dv.y, 2 * j + 1);
      }
    }
  }

  __device__ __forceinline__ void frags(int kk, int rb, int cb,
                                        uint32_t (&a)[MI][4],
                                        uint32_t (&b)[NI][2]) const {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int p = rb + mi * 16 + 2 * g;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int m = kk + 2 * t + 8 * q;
        const uint32_t r0 = ld<uint32_t>(x + m * C::SXW + p);
        const uint32_t r1 = ld<uint32_t>(x + (m + 1) * C::SXW + p);
        a[mi][2 * q] = __byte_perm(r0, r1, 0x5410);      // row g
        a[mi][2 * q + 1] = __byte_perm(r0, r1, 0x7632);  // row g + 8
      }
    }
#pragma unroll
    for (int j = 0; j < NI / 2; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int o = (kk + 2 * t + 8 * q) * C::SN + cb + 16 * j + 2 * g;
        const __nv_bfloat162 y0 = ld<__nv_bfloat162>(y + o);
        const __nv_bfloat162 y1 = ld<__nv_bfloat162>(y + o + C::SN);
        const __nv_bfloat162 d0 = ld<__nv_bfloat162>(dz + o);
        const __nv_bfloat162 d1 = ld<__nv_bfloat162>(dz + o + C::SN);
        b[2 * j][q] = mma::pack_bf16(dy(y0.x, d0.x, 2 * j),
                                     dy(y1.x, d1.x, 2 * j));
        b[2 * j + 1][q] = mma::pack_bf16(dy(y0.y, d0.y, 2 * j + 1),
                                         dy(y1.y, d1.y, 2 * j + 1));
      }
    }
  }
};

// dX worker `wk`: items wk, wk + x_workers, … of the x_items (tile, part)
// pairs, each a 128 × XBN tile of dX (or of part `part`'s f32 partial) over
// one part of N.
template <typename T, int XBN, int WBM, int WBN>
__device__ __forceinline__ void dx_role(const Args<T>& a, int wk,
                                        unsigned char* smem) {
  using C = Cfg<T, XBN, WBM, WBN>;
  using G = typename C::GX;
  struct Item {
    int part, m0, k0, n_beg, n_end, slices;
  };
  auto item = [&](int j) {
    const int q = wk + j * a.x_workers;
    const int tile = q % a.x_tiles;
    Item it;
    it.part = q / a.x_tiles;
    it.m0 = (tile / a.x_tiles_k) * C::XBM;
    it.k0 = (tile % a.x_tiles_k) * XBN;
    it.n_beg = it.part * a.x_len;
    it.n_end = min(a.N, it.n_beg + a.x_len);
    it.slices = (it.n_end - it.n_beg + kBK - 1) / kBK;
    return it;
  };
  auto ys = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * C::kStage);
  };
  auto vs = [&](int slot) {
    return reinterpret_cast<float*>(ys(slot) + (2 * C::XBM + XBN) * C::SX);
  };
  auto stage_in = [&](int slot, const Item& it, int i) {
    const int n0 = it.n_beg + i * kBK;
    T* y = ys(slot);
    T* dz = y + C::XBM * C::SX;
    T* w = dz + C::XBM * C::SX;
    mma::load_tile<T, C::XBM, kBK>(y, C::SX, a.y, a.N, it.m0, a.M, n0,
                                   it.n_end, a.vec_n);
    mma::load_tile<T, C::XBM, kBK>(dz, C::SX, a.dz, a.N, it.m0, a.M, n0,
                                   it.n_end, a.vec_n);
    mma::load_tile<T, XBN, kBK>(w, C::SX, a.w, a.N, it.k0, a.K, n0, it.n_end,
                                a.vec_n);
    const int t = threadIdx.x;
    if (t < 4 * kBK) {
      const float* src = t < kBK       ? a.k1
                         : t < 2 * kBK ? a.k2
                         : t < 3 * kBK ? a.c
                                       : a.mu;
      const int n = n0 + t % kBK;
      mma::cp4(vs(slot) + t, n < it.n_end ? src + n : src, n < it.n_end);
    }
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t2 = (lane % 4) * 2;
  const int rb = (warp / G::WC) * G::MI * 16;
  const int cb = (warp % G::WC) * G::NI * 8;
  float acc[G::MI][G::NI][4] = {};
  auto product = [&](int slot, const Item&, int) {
    const T* y = ys(slot);
    const DxOps<T, C, G::MI, G::NI> op{y, y + C::XBM * C::SX,
                                       y + 2 * C::XBM * C::SX, vs(slot)};
    mma::Slice<T>::template run<G::MI, G::NI>(op, rb, cb, acc);
  };
  auto finish = [&](const Item& it) {
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = it.m0 + rb + mi * 16 + g + 8 * h;
          const int col = it.k0 + cb + ni * 8 + t2;
          const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
          if (row < a.M && col < a.K) {
            const size_t o = (size_t)row * a.K + col;
            if (a.x_parts == 1)
              store2(a.dx, o, col, a.K, v0, v1);
            else
              store2(a.part_x + (size_t)it.part * a.M * a.K, o, col, a.K, v0,
                     v1);
          }
          acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.f;
        }
      }
    }
  };
  const int n = (a.x_items - wk + a.x_workers - 1) / a.x_workers;
  mma::walk(n, item, stage_in, product, finish);
}

// dW worker `wk`: items wk, wk + w_workers, … of the w_items (tile, split)
// pairs, each a WBM × WBN tile of split `split`'s f32 partial of dW over
// its rows of M.
template <typename T, int XBN, int WBM, int WBN>
__device__ __forceinline__ void dw_role(const Args<T>& a, int wk,
                                        unsigned char* smem) {
  using C = Cfg<T, XBN, WBM, WBN>;
  using G = typename C::GW;
  struct Item {
    int split, k0, n0, r0, r1, slices;
  };
  auto item = [&](int j) {
    const int q = wk + j * a.w_workers;
    const int tile = q % a.w_tiles;
    Item it;
    it.split = q / a.w_tiles;
    it.k0 = (tile / a.w_tiles_n) * WBM;
    it.n0 = (tile % a.w_tiles_n) * WBN;
    it.r0 = it.split * a.w_rows;
    it.r1 = min(a.M, it.r0 + a.w_rows);
    it.slices = (it.r1 - it.r0 + kBK - 1) / kBK;
    return it;
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rb = (warp / G::WC) * G::MI * 16;
  const int cb = (warp % G::WC) * G::NI * 8;
  // tile column of the thread's fragment ni at fragment column l (DwOps)
  auto col = [&](int ni, int l) { return cb + 16 * (ni / 2) + 2 * l + ni % 2; };
  auto xs = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * C::kStage);
  };
  auto stage_in = [&](int slot, const Item& it, int i) {
    const int m = it.r0 + i * kBK;
    T* x = xs(slot);
    T* y = x + kBK * C::SXW;
    T* dz = y + kBK * C::SN;
    mma::load_tile<T, kBK, WBM>(x, C::SXW, a.x, a.K, m, it.r1, it.k0, a.K,
                                a.vec_k);
    mma::load_tile<T, kBK, WBN>(y, C::SN, a.y, a.N, m, it.r1, it.n0, a.N,
                                a.vec_n);
    mma::load_tile<T, kBK, WBN>(dz, C::SN, a.dz, a.N, m, it.r1, it.n0, a.N,
                                a.vec_n);
  };
  DwOps<T, C, G::MI, G::NI> op{};
  float acc[G::MI][G::NI][4] = {};
  auto product = [&](int slot, const Item& it, int i) {
    if (i == 0) {  // the item's columns: their BN vectors into registers
      const int n0 = it.n0;
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        const int n = n0 + col(ni, g);
        const bool in = n < a.N;
        op.v[ni][0] = in ? a.k1[n] : 0.f;
        op.v[ni][1] = in ? a.k2[n] : 0.f;
        op.v[ni][2] = in ? a.c[n] : 0.f;
        op.v[ni][3] = in ? a.mu[n] : 0.f;
      }
    }
    op.x = xs(slot);
    op.y = op.x + kBK * C::SXW;
    op.dz = op.y + kBK * C::SN;
    mma::Slice<T>::template run<G::MI, G::NI>(op, rb, cb, acc);
  };
  auto finish = [&](const Item& it) {
    float* p = a.part_w + (size_t)it.split * a.K * a.N;
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
      for (int pr = 0; pr < G::NI / 2; ++pr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // fragments 2pr and 2pr + 1 hold adjacent columns
          const int k = it.k0 + rb + mi * 16 + 2 * g + e / 2;
          const int n = it.n0 + col(2 * pr, 2 * t + e % 2);
          if (k < a.K && n < a.N)
            store2(p, (size_t)k * a.N + n, n, a.N, acc[mi][2 * pr][e],
                   acc[mi][2 * pr + 1][e]);
          acc[mi][2 * pr][e] = acc[mi][2 * pr + 1][e] = 0.f;
        }
      }
    }
  };
  const int n = (a.w_items - wk + a.w_workers - 1) / a.w_workers;
  mma::walk(n, item, stage_in, product, finish);
}

template <typename T, int XBN, int WBM, int WBN>
__global__ void __launch_bounds__(kThreads, 1)
bn_conv_grads_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  if (b < a.w_workers)
    dw_role<T, XBN, WBM, WBN>(a, b, smem);
  else
    dx_role<T, XBN, WBM, WBN>(a, b - a.w_workers, smem);
}

// dw = Σ_s part_w[s] and, where dX was split, dx = T(Σ_s part_x[s]), each
// sum in the order s = 0, 1, …
template <typename T>
__global__ void __launch_bounds__(256)
bn_conv_grads_sum_kernel(const float* __restrict__ part_w,
                         float* __restrict__ dw, int w_splits, long long kn,
                         const float* __restrict__ part_x,
                         T* __restrict__ dx, int x_parts, long long mk) {
  const long long total = kn + (x_parts > 1 ? mk : 0);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (i < kn) {
      for (int s = 0; s < w_splits; ++s) acc += part_w[s * kn + i];
      dw[i] = acc;
    } else {
      const long long j = i - kn;
      for (int s = 0; s < x_parts; ++s) acc += part_x[s * mk + j];
      dx[j] = from_f32<T>(acc);
    }
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

struct Plan {
  int narrow_k, narrow_n;
  int w_tiles_n, w_tiles, w_splits, w_rows, w_workers;
  int x_tiles_k, x_tiles, x_parts, x_len, x_workers;
  long long scratch_w, scratch_x;  // floats of dW / dX partials
};

// Cuts a contraction of `len` into parts of at most `most` (a multiple of
// kBK): (parts, length of each but the last).
void cut(int len, long long most, int& parts, int& each) {
  parts = (int)cdiv(len, most);
  each = (int)(cdiv(cdiv(len, parts), kBK) * kBK);
  parts = (int)cdiv(len, each);
}

// The launch plan of (M, K, N) on `sms` SMs: tiles by K and N; one longest
// contraction length L per item for both roles (dX items cut N, dW items
// cut M); and one wave of persistent blocks, one per SM, split between the
// roles. L and the split minimise a model of the time: the busier role's
// blocks walk ceil(items / blocks) items of (slices + kItemCost) slice
// times each, plus the partials' write and read at the memory rate. L is
// tried at every length that cuts M or N evenly. The plan depends on the
// shape and the card alone, so a re-run gives the same sums.
Plan make_plan(int M, int K, int N, int sms) {
  constexpr double kSliceUs = 1.5, kItemCost = 1.0, kBytesPerUs = 3.0e6;
  Plan p{};
  p.narrow_k = K <= 64;
  p.narrow_n = N <= 64;
  const int xbn = p.narrow_k ? 64 : 128, wbm = xbn;
  const int wbn = p.narrow_n ? 64 : 128;
  p.x_tiles_k = (int)cdiv(K, xbn);
  p.x_tiles = (int)cdiv(M, 128) * p.x_tiles_k;
  p.w_tiles_n = (int)cdiv(N, wbn);
  p.w_tiles = (int)cdiv(K, wbm) * p.w_tiles_n;
  double best = -1.0;
  auto consider = [&](long long most) {
    if (most < kMinLength) return;
    most = cdiv(most, kBK) * kBK;
    int xp, xl, ws, wr;
    cut(N, most, xp, xl);
    cut(M, most, ws, wr);
    const long long ix = (long long)p.x_tiles * xp;
    const long long iw = (long long)p.w_tiles * ws;
    const double sx = cdiv(xl, kBK) + kItemCost;
    const double sw = cdiv(wr, kBK) + kItemCost;
    const long long blocks = std::min<long long>(sms, ix + iw);
    double walk = -1.0;
    long long gw_best = 1;
    for (long long gw = std::max(1LL, blocks - ix);
         gw <= std::min(iw, blocks - 1); ++gw) {
      const double t = std::max(cdiv(iw, gw) * sw, cdiv(ix, blocks - gw) * sx);
      if (walk < 0.0 || t < walk) {
        walk = t;
        gw_best = gw;
      }
    }
    const double partials =
        (double)ws * K * N + (xp > 1 ? (double)xp * M * K : 0.0);
    const double cost = walk * kSliceUs + partials * 8.0 / kBytesPerUs;
    if (walk >= 0.0 && (best < 0.0 || cost < best)) {
      best = cost;
      p.x_parts = xp;
      p.x_len = xl;
      p.w_splits = ws;
      p.w_rows = wr;
      p.w_workers = (int)gw_best;
      p.x_workers = (int)(blocks - gw_best);
    }
  };
  consider(std::max<long long>({M, N, kMinLength}));
  for (int q = 2; q <= 1024; ++q) {
    consider(cdiv(M, q));
    if (q <= 64) consider(cdiv(N, q));
  }
  p.scratch_w = (long long)p.w_splits * K * N;
  p.scratch_x = p.x_parts > 1 ? (long long)p.x_parts * M * K : 0;
  return p;
}

// make_plan for the current device, remembered per shape and SM count (a
// training step repeats 15 shapes).
Plan plan_for(int M, int K, int N) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    sms = 132;
  static std::mutex lock;
  static std::map<std::tuple<int, int, int, int>, Plan> plans;
  const std::lock_guard<std::mutex> hold(lock);
  const auto key = std::make_tuple(M, K, N, sms);
  auto it = plans.find(key);
  if (it == plans.end()) it = plans.emplace(key, make_plan(M, K, N, sms)).first;
  return it->second;
}

template <typename T, int XBN, int WBM, int WBN>
cudaError_t launch_main(const Args<T>& a, int blocks, cudaStream_t stream) {
  using C = Cfg<T, XBN, WBM, WBN>;
  static_assert(C::kSmem <= 232448, "ring does not fit a block's shared "
                                    "memory");
  auto kernel = bn_conv_grads_kernel<T, XBN, WBM, WBN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, C::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* dz,
                   const void* w, const float* k1, const float* k2,
                   const float* c, const float* mu, void* dx, float* dw,
                   float* part, int M, int K, int N, cudaStream_t stream) {
  const Plan p = plan_for(M, K, N);
  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.y = static_cast<const T*>(y);
  a.dz = static_cast<const T*>(dz);
  a.w = static_cast<const T*>(w);
  a.k1 = k1;
  a.k2 = k2;
  a.c = c;
  a.mu = mu;
  a.dx = static_cast<T*>(dx);
  a.part_w = part;
  a.part_x = part + p.scratch_w;
  a.M = M;
  a.K = K;
  a.N = N;
  a.w_tiles_n = p.w_tiles_n;
  a.w_tiles = p.w_tiles;
  a.w_items = p.w_tiles * p.w_splits;
  a.w_rows = p.w_rows;
  a.w_workers = p.w_workers;
  a.x_tiles_k = p.x_tiles_k;
  a.x_tiles = p.x_tiles;
  a.x_items = p.x_tiles * p.x_parts;
  a.x_len = p.x_len;
  a.x_parts = p.x_parts;
  a.x_workers = p.x_workers;
  a.vec_k = (K * sizeof(T)) % 16 == 0 && mma::aligned16(x);
  a.vec_n = (N * sizeof(T)) % 16 == 0 && mma::aligned16(y) &&
            mma::aligned16(dz) && mma::aligned16(w);
  const int blocks = p.w_workers + p.x_workers;
  cudaError_t err;
  if (p.narrow_k && p.narrow_n)
    err = launch_main<T, 64, 64, 64>(a, blocks, stream);
  else if (p.narrow_k)
    err = launch_main<T, 64, 64, 128>(a, blocks, stream);
  else if (p.narrow_n)
    err = launch_main<T, 128, 128, 64>(a, blocks, stream);
  else
    err = launch_main<T, 128, 128, 128>(a, blocks, stream);
  if (err != cudaSuccess) return err;
  const long long kn = (long long)K * N, mk = (long long)M * K;
  const long long total = kn + (p.x_parts > 1 ? mk : 0);
  const int sum_blocks = (int)std::min<long long>(cdiv(total, 256), 132 * 16);
  bn_conv_grads_sum_kernel<T><<<sum_blocks, 256, 0, stream>>>(
      part, dw, p.w_splits, kn, a.part_x, static_cast<T*>(dx), p.x_parts,
      mk);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dl4j

// Floats of scratch `dl4j_bn_conv_grads` needs: the dW partials, then the
// dX partials where the plan splits N for dX.
extern "C" long long dl4j_bn_conv_grads_scratch(int M, int K, int N) {
  const dl4j::Plan p = dl4j::plan_for(M, K, N);
  return p.scratch_w + p.scratch_x;
}

// x (M, K), y and dz (M, N), w (K, N) contiguous in `dtype` (0 f32,
// 1 bf16); k1, k2, c, mu (N,) f32; dx (M, K) in `dtype`; dw (K, N) f32;
// part: dl4j_bn_conv_grads_scratch floats. M, K, N > 0. Launches on
// `stream` (two kernels) and returns cudaGetLastError().
extern "C" int dl4j_bn_conv_grads(const void* x, const void* y,
                                  const void* dz, const void* w,
                                  const void* k1, const void* k2,
                                  const void* c, const void* mu, void* dx,
                                  void* dw, void* part, int dtype, int M,
                                  int K, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  const float* f1 = static_cast<const float*>(k1);
  const float* f2 = static_cast<const float*>(k2);
  const float* fc = static_cast<const float*>(c);
  const float* fm = static_cast<const float*>(mu);
  float* d = static_cast<float*>(dw);
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dl4j::launch<float>(x, y, dz, w, f1, f2, fc, fm, dx, d, p, M, K,
                               N, st);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(x, y, dz, w, f1, f2, fc, fm, dx, d,
                                       p, M, K, N, st);
  return cudaErrorInvalidValue;
}
