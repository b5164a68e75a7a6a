// Fused ResNet bottleneck block for inference on Hopper, BN folded:
//   h1 = relu(x @ W1 + b1)              1×1 reduce,  C → M
//   h2 = relu(conv3×3(h1, W2) + b2)     SAME, one product of depth 9·M
//   y  = relu(h2 @ W3 + b3 + x)         1×1 expand,  M → C, residual
// x and y (B, H, W, C) NHWC; W1 (C, M), W2 (3, 3, M, M) HWIO, W3 (M, C), all
// in the activation dtype (f32 or bf16); biases f32. Products accumulate
// in f32; h1 and h2 are rounded to the activation dtype, as the JAX
// kernel casts them.
//
// Replaces: deeplearning4j_tpu/kernels/residual_block.py::_block_kernel
// (:38, pallas_call at :72 in _run), reached through `bottleneck_block`.
// Its point, kept here: one launch, h1 and h2 never leave the chip.
//
// What bounds it on the H100: 2·B·H·W·(C·M + 9·M² + M·C) operations
// (13.95 G at every ResNet-50 identity stage at B = 32) against
// |x| + |y| + |W| bytes. f32 runs as 3×TF32, three tensor-core products
// per f32 product: 0.0845 ms at 495 TFLOP/s, over res2's 0.061 ms of
// bytes; bf16 runs at 989 TFLOP/s (0.0141 ms) and is bound by bytes at
// res2 (0.031 ms). Inside the chip the weights are the traffic that
// counts: every block streams all 17·M² weight values from L2, so a
// block with P output pixels does 2·P / size operations per byte of L2
// weight traffic, and the design's main lever is a large P.
//
// Design:
// - The three products on the tensor cores through mma_tile.cuh's engine
//   (`walk`, `Slice`): mma.sync bf16, and f32 as 3×TF32 with each slice's
//   products summed apart and added to the accumulator in f32, so phase
//   2's contraction of 9·512 = 4,608 at res5 keeps f32's accuracy.
// - A block owns R image rows of one image (blockIdx.x = image · groups +
//   row group) and keeps, in shared memory in the activation dtype, h1 of
//   its rows and a one-row halo above and below ((R + 2)·W pixels; zero
//   outside the image, which is the SAME padding of the 3×3) and h2 of its
//   rows (R·W pixels). Pixel rows are padded to M + 8 values, so the
//   fragment reads of eight consecutive pixels meet no bank conflict.
// - Each phase is a walk over output tiles of 32·MI pixels × BN channels
//   (BN = 64 in f32, 128 in bf16, twice that where M ≥ 256; 8 warps, 2 down
//   the pixels and 4 across the channels), each over its contraction in
//   slices of 64 (twice the forward GEMMs' 32: half the slices' barriers
//   and waits, which ran faster on the H100 at every stage). The three
//   phases' tiles form one walk through one 3-stage cp.async ring, so the
//   first weight slices of a phase load while the last products of the
//   one before run: the weights (all three phases' B) and x (phase 1's A)
//   stream through the ring as 16-byte copies; phases 2 and 3 read A
//   straight from the resident h1 and h2. Phase 2 is an implicit GEMM:
//   contraction t·M + k reads h1 at pixel p + dy·W + dx − 1 (t = 3·dy + dx),
//   zero past the left and right edges; W2's HWIO layout is already that
//   (9·M, M) matrix. Each tap is walked in its own slices, so any M that is
//   a multiple of 8 works (the rest of a slice past M reads as zero).
// - Epilogues in registers: phases 1 and 2 add the bias, apply relu, round
//   to the dtype and store four adjacent channels to shared memory (halo
//   rows outside the image store zero); phase 3 adds b3 and x, applies
//   relu, and reads x and writes y four channels (16 bytes f32) at a time.
// - R and MI come from `block_plan`: the largest tile that fits the 227 KB
//   of shared memory is not always best, because the whole image rows of
//   ResNet-50's late stages give few blocks (res5 at B = 32 has 224 image
//   rows), so a model of the walk weighs the products (padding rows
//   included) against the blocks' L2 weight traffic and the waves.
// - What still holds it back on the H100 is the engine's rate: the
//   mma.sync walk (32-bit fragment loads, a barrier per slice, 8 warps an
//   SM) reaches about a fifth of the tensor cores' peak on a large GEMM,
//   and at res5 the few blocks leave SMs idle (PERF.md).
// - Fixed summation order and no atomics: a re-run gives the same bits.
#include "mma_tile.cuh"

namespace dl4j {
namespace {

using mma::kStages;
using mma::kThreads;

constexpr int kSmemMax = 232448;  // a block's shared memory on the H100
constexpr int kPad = 8;           // values of padding after a pixel's M
constexpr int kBKB = 64;          // contraction values per slice

// The tile of a block's walk: 32·MI pixels × BN channels, BN narrow (64
// f32, 128 bf16) or, where M ≥ 256, wide (twice that), so each warp's
// fragment reads feed twice the products. A ring stage holds x's pixel
// rows (phase 1) and the weights' contraction rows in the forward
// product's layout (FwdOps): rows of kBKB + 8 values for x and of BN + 4
// (f32) or BN + 8 (bf16) for the weights, fragment reads free of bank
// conflicts.
template <typename T, int MI_, bool WIDE>
struct Cfg {
  static constexpr int MI = MI_;
  static constexpr int BN = (sizeof(T) == 4 ? 64 : 128) * (WIDE ? 2 : 1);
  static constexpr int RT = 32 * MI;
  static constexpr int SX = kBKB + 8;
  static constexpr int SN = BN + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int kStage = (RT * SX + kBKB * SN) * (int)sizeof(T);
  static constexpr int kRing = kStages * kStage;
  using G = mma::Geom<RT, BN, 4>;
};

template <typename T>
struct Args {
  const T* x;
  const T* w1;
  const float* b1;
  const T* w2;
  const float* b2;
  const T* w3;
  const float* b3;
  T* y;
  int H, W, C, M, R, groups;
  int vec_x, vec_w1, vec_w2, vec_w3;
};

// The A operand of phases 2 and 3 from a resident h1 or h2 (pixel rows of
// S values), B from the ring stage. off[mi][h]: the element offset of
// fragment row (mi, h)'s pixel, contraction k0 included, or −1 for a row
// that reads zero; kmax: the contraction values of this slice that exist.
template <typename T, int SN, int MI, int NI>
struct HOps {
  const T* h;
  const T* b;
  int off[MI][2];
  int kmax;

  __device__ __forceinline__ void frags(int kk, int, int cb,
                                        float (&fa)[MI][4],
                                        float (&fb)[NI][2]) const {
    const int k = kk + 2 * (threadIdx.x % 4);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float2 v = make_float2(0.f, 0.f);
        if (off[mi][hh] >= 0 && k < kmax)
          v = *reinterpret_cast<const float2*>(h + off[mi][hh] + k);
        fa[mi][hh] = v.x;
        fa[mi][2 + hh] = v.y;
      }
    }
    mma::b_frags<SN>(b, kk, cb, fb);
  }

  __device__ __forceinline__ void frags(int kk, int, int cb,
                                        uint32_t (&fa)[MI][4],
                                        uint32_t (&fb)[NI][2]) const {
    const int k = kk + 2 * (threadIdx.x % 4);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const T* p = h + off[mi][hh] + k;
        const bool in = off[mi][hh] >= 0;
        fa[mi][hh] = in && k < kmax ? *reinterpret_cast<const uint32_t*>(p)
                                    : 0u;
        fa[mi][2 + hh] = in && k + 8 < kmax
                             ? *reinterpret_cast<const uint32_t*>(p + 8)
                             : 0u;
      }
    }
    mma::b_frags<SN>(b, kk, cb, fb);
  }
};

struct Item {
  int phase, r0, rows, n0, slices;  // tile's first pixel, pixels in it
};

template <typename T, int MI, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_block_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using K = Cfg<T, MI, WIDE>;
  using F = K;
  using G = typename K::G;
  constexpr int RT = K::RT, BN = K::BN, NI = G::NI;
  const int W = a.W, C = a.C, M = a.M, S = M + kPad;
  const int b = blockIdx.x / a.groups;
  const int row0 = (blockIdx.x % a.groups) * a.R;
  const int rb_rows = min(a.R, a.H - row0);  // output rows of this block
  const int P = rb_rows * W, P1 = P + 2 * W;
  T* h1 = reinterpret_cast<T*>(smem + K::kRing);
  T* h2 = h1 + (size_t)(a.R + 2) * W * S;
  const T* x_img = a.x + (size_t)b * a.H * W * C;

  const int t1 = (P1 + RT - 1) / RT, t2 = (P + RT - 1) / RT;
  const int n_m = (M + BN - 1) / BN, n_c = (C + BN - 1) / BN;
  const int spt = (M + kBKB - 1) / kBKB;  // slices per tap of phase 2
  const int n1 = t1 * n_m, n2 = t2 * n_m, n3 = t2 * n_c;
  auto item_at = [&](int j) {
    Item it;
    int tiles_n, jj;
    if (j < n1) {
      it.phase = 1, jj = j, tiles_n = n_m;
      it.slices = (C + kBKB - 1) / kBKB;
    } else if (j < n1 + n2) {
      it.phase = 2, jj = j - n1, tiles_n = n_m;
      it.slices = 9 * spt;
    } else {
      it.phase = 3, jj = j - n1 - n2, tiles_n = n_c;
      it.slices = spt;
    }
    it.r0 = (jj / tiles_n) * RT;
    it.n0 = (jj % tiles_n) * BN;
    it.rows = min(RT, (it.phase == 1 ? P1 : P) - it.r0);
    return it;
  };
  auto stage = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * F::kStage);
  };
  auto stage_in = [&](int slot, const Item& it, int i) {
    T* xs = stage(slot);
    T* ws = xs + RT * F::SX;
    if (it.phase == 1) {
      const int k0 = i * kBKB;
      // x's pixels of h1's rows row0 − 1 … row0 + rows: rows outside the
      // image are never read
      mma::load_tile<T, RT, kBKB>(xs, F::SX, x_img, C, (row0 - 1) * W + it.r0,
                                 min(a.H, row0 + rb_rows + 1) * W, k0, C,
                                 a.vec_x, 0);
      mma::load_tile<T, kBKB, BN>(ws, F::SN, a.w1, M, k0, C, it.n0, M,
                                 a.vec_w1);
    } else if (it.phase == 2) {
      const int tap = i / spt, k0 = tap * M + (i % spt) * kBKB;
      mma::load_tile<T, kBKB, BN>(ws, F::SN, a.w2, M, k0, tap * M + M, it.n0,
                                 M, a.vec_w2);
    } else {
      mma::load_tile<T, kBKB, BN>(ws, F::SN, a.w3, C, i * kBKB, M, it.n0, C,
                                 a.vec_w3);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rb = (warp / G::WC) * MI * 16;
  const int cb = (warp % G::WC) * NI * 8;
  float acc[MI][NI][4] = {};
  // the column within the image of each fragment row's pixel (phase 2)
  int pc[MI][2];
  auto product = [&](int slot, const Item& it, int i) {
    const T* ws = stage(slot) + RT * F::SX;
    if (it.phase == 1) {
      const mma::FwdOps<T, F, MI, NI> op{stage(slot), ws};
      mma::Slice<T>::template run<MI, NI, kBKB>(op, rb, cb, acc);
      return;
    }
    HOps<T, F::SN, MI, NI> op;
    op.b = ws;
    if (it.phase == 2) {
      const int tap = i / spt, k0 = (i % spt) * kBKB;
      const int dy = tap / 3, dx = tap % 3;
      if (i == 0) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            pc[mi][hh] = (it.r0 + rb + mi * 16 + g + 8 * hh) % W;
        }
      }
      op.h = h1;
      op.kmax = M - k0;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = it.r0 + rb + mi * 16 + g + 8 * hh;
          const int c = pc[mi][hh] + dx - 1;
          op.off[mi][hh] = p < P && c >= 0 && c < W
                               ? (p + dy * W + dx - 1) * S + k0
                               : -1;
        }
      }
    } else {
      const int k0 = i * kBKB;
      op.h = h2;
      op.kmax = M - k0;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = it.r0 + rb + mi * 16 + g + 8 * hh;
          op.off[mi][hh] = p < P ? p * S + k0 : -1;
        }
      }
    }
    mma::Slice<T>::template run<MI, NI, kBKB>(op, rb, cb, acc);
  };

  auto finish = [&](const Item& it) {
    const int ncols = it.phase == 3 ? C : M;
    const float* bias = it.phase == 1 ? a.b1 : it.phase == 2 ? a.b2 : a.b3;
#pragma unroll
    for (int j = 0; j < NI / 2; ++j) {
      const int n = it.n0 + cb + 16 * j + 4 * t;
      float bv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) bv[e] = n < ncols ? __ldg(bias + n + e) : 0.f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = it.r0 + rb + mi * 16 + g + 8 * hh;
          float q[4];
          mma::fwd_run<2>(acc, mi, j, hh, q);
          if (n < ncols && p - it.r0 < it.rows) {
            T v[4];
            if (it.phase == 3) {
              const size_t o = ((size_t)(b * a.H + row0) * W + p) * C + n;
              T xv[4];
              if constexpr (sizeof(T) == 4) {
                const float4 u = *reinterpret_cast<const float4*>(a.x + o);
                xv[0] = u.x, xv[1] = u.y, xv[2] = u.z, xv[3] = u.w;
              } else {
                const uint2 u = *reinterpret_cast<const uint2*>(a.x + o);
                const __nv_bfloat162* hv =
                    reinterpret_cast<const __nv_bfloat162*>(&u);
                xv[0] = hv[0].x, xv[1] = hv[0].y, xv[2] = hv[1].x,
                xv[3] = hv[1].y;
              }
#pragma unroll
              for (int e = 0; e < 4; ++e)
                v[e] = from_f32<T>(fmaxf(q[e] + bv[e] + to_f32(xv[e]), 0.f));
              mma::store4(a.y, o, n, C, v);
            } else {
              // phase 1: h1's halo rows outside the image are the SAME
              // padding, zero
              const int img_row = row0 - 1 + p / W;
              const bool in = it.phase == 2 || (img_row >= 0 && img_row < a.H);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                v[e] = from_f32<T>(in ? fmaxf(q[e] + bv[e], 0.f) : 0.f);
              mma::store4(it.phase == 1 ? h1 : h2, (size_t)p * S + n, n, M,
                          v);
            }
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      }
    }
  };
  mma::walk(n1 + n2 + n3, item_at, stage_in, product, finish);
}

// The block plan: R image rows per block, MI row fragments per warp, and
// the tile width.
struct BlockPlan {
  int rows, mi, wide, groups, blocks, smem;
};

// A model of one block's walk, per tile and R: its products (the phases'
// tiles padded to 32·MI pixels and BN channels; f32 three TF32 products
// each) at a tensor-core rate per SM, against its weights' L2 traffic (all
// blocks of a wave share the L2's rate), times the waves of blocks (one
// block per SM). The rates are the H100's published peaks derated to the
// 20 % of them that this engine's mma.sync walk reaches on a large GEMM
// (kernels/engine_rate.py), a warp tile of twice the rows running
// 1.35× faster per product (`gain`; both fitted to H100 times of the four
// ResNet-50 stages), and an L2 rate of 5.5 TB/s. The largest R wins a
// tie: it moves fewer bytes.
template <typename T, int MI, bool WIDE>
void consider(int B, int H, int W, int C, int M, int sms, double gain,
              BlockPlan& best, double& best_t) {
  using K = Cfg<T, MI, WIDE>;
  constexpr bool f32 = sizeof(T) == 4;
  const double mac_rate =
      (f32 ? 495e12 / 3.0 : 989e12) / 2.0 / 132 * 0.2 * gain;
  const double l2_rate = 5.5e12;
  const long long kp = 9LL * ((M + kBKB - 1) / kBKB) * kBKB;
  const long long mp = (M + K::BN - 1) / K::BN * K::BN;
  const long long cp = (C + K::BN - 1) / K::BN * K::BN;
  for (int R = 1; R <= H; ++R) {
    const long long smem =
        K::kRing + (2LL * R + 2) * W * (M + kPad) * (long long)sizeof(T);
    if (smem > kSmemMax) break;
    const long long P = (long long)R * W, P1 = P + 2LL * W;
    const long long t1 = (P1 + K::RT - 1) / K::RT, t2 = (P + K::RT - 1) / K::RT;
    const double macs =
        (double)K::RT * (t1 * C * mp + t2 * kp * mp + t2 * M * cp);
    const double bytes =
        (double)(t1 * C * M + t2 * 9LL * M * M + t2 * (long long)M * C) *
        sizeof(T);
    const int groups = (H + R - 1) / R;
    const long long blocks = (long long)B * groups;
    const long long waves = (blocks + sms - 1) / sms;
    const double in_wave = blocks < sms ? (double)blocks : (double)sms;
    const double t_mac = macs / mac_rate, t_l2 = bytes * in_wave / l2_rate;
    const double t = waves * (t_mac > t_l2 ? t_mac : t_l2);
    if (best_t < 0.0 || t <= best_t) {
      best_t = t;
      best = BlockPlan{R, MI, WIDE, groups, (int)blocks, (int)smem};
    }
  }
}

// The wide tile (with the smaller MI: the larger spills) where M ≥ 256
// and it fits: on the H100 it was faster at res4 and res5 in both dtypes,
// slower at M = 64 and 128. Else the narrow tile, MI and R from the model.
template <typename T>
BlockPlan block_plan(int B, int H, int W, int C, int M, int sms) {
  constexpr int lo = sizeof(T) == 4 ? 1 : 2;
  BlockPlan best{};
  double best_t = -1.0;
  if (M >= 256) consider<T, lo, true>(B, H, W, C, M, sms, 1.0, best, best_t);
  if (best.rows == 0) {
    consider<T, lo, false>(B, H, W, C, M, sms, 1.0, best, best_t);
    consider<T, 2 * lo, false>(B, H, W, C, M, sms, 1.35, best, best_t);
  }
  return best;
}

template <typename T, int MI, bool WIDE>
cudaError_t launch_tile(const Args<T>& a, const BlockPlan& p,
                        cudaStream_t stream) {
  auto kernel = bottleneck_block_kernel<T, MI, WIDE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.blocks, kThreads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const float* b1,
                   const void* w2, const float* b2, const void* w3,
                   const float* b3, void* y, int B, int H, int W, int C,
                   int M, cudaStream_t stream) {
  const BlockPlan p = block_plan<T>(B, H, W, C, M, mma::sm_count());
  if (p.rows == 0) return cudaErrorInvalidValue;  // W·M too large
  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.w1 = static_cast<const T*>(w1);
  a.b1 = b1;
  a.w2 = static_cast<const T*>(w2);
  a.b2 = b2;
  a.w3 = static_cast<const T*>(w3);
  a.b3 = b3;
  a.y = static_cast<T*>(y);
  a.H = H;
  a.W = W;
  a.C = C;
  a.M = M;
  a.R = p.rows;
  a.groups = p.groups;
  // rows of C (x, w3) and of M (w1, w2) are whole 16-byte chunks (M and C
  // are multiples of 8): 16-byte copies wherever the base is aligned
  a.vec_x = mma::aligned16(x);
  a.vec_w1 = mma::aligned16(w1);
  a.vec_w2 = mma::aligned16(w2);
  a.vec_w3 = mma::aligned16(w3);
  constexpr int lo = sizeof(T) == 4 ? 1 : 2;  // the tiles block_plan weighs
  if (p.wide) return launch_tile<T, lo, true>(a, p, stream);
  return p.mi == lo ? launch_tile<T, lo, false>(a, p, stream)
                    : launch_tile<T, 2 * lo, false>(a, p, stream);
}

}  // namespace
}  // namespace dl4j

// x, y (B, H, W, C); w1 (C, M); w2 (3, 3, M, M); w3 (M, C), all contiguous in
// `dtype` (0 f32, 1 bf16), x and y 16-byte aligned; b1, b2 (M,) and b3 (C,)
// f32. M and C multiples of 8, and W·(M + 8)·size ≤ 38,144 bytes (a block
// holds four pixel rows of h1 and h2 at least beside its ring). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dl4j_bottleneck_block(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* w3,
                                     const void* b3, void* y, int dtype,
                                     int B, int H, int W, int C, int M,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || M <= 0 || M % 8 || C % 8 ||
      !dl4j::mma::aligned16(x) || !dl4j::mma::aligned16(y))
    return cudaErrorInvalidValue;
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* fb3 = static_cast<const float*>(b3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dl4j::launch<float>(x, w1, fb1, w2, fb2, w3, fb3, y, B, H, W, C, M,
                               s);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(x, w1, fb1, w2, fb2, w3, fb3, y, B, H,
                                       W, C, M, s);
  return cudaErrorInvalidValue;
}

// The plan the launch picks for this shape on the current device:
// out = {R image rows per block, output pixels per block (R·W), blocks,
// MI row fragments per warp (tiles of 32·MI pixels), shared memory bytes,
// the tile's BN channels}.
// Returns 0, or cudaErrorInvalidValue where no plan fits.
extern "C" int dl4j_bottleneck_plan(int dtype, int B, int H, int W, int C,
                                    int M, int* out) {
  const int sms = dl4j::mma::sm_count();
  const dl4j::BlockPlan p =
      dtype == dl4j::kFloat32
          ? dl4j::block_plan<float>(B, H, W, C, M, sms)
          : dl4j::block_plan<__nv_bfloat16>(B, H, W, C, M, sms);
  if (p.rows == 0) return cudaErrorInvalidValue;
  out[0] = p.rows;
  out[1] = p.rows * W;
  out[2] = p.blocks;
  out[3] = p.mi;
  out[4] = p.smem;
  out[5] = (dtype == dl4j::kFloat32 ? 64 : 128) * (p.wide ? 2 : 1);
  return 0;
}
