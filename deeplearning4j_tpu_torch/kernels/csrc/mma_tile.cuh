// A tensor-core tile engine for Hopper: mma.sync products fed from a ring
// of shared-memory stages that cp.async fills ahead of the math.
//
// A block of 256 threads (8 warps) owns a BM × BN output tile (BM, BN in
// {64, 128}) and walks the contraction in slices of kBK = 32 (int8: 128).
// Each slice's raw operand tiles land in one of kStages stages of shared
// memory, so the loads of slice s + 2 are in flight while slice s is
// multiplied (`walk`, which carries the ring across the block's work
// items). The caller builds each step's register fragments itself
// (`Slice`'s `op.frags`), so it may compute on the raw values on the way
// (the BN gradient forms its dy there) and pick which shared-memory
// element feeds which fragment slot, to read pairs as 64-bit words.
// The forward product y = x @ w of matmul_epilogue.cu and matmul_stats.cu
// is built on it at the end of this file (`fwd_walk`, `fwd_plan`); the
// fused bottleneck block (bottleneck_block.cu) runs its three products on
// `walk` and `Slice` with its own A fragments.
//
// Three routes, by the operand type T:
// - bf16: mma.sync.m16n8k16 bf16 × bf16 → f32. The product of two bf16
//   values is exact in f32, so only the order of the sum differs from a
//   plain f32 product of the same values.
// - f32: 3×TF32 (CUTLASS's OpMultiplyAddFastF32). Each operand is split
//   into a TF32 hi (rounded to nearest, as cvt.rna.tf32.f32 rounds) and a
//   TF32 lo (the remainder, truncated), and a·b accumulates as
//   a_lo·b_hi + a_hi·b_lo + a_hi·b_hi through mma.sync.m16n8k8 tf32 in f32:
//   about 2^-21 relative error per product, f32's accuracy. One TF32 pass
//   (about 2^-11) would not hold an f32 gradient to f32.
// - int8: mma.sync.m16n8k32 s8 × s8 → s32, accumulated in int32: exact
//   for any order while K·128² < 2^31.
#pragma once

#include "common.cuh"

namespace dl4j {
namespace mma {

constexpr int kThreads = 256;
constexpr int kBK = 32;      // contraction values per slice (f32, bf16)
constexpr int kBK8 = 128;    // contraction values per int8 slice
constexpr int kStages = 3;   // slices in flight

// -- asynchronous copies ------------------------------------------------------
// 16 bytes global -> shared; `full` false fills the 16 bytes with zeros
// (src-size 0: nothing is read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One element, for rows whose byte length is not a multiple of 16: f32 by a
// 4-byte cp.async, bf16 (2 bytes, below cp.async's smallest copy) by a plain
// load and store, which the slice's __syncthreads publishes as it does the
// asynchronous copies.
__device__ __forceinline__ void copy_elem(float* dst, const float* src,
                                          bool full) {
  cp4(dst, src, full);
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          bool full) {
  *dst = full ? *src : __float2bfloat16(0.f);
}
__device__ __forceinline__ void copy_elem(int8_t* dst, const int8_t* src,
                                          bool full) {
  *dst = full ? *src : int8_t(0);
}

// Stage a ROWS × COLS tile of a row-major matrix g (row stride gs) from
// (r0, c0) into shared memory s (row stride ss elements). Rows ≥ r_end or
// < r_beg and columns ≥ c_end stage as zeros; nothing outside them is
// read (r0 may be negative). `vec`: the rows are 16-byte aligned and
// c_end, c0 are multiples of 16 bytes, so a 16-byte chunk is wholly in or
// wholly out.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* s, int ss, const T* g,
                                          long long gs, int r0, int r_end,
                                          int c0, int c_end, bool vec,
                                          int r_beg = 0) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int CH = COLS / E;
    static_assert(ROWS * CH % kThreads == 0, "tile not a whole number of "
                                             "chunk rounds");
#pragma unroll
    for (int i = 0; i < ROWS * CH / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / CH, c = (idx % CH) * E;
      const bool in = r0 + r >= r_beg && r0 + r < r_end && c0 + c < c_end;
      const T* src = in ? g + (long long)(r0 + r) * gs + c0 + c : g;
      cp16(s + r * ss + c, src, in);
    }
  } else {
    static_assert(ROWS * COLS % kThreads == 0, "tile not a whole number of "
                                               "element rounds");
#pragma unroll 4
    for (int i = 0; i < ROWS * COLS / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / COLS, c = idx % COLS;
      const bool in = r0 + r >= r_beg && r0 + r < r_end && c0 + c < c_end;
      const T* src = in ? g + (long long)(r0 + r) * gs + c0 + c : g;
      copy_elem(s + r * ss + c, src, in);
    }
  }
}

// -- the products ---------------------------------------------------------------
// hi: x rounded to TF32's 10 mantissa bits, to nearest with ties away from
// zero (cvt.rna.tf32.f32's rounding, done on the integer pipe: CUTLASS's
// round_half_ulp_truncate); lo: the exact remainder x − hi, cut to TF32 by
// truncation. x ≈ hi + lo to about 2^-21 relative.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The accumulator of each route: f32, int32 for int8.
template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<int8_t> {
  using type = int;
};

// Two values already representable in bf16, packed low (lower k) first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The warp layout of a BM × BN tile over 8 warps, WC warps across the
// columns: warp tiles of (16·MI) × (8·NI). A caller whose A operand costs
// more to form than its B takes a small WC, so fewer warps form each A row.
template <int BM, int BN, int WC_>
struct Geom {
  static constexpr int WC = WC_;
  static constexpr int WR = 8 / WC;
  static constexpr int MI = BM / (16 * WR);
  static constexpr int NI = BN / (8 * WC);
  static_assert(WR * WC == 8 && MI >= 1 && NI >= 2 && NI % 2 == 0 &&
                    MI * 16 * WR == BM && NI * 8 * WC == BN,
                "tile does not split over 8 warps");
};

// One slice's contribution to acc. `op.frags(kk, rb, cb, a, b)` fills the
// fragments of contraction step kk for the warp's corner (rb, cb) in the
// PTX ISA's m16n8k8 (f32: values), m16n8k16 (bf16: packed pairs) or
// m16n8k32 (int8: packed quads) layouts; which shared-memory element
// stands behind each fragment slot is the caller's choice, as long as A's
// and B's contraction orders agree and its epilogue maps the accumulators
// back the same way. DEPTH: the slice's contraction values, kDepth unless
// the caller stages deeper slices.
template <typename T>
struct Slice;

template <>
struct Slice<float> {
  static constexpr int kDepth = kBK;
  template <int MI, int NI, int DEPTH = kDepth, class Ops>
  __device__ __forceinline__ static void run(const Ops& op, int rb, int cb,
                                             float (&acc)[MI][NI][4]) {
    // this slice's sum, added to acc in f32: the tensor cores' own
    // accumulation drifts over thousands of steps (at N = 2,048 it came
    // near the f32 gate when acc took every step); a sum per slice (12
    // mma steps) keeps the error at a plain f32 product's
    float sum[MI][NI][4] = {};
#pragma unroll
    for (int kk = 0; kk < DEPTH; kk += 8) {
      float a[MI][4], b[NI][2];
      op.frags(kk, rb, cb, a, b);
      uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int e = 0; e < 4; ++e) split(a[mi][e], ah[mi][e], al[mi][e]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        split(b[ni][0], bh[ni][0], bl[ni][0]);
        split(b[ni][1], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          mma_tf32(sum[mi][ni], al[mi], bh[ni]);
          mma_tf32(sum[mi][ni], ah[mi], bl[ni]);
          mma_tf32(sum[mi][ni], ah[mi], bh[ni]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += sum[mi][ni][e];
      }
    }
  }
};

template <>
struct Slice<__nv_bfloat16> {
  static constexpr int kDepth = kBK;
  template <int MI, int NI, int DEPTH = kDepth, class Ops>
  __device__ __forceinline__ static void run(const Ops& op, int rb, int cb,
                                             float (&acc)[MI][NI][4]) {
#pragma unroll
    for (int kk = 0; kk < DEPTH; kk += 16) {
      uint32_t a[MI][4], b[NI][2];
      op.frags(kk, rb, cb, a, b);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
      }
    }
  }
};

// int8: the products are exact, so the tensor cores accumulate straight
// into the int32 sums.
template <>
struct Slice<int8_t> {
  static constexpr int kDepth = kBK8;
  template <int MI, int NI, int DEPTH = kDepth, class Ops>
  __device__ __forceinline__ static void run(const Ops& op, int rb, int cb,
                                             int (&acc)[MI][NI][4]) {
#pragma unroll
    for (int kk = 0; kk < DEPTH; kk += 32) {
      uint32_t a[MI][4], b[NI][2];
      op.frags(kk, rb, cb, a, b);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
      }
    }
  }
};

// The pipelined walk of a block over its items, one after another through
// one ring, so the copies of the next item's first slices overlap the
// current item's last products and its epilogue. `item_at(j)` describes
// item j < n (its `slices` and whatever the callbacks need; computed once
// per item on each side of the ring); `stage_in(slot, item, i)` issues the
// copies of the item's slice i into ring slot `slot`; `product(slot, item,
// i)` multiplies it; `finish(item)` runs after the item's last product
// (on every thread; it must not touch the ring). One commit group per
// slice, empty ones included, so wait_pending<kStages - 2> always means
// "the slice about to be read has landed".
template <class ItemAt, class StageIn, class Product, class Finish>
__device__ __forceinline__ void walk(int n, ItemAt item_at, StageIn stage_in,
                                     Product product, Finish finish) {
  int lj = 0, li = 0;  // next slice to load
  auto lit = item_at(0);
  auto load = [&](int slot) {
    if (lj < n) {
      stage_in(slot, lit, li);
      if (++li == lit.slices) {
        li = 0;
        if (++lj < n) lit = item_at(lj);
      }
    }
    commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);
  int slot = 0;
  for (int j = 0; j < n; ++j) {
    const auto it = item_at(j);
    for (int i = 0; i < it.slices; ++i) {
      wait_pending<kStages - 2>();
      __syncthreads();  // this slice visible; the slot before it free
      load(slot == 0 ? kStages - 1 : slot - 1);
      product(slot, it, i);
      slot = slot == kStages - 1 ? 0 : slot + 1;
    }
    finish(it);
  }
}

// -- the forward product y = x @ w (matmul_epilogue.cu, matmul_stats.cu) -----
// x (M, K) and w (K, N) row-major. Persistent blocks walk BM × BN output
// tiles (BM, BN in {64, 128}, chosen by `fwd_plan`), each over K in slices
// through one ring, so a tile's epilogue overlaps the next tile's first
// copies. A stage holds x's BM rows (the contraction contiguous, rows of
// BK + 8 f32/bf16 or BK + 16 int8 values) and w's BK rows (columns
// contiguous, rows of BN + 4 floats, BN + 8 bf16 or BN + 16 int8); every
// fragment read below meets no bank conflict.
// - A = x. f32: slot t takes contraction 2t and slot t + 4 takes 2t + 1,
//   one 64-bit read per row; bf16 and int8: the k16 / k32 layouts, 32-bit
//   reads.
// - B = w, read in runs of F adjacent columns (`b_frags`): F = 2 for f32
//   and bf16, F = 4 for int8. The n8 fragments F·j … F·j + F − 1 at
//   fragment column g are tile columns 8F·j + F·g … + F − 1: f32 reads
//   64-bit words of rows 2t and 2t + 1; bf16 reads 32-bit words of two
//   adjacent rows merged by __byte_perm; int8 reads a 32-bit word of four
//   columns from each of four consecutive rows and transposes the 4 × 4
//   bytes with __byte_perm. So a thread's accumulators acc[mi][F·j + e]
//   [2h + c] are the 2F adjacent columns 8F·j + 2F·t … + 2F − 1 of tile
//   row 16·mi + g + 8h (`fwd_run`), and an epilogue stores 16 bytes (f32)
//   or 8 bytes (bf16) at a time.
template <typename T, int BM_, int BN_>
struct FwdCfg {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr bool kInt8 = sizeof(T) == 1;
  static constexpr int BK = Slice<T>::kDepth;
  static constexpr int F = kInt8 ? 4 : 2;  // n8 fragments a column run spans
  static constexpr int SX = BK + (kInt8 ? 16 : 8);
  static constexpr int SN = BN + (sizeof(T) == 4 ? 4 : kInt8 ? 16 : 8);
  static constexpr int kStage = (BM * SX + BK * SN) * (int)sizeof(T);
  static constexpr int kSmem = kStages * kStage;
  using G = Geom<BM, BN, BN / 32>;  // warp tiles of 64 × 32, 32 × 32, 16 × 32
};

// B's fragments of contraction step kk for a warp whose columns start at
// cb, from a stage b of rows of SN elements (the layout above).
template <int SN, int NI>
__device__ __forceinline__ void b_frags(const float* b, int kk, int cb,
                                        float (&fb)[NI][2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NI / 2; ++j) {
    const float* p = b + (kk + 2 * t) * SN + cb + 16 * j + 2 * g;
    const float2 v0 = *reinterpret_cast<const float2*>(p);
    const float2 v1 = *reinterpret_cast<const float2*>(p + SN);
    fb[2 * j][0] = v0.x;
    fb[2 * j + 1][0] = v0.y;
    fb[2 * j][1] = v1.x;
    fb[2 * j + 1][1] = v1.y;
  }
}

template <int SN, int NI>
__device__ __forceinline__ void b_frags(const __nv_bfloat16* b, int kk,
                                        int cb, uint32_t (&fb)[NI][2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NI / 2; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const __nv_bfloat16* p =
          b + (kk + 2 * t + 8 * q) * SN + cb + 16 * j + 2 * g;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(p + SN);
      fb[2 * j][q] = __byte_perm(r0, r1, 0x5410);      // column 2g
      fb[2 * j + 1][q] = __byte_perm(r0, r1, 0x7632);  // column 2g + 1
    }
  }
}

// int8: register q holds contraction 16q + 4t … + 3 of a column. The
// threads with t ≥ 2 read their four rows in the order 2, 3, 0, 1: with
// rows of BN + 16 bytes the four t then meet four different bank octets in
// every load, where the plain order would pair them.
template <int SN, int NI>
__device__ __forceinline__ void b_frags(const int8_t* b, int kk, int cb,
                                        uint32_t (&fb)[NI][2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rot = t & 2;
#pragma unroll
  for (int j = 0; j < NI / 4; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int8_t* p = b + (kk + 16 * q + 4 * t) * SN + cb + 32 * j + 4 * g;
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = *reinterpret_cast<const uint32_t*>(p + ((i ^ rot) * SN));
      uint32_t w[4];  // w[r]: row 4t + r, columns 4g … 4g + 3
#pragma unroll
      for (int r = 0; r < 4; ++r) w[r] = rot ? v[r ^ 2] : v[r];
      const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
      fb[4 * j][q] = __byte_perm(t0, t2, 0x5410);      // column 4g
      fb[4 * j + 1][q] = __byte_perm(t0, t2, 0x7632);  // column 4g + 1
      fb[4 * j + 2][q] = __byte_perm(t1, t3, 0x5410);  // column 4g + 2
      fb[4 * j + 3][q] = __byte_perm(t1, t3, 0x7632);  // column 4g + 3
    }
  }
}

template <typename T, class C, int MI, int NI>
struct FwdOps {
  const T* a;  // BM × SX: x's rows
  const T* b;  // BK × SN: w's rows

  __device__ __forceinline__ void frags(int kk, int rb, int cb,
                                        float (&fa)[MI][4],
                                        float (&fb)[NI][2]) const {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(
            a + (rb + mi * 16 + g + 8 * h) * C::SX + kk + 2 * t);
        fa[mi][h] = v.x;
        fa[mi][2 + h] = v.y;
      }
    }
    b_frags<C::SN>(b, kk, cb, fb);
  }

  // bf16 (k16: pairs 2t and 2t + 8) and int8 (k32: quads 4t and 4t + 16)
  __device__ __forceinline__ void frags(int kk, int rb, int cb,
                                        uint32_t (&fa)[MI][4],
                                        uint32_t (&fb)[NI][2]) const {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    constexpr int E = 4 / sizeof(T);  // values in a 32-bit word
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T* p = a + (rb + mi * 16 + g + 8 * h) * C::SX + kk + E * t;
        fa[mi][h] = *reinterpret_cast<const uint32_t*>(p);
        fa[mi][2 + h] = *reinterpret_cast<const uint32_t*>(p + 4 * E);
      }
    }
    b_frags<C::SN>(b, kk, cb, fb);
  }
};

// The 2F accumulators of tile columns 8F·j + 2F·t … + 2F − 1 in row half
// h (F = 2: f32 and bf16; F = 4: int8).
template <int F, typename A, int MI, int NI>
__device__ __forceinline__ void fwd_run(const A (&acc)[MI][NI][4], int mi,
                                        int j, int h, A (&v)[2 * F]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int e = 0; e < F; ++e) v[F * c + e] = acc[mi][F * j + e][2 * h + c];
  }
}

// Four adjacent outputs at o (column col of a row of N): one 16-byte (f32)
// or 8-byte (bf16) store where all four exist and o is a multiple of 4.
__device__ __forceinline__ void store4(float* p, size_t o, int col, int N,
                                       const float (&v)[4]) {
  if (col + 3 < N && o % 4 == 0) {
    *reinterpret_cast<float4*>(p + o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int e = 0; e < 4 && col + e < N; ++e) p[o + e] = v[e];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, size_t o, int col,
                                       int N, const __nv_bfloat16 (&v)[4]) {
  if (col + 3 < N && o % 4 == 0) {
    __nv_bfloat162 lo, hi;
    lo.x = v[0];
    lo.y = v[1];
    hi.x = v[2];
    hi.y = v[3];
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p + o) = u;
  } else {
    for (int e = 0; e < 4 && col + e < N; ++e) p[o + e] = v[e];
  }
}

struct FwdItem {
  int m0, n0, tm, idx, slices;  // tile origin, tile row, item number
};

// The block's walk over tiles blockIdx.x, blockIdx.x + gridDim.x, … of
// `tiles` (tiles_n across N), each over K in slices of BK: x's rows ≥ M,
// w's columns ≥ N and the contraction past K stage as zeros. `extra(slot,
// item)` issues the cp.async copies the item's epilogue needs into the
// commit group of its first slice (ring slot `slot`); `finish(item, acc)`
// runs after its last product, on every thread (it may synchronise), and
// the accumulators (f32, int32 for int8) are zeroed after it. `vec_x`,
// `vec_w`: x's and w's rows take 16-byte copies. At most kStages items
// are in flight at once, so an item's `extra` data may be kept in buffer
// idx % kStages.
template <typename T, int BM, int BN, class Extra, class Finish>
__device__ __forceinline__ void fwd_walk(const T* x, const T* w, int M, int K,
                                         int N, int tiles_n, int tiles,
                                         bool vec_x, bool vec_w,
                                         unsigned char* smem, Extra extra,
                                         Finish finish) {
  using C = FwdCfg<T, BM, BN>;
  using G = typename C::G;
  using A = typename Acc<T>::type;
  static_assert(G::NI % C::F == 0, "a warp's columns are not whole runs");
  const int slices = (K + C::BK - 1) / C::BK;
  auto item_at = [&](int j) {
    const int q = blockIdx.x + j * gridDim.x;
    FwdItem it;
    it.tm = q / tiles_n;
    it.m0 = it.tm * BM;
    it.n0 = (q % tiles_n) * BN;
    it.idx = j;
    it.slices = slices;
    return it;
  };
  auto xs = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * C::kStage);
  };
  auto stage_in = [&](int slot, const FwdItem& it, int i) {
    const int k0 = i * C::BK;
    load_tile<T, BM, C::BK>(xs(slot), C::SX, x, K, it.m0, M, k0, K, vec_x);
    load_tile<T, C::BK, BN>(xs(slot) + BM * C::SX, C::SN, w, N, k0, K, it.n0,
                            N, vec_w);
    if (i == 0) extra(slot, it);
  };
  const int warp = threadIdx.x / 32;
  const int rb = (warp / G::WC) * G::MI * 16;
  const int cb = (warp % G::WC) * G::NI * 8;
  A acc[G::MI][G::NI][4] = {};
  auto product = [&](int slot, const FwdItem&, int) {
    const FwdOps<T, C, G::MI, G::NI> op{xs(slot), xs(slot) + BM * C::SX};
    Slice<T>::template run<G::MI, G::NI>(op, rb, cb, acc);
  };
  auto done = [&](const FwdItem& it) {
    finish(it, acc);
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = A(0);
      }
    }
  };
  const int n = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                (int)gridDim.x;
  walk(n, item_at, stage_in, product, done);
}

// A matrix's rows take load_tile's 16-byte copies only where its base is
// 16-byte aligned (and its row length a multiple of 16 bytes, which the
// caller checks).
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The launch of a forward product: tile BM × BN, tiles_m × tiles_n tiles,
// `blocks` persistent blocks (one per SM, at most one per tile).
struct FwdPlan {
  int bm, bn, tiles_m, tiles_n, blocks;
};

// The tile of (M, K, N) on `sms` SMs: the one whose walk a model finds
// shortest. The busiest block walks ceil(tiles / sms) tiles of
// (slices + kItem) slice times; a slice time grows with the tile's area,
// and per output a small tile costs more (its warps read more shared
// memory and split more values per product). kCost is the H100's, fitted
// to the f32 times of every tile at ResNet-50's 15 shapes: a tile that
// leaves SMs idle can still win (res4 _a's 98 tiles of 128 × 128 beat 196
// of 128 × 64 on all 132 SMs), and a K split is reckoned not to pay for
// its partials' traffic at these shapes. The plan depends on the shape
// and the card alone, so a re-run gives the same bits. `bk`: the slice
// depth (kBK8 for int8).
inline FwdPlan fwd_plan_on(int M, int K, int N, int sms, int bk) {
  constexpr int kTiles[4][2] = {{128, 128}, {128, 64}, {64, 128}, {64, 64}};
  constexpr double kCost[4] = {1.0, 1.17, 1.2, 1.52};  // per output
  constexpr double kItem = 0.5;                         // the epilogue
  const long long slices = (K + bk - 1) / bk;
  FwdPlan best{};
  double best_t = -1.0;
  for (int c = 0; c < 4; ++c) {
    const int bm = kTiles[c][0], bn = kTiles[c][1];
    const long long tm = (M + bm - 1) / bm, tn = (N + bn - 1) / bn;
    const long long tiles = tm * tn;
    const long long rounds = (tiles + sms - 1) / sms;
    const double t = rounds * (slices + kItem) * kCost[c] * bm * bn /
                     (128.0 * 128.0);
    if (best_t < 0.0 || t < best_t) {
      best_t = t;
      best = FwdPlan{bm, bn, (int)tm, (int)tn,
                     (int)(tiles < sms ? tiles : sms)};
    }
  }
  return best;
}

// The current device's SMs.
inline int sm_count() {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    sms = 132;
  return sms;
}

// fwd_plan_on the current device.
inline FwdPlan fwd_plan(int M, int K, int N, int bk = kBK) {
  return fwd_plan_on(M, K, N, sm_count(), bk);
}

}  // namespace mma
}  // namespace dl4j
