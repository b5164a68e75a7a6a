// A tensor-core tile engine for Hopper: mma.sync products fed from a ring
// of shared-memory stages that cp.async fills ahead of the math.
//
// A block of 256 threads (8 warps) owns a BM × BN output tile (BM, BN in
// {64, 128}) and walks the contraction in slices of kBK = 32. Each slice's
// raw operand tiles land in one of kStages stages of shared memory, so the
// loads of slice s + 2 are in flight while slice s is multiplied
// (`walk`, which carries the ring across the block's work items). The caller builds each step's register fragments itself
// (`Slice`'s `op.frags`), so it may compute on the raw values on the way
// (the BN gradient forms its dy there) and pick which shared-memory
// element feeds which fragment slot, to read pairs as 64-bit words.
//
// Two routes, by the operand type T:
// - bf16: mma.sync.m16n8k16 bf16 × bf16 → f32. The product of two bf16
//   values is exact in f32, so only the order of the sum differs from a
//   plain f32 product of the same values.
// - f32: 3×TF32 (CUTLASS's OpMultiplyAddFastF32). Each operand is split
//   into a TF32 hi (rounded to nearest, as cvt.rna.tf32.f32 rounds) and a
//   TF32 lo (the remainder, truncated), and a·b accumulates as
//   a_lo·b_hi + a_hi·b_lo + a_hi·b_hi through mma.sync.m16n8k8 tf32 in f32:
//   about 2^-21 relative error per product, f32's accuracy. One TF32 pass
//   (about 2^-11) would not hold an f32 gradient to f32.
#pragma once

#include "common.cuh"

namespace dl4j {
namespace mma {

constexpr int kThreads = 256;
constexpr int kBK = 32;      // contraction values per slice
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

// Stage a ROWS × COLS tile of a row-major matrix g (row stride gs) from
// (r0, c0) into shared memory s (row stride ss elements). Rows ≥ r_end and
// columns ≥ c_end stage as zeros; nothing outside them is read. `vec`: the
// rows are 16-byte aligned and c_end, c0 are multiples of 16 bytes, so a
// 16-byte chunk is wholly in or wholly out.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* s, int ss, const T* g,
                                          long long gs, int r0, int r_end,
                                          int c0, int c_end, bool vec) {
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
      const bool in = r0 + r < r_end && c0 + c < c_end;
      const T* src = in ? g + (size_t)(r0 + r) * gs + c0 + c : g;
      cp16(s + r * ss + c, src, in);
    }
  } else {
    static_assert(ROWS * COLS % kThreads == 0, "tile not a whole number of "
                                               "element rounds");
#pragma unroll 4
    for (int i = 0; i < ROWS * COLS / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / COLS, c = idx % COLS;
      const bool in = r0 + r < r_end && c0 + c < c_end;
      const T* src = in ? g + (size_t)(r0 + r) * gs + c0 + c : g;
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
// PTX ISA's m16n8k8 (f32: values) or m16n8k16 (bf16: packed pairs)
// layouts; which shared-memory element stands behind each fragment slot
// is the caller's choice, as long as A's and B's contraction orders agree
// and its epilogue maps the accumulators back the same way.
template <typename T>
struct Slice;

template <>
struct Slice<float> {
  template <int MI, int NI, class Ops>
  __device__ __forceinline__ static void run(const Ops& op, int rb, int cb,
                                             float (&acc)[MI][NI][4]) {
    // this slice's sum, added to acc in f32: the tensor cores' own
    // accumulation drifts over thousands of steps (at N = 2,048 it came
    // near the f32 gate when acc took every step); a sum per slice (12
    // mma steps) keeps the error at a plain f32 product's
    float sum[MI][NI][4] = {};
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
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
  template <int MI, int NI, class Ops>
  __device__ __forceinline__ static void run(const Ops& op, int rb, int cb,
                                             float (&acc)[MI][NI][4]) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
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

// The pipelined walk of a block over its items, one after another through
// one ring, so the copies of the next item's first slices overlap the
// current item's last products and its epilogue. `item_at(j)` describes
// item j < n (its `slices` and whatever the callbacks need; computed once
// per item on each side of the ring); `stage_in(slot, item, i)` issues the
// copies of the item's slice i into ring slot `slot`; `product(slot, item,
// i)` multiplies it; `finish(item)` runs after the item's last product
// (registers and device memory only, not the ring). One commit group per
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

}  // namespace mma
}  // namespace dl4j
