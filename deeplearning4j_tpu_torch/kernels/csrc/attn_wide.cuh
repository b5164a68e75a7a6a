// The wide attention tile of flash_fwd.cuh and flash_bwd_dq.cuh (head
// dims past 128) on Hopper: a block of two consumer warpgroups and a
// producer warpgroup whose first warp keeps TMA loads in flight.
//
// A block covers one (b·h), a tile of kRows = 64 query rows (wgmma's M)
// and a group of output columns: kCpb = 2 128-column chunks of D, G = 256
// (`kCpw`'s note). A wider D splits its output chunks over grid z, so the
// score products run D/G times, once wherever D ≤ G.
// - Scores once per key tile: the two warpgroups split the contraction of
//   S = Q·Kᵀ (and dQ's dP = dO·Vᵀ) over D's chunks, chunk c to warpgroup
//   c mod 2. Each writes its partial sum (started from zero) to shared
//   memory and adds the other's in f32, rounded to nearest (`exchange`);
//   f32 addition commutes, so both hold the same S and reach the same m
//   and l. Warpgroup w then owns output chunks oc0 + w, oc0 + w + 2, … and
//   multiplies only those: O += P·V or dQ += dS·K, with P or dS taken from
//   the score registers as the A operand. Each output element has one
//   owner and one order of summation, so re-runs give the same bits.
// - Operands read once: Q (and dQ's dO) come from device memory once per
//   block and stay in shared memory for the walk wherever they fit beside
//   the ring (`plan`); where they do not, every key tile restages their
//   chunks from L2 next to K's (and V's) slice. K and V arrive in slices
//   of BK keys × 128 columns through a ring of stages, which one producer
//   warp fills by TMA (tensor maps built by the C entry point, 128-byte
//   swizzle), each stage completing on an mbarrier; the consumers release
//   a stage by an mbarrier of their own once its products have read it.
// - Tensor cores: bf16 on wgmma (m64nBKk16 for the scores with Q and K
//   from shared memory, m64n128k16 for P·V and dS·K with the probabilities
//   in registers and V or K read MN-major through the descriptor's
//   transpose). f32 keeps 3×TF32 on mma.sync (a warp per 16 rows of the
//   64), reading the swizzled tiles itself: tf32 wgmma takes both operands
//   K-major and 19 bits wide, so 3×TF32 there needs TF32 hi and lo copies
//   of K and of V transposed, which the threads would have to write to
//   shared memory every key tile beside Q's 64 × D (64 KB at D = 256); the
//   ring, Q and the exchange already take the 227 KB.
// - Every role walks the same key tiles (`Schedule`): a tile none of whose
//   keys is valid is skipped once the block's first row has seen a valid
//   key (then every row has, and the tile's p are exactly 0 and alpha
//   exactly 1), and in dQ unless a row of the block is degenerate
//   (lse ≤ −1e29); causal tiles past the block's last row are never
//   loaded. A fully padded example walks every tile and comes out as the
//   mean of V, as the plain version gives it.
#pragma once

#include <cuda.h>

#include "attn_tile.cuh"

namespace dl4j {
namespace wide {

constexpr int kChunk = 128;                  // columns of D a slice holds
constexpr int kRows = 64;                    // query rows a block
constexpr int kGroups = 2;                    // consumer warpgroups
constexpr int kThreads = 128 * (kGroups + 1);  // and the producer's
constexpr int kProducerWarp = 4 * kGroups;     // its first warp loads
constexpr int kMaxStages = 16;
// Output chunks a consumer warpgroup owns: its O (or dQ) accumulator is
// 64 × 128·kCpw f32, 64·kCpw registers a thread. bf16 could own two
// (G = 512), but ptxas allocates the consumers within the 168 registers a
// 384-thread launch starts with, and the 128-register accumulator beside S
// spilled ~760 bytes a thread to local memory (L2, with 227 KB taken as
// shared memory), which slowed every step of a key tile (wide_trace.py):
// one chunk a warpgroup, G = 256, in both dtypes.
constexpr int kCpw = 1;
constexpr int kCpb = kGroups * kCpw;  // output chunks a block
constexpr size_t kSmemMax = 232448;          // 227 KB a block
constexpr size_t kFixed = 2048;              // barriers, base alignment

// -- the plan (host) ----------------------------------------------------------
// The shared-memory budget of one launch: [barriers][exchange][resident Q
// (and dO)][ring of `stages` stages], each region 1024-byte aligned (the
// 128-byte swizzle's period).
struct Plan {
  int bk;           // keys a tile
  int cpb;          // output chunks a block
  int resident;     // Q (and dO) stay in shared memory for the walk
  int stages;
  int stage_bytes;  // a K or V slice (and, restaged, a Q or dO chunk)
  int xbuf_bytes;   // the exchange: `arrays` × 2 warpgroups × 64 × BK f32
  int q_bytes;      // the resident region
  int z;            // blocks along grid z
  size_t smem;
};

// esz: bytes a value; arrays: 1 (S) or 2 (S and dP: dQ, which also keeps
// dO and holds each K slice of its output chunks until dS·K has read it,
// `hold`). Each warpgroup waits on its slices in the ring's order and
// holds at most one more (bf16: the slice its last product group still
// reads), so held + 2 stages (bf16 held + 3) never stall; Q stays
// resident when the ring beside it still has that many.
inline Plan plan(int esz, int bk, int cpb, int arrays, bool hold, int DC) {
  Plan p{};
  p.bk = bk;
  p.cpb = cpb;
  const int slice = bk * kChunk * esz;
  const int qchunk = kRows * kChunk * esz;
  p.xbuf_bytes = arrays * kGroups * kRows * bk * 4;
  const long fixed = (long)kFixed + p.xbuf_bytes;
  const int need = (hold ? cpb : 0) + (esz == 2 ? 3 : 2);
  const long qres = (long)DC * qchunk * arrays;
  const long room = (long)kSmemMax - fixed - qres;
  int ns = room > 0 ? (int)(room / slice) : 0;
  if (ns >= need) {
    p.resident = 1;
    p.stage_bytes = slice;
    p.q_bytes = (int)qres;
  } else {
    p.stage_bytes = slice + qchunk;
    ns = (int)(((long)kSmemMax - fixed) / p.stage_bytes);
  }
  p.stages = ns < kMaxStages ? ns : kMaxStages;
  if (p.stages < need) p.stages = 0;  // the launch refuses it
  p.smem = fixed + p.q_bytes + (size_t)p.stages * p.stage_bytes;
  p.z = (DC + cpb - 1) / cpb;
  return p;
}

// The operands' tensor maps: (BH, T, D) row-major as a 3-D tensor, boxes
// of 128 bytes × `rows` rows with the 128-byte swizzle; rows past T read
// as zeros.
struct Maps {
  CUtensorMap q, k, v, g;
};

inline bool encode(CUtensorMap* map, const void* base, int esz, int D, int T,
                   int BH, int rows) {
  cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  cuuint64_t strides[2] = {(cuuint64_t)D * esz, (cuuint64_t)T * D * esz};
  cuuint32_t box[3] = {(cuuint32_t)(128 / esz), (cuuint32_t)rows, 1};
  cuuint32_t unit[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map,
             esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             3, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// -- tracing ----------------------------------------------------------------------
// Built with -DDL4J_WIDE_TRACE (kernels/wide_trace.py), one block of the
// forward stamps clock64() at each step of its walk into a device array
// that dl4j_wide_trace copies out; the libraries the wrappers load are
// built without it.
#ifdef DL4J_WIDE_TRACE
__device__ unsigned long long g_wide_trace[4096];
__device__ int g_wide_trace_x;
#define WIDE_TRACE(slot)                                                    \
  do {                                                                      \
    if (blockIdx.x == ::dl4j::wide::g_wide_trace_x && blockIdx.y == 0 && \
        blockIdx.z == 0)                                                    \
      ::dl4j::wide::g_wide_trace[(slot) & 4095] = clock64();               \
  } while (0)
#else
#define WIDE_TRACE(slot) \
  do {                   \
  } while (0)
#endif

// -- barriers and copies --------------------------------------------------------
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait of more
// than 2^34 cycles (about 10 s) is a fault of the schedule: trap, so the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Rows [r0, r0 + rows) × columns [128c, 128c + 128) of (b·h) `bh`: the
// chunk's boxes one after another, each rows × 128 bytes.
template <typename T>
__device__ __forceinline__ void load_chunk(unsigned char* dst,
                                           const CUtensorMap* map,
                                           uint64_t* bar, int c, int r0,
                                           int bh, int rows) {
  constexpr int E = 128 / (int)sizeof(T);  // values a box row
#pragma unroll
  for (int b = 0; b < kChunk / E; ++b)
    tma_load(dst + b * rows * 128, map, bar, c * kChunk + b * E, r0, bh);
}

// The producer warpgroup gives back registers, the consumer warpgroups
// take them (a launch of 384 threads starts at 168 a thread): 128 × 40 +
// 256 × 232 = 64,512 of the SM's 65,536. The pool is what the producer's
// four warps release, so the producer is a whole warpgroup (a lone warp
// would release a quarter and the consumers would wait for ever); its
// first warp loads, the other three leave.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(128 * kGroups)
               : "memory");
}

// The block's shared memory, carved as `plan` laid it out.
struct Smem {
  uint64_t* full;
  uint64_t* empty;
  uint64_t* qbar;
  float* xbuf;
  unsigned char* qres;
  unsigned char* ring;
  int stages, stage_bytes;

  __device__ Smem(unsigned char* raw, const Plan& p) {
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    full = reinterpret_cast<uint64_t*>(base);
    empty = full + kMaxStages;
    qbar = empty + kMaxStages;
    xbuf = reinterpret_cast<float*>(base + 1024);
    qres = base + 1024 + p.xbuf_bytes;
    ring = qres + p.q_bytes;
    stages = p.stages;
    stage_bytes = p.stage_bytes;
  }

  // One thread: a full barrier per stage (the producer's arrival and the
  // TMA bytes), an empty barrier per stage (one arrival per warp of the
  // consuming warpgroup), and Q's.
  __device__ void init() {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // slice n of the walk (every role counts every slice)
  __device__ unsigned char* stage(int n) const {
    return ring + (size_t)(n % stages) * stage_bytes;
  }
  __device__ void wait(int n) const {
    mbar_wait(full + n % stages, (n / stages) & 1);
  }
  // a warp of the consuming warpgroup is done with slice n
  __device__ void release(int n) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + n % stages);
  }
  // the producer's lane 0: wait for slice n's stage to be free, then
  // announce `bytes` on its full barrier; returns the stage
  __device__ unsigned char* acquire(int n, uint32_t bytes) const {
    mbar_wait(empty + n % stages, ((n / stages) & 1) ^ 1);
    mbar_expect(full + n % stages, bytes);
    return stage(n);
  }
  __device__ uint64_t* bar(int n) const { return full + n % stages; }
};

// -- the walk -------------------------------------------------------------------
// Which key tiles the block visits, the same in every role (each warp
// reads the key mask itself). `always`: dQ with a degenerate row.
template <int BK>
struct Schedule {
  const uint8_t* mask;
  int Tk, q0, causal;
  bool always;
  bool seen = false;  // the block's first row has seen a valid key
  attn::Keys<BK> next;  // the next tile's keys, read a tile ahead

  // kt = 0, 1, 2, … in turn
  __device__ bool visit(int kt, uint64_t& bits) {
    if (kt == 0) next.load(mask, Tk, 0);
    bits = next.bits();
    next.load(mask, Tk, (kt + 1) * BK);
    const bool go = always || bits != 0 || !seen;
    if (go && !seen && bits != 0) {
      // under causality row q0 sees keys up to q0 (later rows see more)
      const int last = q0 - kt * BK;
      seen = !causal || last >= BK - 1 ||
             (last >= 0 && (bits & ((2ull << last) - 1)) != 0);
    }
    return go;
  }
};

// Hand S (and dP) over between the warpgroups: each writes its partial,
// then adds the other's. The thread at the same place of the other
// warpgroup holds the same rows and keys, so the exchange keeps the
// fragments' order (a float4 per thread and 8-key block). Barrier 2 first
// waits for both to have read the previous tile's partials.
template <int NJ>
__device__ __forceinline__ void exchange(float (&s)[NJ][4], float* xbuf,
                                         float (*dp)[4] = nullptr) {
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  float4* x = reinterpret_cast<float4*>(xbuf);
  constexpr int A = NJ * 128;  // float4s a warpgroup's partial
  bar_sync(2);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    x[wg * A + j * 128 + tid] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    if (dp)
      x[(2 + wg) * A + j * 128 + tid] =
          make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
  }
  bar_sync(1);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float4 o = x[(1 - wg) * A + j * 128 + tid];
    s[j][0] += o.x;
    s[j][1] += o.y;
    s[j][2] += o.z;
    s[j][3] += o.w;
    if (dp) {
      const float4 e = x[(3 - wg) * A + j * 128 + tid];
      dp[j][0] += e.x;
      dp[j][1] += e.y;
      dp[j][2] += e.z;
      dp[j][3] += e.w;
    }
  }
}

// -- bf16: wgmma ------------------------------------------------------------------
// A shared-memory matrix descriptor with the 128-byte swizzle; lbo and sbo
// in 16-byte units.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | (uint64_t)lbo << 16 |
         (uint64_t)sbo << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving register reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e]));
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e]));
}

// d (+)= A·B, m64n32k16, A and B from shared memory (both K-major)
__device__ __forceinline__ void mma_ss_n32(float (&d)[4][4], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A·B, m64n64k16, A and B from shared memory (both K-major)
__device__ __forceinline__ void mma_ss_n64(float (&d)[8][4], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A·B, m64n128k16, A from registers (the mma.sync A layout per
// warp), B from shared memory MN-major (transposed)
__device__ __forceinline__ void mma_rs_n128(float (&d)[16][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BK>
__device__ __forceinline__ void mma_ss(float (&d)[BK / 8][4], uint64_t a,
                                       uint64_t b, int accumulate) {
  if constexpr (BK == 64)
    mma_ss_n64(d, a, b, accumulate);
  else
    mma_ss_n32(d, a, b, accumulate);
}

// Issue s (+)= A·Kᵀ over one 128-column chunk: A the chunk's 64 rows (two
// boxes of 64 × 64), K's slice BK keys (two boxes of BK × 64), both
// K-major; a k16 step moves 32 bytes along the swizzled row, the fifth
// step to the second box. `accumulate` false starts s from zero. The
// caller fences before and commits and waits after a warpgroup's chunks.
template <int BK>
__device__ __forceinline__ void scores_bf16(const __nv_bfloat16* a,
                                            const __nv_bfloat16* ks,
                                            float (&s)[BK / 8][4],
                                            bool accumulate) {
  // a step's descriptors: the base's plus its byte offset / 16
  const uint64_t da = desc(a, 1, 64), db = desc(ks, 1, 64);
#pragma unroll
  for (int st = 0; st < kChunk / 16; ++st) {
    const int box = st / 4, in = (st % 4) * 32;  // bytes
    mma_ss<BK>(s, da + ((box * kRows * 128 + in) >> 4),
               db + ((box * BK * 128 + in) >> 4),
               (accumulate || st > 0) ? 1 : 0);
  }
}

// acc += P·X over a slice X of BK keys × 128 columns (two boxes of
// BK × 64), read MN-major: a k16 step is 16 key rows further (2 KB), the
// second 64 columns one box further (LBO), 8 keys apart SBO = 1 KB. P is
// the score fragments packed to bf16 (the mma.sync A layout per warp).
template <int BK>
__device__ __forceinline__ void accumulate_bf16(
    uint32_t (&pa)[BK / 16][4], const __nv_bfloat16* xs,
    float (&acc)[16][4]) {
  keep(acc);
  keep(pa);
  wg_fence();
  const uint64_t db = desc(xs, BK * 8, 64);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    mma_rs_n128(acc, pa[kk], db + ((kk * 16 * 128) >> 4));
  wg_commit();
  wg_wait();
  keep(acc);
  keep(pa);
}

// The score fragments as the A fragments of the k16 steps over BK keys.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&p)[BK / 8][4],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = mma::pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = mma::pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = mma::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = mma::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// -- f32: 3×TF32 on mma.sync over the swizzled tiles ------------------------------
// A tile of R rows × 128 f32 columns is four boxes of R × 32: value (r, c)
// lies at float (c / 32)·32R + 32r + 4·(((c / 4) % 8) XOR (r % 8)) + c % 4,
// the 16-byte groups swizzled by the row's low three bits. The fragment
// reads below meet no bank conflict.

// s = A·Kᵀ over one chunk (`first`), else s += it, for the warp's 16 rows
// `wr`.. of the chunk's 64 (A times `mul`, as the JAX kernel scales q);
// the chunk's products start from zero and are added in f32, as
// attn::scores_chunk does. Every row this thread reads (wr + g, wr + g + 8,
// 8j + g) has g as its low three bits, so the swizzle is one XOR of the
// step's 16-byte group with g·4: each read is a base pointer plus a
// constant and that XOR.
template <int BK>
__device__ __forceinline__ void scores_f32(const float* a, float mul,
                                           const float* ks,
                                           float (&s)[BK / 8][4], bool first,
                                           int wr) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int g4 = g << 2;
  const float* a0 = a + (wr + g) * 32 + t;  // rows wr + g, then + 8
  const float* k0 = ks + g * 32 + t;        // rows 8j + g
  float part[BK / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    // columns 8kk + t and 8kk + t + 4: box kk / 4, groups 2(kk % 4) (+1)
    const int lo = ((8 * (kk & 3)) ^ g4), hi = ((8 * (kk & 3) + 4) ^ g4);
    const int ab = (kk >> 2) * kRows * 32, kb = (kk >> 2) * BK * 32;
    uint32_t ah[4], al[4];
    mma::split(a0[ab + lo] * mul, ah[0], al[0]);
    mma::split(a0[ab + 256 + lo] * mul, ah[1], al[1]);
    mma::split(a0[ab + hi] * mul, ah[2], al[2]);
    mma::split(a0[ab + 256 + hi] * mul, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      uint32_t bh[2], bl[2];
      mma::split(k0[kb + 256 * j + lo], bh[0], bl[0]);
      mma::split(k0[kb + 256 * j + hi], bh[1], bl[1]);
      mma::mma_tf32(part[j], al, bh);
      mma::mma_tf32(part[j], ah, bl);
      mma::mma_tf32(part[j], ah, bh);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = first ? part[j][e] : s[j][e] + part[j][e];
}

// acc += P·X over a slice X (BK keys × 128 columns), P in the score
// layout with the contraction relabelled as attn::accumulate's. Each
// 8-key step's three products start from zero and are added to acc in f32
// (rounded to nearest, attn::accumulate's kRound), so no second
// accumulator is needed to keep the tensor cores' truncating chain short.
// The thread reads rows 8j + 2t (+1) at columns 8n + g: with those rows'
// low bits 2t (+1), the group for column block n is (8(n % 4) + (g / 4)·4)
// XOR (2t + p)·4, which is 8(n % 4) XOR q_p with q_p fixed per thread.
template <int BK>
__device__ __forceinline__ void accumulate_f32(const float (&p)[BK / 8][4],
                                               const float* xs,
                                               float (&acc)[16][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* x0 = xs + 2 * t * 32 + (g & 3);  // row 8j + 2t, then + 1
  const int q0 = ((g >> 2) << 2) ^ (2 * t << 2);
  const int q1 = ((g >> 2) << 2) ^ ((2 * t + 1) << 2);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    uint32_t ah[4], al[4];
    mma::split(p[j][0], ah[0], al[0]);
    mma::split(p[j][2], ah[1], al[1]);
    mma::split(p[j][1], ah[2], al[2]);
    mma::split(p[j][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int nb = (n >> 2) * BK * 32 + 256 * j;
      uint32_t bh[2], bl[2];
      mma::split(x0[nb + ((8 * (n & 3)) ^ q0)], bh[0], bl[0]);
      mma::split(x0[nb + 32 + ((8 * (n & 3)) ^ q1)], bh[1], bl[1]);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma::mma_tf32(c, al, bh);
      mma::mma_tf32(c, ah, bl);
      mma::mma_tf32(c, ah, bh);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += c[e];
    }
  }
}

// -- launch -----------------------------------------------------------------------
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, const Plan& p, int BH, int Tq,
                   cudaStream_t stream, Args... args) {
  if (p.stages == 0 || BH > 65535 || p.z > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kRows - 1) / kRows, BH, p.z);
  kernel<<<grid, kThreads, p.smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace dl4j

#ifdef DL4J_WIDE_TRACE
extern "C" int dl4j_wide_trace(void* dst, int x) {
  if (dst == nullptr)
    return cudaMemcpyToSymbol(dl4j::wide::g_wide_trace_x, &x, sizeof(int));
  return cudaMemcpyFromSymbol(dst, dl4j::wide::g_wide_trace,
                              sizeof(dl4j::wide::g_wide_trace));
}
#endif
