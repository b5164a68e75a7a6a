// Single-query decode attention on Hopper: for each (b, h), one query row
// attends a (C, D) K/V cache under a (B, C) cache-validity mask. Rows with
// no valid key come back as zeros.
//
// Replaces: the decode shape of
// deeplearning4j_tpu/kernels/flash_attention.py::_flash_fwd_kernel (:42),
// which flash_attention_decode(impl="pallas") (:645-650) drives with the
// one query padded into a 128-row tile.
//
// What bounds it on the H100: a decode step reads every valid cache row
// once and does 4·D operations per row, about one operation per byte in
// f32. That is far below the card's ~295 operations per byte, so the
// bytes of the K/V cache (3.35 TB/s) bound it. At the serving shape (8
// slots × 12 heads, C ≤ 512, D = 64) they are a few MB, which the card
// moves in about 3 µs: what a kernel must hide is the latency of its loads.
//
// Design: one launch, a thread-block cluster per (b, h).
// - The cluster's CS CTAs (2, 4 or 8: `cluster_size`, so that B·H·CS
//   reaches every SM and the CTAs take few passes) split the cache rows
//   into contiguous shares.
// - A CTA of 4 warps reads its share in passes of kPass rows. Lanes read
//   16-byte vectors: a row of D = 64 is 16 lanes in f32 and 8 in bf16, so
//   one warp instruction covers 2 or 4 rows, and shuffles over a row's
//   lanes finish its dot product. A row narrower than a warp's 32 vectors
//   takes D/E lanes (E = 4 f32 or 8 bf16 values a vector): D = 8 is 2
//   lanes in f32 and 1 in bf16, 16 or 32 rows an instruction. A row of
//   more than 32 vectors (D ≥ 256 in f32, 512 in bf16) takes the whole
//   warp, each lane V = D/(32·E) vectors of it and their slice of the
//   accumulator; a lane then keeps kLoads/V rows in flight instead of
//   kLoads, so a pass still holds kLoads vectors of K and of V a lane and
//   kPass stays 4·kLoads·32·16 / (D·esz) rows. Each lane issues all
//   kLoads K and V vectors of a pass before it consumes any, and the
//   next pass's mask
//   bytes are read while this pass's rows are in flight: a pass costs one
//   load latency, not two per row group. Masked rows are never read.
// - Each warp keeps its running max, sum and accumulator; the CTA merges
//   its 4 warps in shared memory, and the cluster's leader merges the CTAs'
//   partials in rank order through distributed shared memory between two
//   cluster barriers, with every remote read in flight at once (read one
//   rank after another, their round trips made 8 the slowest cluster size
//   at every shape). A CTA whose share has no valid row contributes
//   m = −inf and is skipped. One launch per call, and a fixed order of
//   every sum: re-runs are bit-identical, and serving's launches per
//   decode step are those of a one-CTA kernel.
// - Head dims: D = 8, 16, 32, 64, 128, 256, 512 and 1024 have their own
//   instantiation. Any other D ≤ 1024 runs ragged (`kRagged`) in the next
//   one's geometry: the cache keeps its row stride dt (the true D), a lane
//   reads its vector value by value with the columns past dt as zeros, and
//   only dt columns are written. Nothing is padded or copied: zero-padding
//   the (B, H, C, D) cache would copy all of it on every decode step.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace dl4j {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kLoads = 8;        // K and V vectors a lane keeps in flight
constexpr int kMaxCluster = 8;   // the portable cluster size

// A 16-byte vector of T as floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int E = 4;
  using Raw = uint32_t;
  __device__ __forceinline__ static void get(const uint4& u, float (&x)[4]) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  using Raw = uint16_t;
  __device__ __forceinline__ static void get(const uint4& u, float (&x)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// The 16-byte vector of `row` from column `col` on: one load, or (ragged)
// value by value, the columns ≥ dt read as zeros (zero bits are 0.0 in both
// types).
template <typename T, bool kRagged>
__device__ __forceinline__ uint4 load_vec(const T* row, int col, int dt) {
  if constexpr (!kRagged) {
    return *reinterpret_cast<const uint4*>(row + col);
  } else {
    using Raw = typename Vec<T>::Raw;
    constexpr int E = Vec<T>::E;
    const Raw* src = reinterpret_cast<const Raw*>(row);
    uint32_t x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = col + e < dt ? src[col + e] : 0u;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = E == 4 ? x[i] : x[(2 * i) % E] | x[(2 * i + 1) % E] << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Rows a CTA reads in one pass: kLoads 16-byte vectors a lane, a row of
// D elements of `esz` bytes taking D·esz/16 vectors.
constexpr int pass_rows(int esz, int D) {
  return kWarps * kLoads * 32 * 16 / (D * esz);
}

// Vectors per cache row, lanes per row, vectors a lane holds of each row,
// rows per warp instruction, rows a lane keeps in flight, rows per CTA
// pass.
template <typename T, int D>
struct Geo {
  static constexpr int E = Vec<T>::E;
  static constexpr int CH = D / E;
  static constexpr int LPR = CH < 32 ? CH : 32;
  static constexpr int V = CH / LPR;
  static constexpr int RPI = 32 / LPR;
  static constexpr int NR = kLoads / V;
  static constexpr int kPass = kWarps * NR * RPI;
  static_assert(CH >= 1 && CH % LPR == 0 && 32 % LPR == 0 && NR >= 1 &&
                    NR * V == kLoads && kPass == pass_rows(sizeof(T), D),
                "head dim must be a power of two from 8 to 1024");
};

template <typename T, int D, bool kRagged>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    T* __restrict__ o, int H, int C, int dt, float scale) {
  using G = Geo<T, D>;
  constexpr int E = G::E, LPR = G::LPR, V = G::V, RPI = G::RPI, NR = G::NR;
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ __align__(16) float sm_acc[kWarps][D];
  // the CTA's partial, which the cluster's leader reads
  __shared__ float part_m, part_l;
  __shared__ float part_acc[D];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / cs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % LPR;  // the lane's first vector of a row
  const int grp = lane / LPR;  // the lane's row within an instruction
  const int ld = kRagged ? dt : D;  // the row stride

  const int share = (C + cs - 1) / cs;
  const int c_begin = min(C, rank * share);
  const int c_end = min(C, c_begin + share);

  // the lane's vectors of a row: columns (j·LPR + sub)·E, j < V
  float qv[V][E];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    Vec<T>::get(load_vec<T, kRagged>(q + (size_t)bh * ld,
                                     (j * LPR + sub) * E, dt),
                qv[j]);
#pragma unroll
    for (int e = 0; e < E; ++e) qv[j][e] *= scale;
  }
  float acc[V][E] = {};
  float m = neg_inf(), l = 0.f;  // m is uniform over the warp

  const T* kb = k + (size_t)bh * C * ld;
  const T* vb = v + (size_t)bh * C * ld;
  const uint8_t* mb = mask + (size_t)(bh / H) * C;
  auto row = [&](int pass, int i) {
    return c_begin + ((pass * kWarps + warp) * NR + i) * RPI + grp;
  };
  bool ok[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = row(0, i);
    ok[i] = r < c_end && mb[r] != 0;
  }

  for (int pass = 0; c_begin + pass * G::kPass < c_end; ++pass) {
    uint4 kx[NR][V], vx[NR][V];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const size_t off = (size_t)row(pass, i) * ld;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int col = (j * LPR + sub) * E;
        kx[i][j] = ok[i] ? load_vec<T, kRagged>(kb + off, col, dt)
                         : make_uint4(0, 0, 0, 0);
        vx[i][j] = ok[i] ? load_vec<T, kRagged>(vb + off, col, dt)
                         : make_uint4(0, 0, 0, 0);
      }
    }
    bool next[NR];  // the next pass's mask bytes, while these land
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = row(pass + 1, i);
      next[i] = r < c_end && mb[r] != 0;
    }

    float s[NR];
    float mx = m;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float x[E];
        Vec<T>::get(kx[i][j], x);
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qv[j][e], x[e], dot);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off /= 2)
        dot += __shfl_xor_sync(kFull, dot, off);
      s[i] = ok[i] ? dot : neg_inf();
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int off = LPR; off < 32; off *= 2)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    if (mx != neg_inf()) {  // uniform over the warp
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int j = 0; j < V; ++j) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float p = expf(s[i] - mx);
        l += p;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float x[E];
          Vec<T>::get(vx[i][j], x);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[j][e] = fmaf(p, x[e], acc[j][e]);
        }
      }
      m = mx;
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) ok[i] = next[i];
  }

  // the warp's sum and accumulator over its row lanes
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
    l += __shfl_xor_sync(kFull, l, off);
#pragma unroll
    for (int j = 0; j < V; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[j][e] += __shfl_xor_sync(kFull, acc[j][e], off);
    }
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (lane < LPR) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        sm_acc[warp][(j * LPR + lane) * E + e] = acc[j][e];
    }
  }
  __syncthreads();

  // the CTA's partial: its warps merged in order (one pass of the loop for
  // D ≤ 128)
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mc = neg_inf();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mc = fmaxf(mc, sm_m[w]);
    float den = 0.f, num = 0.f;
    if (mc != neg_inf()) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (sm_m[w] == neg_inf()) continue;
        const float f = expf(sm_m[w] - mc);
        den = fmaf(sm_l[w], f, den);
        num = fmaf(sm_acc[w][d], f, num);
      }
    }
    part_acc[d] = num;
    if (d == 0) {
      part_m = mc;
      part_l = den;
    }
  }
  cluster.sync();  // every CTA's partial is in its shared memory

  // the leader merges the CTAs' partials in rank order, all of their
  // remote reads issued before any is used (one pass for D ≤ 128)
  for (int d = threadIdx.x; rank == 0 && d < D; d += kThreads) {
    float pm[kMaxCluster], pl[kMaxCluster], pa[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      pm[r] = neg_inf();
      if (r < cs) {
        pm[r] = *cluster.map_shared_rank(&part_m, r);
        pl[r] = *cluster.map_shared_rank(&part_l, r);
        pa[r] = cluster.map_shared_rank(part_acc, r)[d];
      }
    }
    float mx = neg_inf();
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) mx = fmaxf(mx, pm[r]);
    float out = 0.f;  // an empty row stays zero
    if (mx != neg_inf()) {
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (pm[r] == neg_inf()) continue;
        const float f = expf(pm[r] - mx);
        den = fmaf(pl[r], f, den);
        num = fmaf(pa[r], f, num);
      }
      out = num / den;
    }
    if (!kRagged || d < dt) o[(size_t)bh * ld + d] = from_f32<T>(out);
  }
  cluster.sync();  // no CTA leaves while the leader reads its partial
}

// CTAs per (b, h), of 2, 4 and 8: among the sizes that give every SM of
// the card a CTA (8 where none does), the one whose CTAs take the fewest
// passes over their shares, a cluster of 8 counting one pass more (its
// merge and its scheduling cost about that on the H100); the smaller on a
// tie. At B·H = 96 and D = 64: 2 at C = 128, 4 at C = 512 (f32: two
// passes), 8 at C = 1024 in f32.
inline int cluster_size(int BH, int C, int rows_per_pass, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    sms = 132;
  int best = kMaxCluster, best_cost = 0;
  for (int cs = kMaxCluster; cs >= 2; cs /= 2) {
    if ((long long)BH * cs < sms && cs < kMaxCluster) continue;
    const int share = (C + cs - 1) / cs;
    const int cost =
        (share + rows_per_pass - 1) / rows_per_pass + (cs == kMaxCluster);
    if (cs == kMaxCluster || cost <= best_cost) {
      best = cs;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T, int D, bool kRagged>
cudaError_t launch_dr(const void* q, const void* k, const void* v,
                      const uint8_t* mask, void* o, int BH, int H, int C,
                      int dt, float scale, int device, cudaStream_t stream) {
  const int cs = cluster_size(BH, C, Geo<T, D>::kPass, device);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(BH * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, flash_decode_kernel<T, D, kRagged>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(o), H, C, dt, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const uint8_t* mask, void* o, int BH, int H, int C,
                     int dt, float scale, int device, cudaStream_t stream) {
  if (dt == D)
    return launch_dr<T, D, false>(q, k, v, mask, o, BH, H, C, dt, scale,
                                  device, stream);
  return launch_dr<T, D, true>(q, k, v, mask, o, BH, H, C, dt, scale, device,
                               stream);
}

// The instantiated head dim that runs a true head dim dt: the smallest
// power of two from 8 to 1024 that holds it, or 0.
inline int plan_width(int dt) {
  for (int w = 8; w <= 1024; w *= 2) {
    if (dt <= w) return dt >= 1 ? w : 0;
  }
  return 0;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, int BH, int H, int C, int dt,
                   float scale, int device, cudaStream_t stream) {
  switch (plan_width(dt)) {
    case 8:
      return launch_d<T, 8>(q, k, v, mask, o, BH, H, C, dt, scale, device,
                            stream);
    case 16:
      return launch_d<T, 16>(q, k, v, mask, o, BH, H, C, dt, scale, device,
                             stream);
    case 32:
      return launch_d<T, 32>(q, k, v, mask, o, BH, H, C, dt, scale, device,
                             stream);
    case 64:
      return launch_d<T, 64>(q, k, v, mask, o, BH, H, C, dt, scale, device,
                             stream);
    case 128:
      return launch_d<T, 128>(q, k, v, mask, o, BH, H, C, dt, scale, device,
                              stream);
    case 256:
      return launch_d<T, 256>(q, k, v, mask, o, BH, H, C, dt, scale, device,
                              stream);
    case 512:
      return launch_d<T, 512>(q, k, v, mask, o, BH, H, C, dt, scale, device,
                              stream);
    case 1024:
      return launch_d<T, 1024>(q, k, v, mask, o, BH, H, C, dt, scale, device,
                               stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// q, o: (BH, D); k, v: (BH, C, D), all contiguous in `dtype`, any D from 1
// to 1024; mask: (B, C) bytes. Launches on `stream` and returns
// cudaGetLastError(); a cluster size the card refuses is returned as its
// error, never run otherwise.
extern "C" int dl4j_flash_decode(const void* q, const void* k, const void* v,
                                 const void* mask, void* o, int dtype, int BH,
                                 int H, int C, int D, float scale, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kFloat32)
    return dl4j::launch<float>(q, k, v, mb, o, BH, H, C, D, scale, device, s);
  if (dtype == dl4j::kBFloat16)
    return dl4j::launch<__nv_bfloat16>(q, k, v, mb, o, BH, H, C, D, scale,
                                       device, s);
  return cudaErrorInvalidValue;
}

// The CTAs per (b, h) that dl4j_flash_decode launches at this shape, or
// -1 for a dtype or head dim it does not take.
extern "C" int dl4j_flash_decode_cluster(int dtype, int BH, int C, int D,
                                         int device) {
  const int esz =
      dtype == dl4j::kFloat32 ? 4 : dtype == dl4j::kBFloat16 ? 2 : 0;
  const int w = dl4j::plan_width(D);
  if (esz == 0 || w == 0) return -1;
  return dl4j::cluster_size(BH, C, dl4j::pass_rows(esz, w), device);
}
