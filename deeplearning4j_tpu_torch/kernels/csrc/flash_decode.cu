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
//   lanes finish its dot product. Each lane issues all kLoads K and V
//   vectors of a pass before it consumes any, and the next pass's mask
//   bytes are read while this pass's rows are in flight: a pass costs one
//   load latency, not two per row group. Masked rows are never read.
// - Each warp keeps its running max, sum and accumulator; the CTA merges
//   its 4 warps in shared memory, and the cluster's leader merges the CTAs'
//   partials in rank order through distributed shared memory between two
//   cluster barriers, with every remote read in flight at once (read one
//   rank after another, their round trips made 8 the slowest cluster size
//   at every shape). A CTA whose share has no valid row contributes
//   m = −inf and is skipped. One launch per call, and a fixed order of
//   every sum: re-runs are bit-identical, and serving's launches per decode
//   step are those of a one-CTA kernel.
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

// Rows a CTA reads in one pass: kLoads 16-byte vectors a lane, a row of
// D elements of `esz` bytes taking D·esz/16 lanes.
constexpr int pass_rows(int esz, int D) {
  return kWarps * kLoads * 32 * 16 / (D * esz);
}

// Lanes per cache row, rows per warp instruction, rows per CTA pass.
template <typename T, int D>
struct Geo {
  static constexpr int E = Vec<T>::E;
  static constexpr int LPR = D / E;
  static constexpr int RPI = 32 / LPR;
  static constexpr int kPass = pass_rows((int)sizeof(T), D);
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0 && D <= kThreads,
                "head dim must be 32, 64 or 128");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    T* __restrict__ o, int H, int C, float scale) {
  using G = Geo<T, D>;
  constexpr int E = G::E, LPR = G::LPR, RPI = G::RPI;
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
  const int sub = lane % LPR;  // the lane's 16-byte chunk of a row
  const int grp = lane / LPR;  // the lane's row within an instruction

  const int share = (C + cs - 1) / cs;
  const int c_begin = min(C, rank * share);
  const int c_end = min(C, c_begin + share);

  float qv[E];
  Vec<T>::get(*reinterpret_cast<const uint4*>(q + (size_t)bh * D + sub * E),
              qv);
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] *= scale;
  float acc[E] = {};
  float m = neg_inf(), l = 0.f;  // m is uniform over the warp

  const T* kb = k + (size_t)bh * C * D + sub * E;
  const T* vb = v + (size_t)bh * C * D + sub * E;
  const uint8_t* mb = mask + (size_t)(bh / H) * C;
  auto row = [&](int pass, int i) {
    return c_begin + ((pass * kWarps + warp) * kLoads + i) * RPI + grp;
  };
  bool ok[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int r = row(0, i);
    ok[i] = r < c_end && mb[r] != 0;
  }

  for (int pass = 0; c_begin + pass * G::kPass < c_end; ++pass) {
    uint4 kx[kLoads], vx[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const size_t off = (size_t)row(pass, i) * D;
      kx[i] = ok[i] ? *reinterpret_cast<const uint4*>(kb + off)
                    : make_uint4(0, 0, 0, 0);
      vx[i] = ok[i] ? *reinterpret_cast<const uint4*>(vb + off)
                    : make_uint4(0, 0, 0, 0);
    }
    bool next[kLoads];  // the next pass's mask bytes, while these land
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int r = row(pass + 1, i);
      next[i] = r < c_end && mb[r] != 0;
    }

    float s[kLoads];
    float mx = m;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      float x[E];
      Vec<T>::get(kx[i], x);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(qv[e], x[e], dot);
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
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const float p = expf(s[i] - mx);
        float x[E];
        Vec<T>::get(vx[i], x);
        l += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(p, x[e], acc[e]);
      }
      m = mx;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) ok[i] = next[i];
  }

  // the warp's sum and accumulator over its row lanes
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
    l += __shfl_xor_sync(kFull, l, off);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], off);
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (lane < LPR) {
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[e];
  }
  __syncthreads();

  // the CTA's partial: its warps merged in order
  const int d = threadIdx.x;
  if (d < D) {
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
  // remote reads issued before any is used
  if (rank == 0 && d < D) {
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
    o[(size_t)bh * D + d] = from_f32<T>(out);
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

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const uint8_t* mask, void* o, int BH, int H, int C,
                     float scale, int device, cudaStream_t stream) {
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
      &cfg, flash_decode_kernel<T, D>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(o), H, C, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, int BH, int H, int C, int D,
                   float scale, int device, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, mask, o, BH, H, C, scale, device,
                             stream);
    case 64:
      return launch_d<T, 64>(q, k, v, mask, o, BH, H, C, scale, device,
                             stream);
    case 128:
      return launch_d<T, 128>(q, k, v, mask, o, BH, H, C, scale, device,
                              stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// q, o: (BH, D); k, v: (BH, C, D), all contiguous in `dtype`; mask: (B, C)
// bytes. Launches on `stream` and returns cudaGetLastError(); a cluster
// size the card refuses is returned as its error, never run otherwise.
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
  const int esz = dtype == dl4j::kFloat32 ? 4 : dtype == dl4j::kBFloat16 ? 2 : 0;
  if (esz == 0 || (D != 32 && D != 64 && D != 128)) return -1;
  return dl4j::cluster_size(BH, C, dl4j::pass_rows(esz, D), device);
}
