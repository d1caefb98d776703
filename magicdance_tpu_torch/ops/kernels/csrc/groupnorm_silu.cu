// Kernel K8: fused GroupNorm forward with an activation epilogue,
// y = act(GN(x) * gamma + beta), act SiLU or the identity, with fp32
// statistics and an fp32 affine, written in x's type.
//
// Replaces magicdance_tpu/ops/pallas/groupnorm.py::_gn_silu_kernel (reached
// through groupnorm_act from models/layers.py::GroupNorm32, which takes it on
// the card in every pass that asks for no gradient: SiLU after a ResBlock's
// norms and the UNet's output norm, the identity after the transformers').
//
// What bounds it on an H100. The work is a few operations per element, so it
// is bound by device memory: the least it can move is one read and one write
// of x. The Pallas kernel keeps one whole batch row (H*W x C) in VMEM across
// its statistics and normalize phases, 2.6 MB at (4096, 320) in bf16; a
// Hopper block has at most 227 KB of shared memory, and one block per batch
// row would leave most of the 132 SMs idle, so that design does not carry
// over.
//
// What the design does about it. Two launches from one call, the launch
// boundary being the barrier between statistics and apply:
//
//   gn_stats, grid (chunks, B) in clusters of CL blocks. Each block owns one
//   chunk of rows of one batch row; chunks are sized so that the grid makes
//   about two blocks per SM. Every thread moves 16 bytes of one row per
//   load (8 bf16 or 4 fp32 channels: VEC), consecutive threads on
//   consecutive pieces, so a warp reads whole rows; a thread keeps one
//   column of VEC channels over every RP-th row of the chunk (RP = the rows
//   the block covers side by side). Per channel it accumulates the sum and
//   the sum of squares of x minus the chunk's first row (a shift that keeps
//   E[x^2] - E[x]^2 clear of cancellation). Then LPG lanes per group, all
//   groups at once: each lane adds its channels' row lanes in a fixed
//   order, turns them into a per-channel mean and M2, and the lanes fold
//   channels into the group (a group may straddle a 16-byte piece: cg = 10,
//   30, or 3 at C = 48 with 16 groups). The CL blocks of a cluster then meet
//   in distributed shared memory: rank 0 combines their (count, mean, M2)
//   per group in rank order and writes one (mean, M2) per (batch, cluster,
//   group) to an fp32 workspace the wrapper allocates.
//
//   gn_apply, grid as gn_stats, a programmatic dependent launch: its blocks
//   may start as soon as every gn_stats block has started, read their first
//   rows of x and their gamma and beta, and only then wait for gn_stats to
//   finish (griddepcontrol). LPG lanes per group combine the batch row's
//   cluster partials (N = sum n_k, mean = sum n_k mean_k / N,
//   M2 = sum M2_k + n_k (mean_k - mean)^2) by one fixed xor tree, then each
//   thread reads its rows again (x is 0.6-42 MB at the model's sites against
//   a 50 MB L2, so mostly from L2), computes
//   (x - mean) * rsqrt(var + eps) * gamma + beta and the epilogue in fp32
//   (a template argument: the identity's instantiation carries no SiLU
//   code), and writes 16-byte pieces. gamma and beta are read in the dtype
//   they are stored in (bf16 or fp32) and widened as they are loaded, so a
//   call casts no weights.
//
//   Where the time goes: at most sites x is a few MB, which the card reads
//   in about a microsecond, so a call is paced by its chain of latencies
//   (two launches, the loads, the barriers, the cluster exchange). Every
//   step of the chain issues all its loads before it needs one, the folds
//   run all groups at once rather than a warp's groups one after another,
//   and SiLU divides with __fdividef: an IEEE division per element made the
//   apply pass compute-bound at 16 frames (PERF.md).
//
// No float atomics and no order that depends on scheduling: two runs give
// bit-identical outputs. A call whose channels or strides are not whole
// 16-byte pieces (or whose base is not 16-byte aligned) runs the same two
// kernels one channel per load (VEC = 1).
//
// Plain C interface, loaded with ctypes. x and y are (B, HW, C) with unit
// channel stride; strides[0..3] = x (batch, row), y (batch, row) in elements.
// gamma, beta: (C,) contiguous, fp32 (wdtype 0) or bf16 (wdtype 1). act: 0 the
// identity, 1 SiLU. ws: B * MAX_CLUSTERS * G * 2 fp32 of scratch.
// Returns cudaGetLastError() of the launches (0 on success), or
// cudaErrorInvalidValue for a call the kernels do not take.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace md {
namespace gn {

namespace cg = cooperative_groups;

constexpr int NT = 256;           // threads per block
constexpr int NW = NT / 32;       // warps per block
constexpr int CL = 8;             // blocks per cluster of gn_stats
constexpr int UNROLL = 4;         // rows in flight per thread
constexpr int MAX_CLUSTERS = 32;  // per batch row (a warp's lanes); groupnorm.py: GN_MAX_CLUSTERS
constexpr size_t MAX_SMEM = 232448;
constexpr int ACT_NONE = 0, ACT_SILU = 1;  // gn_apply's epilogue; groupnorm.py: ACTS

struct Params {
  const void* x;
  void* y;
  const void* gamma;  // (C,), fp32 or bf16 (w_bf16)
  const void* beta;
  float* ws;  // (B, nch / CL, G) x (mean, M2)
  long long x_sb, x_ss, y_sb, y_ss;
  int HW, C, G;
  int w_bf16;  // gamma and beta stored in bf16
  int rows;  // rows per chunk
  int nch;   // chunks per batch row, a multiple of CL
  float eps;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// One affine parameter of channel c, widened from its stored dtype.
__device__ __forceinline__ float affine_at(const void* w, int bf16, int c) {
  return bf16 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(w) + c))
              : __ldg(static_cast<const float*>(w) + c);
}

// One load of VEC channels, kept packed (4 registers for 8 bf16) until
// unpack() turns it into floats where it is used.
template <typename T, int VEC>
struct Raw;
template <>
struct Raw<__nv_bfloat16, 8> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void unpack(float (&v)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Raw<float, 4> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void unpack(float (&v)[4]) const {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};
template <typename T>
struct Raw<T, 1> {
  T r;
  __device__ __forceinline__ void load(const T* p) { r = *p; }
  __device__ __forceinline__ void unpack(float (&v)[1]) const { v[0] = to_f(r); }
};

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]);
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 8>(__nv_bfloat16* p,
                                                            const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
template <>
__device__ __forceinline__ void store_vec<float, 4>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 1>(__nv_bfloat16* p,
                                                            const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
}
template <>
__device__ __forceinline__ void store_vec<float, 1>(float* p, const float (&v)[1]) {
  *p = v[0];
}

// How a block's threads cover its chunk: V = C / VEC pieces per row. With
// V <= NT, RP = NT / V rows side by side and each thread one column (piece)
// for every RP-th row; otherwise one row at a time and each thread the
// columns tid, tid + NT, ... Threads with lane >= RP idle.
struct Cover {
  int V, RP, lane, col0, step;
  __device__ __forceinline__ Cover(int C, int vec) {
    V = C / vec;
    const int t = threadIdx.x;
    if (V <= NT) {
      RP = NT / V; lane = t / V; col0 = t - lane * V; step = V;
    } else {
      RP = 1; lane = 0; col0 = t; step = NT;
    }
  }
};

__device__ __forceinline__ int chunk_rows(const Params& p, int chunk) {
  return max(0, min(p.HW - chunk * p.rows, p.rows));
}

// Lanes that share one group in the folds below.
constexpr int LPG = 8;

// Sum over each aligned run of LPG lanes; every lane of the run gets it. The
// xor tree adds in one fixed order, so equal inputs give equal bits.
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LPG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of gn_stats, in floats: the row lanes' sums and sums of
// squares (RP x C each), the shifts (C), the group partials (2 G).
inline size_t stats_smem(int C, int G, int vec) {
  const int V = C / vec;
  const int RP = V <= NT ? NT / V : 1;
  return sizeof(float) * ((size_t)2 * RP * C + C + 2 * (size_t)G);
}

template <typename T, int VEC>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT) gn_stats(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const Cover cv(p.C, VEC);
  float* lane_sum = sm;                      // [RP][C]
  float* lane_sq = lane_sum + cv.RP * p.C;   // [RP][C]
  float* shift = lane_sq + cv.RP * p.C;      // [C]
  float* gpart = shift + p.C;                // [G] x (mean, M2)
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int r0 = chunk * p.rows;
  const int n = chunk_rows(p, chunk);
  const int r1 = r0 + n;
  const T* x = static_cast<const T*>(p.x) + (long long)b * p.x_sb;
  // gn_apply may start now: it reads x and waits for this grid before the
  // workspace
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  for (int col = cv.col0; cv.lane < cv.RP && col < cv.V; col += cv.step) {
    const T* xc = x + col * VEC;
    float sh[VEC], s[VEC], ss[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) sh[e] = s[e] = ss[e] = 0.f;
    if (n > 0) {
      Raw<T, VEC> first;
      first.load(xc + (long long)r0 * p.x_ss);
      first.unpack(sh);
    }
    for (int r = r0 + cv.lane; r < r1; r += UNROLL * cv.RP) {
      Raw<T, VEC> raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (r + u * cv.RP < r1) raw[u].load(xc + (long long)(r + u * cv.RP) * p.x_ss);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * cv.RP >= r1) continue;
        float v[VEC];
        raw[u].unpack(v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float d = v[e] - sh[e];
          s[e] += d;
          ss[e] = fmaf(d, d, ss[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      lane_sum[cv.lane * p.C + col * VEC + e] = s[e];
      lane_sq[cv.lane * p.C + col * VEC + e] = ss[e];
      if (cv.lane == 0) shift[col * VEC + e] = sh[e];
    }
  }
  __syncthreads();

  // per group, LPG lanes of a warp, NT / LPG groups at once: each lane takes
  // every LPG-th channel of the group, whose row lanes in order give its
  // mean and M2 over the n rows (kept in row lane 0's slots, which only this
  // lane touches); equal counts then make the group's mean the channels'
  // mean and its M2 = sum(M2_c) + n * sum((mean_c - mean)^2)
  const int cgp = p.C / p.G;
  const float fn = static_cast<float>(n);
  const float inv_n = n > 0 ? 1.f / fn : 0.f;
  const float inv_cg = 1.f / cgp;
  const int sub = threadIdx.x % LPG;
  // the loop is uniform over each warp, whose shuffles need all its lanes
  for (int g0 = (threadIdx.x / 32) * (32 / LPG); g0 < p.G; g0 += NT / LPG) {
    const int g = g0 + (threadIdx.x % 32) / LPG;
    const bool ok = g < p.G;
    float a = 0.f;
    for (int c = g * cgp + sub; ok && c < (g + 1) * cgp; c += LPG) {
      float sc = 0.f, ssc = 0.f;
      for (int l = 0; l < cv.RP; ++l) {
        sc += lane_sum[l * p.C + c];
        ssc += lane_sq[l * p.C + c];
      }
      const float mean_c = n > 0 ? fmaf(sc, inv_n, shift[c]) : 0.f;
      lane_sum[c] = mean_c;
      lane_sq[c] = fmaxf(fmaf(-sc * sc, inv_n, ssc), 0.f);
      a += mean_c;
    }
    const float mean = group_sum(a) * inv_cg;
    float m = 0.f;
    for (int c = g * cgp + sub; ok && c < (g + 1) * cgp; c += LPG) {
      const float d = lane_sum[c] - mean;
      m += fmaf(fn * d, d, lane_sq[c]);
    }
    m = group_sum(m);
    if (ok && sub == 0) {
      gpart[2 * g] = mean;
      gpart[2 * g + 1] = m;
    }
  }

  // the cluster's CL chunks, combined by rank 0 in rank order:
  // N = sum n_r, mean = sum n_r mean_r / N, M2 = sum M2_r + n_r (mean_r - mean)^2
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int first = chunk;  // rank 0 holds the cluster's first chunk
    float* out = p.ws + ((long long)b * (p.nch / CL) + chunk / CL) * 2 * p.G;
    for (int g = threadIdx.x; g < p.G; g += NT) {
      float pn[CL], pm[CL], pq[CL];
#pragma unroll
      for (int r = 0; r < CL; ++r) {  // every rank's read in flight at once
        const float* part = cluster.map_shared_rank(gpart, r);
        pn[r] = static_cast<float>(chunk_rows(p, first + r) * cgp);
        pm[r] = part[2 * g];
        pq[r] = part[2 * g + 1];
      }
      float cnt = 0.f, wsum = 0.f;
#pragma unroll
      for (int r = 0; r < CL; ++r) {
        cnt += pn[r];
        wsum = fmaf(pn[r], pm[r], wsum);
      }
      const float mean = cnt > 0.f ? wsum / cnt : 0.f;
      float m2 = 0.f;
#pragma unroll
      for (int r = 0; r < CL; ++r) {
        const float d = pm[r] - mean;
        m2 += fmaf(pn[r] * d, d, pq[r]);
      }
      out[2 * g] = mean;
      out[2 * g + 1] = m2;
    }
  }
  cluster.sync();  // the other ranks' shared memory stays until rank 0 has read it
}

template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(NT) gn_apply(const Params p) {
  extern __shared__ __align__(16) float stat[];  // [G] x (mean, rstd)
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int ncl = p.nch / CL;
  const int cgp = p.C / p.G;  // channels per group: a row adds cgp elements
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Cover cv(p.C, VEC);
  const int r0 = chunk * p.rows;
  const int r1 = r0 + chunk_rows(p, chunk);
  const T* x = static_cast<const T*>(p.x) + (long long)b * p.x_sb;
  T* y = static_cast<T*>(p.y) + (long long)b * p.y_sb;

  // everything that does not depend on gn_stats is read while it runs: the
  // first rows of this thread's first column and its gamma and beta
  Raw<T, VEC> raw[UNROLL];
  const int rfirst = r0 + cv.lane;
  const bool active = cv.lane < cv.RP && cv.col0 < cv.V;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    if (active && rfirst + u * cv.RP < r1)
      raw[u].load(x + (long long)(rfirst + u * cv.RP) * p.x_ss + cv.col0 * VEC);
  float gam[VEC], bet[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    gam[e] = active ? affine_at(p.gamma, p.w_bf16, cv.col0 * VEC + e) : 0.f;
    bet[e] = active ? affine_at(p.beta, p.w_bf16, cv.col0 * VEC + e) : 0.f;
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // gn_stats done, ws visible

  // per group, LPG lanes, NT / LPG groups at once: lane sub sums the
  // partials of clusters sub, sub + LPG, ... (ncl <= 32): N = sum n_k,
  // mean = sum n_k mean_k / N, M2 = sum M2_k + n_k (mean_k - mean)^2, in one
  // fixed order, so every block gets the same bits
  const float* part = p.ws + (long long)b * ncl * 2 * p.G;
  const int sub = threadIdx.x % LPG;
  const float inv_total = 1.f / (static_cast<float>(p.HW) * cgp);
  for (int g0 = warp * (32 / LPG); g0 < p.G; g0 += NT / LPG) {
    const int g = g0 + lane / LPG;
    const bool ok = g < p.G;
    float pn[MAX_CLUSTERS / LPG], pm[MAX_CLUSTERS / LPG], pq[MAX_CLUSTERS / LPG];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTERS / LPG; ++k) {  // every load in flight at once
      const int c = sub + k * LPG;
      const bool has = ok && c < ncl;
      pn[k] = has ? static_cast<float>(max(0, min(p.HW - c * CL * p.rows, CL * p.rows)) * cgp)
                  : 0.f;
      pm[k] = has ? part[(long long)c * 2 * p.G + 2 * g] : 0.f;
      pq[k] = has ? part[(long long)c * 2 * p.G + 2 * g + 1] : 0.f;
    }
    float wsum = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTERS / LPG; ++k) wsum = fmaf(pn[k], pm[k], wsum);
    const float mean = group_sum(wsum) * inv_total;
    float m2 = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTERS / LPG; ++k) {
      const float d = pm[k] - mean;
      m2 += fmaf(pn[k] * d, d, pq[k]);
    }
    m2 = group_sum(m2);
    if (ok && sub == 0) {
      stat[2 * g] = mean;
      stat[2 * g + 1] = rsqrtf(fmaf(m2, inv_total, p.eps));
    }
  }
  __syncthreads();

  for (int col = cv.col0; cv.lane < cv.RP && col < cv.V; col += cv.step) {
    float mu[VEC], a[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int c = col * VEC + e;
      const int g = c / cgp;
      if (col != cv.col0) {
        gam[e] = affine_at(p.gamma, p.w_bf16, c);
        bet[e] = affine_at(p.beta, p.w_bf16, c);
      }
      mu[e] = stat[2 * g];
      a[e] = stat[2 * g + 1] * gam[e];
    }
    const T* xc = x + col * VEC;
    T* yc = y + col * VEC;
    for (int r = rfirst; r < r1; r += UNROLL * cv.RP) {
      if (col != cv.col0 || r != rfirst) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (r + u * cv.RP < r1) raw[u].load(xc + (long long)(r + u * cv.RP) * p.x_ss);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * cv.RP >= r1) continue;
        float v[VEC];
        raw[u].unpack(v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float t = fmaf(v[e] - mu[e], a[e], bet[e]);
          if constexpr (ACT == ACT_SILU)
            v[e] = __fdividef(t, 1.f + __expf(-t));  // -> -0 for t < -87
          else
            v[e] = t;
        }
        store_vec<T, VEC>(yc + (long long)(r + u * cv.RP) * p.y_ss, v);
      }
    }
  }
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// Chunks: about two blocks per SM over the whole (B x chunks) grid, a
// multiple of CL per batch row, at most CL * MAX_CLUSTERS.
inline void plan_chunks(Params& p, int B) {
  const int target = (2 * sm_count() + B - 1) / B;
  int nch = (target + CL - 1) / CL * CL;
  if (nch > CL * MAX_CLUSTERS) nch = CL * MAX_CLUSTERS;
  p.rows = (p.HW + nch - 1) / nch;
  nch = (p.HW + p.rows - 1) / p.rows;
  p.nch = (nch + CL - 1) / CL * CL;
}

template <typename T, int VEC, int ACT>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
  const size_t smem_s = stats_smem(p.C, p.G, VEC);
  const size_t smem_a = sizeof(float) * 2 * (size_t)p.G;
  if (smem_s > MAX_SMEM || smem_a > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gn_stats<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_s);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gn_apply<T, VEC, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_a);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nch, B);
  gn_stats<T, VEC><<<grid, NT, smem_s, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // gn_apply as a programmatic dependent launch: its blocks may start once
  // every gn_stats block has started, and wait for gn_stats in the kernel
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_a;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gn_apply<T, VEC, ACT>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// 16-byte pieces when every row start and the channel count allow them.
template <typename T, int ACT>
cudaError_t launch_any(const Params& p, int B, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_ok = p.C % VEC == 0 && p.x_sb % VEC == 0 && p.x_ss % VEC == 0 &&
                      p.y_sb % VEC == 0 && p.y_ss % VEC == 0 &&
                      reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p.y) % 16 == 0;
  return vec_ok ? launch<T, VEC, ACT>(p, B, stream) : launch<T, 1, ACT>(p, B, stream);
}

}  // namespace gn
}  // namespace md

extern "C" int md_groupnorm_silu(int dtype, int wdtype, int act, const void* x,
                                 const void* gamma, const void* beta, void* y, float* ws,
                                 const long long* strides, int B, int HW,
                                 int C, int G, float eps, void* stream) {
  if (B < 1 || HW < 1 || G < 1 || C < G || C % G != 0 || B > 65535 ||
      (wdtype != 0 && wdtype != 1) || (act != md::gn::ACT_NONE && act != md::gn::ACT_SILU))
    return static_cast<int>(cudaErrorInvalidValue);
  md::gn::Params p = {};
  p.x = x;
  p.y = y;
  p.gamma = gamma;
  p.beta = beta;
  p.ws = ws;
  p.x_sb = strides[0]; p.x_ss = strides[1];
  p.y_sb = strides[2]; p.y_ss = strides[3];
  p.HW = HW;
  p.C = C;
  p.G = G;
  p.eps = eps;
  p.w_bf16 = wdtype;
  md::gn::plan_chunks(p, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using md::gn::ACT_SILU;
  using md::gn::launch_any;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = act == ACT_SILU ? launch_any<float, ACT_SILU>(p, B, s)
                          : launch_any<float, md::gn::ACT_NONE>(p, B, s);
  else if (dtype == 1)
    err = act == ACT_SILU ? launch_any<__nv_bfloat16, ACT_SILU>(p, B, s)
                          : launch_any<__nv_bfloat16, md::gn::ACT_NONE>(p, B, s);
  return static_cast<int>(err);
}

extern "C" const char* md_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
