// Kernel K9: head-packed attention, the probe kernel of the head-packing
// question (can G heads of width D share one tensor-core tile?).
//
// Replaces scripts/bench_head_packing.py::_packed_kernel (reached through
// packed_attention). qp is (BG, Sq, G*D), lane-packed: head g's queries in
// columns [g*D, (g+1)*D). kbd and vbd are (BG, G*S, G*D): key rows
// [g*S, (g+1)*S) form head g's segment. For any kbd/vbd (block-diagonal in
// the probe, but not required):
//   logits = qp . kbd^T * scale                          (BG, Sq, G*S), fp32
//   P      = softmax over each segment's S keys separately
//   o      = P . vbd                                     (BG, Sq, G*D)
// with P cast to the input dtype before the PV product, as the Pallas kernel
// does. The whole G*D contraction and the whole G*D-wide output are
// computed, zeros included: that cost is what the probe measures.
//
// What bounds it on an H100. Per (BG row, query) it does 2*G*S*G*D
// multiply-adds for QK^T and as many for PV, G times a per-head kernel's,
// on G*S keys: at the probe's shape (BG 64, S 4096, G 3, D 40) 1.55 TFLOP
// on 0.5 GB, so it is bound by operations (989 TFLOP/s in bf16). The Pallas
// kernel held all G*S keys in VMEM (vmem_limit 100 MB); a block here has at
// most 227 KB, so K/V stream through shared memory in 64-key tiles.
//
// What the design does. Three bodies, chosen by the wrapper (packed.py,
// packed_body) and named by the C entry's `body` argument:
//   2  bf16 at G*D <= 128: the Hopper body of attention_wgmma.cuh in MODE
//      PACKED, the body of bf16 kernels A and B too (wgmma, TMA into a
//      three-stage mbarrier ring, one producer warp, two consumer
//      warpgroups of 64 query rows). At G*D = 120 the QK^T
//      contraction runs 8 k16 steps over two 64-column TMA boxes (the last
//      8 columns zero-filled by TMA) and PV two m64n64 products per k16 step.
//   1  bf16 at any width (the wrapper takes it above 128, where the Hopper
//      body's two fp32 accumulators do not fit the registers): kernel A's
//      tensor-core kernel (attention_tc of attention_mma.cuh, mma.sync) at
//      width G*D over G key segments, K/V tiles through cp.async into a
//      two-stage ring.
//   0  fp32: a CUDA-core body with the same segment loop (exact fp32
//      products, as fp32 kernel A).
// In every body a key tile belongs to one segment (tiles start at g*S and
// the ragged edge is masked), each segment keeps its own running (m, l) and
// fp32 accumulator, and at its end acc / l is added into the output.
//
// Plain C interface, loaded with ctypes. Strides are in elements, unit over
// the last dim: strides[0..7] = q (batch, row), k (...), v (...), o (...).
// Returns cudaGetLastError() of the launch (0 on success).

#include "attention_mma.cuh"
#include "attention_wgmma.cuh"

namespace md {
namespace tc {

// K9 is attention_tc over G segments with H = 1: one block per 64 query
// rows of one BG row, one row tile per warp (two sets of the 15-tile output
// accumulators would not fit the registers), 64-key tiles.
struct PackedLaunch {
  const Params& p;
  int G, BG;
  cudaStream_t stream;
  template <int KD, int NO>
  cudaError_t run() {
    return launch_tc<KD, NO, 1, 64, PACKED>(p, G, BG, stream);
  }
};

}  // namespace tc

// fp32: the CUDA-core layout of attention_fwd (256 threads, 16 x 16; each
// thread owns rows ty + 16 i and columns tx + 16 j) with the segment loop.
template <int DJ>
__global__ void __launch_bounds__(NT) packed_attention_f32(const Params p, const int G) {
  extern __shared__ float f32_smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* Qs = f32_smem;
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ss = Vs + BK * ld;  // BQ x (BK + 1)
  float* row_m = Ss + BQ * (BK + 1);
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;

  const int q0 = blockIdx.x * BQ;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const Source src = p.src[0];
  const float* kb = static_cast<const float*>(src.k) + b * src.k_sb;
  const float* vb = static_cast<const float*>(src.v) + b * src.v_sb;
  load_tile<float>(Qs, ld, static_cast<const float*>(p.q) + b * p.q_sb + (long long)q0 * p.q_ss,
                   p.q_ss, min(BQ, p.Sq - q0), D);

  float out[4][DJ], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    if (tid < BQ) {  // the last segment's reads of row_l ended at a barrier
      row_m[tid] = -INFINITY;
      row_l[tid] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < src.len; k0 += BK) {
      const int nk = min(BK, src.len - k0);
      const long long key = (long long)g * src.len + k0;
      __syncthreads();
      load_tile<float>(Ks, ld, kb + key * src.k_ss, src.k_ss, nk, D);
      load_tile<float>(Vs, ld, vb + key * src.v_ss, src.v_ss, nk, D);
      __syncthreads();

      float sacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          Ss[(ty + 16 * i) * (BK + 1) + c] = c < nk ? sacc[i][j] * p.scale : -INFINITY;
        }
      __syncthreads();

      {  // online softmax of the segment: four neighbouring lanes share a row
        const int r = tid >> 2;
        const int part = tid & 3;
        float* srow = Ss + r * (BK + 1);
        float mx = -INFINITY;
        for (int c = part; c < BK; c += 4) mx = fmaxf(mx, srow[c]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_old = row_m[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int c = part; c < BK; c += 4) {
          const float e = expf(srow[c] - m_new);
          srow[c] = e;
          sum += e;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0) {
          const float alpha = expf(m_old - m_new);
          row_a[r] = alpha;
          row_l[r] = row_l[r] * alpha + sum;
          row_m[r] = m_new;
        }
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = row_a[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
      }
      for (int c = 0; c < nk; ++c) {
        float pv[4], vv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int col = tx + 16 * j;
          vv[j] = col < D ? Vs[c * ld + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float inv = 1.f / row_l[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) out[i][j] += acc[i][j] * inv;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
    float* orow = static_cast<float*>(p.o) + b * p.o_sb + (long long)r * p.o_ss;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) orow[col] = out[i][j];
    }
  }
}

struct PackedLaunchF32 {
  const Params& p;
  int G, BG;
  cudaStream_t stream;
  template <int DJ>
  cudaError_t run() {
    const size_t smem = smem_bytes(p.D);
    cudaError_t err = cudaFuncSetAttribute(
        packed_attention_f32<DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + BQ - 1) / BQ, BG);
    packed_attention_f32<DJ><<<grid, NT, smem, stream>>>(p, G);
    return cudaGetLastError();
  }
};

}  // namespace md

// dtype: 0 = float32, 1 = bfloat16. body: 0 = CUDA cores (fp32), 1 =
// attention_tc (bf16), 2 = attention_wgmma (bf16, G*D <= 128); any other
// pairing is refused with cudaErrorInvalidValue.
extern "C" int md_packed_attention(int dtype, int body, const void* q, const void* k,
                                   const void* v, void* o, const long long* strides, int BG,
                                   int GD, int Sq, int S, int G, float scale, void* stream) {
  md::Params p = {};  // H = 1: head strides stay 0
  p.q = q;
  p.o = o;
  p.q_sb = strides[0]; p.q_ss = strides[1];
  p.src[0].k = k;
  p.src[0].k_sb = strides[2]; p.src[0].k_ss = strides[3];
  p.src[0].v = v;
  p.src[0].v_sb = strides[4]; p.src[0].v_ss = strides[5];
  p.src[0].len = S;
  p.o_sb = strides[6]; p.o_ss = strides[7];
  p.H = 1;
  p.D = GD;
  p.Sq = Sq;
  p.scale = scale;
  if (!md::head_dim_ok(GD) || BG < 1 || Sq < 1 || S < 1 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && body == 2) {
    return static_cast<int>(md::wg::launch_packed(p, G, BG, st));
  }
  if (dtype == 1 && body == 1) {
    md::tc::PackedLaunch f{p, G, BG, st};
    return static_cast<int>(md::tc::dispatch_no(GD, f));
  }
  if (dtype == 0 && body == 0) {
    md::PackedLaunchF32 f{p, G, BG, st};
    return static_cast<int>(md::dispatch_dj(GD, f));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
