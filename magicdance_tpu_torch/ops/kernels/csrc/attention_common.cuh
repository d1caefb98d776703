// CUDA-core body of the port's two attention kernels (self_attention.cu and
// two_source_attention.cu) in fp32: a flash-style forward pass with an online
// (FA2-style) softmax over K/V tiles staged in shared memory; also the
// launch parameters of every attention kernel, and the tile loader and
// helpers that the backward kernels (attention_dq.cu, attention_dkv.cu) use.
//
// Forward with log-sum-exp (training). Given an `lse` pointer, the same pass
// also writes each query row's m + log(l) in fp32 to lse[(b * H + h) * Sq +
// row] -- the statistics the online softmax already keeps, so the training
// forward costs no extra pass. It replaces
// magicdance_tpu/ops/pallas/flash_vjp.py::_fwd_lse_kernel (NSRC = 1) and
// ::_fwd2_lse_kernel (NSRC = 2, the joint LSE over both sources); the Pallas
// versions store the LSE as (B*H, 1, S), which is this layout.
//
// Replaces (magicdance_tpu/ops/pallas/flash.py):
//   self_attention.cu        -> _attn_kernel_fused (packed (B,S,H*D)) and
//                               _attn_kernel (BSNH); both layouts are the same
//                               memory on the GPU, so one strided kernel
//                               serves both.
//   two_source_attention.cu  -> _attn2_kernel_fused (packed) and
//                               _attn2_kernel_nomask (BSNH): one joint softmax
//                               over [self keys ; bank keys]. The concatenation
//                               is never built: the kernel walks the self
//                               source, then the bank source, with one running
//                               max and one running denominator per row. A
//                               batch-1 bank is read through batch stride 0.
//
// Which body runs where. This CUDA-core body serves fp32 kernels A and B;
// the backward kernels C and D use its tile loader and helpers. bf16 A and
// B (every mode: two sources, the LSE, gated) run the tensor-core kernel
// attention_tc of attention_mma.cuh, which takes the Params and Source
// below; fp32 stays here because on the tensor cores it would be TF32, and
// the fp32 paths are the card-vs-CPU checks.
//
// What bounds it on an H100. At the main path's shapes (S = 4096/1024/256,
// D = 40/80/160) attention does 4*S*S*D operations per (batch, head) on
// 4*S*D elements of input and output, i.e. roughly S/2 operations per byte
// in bf16 -- far above the card's ~295 operations per byte, so the work is
// bound by operations, not by device memory. The Pallas kernels held a whole
// K/V row in VMEM; on Hopper a block has at most 227 KB of shared memory and
// K+V of one head at the S = 4096 bank read is ~1.3 MB, so this kernel
// streams 64-key tiles and keeps the softmax statistics online.
//
// What the design does about it (the first, simple version, kept for fp32).
// One block of 256 threads owns one (batch, head, 64-query tile). Q, the K
// tile and the V tile are converted to fp32 in shared memory (rows padded to
// an odd stride so the column reads of K hit 32 different banks); each
// thread computes a 4x4 block of the 64x64 logits tile with fp32 FMAs, four
// threads per row keep the online max/denominator, and each thread
// accumulates a 4 x (16*DJ) slab of the output in registers. Logits,
// softmax and accumulation are fp32. The products run on the CUDA cores,
// not the tensor cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace md {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NT = 256;  // threads per block (16 x 16)

struct Source {
  const void* k;
  const void* v;
  long long k_sb, k_ss, k_sh;  // batch, row, head strides in elements
  long long v_sb, v_ss, v_sh;
  int len;                     // number of keys
};

struct Params {
  const void* q;
  void* o;
  float* lse;  // optional (B, H, Sq) fp32 log-sum-exp output, or nullptr
  // optional (B,) fp32 gate on the second source (NSRC = 2), indexed by the
  // batch row of q, or nullptr (ungated)
  const float* gate;
  long long q_sb, q_ss, q_sh;
  long long o_sb, o_ss, o_sh;
  Source src[2];
  int H, D, Sq;
  float scale;
};

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The value a float takes once stored in T and read back: identity for
// fp32, round-to-nearest bf16 for bf16. The backward kernels apply it where
// the JAX kernels cast P and dS to the input dtype before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Copy `rows_valid` rows of D elements (row stride `row_stride`) into a
// ROWS-row fp32 tile with leading dimension `ld`; rows past `rows_valid` are
// zero. D is a multiple of 8 and every row start is 16-byte aligned (the
// Python wrapper checks both), so each thread moves 8 elements at a time.
template <typename T, int ROWS = 64>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          long long row_stride, int rows_valid,
                                          int D) {
  const int chunks = D >> 3;
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += NT) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) << 3;
    float vals[8];
    if (r < rows_valid) {
      load8(base + r * row_stride + c, vals);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] = 0.f;
    }
    float* d = dst + r * ld + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = vals[j];
  }
}

inline size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) *
         (size_t)(BQ * ld + 2 * BK * ld + BQ * (BK + 1) + 3 * BQ);
}

// NSRC = 1: softmax(q k^T * scale) v. NSRC = 2: one joint softmax over the
// keys of src[0] then src[1]. DJ = ceil(D / 16) rounded up to a compiled
// bucket: each thread owns output columns tx + 16*j, j < DJ.
template <typename T, int NSRC, int DJ>
__global__ void __launch_bounds__(NT) attention_fwd(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ss = Vs + BK * ld;  // BQ x (BK + 1)
  float* row_m = Ss + BQ * (BK + 1);
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qbase = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                   (long long)q0 * p.q_ss;
  load_tile<T>(Qs, ld, qbase, p.q_ss, min(BQ, p.Sq - q0), D);
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < NSRC; ++s) {
    const Source src = p.src[s];
    // the gate scales the second source's probabilities after the exp, inside
    // the joint max and denominator; a row gated by exactly 0 is plain
    // self-attention, so its block skips the bank tiles
    const float gate = (s == 1 && p.gate != nullptr) ? p.gate[b] : 1.f;
    if (gate == 0.f) continue;
    const T* kb = static_cast<const T*>(src.k) + b * src.k_sb + h * src.k_sh;
    const T* vb = static_cast<const T*>(src.v) + b * src.v_sb + h * src.v_sh;
    for (int k0 = 0; k0 < src.len; k0 += BK) {
      const int nk = min(BK, src.len - k0);
      __syncthreads();  // the previous tile is consumed; Q and stats are set
      load_tile<T>(Ks, ld, kb + (long long)k0 * src.k_ss, src.k_ss, nk, D);
      load_tile<T>(Vs, ld, vb + (long long)k0 * src.v_ss, src.v_ss, nk, D);
      __syncthreads();

      // logits tile: this thread owns rows ty + 16 i, columns tx + 16 j
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
          Ss[(ty + 16 * i) * (BK + 1) + c] =
              c < nk ? sacc[i][j] * p.scale : -INFINITY;
        }
      __syncthreads();

      // online softmax: four neighbouring lanes share one row
      {
        const int r = tid >> 2;
        const int part = tid & 3;
        float* srow = Ss + r * (BK + 1);
        float mx = -INFINITY;
        for (int c = part; c < BK; c += 4) mx = fmaxf(mx, srow[c]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_old = row_m[r];
        const float m_new = fmaxf(m_old, mx);  // finite: nk >= 1
        float sum = 0.f;
        for (int c = part; c < BK; c += 4) {
          const float e = expf(srow[c] - m_new) * gate;  // masked keys: exp(-inf) = 0
          srow[c] = e;
          sum += e;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0) {
          const float alpha = expf(m_old - m_new);  // 0 on the first tile
          row_a[r] = alpha;
          row_l[r] = row_l[r] * alpha + sum;
          row_m[r] = m_new;
        }
      }
      __syncthreads();

      // acc = alpha * acc + P V
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
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= p.Sq) continue;
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + q0 + r] = row_m[r] + logf(row_l[r]);
    const float inv = 1.f / row_l[r];
    T* orow = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh +
              (long long)(q0 + r) * p.o_ss;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) store1(orow + col, acc[i][j] * inv);
    }
  }
}

template <typename T, int NSRC, int DJ>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd<T, NSRC, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  attention_fwd<T, NSRC, DJ><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// Compiled head-dim buckets: D = 40 -> DJ 3, D = 80 -> 5, D = 160 -> 10.
template <typename T, int NSRC>
cudaError_t launch_d(const Params& p, int B, cudaStream_t stream) {
  const int dj = (p.D + 15) / 16;
  if (dj <= 1) return launch<T, NSRC, 1>(p, B, stream);
  if (dj <= 2) return launch<T, NSRC, 2>(p, B, stream);
  if (dj <= 3) return launch<T, NSRC, 3>(p, B, stream);
  if (dj <= 4) return launch<T, NSRC, 4>(p, B, stream);
  if (dj <= 5) return launch<T, NSRC, 5>(p, B, stream);
  if (dj <= 6) return launch<T, NSRC, 6>(p, B, stream);
  if (dj <= 8) return launch<T, NSRC, 8>(p, B, stream);
  if (dj <= 10) return launch<T, NSRC, 10>(p, B, stream);
  if (dj <= 12) return launch<T, NSRC, 12>(p, B, stream);
  return launch<T, NSRC, 16>(p, B, stream);
}

// Head-dim buckets shared by every kernel: calls f.template run<DJ>() with
// DJ = ceil(D / 16) rounded up to a compiled bucket.
template <typename F>
cudaError_t dispatch_dj(int D, F& f) {
  const int dj = (D + 15) / 16;
  if (dj <= 1) return f.template run<1>();
  if (dj <= 2) return f.template run<2>();
  if (dj <= 3) return f.template run<3>();
  if (dj <= 4) return f.template run<4>();
  if (dj <= 5) return f.template run<5>();
  if (dj <= 6) return f.template run<6>();
  if (dj <= 8) return f.template run<8>();
  if (dj <= 10) return f.template run<10>();
  if (dj <= 12) return f.template run<12>();
  return f.template run<16>();
}

inline bool head_dim_ok(int D) { return D >= 8 && D <= 256 && D % 8 == 0; }

}  // namespace md

extern "C" const char* md_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
