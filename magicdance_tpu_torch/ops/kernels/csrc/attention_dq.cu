// Kernel C: the dQ half of the attention backward pass, for one source
// (self-attention) or two (bank-read attention with one joint softmax):
//
//   P  = exp(q k^T * scale - lse)          (the forward's probabilities)
//   dP = dO v^T
//   dS = P o (dP - delta) * scale          (delta = rowsum(dO o O))
//   dQ = sum over the keys of every source of dS k
//
// Replaces magicdance_tpu/ops/pallas/flash_vjp.py::_dq_kernel (NSRC = 1,
// reached through _core_dq) and ::_dq2_kernel (NSRC = 2, through _core2_dq).
// The Pallas kernels recompute the softmax statistics from a whole K row held
// in VMEM; this kernel reads the forward's per-row log-sum-exp and the
// caller's delta instead, so it can stream K/V in tiles.
//
// Three bodies, chosen by the wrapper (ops/kernels/attention.py,
// attention_body) and named by the C entry's `body` argument: 2, bf16 at
// D <= 192, the Hopper body (wg::attention_dq_wgmma of
// attention_bwd_wgmma.cuh: Q and dO copied once by TMA, K/V tiles through
// an mbarrier ring, three wgmma products per key tile); 1, bf16 at any
// width, attention_dq_tc of attention_bwd_mma.cuh (FA2's dQ layout, three
// mma.sync products per key tile, dS packed to bf16 in registers; that
// header says how and why C and D stay two kernels); 0, fp32, the
// CUDA-core body below, whose products are exact fp32 (the card-vs-CPU
// checks and the fp32 paths need them); it is compiled for fp32 only, so
// no bf16 call can reach it.
//
// What bounds it on an H100: 6 * Sq * Skv * D operations per (batch, head,
// source) (three products: q k^T, dO v^T, dS k) against ~4 * S * D input and
// output elements, i.e. far more operations than bytes at S >= 256 -- bound by
// operations.
//
// The CUDA-core body (fp32). One block of 256 threads owns
// one (batch, head, 64-query tile): Q and dO of the tile, its LSE and delta
// stay in shared memory (fp32) for the whole pass. The block streams the self
// source's K/V in 32-key tiles, then the bank's (a batch-1 bank is read with
// batch stride 0). Per tile each thread computes a 4 x 2 patch of the logits
// and of dP with fp32 FMAs, forms dS, and accumulates a 4 x (16 * DJ)
// slab of dQ in fp32 registers. 32-key tiles keep Q, dO, K, V and dS under
// the 227 KB of shared memory a block has up to D = 256 (206 KB there; 133 KB
// at D = 160).
//
// Plain C interface, loaded with ctypes. Strides are in elements:
// strides[0..20] = q, k_self, v_self, k_bank, v_bank, dout, dq, each
// (batch, row, head). lse and delta: contiguous (B, H, Sq) fp32. nsrc = 1
// ignores the bank arguments. A body that cannot take the dtype and width
// returns cudaErrorInvalidValue; otherwise cudaGetLastError() of the launch.

#include "attention_bwd_mma.cuh"
#include "attention_bwd_wgmma.cuh"

namespace md {

constexpr int DQ_BQ = 64;  // query rows per block
constexpr int DQ_BK = 32;  // keys per streamed tile

inline size_t dq_smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) * (size_t)(2 * DQ_BQ * ld + 2 * DQ_BK * ld +
                                  DQ_BQ * (DQ_BK + 1) + 2 * DQ_BQ);
}

template <typename T, int NSRC, int DJ>
__global__ void __launch_bounds__(NT) attention_dq(const DqParams p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* Qs = smem;                 // DQ_BQ x ld
  float* dOs = Qs + DQ_BQ * ld;     // DQ_BQ x ld
  float* Ks = dOs + DQ_BQ * ld;     // DQ_BK x ld
  float* Vs = Ks + DQ_BK * ld;      // DQ_BK x ld
  float* dSs = Vs + DQ_BK * ld;     // DQ_BQ x (DQ_BK + 1)
  float* row_lse = dSs + DQ_BQ * (DQ_BK + 1);
  float* row_delta = row_lse + DQ_BQ;

  const int q0 = blockIdx.x * DQ_BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int rows = min(DQ_BQ, p.Sq - q0);

  load_tile<T, DQ_BQ>(Qs, ld, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                                  (long long)q0 * p.q_ss, p.q_ss, rows, D);
  load_tile<T, DQ_BQ>(dOs, ld, static_cast<const T*>(p.dout) + b * p.do_sb +
                                   h * p.do_sh + (long long)q0 * p.do_ss,
                      p.do_ss, rows, D);
  if (tid < DQ_BQ) {
    const long long idx = (b * p.H + h) * p.Sq + q0 + tid;
    row_lse[tid] = tid < rows ? p.lse[idx] : 0.f;
    row_delta[tid] = tid < rows ? p.delta[idx] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < NSRC; ++s) {
    const Source src = p.src[s];
    const T* kb = static_cast<const T*>(src.k) + b * src.k_sb + h * src.k_sh;
    const T* vb = static_cast<const T*>(src.v) + b * src.v_sb + h * src.v_sh;
    for (int k0 = 0; k0 < src.len; k0 += DQ_BK) {
      const int nk = min(DQ_BK, src.len - k0);
      __syncthreads();  // the previous tile is consumed; Q, dO and rows are set
      load_tile<T, DQ_BK>(Ks, ld, kb + (long long)k0 * src.k_ss, src.k_ss, nk, D);
      load_tile<T, DQ_BK>(Vs, ld, vb + (long long)k0 * src.v_ss, src.v_ss, nk, D);
      __syncthreads();

      // logits and dP: this thread owns rows ty + 16 i, keys tx + 16 j
      float sacc[4][2], pacc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sacc[i][j] = pacc[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[4], ov[4], kv[2], vv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = Qs[(ty + 16 * i) * ld + d];
          ov[i] = dOs[(ty + 16 * i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          kv[j] = Ks[(tx + 16 * j) * ld + d];
          vv[j] = Vs[(tx + 16 * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
            pacc[i][j] = fmaf(ov[i], vv[j], pacc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = ty + 16 * i;
          const int c = tx + 16 * j;
          float ds = 0.f;
          if (c < nk) {
            const float pr = expf(sacc[i][j] * p.scale - row_lse[r]);
            ds = round_to<T>(pr * (pacc[i][j] - row_delta[r]) * p.scale);
          }
          dSs[r * (DQ_BK + 1) + c] = ds;
        }
      __syncthreads();

      // dQ += dS K
      for (int c = 0; c < nk; ++c) {
        float sv[4], kv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * (DQ_BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int col = tx + 16 * j;
          kv[j] = col < D ? Ks[c * ld + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    T* out = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh +
             (long long)(q0 + r) * p.dq_ss;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) store1(out + col, acc[i][j]);
    }
  }
}

template <typename T, int NSRC>
struct DqLaunch {
  const DqParams& p;
  int B;
  cudaStream_t stream;
  template <int DJ>
  cudaError_t run() {
    const size_t smem = dq_smem_bytes(p.D);
    cudaError_t err = cudaFuncSetAttribute(
        attention_dq<T, NSRC, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + DQ_BQ - 1) / DQ_BQ, p.H, B);
    attention_dq<T, NSRC, DJ><<<grid, NT, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

template <typename T>
cudaError_t dq_launch(int nsrc, const DqParams& p, int B, cudaStream_t stream) {
  if (nsrc == 1) {
    DqLaunch<T, 1> f{p, B, stream};
    return dispatch_dj(p.D, f);
  }
  DqLaunch<T, 2> f{p, B, stream};
  return dispatch_dj(p.D, f);
}

}  // namespace md

extern "C" int md_attention_dq(int dtype, int body, int nsrc, const void* q,
                               const void* k_self, const void* v_self,
                               const void* k_bank, const void* v_bank,
                               const void* dout, const float* lse,
                               const float* delta, void* dq,
                               const long long* strides, int B, int H, int D,
                               int Sq, int Sk, int Sb, float scale, void* stream) {
  if (!md::head_dim_ok(D) || Sq < 1 || B < 1 || H < 1 || Sk < 1 ||
      (nsrc == 2 && Sb < 1) || (nsrc != 1 && nsrc != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  md::DqParams p = {};
  p.q = q;
  p.dout = dout;
  p.dq = dq;
  p.lse = lse;
  p.delta = delta;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  const void* ks[2] = {k_self, k_bank};
  const void* vs[2] = {v_self, v_bank};
  const int lens[2] = {Sk, Sb};
  for (int s = 0; s < nsrc; ++s) {
    const long long* st = strides + 3 + 6 * s;
    p.src[s].k = ks[s];
    p.src[s].k_sb = st[0]; p.src[s].k_ss = st[1]; p.src[s].k_sh = st[2];
    p.src[s].v = vs[s];
    p.src[s].v_sb = st[3]; p.src[s].v_ss = st[4]; p.src[s].v_sh = st[5];
    p.src[s].len = lens[s];
  }
  p.do_sb = strides[15]; p.do_ss = strides[16]; p.do_sh = strides[17];
  p.dq_sb = strides[18]; p.dq_ss = strides[19]; p.dq_sh = strides[20];
  p.H = H;
  p.D = D;
  p.Sq = Sq;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && body == 0) return static_cast<int>(md::dq_launch<float>(nsrc, p, B, st));
  if (dtype == 1 && body == 2)
    return static_cast<int>(md::wg::launch_attention_dq(p, nsrc, B, st));
  if (dtype != 1 || body != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nsrc == 1) {
    md::tc::DqTcLaunch<1> f{p, B, st};
    return static_cast<int>(md::tc::dispatch_no(D, f));
  }
  md::tc::DqTcLaunch<2> f{p, B, st};
  return static_cast<int>(md::tc::dispatch_no(D, f));
}
