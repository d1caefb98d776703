// Kernel D: the dK/dV half of the attention backward pass, for one K/V
// source given the forward's log-sum-exp and delta = rowsum(dO o O):
//
//   P^T  = exp(k q^T * scale - lse)        (one column per query)
//   dV   = P^T dO                           (P rounded to dO's type first)
//   dS^T = P^T o (v dO^T - delta) * scale
//   dK   = dS^T q                           (dS rounded to q's type first)
//
// Replaces magicdance_tpu/ops/pallas/flash_vjp.py::_dkv_kernel (reached
// through _core_dkv). As in JAX, the same kernel serves the self source of
// self-attention and both sources of bank-read attention: the joint LSE
// already encodes the shared softmax. For a batch-1 bank read by B query
// batches (one reference image shared by every frame) one block walks the
// queries of every batch, so dK/dV come out summed over the frames directly:
// no atomics, a deterministic order, and none of the B-fold intermediate that
// JAX materializes and reduces (_core2_bwd, flash_vjp.py:457-461).
//
// Three bodies, chosen by the wrapper (ops/kernels/attention.py,
// attention_body) and named by the C entry's `body` argument: 2, bf16 at
// D <= 160, the Hopper body (wg::attention_dkv_wgmma of
// attention_bwd_wgmma.cuh: K and V copied once by TMA, Q/dO/lse/delta tiles
// through an mbarrier ring, four wgmma products per query tile), which
// alone takes nsplit > 1: the query walk split over nsplit blocks writing
// fp32 partials to `part` (2 x nsplit x Bk x Sk x H x D values), summed in
// split order by a second kernel, for grids too small to fill the card; 1,
// bf16 at any width, attention_dkv_tc of attention_bwd_mma.cuh (K and V
// held in shared memory, Q/dO/lse/delta tiles streamed through a cp.async
// ring, four mma.sync products per query tile, P^T and dS^T packed to bf16
// in registers); 0, fp32, the CUDA-core body below, whose products are
// exact fp32; it is compiled for fp32 only, so no bf16 call can reach it.
//
// What bounds it on an H100: 8 * Sq * Skv * D operations per (batch, head)
// (four products: k q^T, v dO^T, P^T dO, dS^T q) against ~6 * S * D input and
// output elements -- bound by operations at S >= 256.
//
// The CUDA-core body (fp32). One block of 256 threads owns
// one (key batch, head, 64-key tile): its K and V stay in shared memory
// (fp32), and dK and dV accumulate in fp32 registers (a 4 x (16 * DJ) slab
// each per thread). The block streams the queries in 32-row tiles of Q and
// dO with their LSE and delta; per tile each thread computes a 4 x 2 patch
// of k q^T and v dO^T with fp32 FMAs, the block stages P^T and dS^T in
// shared memory, and every thread adds its slab of P^T dO and dS^T q. At
// D = 256 the tiles take 214 KB of the 227 KB a block may use (141 KB at
// D = 160).
//
// Plain C interface, loaded with ctypes. Strides are in elements:
// strides[0..17] = k, v, q, dout, dk, dv, each (batch, row, head). lse and
// delta: contiguous (Bq, H, Sq) fp32. Bk is Bq, or 1 for a shared bank (then
// the k/v batch strides are ignored and dk/dv hold the sum over the Bq query
// batches). A body that cannot take the dtype, width or split returns
// cudaErrorInvalidValue; otherwise cudaGetLastError() of the launch(es).

#include "attention_bwd_mma.cuh"
#include "attention_bwd_wgmma.cuh"

namespace md {

constexpr int DKV_BK = 64;  // keys per block
constexpr int DKV_BQ = 32;  // queries per streamed tile

inline size_t dkv_smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) * (size_t)(2 * DKV_BK * ld + 2 * DKV_BQ * ld +
                                  2 * DKV_BK * (DKV_BQ + 1) + 2 * DKV_BQ);
}

template <typename T, int DJ>
__global__ void __launch_bounds__(NT) attention_dkv(const DkvParams p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  constexpr int LP = DKV_BQ + 1;
  float* Ks = smem;                  // DKV_BK x ld
  float* Vs = Ks + DKV_BK * ld;      // DKV_BK x ld
  float* Qs = Vs + DKV_BK * ld;      // DKV_BQ x ld
  float* dOs = Qs + DKV_BQ * ld;     // DKV_BQ x ld
  float* Ps = dOs + DKV_BQ * ld;     // DKV_BK x LP: P^T rounded to dO's type
  float* dSs = Ps + DKV_BK * LP;     // DKV_BK x LP: dS^T rounded to q's type
  float* row_lse = dSs + DKV_BK * LP;
  float* row_delta = row_lse + DKV_BQ;

  const int k0 = blockIdx.x * DKV_BK;
  const int h = blockIdx.y;
  const long long bk = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nk = min(DKV_BK, p.Sk - k0);

  load_tile<T, DKV_BK>(Ks, ld, static_cast<const T*>(p.k) + bk * p.k_sb + h * p.k_sh +
                                   (long long)k0 * p.k_ss, p.k_ss, nk, D);
  load_tile<T, DKV_BK>(Vs, ld, static_cast<const T*>(p.v) + bk * p.v_sb + h * p.v_sh +
                                   (long long)k0 * p.v_ss, p.v_ss, nk, D);

  float adk[4][DJ], adv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int b_first = p.shared_bank ? 0 : (int)bk;
  const int b_last = p.shared_bank ? p.Bq : (int)bk + 1;
  for (int bq = b_first; bq < b_last; ++bq) {
    const T* qb = static_cast<const T*>(p.q) + (long long)bq * p.q_sb + h * p.q_sh;
    const T* ob = static_cast<const T*>(p.dout) + (long long)bq * p.do_sb + h * p.do_sh;
    const float* lse = p.lse + ((long long)bq * p.H + h) * p.Sq;
    const float* delta = p.delta + ((long long)bq * p.H + h) * p.Sq;
    for (int q0 = 0; q0 < p.Sq; q0 += DKV_BQ) {
      const int nq = min(DKV_BQ, p.Sq - q0);
      __syncthreads();  // the previous tile is consumed; K and V are set
      load_tile<T, DKV_BQ>(Qs, ld, qb + (long long)q0 * p.q_ss, p.q_ss, nq, D);
      load_tile<T, DKV_BQ>(dOs, ld, ob + (long long)q0 * p.do_ss, p.do_ss, nq, D);
      if (tid < DKV_BQ) {
        row_lse[tid] = tid < nq ? lse[q0 + tid] : 0.f;
        row_delta[tid] = tid < nq ? delta[q0 + tid] : 0.f;
      }
      __syncthreads();

      // k q^T and v dO^T: this thread owns keys ty + 16 i, queries tx + 16 j
      float sacc[4][2], pacc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sacc[i][j] = pacc[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[2], ov[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * ld + d];
          vv[i] = Vs[(ty + 16 * i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qv[j] = Qs[(tx + 16 * j) * ld + d];
          ov[j] = dOs[(tx + 16 * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            sacc[i][j] = fmaf(kv[i], qv[j], sacc[i][j]);
            pacc[i][j] = fmaf(vv[i], ov[j], pacc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = ty + 16 * i;
          const int c = tx + 16 * j;
          float pt = 0.f, dst = 0.f;
          if (c < nq) {
            pt = expf(sacc[i][j] * p.scale - row_lse[c]);
            dst = pt * (pacc[i][j] - row_delta[c]) * p.scale;
          }
          Ps[r * LP + c] = round_to<T>(pt);
          dSs[r * LP + c] = round_to<T>(dst);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
      for (int c = 0; c < nq; ++c) {
        float pv[4], sv[4], ov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty + 16 * i) * LP + c];
          sv[i] = dSs[(ty + 16 * i) * LP + c];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int col = tx + 16 * j;
          ov[j] = col < D ? dOs[c * ld + col] : 0.f;
          qv[j] = col < D ? Qs[c * ld + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            adv[i][j] = fmaf(pv[i], ov[j], adv[i][j]);
            adk[i][j] = fmaf(sv[i], qv[j], adk[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nk) continue;
    T* dkr = static_cast<T*>(p.dk) + bk * p.dk_sb + h * p.dk_sh +
             (long long)(k0 + r) * p.dk_ss;
    T* dvr = static_cast<T*>(p.dv) + bk * p.dv_sb + h * p.dv_sh +
             (long long)(k0 + r) * p.dv_ss;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) {
        store1(dkr + col, adk[i][j]);
        store1(dvr + col, adv[i][j]);
      }
    }
  }
}

template <typename T>
struct DkvLaunch {
  const DkvParams& p;
  int Bk;
  cudaStream_t stream;
  template <int DJ>
  cudaError_t run() {
    const size_t smem = dkv_smem_bytes(p.D);
    cudaError_t err = cudaFuncSetAttribute(
        attention_dkv<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sk + DKV_BK - 1) / DKV_BK, p.H, Bk);
    attention_dkv<T, DJ><<<grid, NT, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace md

extern "C" int md_attention_dkv(int dtype, int body, int nsplit, const void* k,
                                const void* v, const void* q, const void* dout,
                                const float* lse, const float* delta, void* dk,
                                void* dv, float* part, const long long* strides,
                                int Bq, int Bk, int H, int D, int Sq, int Sk,
                                float scale, void* stream) {
  if (!md::head_dim_ok(D) || Sq < 1 || Sk < 1 || Bq < 1 || H < 1 ||
      !(Bk == Bq || Bk == 1) || nsplit < 1 || (nsplit > 1 && body != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  md::DkvParams p = {};
  p.k = k;
  p.v = v;
  p.q = q;
  p.dout = dout;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  p.delta = delta;
  p.k_sb = strides[0]; p.k_ss = strides[1]; p.k_sh = strides[2];
  p.v_sb = strides[3]; p.v_ss = strides[4]; p.v_sh = strides[5];
  p.q_sb = strides[6]; p.q_ss = strides[7]; p.q_sh = strides[8];
  p.do_sb = strides[9]; p.do_ss = strides[10]; p.do_sh = strides[11];
  p.dk_sb = strides[12]; p.dk_ss = strides[13]; p.dk_sh = strides[14];
  p.dv_sb = strides[15]; p.dv_ss = strides[16]; p.dv_sh = strides[17];
  p.H = H;
  p.D = D;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Bq = Bq;
  p.shared_bank = (Bk == 1 && Bq > 1) ? 1 : 0;
  p.nsplit = nsplit;
  p.part = part;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && body == 0) {
    md::DkvLaunch<float> f{p, Bk, st};
    return static_cast<int>(md::dispatch_dj(D, f));
  }
  if (dtype == 1 && body == 2) return static_cast<int>(md::wg::launch_attention_dkv(p, Bk, st));
  if (dtype == 1 && body == 1) {
    md::tc::DkvTcLaunch f{p, Bk, st};
    return static_cast<int>(md::tc::dispatch_no(D, f));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
