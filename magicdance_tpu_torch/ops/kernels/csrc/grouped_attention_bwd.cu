// Kernel G backward: dq, dk and dv of grouped attention in one launch, from
// probabilities recomputed from q and k (the forward keeps no statistics).
//
// Replaces magicdance_tpu/ops/pallas/flash_vjp.py::_grouped_bwd_kernel
// (reached through _grouped_bwd, the custom VJP of mha_grouped). Arithmetic
// in the JAX kernel's order, per (sequence, head): fp32 logits,
// pn = exp(l - max) / denom, dp = dO v^T, delta = rowsum(pn * dp),
// ds = pn * (dp - delta) * scale; pn is cast to dO's type and ds to q's type
// before dv = pn^T dO, dk = ds^T q and dq = ds k, each accumulated in fp32.
// What bounds it and how the design answers that: see grouped_common.cuh.
//
// The block walks three phases with two S x D tiles resident: (q, k) ->
// logits and pn; (dO, v) -> dp, dv, delta and ds; (q, k) again -> dk, dq.
// Re-reading q and k costs 2*S*D elements per pair (they are in L2 by then)
// and keeps S = 64, D = 256 within a block's shared memory.
//
// Plain C interface, loaded with ctypes. Every tensor is an (N, S, H, D) view;
// strides[0..20] = q, k, v, dout, dq, dk, dv, each (sequence, row, head) in
// elements. Returns cudaGetLastError() of the launch (0 on success).

#include "grouped_common.cuh"

namespace md {
namespace grouped {

struct BwdParams {
  Operand q, k, v, dout, dq, dk, dv;
  int H, D, S;
  float scale;
};

template <typename T>
__device__ __forceinline__ T* out_ptr(const Operand& t, long long n, int h) {
  return static_cast<T*>(const_cast<void*>(t.p)) + n * t.sn + h * t.sh;
}

template <typename T>
__global__ void __launch_bounds__(GT) grouped_bwd(const BwdParams p) {
  extern __shared__ float smem[];
  const int S = p.S, D = p.D, ld = D + 1, lds = S + 1;
  float* A = smem;          // S x ld: q, then dO, then q
  float* Bt = A + S * ld;   // S x ld: k, then v, then k
  float* P = Bt + S * ld;   // S x lds: logits, then pn (fp32)
  float* DS = P + S * lds;  // S x lds: dp, then ds cast to T

  const long long pair = blockIdx.x;
  const long long n = pair / p.H;
  const int h = static_cast<int>(pair - n * p.H);
  const int tid = threadIdx.x;

  // phase 1: logits and the normalised probabilities
  load_rows<T>(A, ld, p.q, n, h, S, D);
  load_rows<T>(Bt, ld, p.k, n, h, S, D);
  __syncthreads();
  products(P, lds, A, Bt, ld, S, D, p.scale);
  __syncthreads();
  load_rows<T>(A, ld, p.dout, n, h, S, D);
  load_rows<T>(Bt, ld, p.v, n, h, S, D);
  if (tid < S) {
    float* row = P + tid * lds;
    float m = -INFINITY;
    for (int j = 0; j < S; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < S; ++j) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int j = 0; j < S; ++j) row[j] = row[j] / sum;
  }
  __syncthreads();

  // phase 2: dp = dO v^T; dv = pn^T dO; delta and ds per row
  products(DS, lds, A, Bt, ld, S, D, 1.f);
  __syncthreads();
  T* dv = out_ptr<T>(p.dv, n, h);
  for (int idx = tid; idx < S * D; idx += GT) {
    const int j = idx / D;
    const int c = idx - j * D;
    float acc = 0.f;
    for (int i = 0; i < S; ++i) acc = fmaf(round_to<T>(P[i * lds + j]), A[i * ld + c], acc);
    store1(dv + j * p.dv.si + c, acc);
  }
  if (tid < S) {
    const float* pn = P + tid * lds;
    float* row = DS + tid * lds;
    float delta = 0.f;
    for (int j = 0; j < S; ++j) delta += pn[j] * row[j];
    for (int j = 0; j < S; ++j) row[j] = round_to<T>((pn[j] * (row[j] - delta)) * p.scale);
  }
  __syncthreads();

  // phase 3: dk = ds^T q, dq = ds k
  load_rows<T>(A, ld, p.q, n, h, S, D);
  load_rows<T>(Bt, ld, p.k, n, h, S, D);
  __syncthreads();
  T* dk = out_ptr<T>(p.dk, n, h);
  T* dq = out_ptr<T>(p.dq, n, h);
  for (int idx = tid; idx < S * D; idx += GT) {
    const int r = idx / D;
    const int c = idx - r * D;
    float acc_k = 0.f, acc_q = 0.f;
    for (int i = 0; i < S; ++i) {
      acc_k = fmaf(DS[i * lds + r], A[i * ld + c], acc_k);
      acc_q = fmaf(DS[r * lds + i], Bt[i * ld + c], acc_q);
    }
    store1(dk + r * p.dk.si + c, acc_k);
    store1(dq + r * p.dq.si + c, acc_q);
  }
}

inline size_t bwd_smem(int S, int D) {
  return sizeof(float) * ((size_t)2 * S * (D + 1) + (size_t)2 * S * (S + 1));
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, long long pairs, cudaStream_t stream) {
  const size_t smem = bwd_smem(p.S, p.D);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  grouped_bwd<T><<<(unsigned)pairs, GT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace grouped
}  // namespace md

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int md_grouped_attention_bwd(int dtype, const void* q, const void* k,
                                        const void* v, const void* dout, void* dq,
                                        void* dk, void* dv, const long long* strides,
                                        int N, int H, int D, int S, float scale,
                                        void* stream) {
  using namespace md::grouped;
  const long long pairs = (long long)N * H;
  if (!shape_ok(S, D, N, H) || pairs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.q = operand(q, strides);
  p.k = operand(k, strides + 3);
  p.v = operand(v, strides + 6);
  p.dout = operand(dout, strides + 9);
  p.dq = operand(dq, strides + 12);
  p.dk = operand(dk, strides + 15);
  p.dv = operand(dv, strides + 18);
  p.H = H;
  p.D = D;
  p.S = S;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_bwd<float>(p, pairs, st);
  else if (dtype == 1)
    err = launch_bwd<__nv_bfloat16>(p, pairs, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
