// Kernel G: grouped (temporal) attention forward -- for each of N
// independent sequences of S rows and each head, softmax(q k^T * scale) v.
//
// Replaces magicdance_tpu/ops/pallas/flash.py::_grouped_attn_kernel (reached
// through _flash_attention_grouped_impl). Arithmetic in the JAX kernel's
// order: fp32 logits, unnormalised probabilities p = exp(l - max) cast to
// v's type, P V accumulated in fp32, divided by the fp32 denominator (the sum
// of the uncast p), cast to the output type. What bounds it and how the
// design answers that: see grouped_common.cuh.
//
// Plain C interface, loaded with ctypes. q, k, v, o are (N, S, H, D) views
// (packed (N*S, H*D) projection outputs); strides[0..11] = q, k, v, o, each
// (sequence, row, head) in elements. Returns cudaGetLastError() of the
// launch (0 on success).

#include "grouped_common.cuh"

namespace md {
namespace grouped {

struct FwdParams {
  Operand q, k, v, o;
  int H, D, S;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(GT) grouped_fwd(const FwdParams p) {
  extern __shared__ float smem[];
  const int S = p.S, D = p.D, ld = D + 1, lds = S + 1;
  float* A = smem;           // S x ld: q, then v
  float* Bt = A + S * ld;    // S x ld: k
  float* P = Bt + S * ld;    // S x lds: logits, then p cast to T
  float* denom = P + S * lds;

  const long long pair = blockIdx.x;
  const long long n = pair / p.H;
  const int h = static_cast<int>(pair - n * p.H);

  load_rows<T>(A, ld, p.q, n, h, S, D);
  load_rows<T>(Bt, ld, p.k, n, h, S, D);
  __syncthreads();
  products(P, lds, A, Bt, ld, S, D, p.scale);
  __syncthreads();

  // q is consumed: v takes its place while one thread per row runs the softmax
  load_rows<T>(A, ld, p.v, n, h, S, D);
  if (threadIdx.x < S) {
    float* row = P + threadIdx.x * lds;
    float m = -INFINITY;
    for (int j = 0; j < S; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < S; ++j) {
      const float e = expf(row[j] - m);
      sum += e;
      row[j] = round_to<T>(e);
    }
    denom[threadIdx.x] = sum;
  }
  __syncthreads();

  T* o = static_cast<T*>(const_cast<void*>(p.o.p)) + n * p.o.sn + h * p.o.sh;
  for (int idx = threadIdx.x; idx < S * D; idx += GT) {
    const int i = idx / D;
    const int c = idx - i * D;
    const float* pi = P + i * lds;
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc = fmaf(pi[j], A[j * ld + c], acc);
    store1(o + i * p.o.si + c, acc / denom[i]);
  }
}

inline size_t fwd_smem(int S, int D) {
  return sizeof(float) * ((size_t)2 * S * (D + 1) + (size_t)S * (S + 1) + S);
}

template <typename T>
cudaError_t launch_fwd(const FwdParams& p, long long pairs, cudaStream_t stream) {
  const size_t smem = fwd_smem(p.S, p.D);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  grouped_fwd<T><<<(unsigned)pairs, GT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace grouped
}  // namespace md

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int md_grouped_attention(int dtype, const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* strides, int N, int H,
                                    int D, int S, float scale, void* stream) {
  using namespace md::grouped;
  const long long pairs = (long long)N * H;
  if (!shape_ok(S, D, N, H) || pairs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p;
  p.q = operand(q, strides);
  p.k = operand(k, strides + 3);
  p.v = operand(v, strides + 6);
  p.o = operand(o, strides + 9);
  p.H = H;
  p.D = D;
  p.S = S;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_fwd<float>(p, pairs, st);
  else if (dtype == 1)
    err = launch_fwd<__nv_bfloat16>(p, pairs, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
