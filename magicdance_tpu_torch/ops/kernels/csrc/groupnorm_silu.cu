// Kernel K8: fused GroupNorm + SiLU forward, y = SiLU(GN(x) * gamma + beta),
// with fp32 statistics and an fp32 affine, written in x's type.
//
// Replaces magicdance_tpu/ops/pallas/groupnorm.py::_gn_silu_kernel (reached
// through groupnorm_silu, the opt-in MAGICDANCE_FUSED_GN=1 path of
// models/layers.py::GroupNorm32 with act=True).
//
// What bounds it on an H100. The work is a few operations per element, so it
// is bound by device memory: the least it can move is one read and one write
// of x. The Pallas kernel keeps one whole batch row (H*W x C) in VMEM across
// its statistics and normalize phases, 2.6 MB at (4096, 320) in bf16; a
// Hopper block has at most 227 KB of shared memory, so that design does not
// carry over.
//
// What the design does about it (first, simple version). One block of 512
// threads owns one (batch row, group): the (H*W x C/G) slab of that group,
// 80 KB at (4096, 320) in bf16, which stays in L2 between sweeps. Sweep 1
// sums the slab (fp32) for the mean, sweep 2 sums the squared deviations from
// it for the variance (two passes: no cancellation in E[x^2] - E[x]^2), and
// sweep 3 normalises, applies the per-channel affine and SiLU and writes. So
// x is read once from device memory and twice more from L2; consecutive
// threads take consecutive channels of a row, then the next row. The grid is
// B x G blocks (64 at B = 2), fewer than the card's 132 SMs: splitting the
// rows of a group over several blocks is the later work.
//
// Plain C interface, loaded with ctypes. x and y are (B, HW, C) with unit
// channel stride; strides[0..3] = x (batch, row), y (batch, row) in elements.
// gamma, beta: (C,) fp32. Returns cudaGetLastError() of the launch (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace md {
namespace gn {

constexpr int NT = 512;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Params {
  const void* x;
  void* y;
  const float* gamma;
  const float* beta;
  long long x_sb, x_ss, y_sb, y_ss;
  int HW, C, G;
  float eps;
};

// Sum of v over the block; every thread gets the result. `red` holds one
// float per warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // `red` is free: an earlier call's readers are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (NT >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

template <typename T>
__global__ void __launch_bounds__(NT) groupnorm_silu(const Params p) {
  __shared__ float red[NT / 32];
  const int g = blockIdx.x;
  const long long b = blockIdx.y;
  const int cg = p.C / p.G;
  const long long n = (long long)p.HW * cg;
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + (long long)g * cg;
  T* y = static_cast<T*>(p.y) + b * p.y_sb + (long long)g * cg;

  float s = 0.f;
  for (long long i = threadIdx.x; i < n; i += NT) {
    const long long r = i / cg;
    s += to_f(x[r * p.x_ss + (i - r * cg)]);
  }
  const float mean = block_sum(s, red) / (float)n;

  float ss = 0.f;
  for (long long i = threadIdx.x; i < n; i += NT) {
    const long long r = i / cg;
    const float d = to_f(x[r * p.x_ss + (i - r * cg)]) - mean;
    ss = fmaf(d, d, ss);
  }
  const float inv = rsqrtf(block_sum(ss, red) / (float)n + p.eps);

  const float* gamma = p.gamma + g * cg;
  const float* beta = p.beta + g * cg;
  for (long long i = threadIdx.x; i < n; i += NT) {
    const long long r = i / cg;
    const int c = (int)(i - r * cg);
    const float v = (to_f(x[r * p.x_ss + c]) - mean) * inv * gamma[c] + beta[c];
    put(y + r * p.y_ss + c, v / (1.f + expf(-v)));
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid(p.G, B);
  groupnorm_silu<T><<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace gn
}  // namespace md

extern "C" int md_groupnorm_silu(int dtype, const void* x, const float* gamma,
                                 const float* beta, void* y,
                                 const long long* strides, int B, int HW,
                                 int C, int G, float eps, void* stream) {
  if (B < 1 || HW < 1 || G < 1 || C < G || C % G != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  md::gn::Params p = {};
  p.x = x;
  p.y = y;
  p.gamma = gamma;
  p.beta = beta;
  p.x_sb = strides[0]; p.x_ss = strides[1];
  p.y_sb = strides[2]; p.y_ss = strides[3];
  p.HW = HW;
  p.C = C;
  p.G = G;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(md::gn::launch<float>(p, B, s));
  if (dtype == 1) return static_cast<int>(md::gn::launch<__nv_bfloat16>(p, B, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* md_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
