// Shared pieces of the grouped (temporal) attention kernels,
// grouped_attention.cu (forward) and grouped_attention_bwd.cu (backward).
//
// They replace magicdance_tpu/ops/pallas/flash.py::_grouped_attn_kernel and
// magicdance_tpu/ops/pallas/flash_vjp.py::_grouped_bwd_kernel: exact
// softmax(q k^T * scale) v, and its gradient, for many short independent
// sequences (S <= 64 rows, S | 128) laid out packed (rows, H*D) with rows =
// N*S -- the AnimateDiff motion module's attention over the frame axis,
// (b*h*w, F = 16, C).
//
// What the TPU kernel did, and why it is not carried over. The Pallas kernel
// takes 128-row tiles and computes one (128, 128) logits product per head
// with a block-diagonal -1e30 mask, so that the MXU sees MXU-shaped work; at
// S = 16 that is 8x the arithmetic the function needs. Here every
// (sequence, head) pair is computed directly over its own S rows.
//
// What bounds it on an H100. Per (sequence, head) the work is 4*S*S*D
// operations on 4*S*D elements (q, k, v in, o out), about S/2 operations per
// element: at S = 16 that is ~4 per bf16 byte, far below the card's ~295, so
// the kernels are bound by device memory. The least time of the forward at
// the first motion level, (4096*16, 320) bf16, is 4 x 42 MB over 3.35 TB/s,
// ~0.05 ms.
//
// The CUDA-core design (first, simple version), kept for fp32 only: the
// fp32 forward and backward, whose products are exact fp32 (the card-vs-CPU
// checks need them). One block of GT = 128 threads owns one (sequence,
// head) pair. It stages the pair's S x D tiles in fp32 shared memory (rows
// padded to an odd stride), computes the S x S logits with one thread per
// entry, the row softmax with one thread per row, and the S x D outputs
// with one thread per element. Two tiles are resident at a time, so S =
// 64, D = 256 fits in a block's shared memory (forward 148 KB, backward
// 165 KB). Products are fp32 FMAs on the CUDA cores. bf16 runs on the
// tensor cores instead, forward and backward (grouped_tc in
// grouped_attention.cu, grouped_bwd_tc in grouped_attention_bwd.cu, with
// the block geometry of grouped_tc.cuh: several pairs a block, 16-byte row
// pieces across heads, one warp per 16-row tile).

#pragma once

#include "attention_common.cuh"

namespace md {
namespace grouped {

constexpr int GT = 128;                       // threads per block
constexpr size_t MAX_SMEM = 232448;           // a block's shared-memory limit

// One operand: base pointer and (sequence, row, head) strides in elements;
// the head dim has unit stride.
struct Operand {
  const void* p;
  long long sn, si, sh;
};

__host__ __device__ inline Operand operand(const void* p, const long long* s) {
  Operand o = {p, s[0], s[1], s[2]};
  return o;
}

// Copy the S x D tile of (sequence n, head h) of `t` into fp32 shared memory
// with leading dimension ld. D is a multiple of 8 and every row starts on a
// 16-byte boundary (the Python wrapper checks both).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const Operand& t,
                                          long long n, int h, int S, int D) {
  const T* base = static_cast<const T*>(t.p) + n * t.sn + h * t.sh;
  const int chunks = D >> 3;
  for (int idx = threadIdx.x; idx < S * chunks; idx += GT) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) << 3;
    float vals[8];
    load8(base + r * t.si + c, vals);
    float* d = dst + r * ld + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = vals[j];
  }
}

// out[i][j] = scale * sum_d a[i][d] * b[j][d] over the S x S entries.
__device__ __forceinline__ void products(float* out, int lds, const float* a,
                                         const float* b, int ld, int S, int D,
                                         float scale) {
  for (int idx = threadIdx.x; idx < S * S; idx += GT) {
    const int i = idx / S;
    const int j = idx - i * S;
    const float* ai = a + i * ld;
    const float* bj = b + j * ld;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(ai[d], bj[d], acc);
    out[i * lds + j] = acc * scale;
  }
}

inline bool shape_ok(int S, int D, long long N, int H) {
  return S >= 1 && S <= 64 && 128 % S == 0 && D >= 8 && D <= 256 && D % 8 == 0 &&
         N >= 1 && H >= 1;
}

}  // namespace grouped
}  // namespace md
