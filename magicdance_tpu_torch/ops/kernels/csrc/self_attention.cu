// Kernel A: self-attention forward, softmax(q k^T * scale) v, optionally
// with the per-row log-sum-exp the backward pass reads.
//
// Replaces magicdance_tpu/ops/pallas/flash.py::_attn_kernel_fused (packed
// (B, S, H*D), reached through _flash_attention_fused_impl) and ::_attn_kernel
// (BSNH, reached through _flash_attention_impl). Packed and BSNH tensors are
// the same memory here, so one kernel takes batch, row and head strides and
// serves both. With an `lse` pointer it is the training forward and replaces
// magicdance_tpu/ops/pallas/flash_vjp.py::_fwd_lse_kernel.
//
// Three bodies, chosen by the wrapper (ops/kernels/attention.py,
// attention_body) and named by the C entry's `body` argument:
//   2  bf16 at D <= 192: the Hopper body (wg::attention_wgmma in MODE SELF,
//      attention_wgmma.cuh): TMA into a three-stage mbarrier ring, one
//      producer warp, two consumer warpgroups of 64 query rows running
//      wgmma, 128-key tiles up to D = 80 and 64 above;
//   1  bf16 at any width (the wrapper takes it above 192, where Q and three
//      stages of K and V no longer fit in shared memory, at the short
//      shapes where it is the faster body, and for operands TMA cannot
//      read): attention_tc of attention_mma.cuh (mma.sync);
//   0  fp32: the CUDA-core body of attention_common.cuh, whose products are
//      exact fp32 (TF32 is off on purpose: the card-vs-CPU checks and the
//      fp32 paths need them).
//
// What bounds the bf16 body on an H100. At the main path's shapes
// (S = 4096/1024/256, D = 40/80/160) a (batch, head) does 4*Sq*Sk*D
// operations on 2*(Sq + Sk)*D*2 bytes, far above the card's ~295
// operations per byte, so it is bound by operations; at D = 40 the
// exponentials (Sq*Sk per head, 16 per SM per clock) outweigh the
// tensor-core time (989 TFLOP/s). What the design does: both products on
// wgmma, the only way to the tensor cores' full rate, fed by TMA copies
// that cost the consumers no instructions; the logits tile kept in
// registers and re-packed as the PV product's A operand; one FMA and one
// exponential per logit.
//
// Plain C interface, loaded with ctypes. Strides are in elements:
// strides[0..11] = q (batch, row, head), k (...), v (...), o (...).
// lse: nullptr, or a contiguous (B, H, Sq) fp32 output. dtype: 0 = float32,
// 1 = bfloat16; body: 0 = CUDA cores (fp32), 1 = attention_tc (bf16), 2 =
// attention_wgmma (bf16, D <= 192); any other pairing is refused with
// cudaErrorInvalidValue. Returns cudaGetLastError() of the launch (0 on
// success).

#include "attention_mma.cuh"
#include "attention_wgmma.cuh"

extern "C" int md_self_attention(int dtype, int body, const void* q, const void* k,
                                 const void* v, void* o, float* lse,
                                 const long long* strides, int B, int H, int D,
                                 int Sq, int Sk, float scale, void* stream) {
  md::Params p = {};
  p.q = q;
  p.o = o;
  p.lse = lse;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.src[0].k = k;
  p.src[0].k_sb = strides[3]; p.src[0].k_ss = strides[4]; p.src[0].k_sh = strides[5];
  p.src[0].v = v;
  p.src[0].v_sb = strides[6]; p.src[0].v_ss = strides[7]; p.src[0].v_sh = strides[8];
  p.src[0].len = Sk;
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.H = H;
  p.D = D;
  p.Sq = Sq;
  p.scale = scale;
  if (!md::head_dim_ok(D) || Sq < 1 || Sk < 1 || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && body == 2)
    return static_cast<int>(md::wg::launch_attention<md::tc::SELF>(p, B, st));
  if (dtype == 1 && body == 1) {
    md::tc::AttentionLaunch<md::tc::SELF> f{p, B, st};
    return static_cast<int>(md::tc::dispatch_no(D, f));
  }
  if (dtype == 0 && body == 0) return static_cast<int>(md::launch_d<float, 1>(p, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
