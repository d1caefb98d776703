// Kernel A: self-attention forward, softmax(q k^T * scale) v, optionally
// with the per-row log-sum-exp the backward pass reads.
//
// Replaces magicdance_tpu/ops/pallas/flash.py::_attn_kernel_fused (packed
// (B, S, H*D), reached through _flash_attention_fused_impl) and ::_attn_kernel
// (BSNH, reached through _flash_attention_impl). Packed and BSNH tensors are
// the same memory here, so one kernel takes batch, row and head strides and
// serves both. With an `lse` pointer it is the training forward and replaces
// magicdance_tpu/ops/pallas/flash_vjp.py::_fwd_lse_kernel. What bounds it
// and how the design answers that: see attention_common.cuh.
//
// Plain C interface, loaded with ctypes. Strides are in elements:
// strides[0..11] = q (batch, row, head), k (...), v (...), o (...).
// lse: nullptr, or a contiguous (B, H, Sq) fp32 output. Returns cudaGetLastError() of the launch (0 on success).

#include "attention_common.cuh"

extern "C" int md_self_attention(int dtype, const void* q, const void* k,
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
  return static_cast<int>(
      md::launch_typed<1>(dtype, p, B, static_cast<cudaStream_t>(stream)));
}
