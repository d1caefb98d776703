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
// Two bodies. bf16 runs on the tensor cores (attention_tc of
// attention_mma.cuh, with one key segment); fp32 runs the CUDA-core body of
// attention_common.cuh, whose products are exact fp32 (TF32 is off on
// purpose: the card-vs-CPU checks and the fp32 paths need them).
//
// What bounds the bf16 body on an H100. At the main path's shapes
// (S = 4096/1024/256, D = 40/80/160) a (batch, head) does 4*Sq*Sk*D
// operations on 2*(Sq + Sk)*D*2 bytes, far above the card's ~295
// operations per byte, so it is bound by operations; at D = 40 the
// exponentials (Sq*Sk per head, 16 per SM per clock) outweigh the
// tensor-core time (989 TFLOP/s). What the design does: both products on
// the tensor cores (mma.sync m16n8k16, D padded to 48/80/160 for the
// contraction, 5/10/20 n8 output tiles), the logits tile kept in registers
// and re-packed as the PV product's A operand, one FMA and one ex2 per
// logit, K/V tiles streamed by cp.async into a two-stage ring while the
// previous tile is multiplied, one barrier per tile. At D <= 48 each warp
// owns two 16-row tiles (128 rows a block), which halves the shared-memory
// reads of K and V per row; tiles of 128 keys halve the barriers and the
// softmax rescales per key (64 for heads wider than 160, whose two stages
// of 128 keys would not fit in shared memory).
//
// Plain C interface, loaded with ctypes. Strides are in elements:
// strides[0..11] = q (batch, row, head), k (...), v (...), o (...).
// lse: nullptr, or a contiguous (B, H, Sq) fp32 output. Returns cudaGetLastError() of the launch (0 on success).

#include "attention_mma.cuh"

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
  if (!md::head_dim_ok(D) || Sq < 1 || Sk < 1 || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    md::tc::AttentionLaunch<md::tc::SELF> f{p, B, st};
    return static_cast<int>(md::tc::dispatch_no(D, f));
  }
  if (dtype == 0) return static_cast<int>(md::launch_d<float, 1>(p, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
