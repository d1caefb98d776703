// Kernel B: two-source (bank-read) attention forward: one joint softmax over
// [q K_self^T ; q K_bank^T] * scale, applied to [V_self ; V_bank].
//
// Replaces magicdance_tpu/ops/pallas/flash.py::_attn2_kernel_fused (packed,
// reached through _flash_attention_two_source_fused_impl; bank reads at
// S = 1024 and 256) and ::_attn2_kernel_nomask (BSNH, reached through
// _flash_attention_two_source_impl; bank reads at S = 4096). The kernel walks
// the self keys and then the bank keys with one running max and one running
// denominator, so the concatenation is never built. A batch-1 bank (one
// reference image shared by every frame) is read with batch stride 0. With
// an `lse` pointer it is the training forward and replaces
// magicdance_tpu/ops/pallas/flash_vjp.py::_fwd2_lse_kernel (the joint LSE
// over both sources). With a `bank_mask` pointer it is the gated forward of
// fused classifier-free guidance and replaces flash.py::_attn2_kernel (the
// gate per batch row that the Pallas kernel reads by scalar prefetch): the
// bank probabilities are multiplied by bank_mask[b] after the exp, inside the
// joint max and denominator; a row whose gate is exactly 0 skips the bank
// tiles and is plain self-attention.
//
// Three bodies, chosen by the wrapper (ops/kernels/attention.py,
// attention_body) and named by the C entry's `body` argument: 2, bf16 at
// D <= 192, the Hopper body (wg::attention_wgmma in MODE TWO_SOURCE, with
// or without the LSE, or GATED; attention_wgmma.cuh); 1, bf16 at any width,
// attention_tc of attention_mma.cuh in the same modes (mma.sync; the
// wrapper takes it above 192, at the short shapes where it is the faster
// body, and for operands TMA cannot read); 0, fp32,
// the CUDA-core body of attention_common.cuh, whose products are exact
// fp32 (TF32 is off on purpose: the card-vs-CPU checks and the fp32 paths
// need them).
//
// What bounds the bf16 body on an H100. A (batch, head) does
// 4*Sq*(Sk + Sb)*D operations on 2*(Sq + Sk + Sb)*D*2 bytes, far above the
// card's ~295 operations per byte, so the work is bound by operations; at
// D = 40 the exponentials (Sq*(Sk + Sb) per head, 16 per SM per clock)
// outweigh the tensor-core time. What the design does: the self tiles and
// then the bank tiles go through one tile loop (tile t < ceil(Sk / 64) is
// a self tile, the rest bank tiles; no tile straddles the two, each
// source's ragged last tile is masked) with one running (m, l, acc) in
// registers, so B costs what kernel A costs over Sk + Sb keys. In the
// Hopper body each source has its own K and V TMA maps (a batch-1 bank is
// encoded with batch extent 1 and read at batch coordinate 0: TMA takes no
// stride of 0), and the producer walks the same tiles as the consumers.
//
// Plain C interface, loaded with ctypes. Strides are in elements:
// strides[0..17] = q, k_self, v_self, k_bank, v_bank, o, each (batch, row,
// head). lse: nullptr, or a contiguous (B, H, Sq) fp32 output. bank_mask:
// nullptr, or a (B,) fp32 gate on the card. dtype and body as in
// self_attention.cu. Returns cudaGetLastError() of the launch (0 on
// success).

#include "attention_mma.cuh"
#include "attention_wgmma.cuh"

extern "C" int md_two_source_attention(int dtype, int body, const void* q,
                                       const void* k_self, const void* v_self,
                                       const void* k_bank, const void* v_bank,
                                       void* o, float* lse,
                                       const float* bank_mask,
                                       const long long* strides, int B,
                                       int H, int D, int Sq, int Sk, int Sb,
                                       float scale, void* stream) {
  md::Params p = {};
  p.q = q;
  p.o = o;
  p.lse = lse;
  p.gate = bank_mask;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  const void* ks[2] = {k_self, k_bank};
  const void* vs[2] = {v_self, v_bank};
  const int lens[2] = {Sk, Sb};
  for (int s = 0; s < 2; ++s) {
    const long long* st = strides + 3 + 6 * s;
    p.src[s].k = ks[s];
    p.src[s].k_sb = st[0]; p.src[s].k_ss = st[1]; p.src[s].k_sh = st[2];
    p.src[s].v = vs[s];
    p.src[s].v_sb = st[3]; p.src[s].v_ss = st[4]; p.src[s].v_sh = st[5];
    p.src[s].len = lens[s];
  }
  p.o_sb = strides[15]; p.o_ss = strides[16]; p.o_sh = strides[17];
  p.H = H;
  p.D = D;
  p.Sq = Sq;
  p.scale = scale;
  if (!md::head_dim_ok(D) || Sq < 1 || Sk < 1 || Sb < 1 || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && body == 2) {
    if (bank_mask != nullptr)
      return static_cast<int>(md::wg::launch_attention<md::tc::GATED>(p, B, st));
    return static_cast<int>(md::wg::launch_attention<md::tc::TWO_SOURCE>(p, B, st));
  }
  if (dtype == 1 && body == 1) {
    if (bank_mask != nullptr) {
      md::tc::AttentionLaunch<md::tc::GATED> f{p, B, st};
      return static_cast<int>(md::tc::dispatch_no(D, f));
    }
    md::tc::AttentionLaunch<md::tc::TWO_SOURCE> f{p, B, st};
    return static_cast<int>(md::tc::dispatch_no(D, f));
  }
  if (dtype == 0 && body == 0) return static_cast<int>(md::launch_d<float, 2>(p, B, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
