// Kernel B: two-source (bank-read) attention forward: one joint softmax over
// [q K_self^T ; q K_bank^T] * scale, applied to [V_self ; V_bank].
//
// Replaces magicdance_tpu/ops/pallas/flash.py::_attn2_kernel_fused (packed,
// reached through _flash_attention_two_source_fused_impl; bank reads at
// S = 1024 and 256) and ::_attn2_kernel_nomask (BSNH, reached through
// _flash_attention_two_source_impl; bank reads at S = 4096). The kernel walks
// the self keys and then the bank keys with one running max and one running
// denominator, so the concatenation is never built. A batch-1 bank (one
// reference image shared by every frame) is read with batch stride 0. What
// bounds it and how the design answers that: see attention_common.cuh.
//
// Plain C interface, loaded with ctypes. Strides are in elements:
// strides[0..17] = q, k_self, v_self, k_bank, v_bank, o, each (batch, row,
// head). Returns cudaGetLastError() of the launch (0 on success).

#include "attention_common.cuh"

extern "C" int md_two_source_attention(int dtype, const void* q,
                                       const void* k_self, const void* v_self,
                                       const void* k_bank, const void* v_bank,
                                       void* o, const long long* strides, int B,
                                       int H, int D, int Sq, int Sk, int Sb,
                                       float scale, void* stream) {
  md::Params p = {};
  p.q = q;
  p.o = o;
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
  return static_cast<int>(
      md::launch_typed<2>(dtype, p, B, static_cast<cudaStream_t>(stream)));
}
