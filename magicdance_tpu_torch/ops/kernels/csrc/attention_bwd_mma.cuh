// mma.sync bodies of the attention backward: kernel C (dQ,
// attention_dq.cu) and kernel D (dK/dV, attention_dkv.cu) in bf16, and the
// launch parameters all of their bodies take. bf16 C and D run the Hopper
// body (attention_bwd_wgmma.cuh) where the wrappers pick it; these run the
// widths past it (C: D > 192, D: D > 160), operands TMA cannot read, and
// whatever a caller names. fp32 C and D stay on their CUDA-core bodies
// (exact fp32 products: the card-vs-CPU checks need them).
//
// Both recompute the forward's probabilities from the per-row log-sum-exp
// that kernels A and B write, P = exp2(s * scale * log2(e) - lse * log2(e)),
// so neither keeps a running max or rescales anything: P is final as soon
// as its logit is. delta = rowsum(dO o O) comes from the caller (a plain
// reduction, as JAX's _delta is XLA).
//
// Both are built from the tile routines of attention_mma.cuh (the A/B
// forward): one block of 4 warps, MR row tiles of 16 per warp, operands in
// shared memory read by ldmatrix, mma.sync m16n8k16 (bf16 in, fp32
// accumulate), D padded to KD k16 steps for the contractions and NO n8
// tiles for the outputs (dispatch_no), the streamed operand in a two-stage
// cp.async ring, one barrier per tile. qk_tile computes every product whose
// two operands are read as [rows][D] (S = Q K^T, dP = dO V^T and their
// transposes); pv_tile every product whose B operand is a [BN rows][D]
// tile read through ldmatrix.trans (dS K, P^T dO, dS^T Q). The fp32 tiles
// between them stay in registers and go to the next product as bf16 A
// fragments (pack_a), exactly where the JAX kernels cast to the input type.
//
// C (dQ, FA2's layout): a block owns 64 * MR query rows of one (batch,
// head); Q and dO stay in shared memory, each lane keeps its rows' lse and
// delta in registers. Per tile of BN keys (the self source's tiles, then the
// bank's, as in B's walk; a batch-1 bank at batch stride 0): S = Q K^T and
// dP = dO V^T, P from the LSE (keys past the end masked to 0), dS = P o (dP
// - delta) * scale in fp32, rounded to bf16 (JAX casts dS to K's dtype; P
// itself is not rounded before dS), dQ += dS K. Three products per tile.
//
// D (dK/dV): a block owns 64 * MR keys of one (key batch, head); K and V
// stay in shared memory, tiles of BN queries of Q and dO stream through the
// ring together with their lse and delta (fp32, in the same cp.async group).
// Per tile: S^T = K Q^T and dP^T = V dO^T, P^T from the LSE of each column
// (read from shared memory), dV += bf16(P^T) dO, dS^T = P^T o (dP^T -
// delta) * scale rounded to bf16, dK += dS^T Q. Four products per tile. For
// a batch-1 bank read by Bq query batches the block walks the queries of
// every batch, so dK/dV are summed over the frames in registers: no atomics,
// a fixed order.
//
// Why two kernels and not FA2's single fused backward. The fused kernel
// computes dQ inside D's loop and adds it into an fp32 scratch with atomics:
// 5 products instead of C's 3 + D's 4, but the sum then depends on the
// order of the atomics (run-to-run differences in dQ), and it needs an fp32
// dQ buffer and a cast pass. Two kernels keep every gradient deterministic
// and C's one- and two-source walks separate from D's per-source calls.
//
// What bounds them on an H100. C does 6 * Sq * Skv * D operations and D 8 *
// Sq * Sk * D per (batch, head, source) against ~(3 or 4) * S * D bf16
// elements: bound by operations; at D = 40 the one exponential per logit
// (16 per SM per clock) weighs about as much as the tensor-core time.

#pragma once

#include "attention_mma.cuh"

namespace md {

// Kernel C. Strides in elements; lse and delta contiguous (B, H, Sq) fp32.
struct DqParams {
  const void* q;
  const void* dout;
  void* dq;
  const float* lse;
  const float* delta;
  long long q_sb, q_ss, q_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  Source src[2];
  int H, D, Sq;
  float scale;
};

// Kernel D. lse and delta contiguous (Bq, H, Sq) fp32; shared_bank: a
// batch-1 source read by Bq > 1 query batches (dK/dV summed over them);
// nsplit > 1 (the Hopper body only): the query walk split over nsplit
// blocks, which write fp32 partials to part (attention_bwd_wgmma.cuh).
struct DkvParams {
  const void* k;
  const void* v;
  const void* q;
  const void* dout;
  void* dk;
  void* dv;
  const float* lse;
  const float* delta;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long q_sb, q_ss, q_sh;
  long long do_sb, do_ss, do_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float* part;
  int H, D, Sq, Sk, Bq;
  int shared_bank, nsplit;
  float scale;
};

namespace tc {

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// A warp's fp32 16 x BN tile (the mma accumulator layout) as the bf16 A
// fragments of a product over its BN columns (k-step kk holds n-tiles 2kk
// and 2kk + 1), the layout softmax_rows writes P in.
template <int BN>
__device__ __forceinline__ void pack_a(const float (&s)[BN / 8][4], uint32_t (&a)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    a[j >> 1][2 * (j & 1)] = pack_bf16x2(s[j][0], s[j][1]);
    a[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(s[j][2], s[j][3]);
  }
}

template <int KD, int MR, int BN>
inline size_t dq_smem_bytes_tc() {
  return sizeof(bf16) * (size_t)Tile<KD>::LDS * (2 * block_rows<MR>() + 4 * BN);
}

template <int KD, int MR, int BN>
inline size_t dkv_smem_bytes_tc() {
  return sizeof(bf16) * (size_t)Tile<KD>::LDS * (2 * block_rows<MR>() + 4 * BN) +
         sizeof(float) * 4 * BN;
}

// Kernel C, bf16: dQ of 64 * MR query rows of one (batch, head) over the
// keys of src[0], then (NSRC = 2) of src[1].
template <int KD, int NO, int MR, int BN, int NSRC>
__global__ void __launch_bounds__(NT) attention_dq_tc(const DqParams p) {
  constexpr int LDS = Tile<KD>::LDS;
  constexpr int KV = BN * LDS;  // elements of one K or V stage
  constexpr int QR = block_rows<MR>();
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(bwd_smem);
  bf16* dOs = Qs + QR * LDS;
  bf16* Ks = dOs + QR * LDS;  // two stages
  bf16* Vs = Ks + 2 * KV;     // two stages

  const int D = p.D;
  const int q0 = blockIdx.x * QR;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Source s0 = p.src[0];
  const Source s1 = p.src[NSRC - 1];
  const bf16* kb0 = static_cast<const bf16*>(s0.k) + b * s0.k_sb + h * s0.k_sh;
  const bf16* vb0 = static_cast<const bf16*>(s0.v) + b * s0.v_sb + h * s0.v_sh;
  const bf16* kb1 = static_cast<const bf16*>(s1.k) + b * s1.k_sb + h * s1.k_sh;
  const bf16* vb1 = static_cast<const bf16*>(s1.v) + b * s1.v_sb + h * s1.v_sh;
  const int tps = (s0.len + BN - 1) / BN;  // the bank's tiles follow the self tiles
  const int ntiles = tps + (NSRC == 2 ? (s1.len + BN - 1) / BN : 0);
  auto in_bank = [&](int t) { return NSRC == 2 && t >= tps; };
  auto valid_keys = [&](int t) {
    return in_bank(t) ? min(BN, s1.len - (t - tps) * BN) : min(BN, s0.len - t * BN);
  };
  auto load_kv = [&](int t) {
    const bool bank = in_bank(t);
    const long long k0 = (long long)(bank ? t - tps : t) * BN;
    const long long k_ss = bank ? s1.k_ss : s0.k_ss;
    const long long v_ss = bank ? s1.v_ss : s0.v_ss;
    const int stage = t & 1;
    load_tile_async<LDS, BN>(Ks + stage * KV, (bank ? kb1 : kb0) + k0 * k_ss, k_ss,
                             valid_keys(t), D);
    load_tile_async<LDS, BN>(Vs + stage * KV, (bank ? vb1 : vb0) + k0 * v_ss, v_ss,
                             valid_keys(t), D);
  };

  zero_pad_columns<KD>(Qs, 2 * QR + 4 * BN, D);  // Q, dO, K, V rows are contiguous
  load_tile_async<LDS, QR>(Qs, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh +
                                   (long long)q0 * p.q_ss,
                           p.q_ss, p.Sq - q0, D);
  load_tile_async<LDS, QR>(dOs, static_cast<const bf16*>(p.dout) + b * p.do_sb +
                                    h * p.do_sh + (long long)q0 * p.do_ss,
                           p.do_ss, p.Sq - q0, D);
  load_kv(0);
  cp_async_commit();

  // this lane's rows 16 (warp * MR + r) + lane / 4 (+ 8): lse * log2(e), delta
  float lse2[MR][2], dlt[MR][2];
  const long long rows0 = (b * p.H + h) * p.Sq;
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + (warp * MR + r) * 16 + (lane >> 2) + 8 * i;
      const bool ok = row < p.Sq;
      lse2[r][i] = ok ? p.lse[rows0 + row] * LOG2E : 0.f;
      dlt[r][i] = ok ? p.delta[rows0 + row] : 0.f;
    }

  const LaneAddr<KD, MR> la(warp, lane);
  const uint32_t q_addr = smem_u32(Qs) + la.q;
  const uint32_t do_addr = smem_u32(dOs) + la.q;
  const float scale = p.scale;
  const float scale_log2 = scale * LOG2E;
  const int c0 = 2 * (lane & 3);
  float acc[MR][NO][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();  // tile t (and Q, dO) have landed
    __syncthreads();     // and every warp is done with tile t - 1
    if (t + 1 < ntiles) load_kv(t + 1);  // into tile t - 1's stage
    cp_async_commit();
    const int stage = t & 1;
    const uint32_t k_tile = smem_u32(Ks + stage * KV);
    const uint32_t v_tile = smem_u32(Vs + stage * KV);
    const int nk = valid_keys(t);
    float s[MR][BN / 8][4], dp[MR][BN / 8][4];
    qk_tile<KD, MR, BN>(s, q_addr, k_tile + la.k);    // S = Q K^T
    qk_tile<KD, MR, BN>(dp, do_addr, v_tile + la.k);  // dP = dO V^T (V read as a K tile)
    uint32_t ds[MR][BN / 16][4];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float pr = ex2(fmaf(s[r][j][e], scale_log2, -lse2[r][i]));
          if (nk < BN && 8 * j + c0 + (e & 1) >= nk) pr = 0.f;
          s[r][j][e] = pr * (dp[r][j][e] - dlt[r][i]) * scale;
        }
      pack_a<BN>(s[r], ds[r]);
    }
    pv_tile<KD, NO, MR, BN>(acc, ds, k_tile + la.v);  // dQ += dS K
  }

  bf16* out = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh + (long long)q0 * p.dq_ss;
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int r = 0; r < MR; ++r)
    store_rows<NO>(out, p.dq_ss, (warp * MR + r) * 16 + (lane >> 2), p.Sq - q0, D, acc[r],
                   one);
}

// Kernel D, bf16: dK and dV of 64 * MR keys of one (key batch, head) over
// the queries of its batch, or of every batch for a shared bank.
template <int KD, int NO, int MR, int BN>
__global__ void __launch_bounds__(NT) attention_dkv_tc(const DkvParams p) {
  constexpr int LDS = Tile<KD>::LDS;
  constexpr int QT = BN * LDS;  // elements of one Q or dO stage
  constexpr int KR = block_rows<MR>();
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(bwd_smem);
  bf16* Vs = Ks + KR * LDS;
  bf16* Qs = Vs + KR * LDS;  // two stages
  bf16* dOs = Qs + 2 * QT;   // two stages
  float* rows = reinterpret_cast<float*>(dOs + 2 * QT);  // per stage: lse[BN], delta[BN]

  const int D = p.D;
  const int k0 = blockIdx.x * KR;
  const int h = blockIdx.y;
  const long long bk = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b_first = p.shared_bank ? 0 : (int)bk;
  const int tpb = (p.Sq + BN - 1) / BN;  // query tiles per batch
  const int ntiles = (p.shared_bank ? p.Bq : 1) * tpb;
  auto valid_queries = [&](int t) { return min(BN, p.Sq - (t % tpb) * BN); };
  auto load_q = [&](int t) {
    const long long bq = b_first + t / tpb;
    const int q0 = (t % tpb) * BN;
    const int nq = valid_queries(t);
    const int stage = t & 1;
    load_tile_async<LDS, BN>(Qs + stage * QT, static_cast<const bf16*>(p.q) + bq * p.q_sb +
                                                  h * p.q_sh + (long long)q0 * p.q_ss,
                             p.q_ss, nq, D);
    load_tile_async<LDS, BN>(dOs + stage * QT, static_cast<const bf16*>(p.dout) +
                                                   bq * p.do_sb + h * p.do_sh +
                                                   (long long)q0 * p.do_ss,
                             p.do_ss, nq, D);
    const long long r0 = (bq * p.H + h) * p.Sq + q0;
    const uint32_t dst = smem_u32(rows + stage * 2 * BN);
    for (int idx = threadIdx.x; idx < 2 * BN; idx += NT) {
      const int c = idx < BN ? idx : idx - BN;
      const float* src = (idx < BN ? p.lse : p.delta) + r0;
      cp_async4(dst + (uint32_t)idx * 4u, c < nq ? src + c : src, c < nq ? 4 : 0);
    }
  };

  zero_pad_columns<KD>(Ks, 2 * KR + 4 * BN, D);  // K, V, Q, dO rows are contiguous
  load_tile_async<LDS, KR>(Ks, static_cast<const bf16*>(p.k) + bk * p.k_sb + h * p.k_sh +
                                   (long long)k0 * p.k_ss,
                           p.k_ss, p.Sk - k0, D);
  load_tile_async<LDS, KR>(Vs, static_cast<const bf16*>(p.v) + bk * p.v_sb + h * p.v_sh +
                                   (long long)k0 * p.v_ss,
                           p.v_ss, p.Sk - k0, D);
  load_q(0);
  cp_async_commit();

  const LaneAddr<KD, MR> la(warp, lane);
  const uint32_t k_addr = smem_u32(Ks) + la.q;
  const uint32_t v_addr = smem_u32(Vs) + la.q;
  const float scale = p.scale;
  const float scale_log2 = scale * LOG2E;
  const int c0 = 2 * (lane & 3);
  float dk[MR][NO][4], dv[MR][NO][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[r][n][e] = dv[r][n][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();  // tile t (and K, V) have landed
    __syncthreads();     // and every warp is done with tile t - 1
    if (t + 1 < ntiles) load_q(t + 1);  // into tile t - 1's stage
    cp_async_commit();
    const int stage = t & 1;
    const uint32_t q_tile = smem_u32(Qs + stage * QT);
    const uint32_t do_tile = smem_u32(dOs + stage * QT);
    const float* lse_s = rows + stage * 2 * BN;
    const float* dlt_s = lse_s + BN;
    const int nq = valid_queries(t);
    float st[MR][BN / 8][4], dpt[MR][BN / 8][4];
    qk_tile<KD, MR, BN>(st, k_addr, q_tile + la.k);    // S^T = K Q^T
    qk_tile<KD, MR, BN>(dpt, v_addr, do_tile + la.k);  // dP^T = V dO^T
    // this lane's columns (queries) 8j + c0 and 8j + c0 + 1
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + c0);
      const float2 d = *reinterpret_cast<const float2*>(dlt_s + 8 * j + c0);
      const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
      const float dl[2] = {d.x, d.y};
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          float pr = ex2(fmaf(st[r][j][e], scale_log2, -l2[c]));
          if (nq < BN && 8 * j + c0 + c >= nq) pr = 0.f;
          dpt[r][j][e] = pr * (dpt[r][j][e] - dl[c]) * scale;
          st[r][j][e] = pr;
        }
    }
    uint32_t pa[MR][BN / 16][4], da[MR][BN / 16][4];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      pack_a<BN>(st[r], pa[r]);
      pack_a<BN>(dpt[r], da[r]);
    }
    pv_tile<KD, NO, MR, BN>(dv, pa, do_tile + la.v);  // dV += P^T dO
    pv_tile<KD, NO, MR, BN>(dk, da, q_tile + la.v);   // dK += dS^T Q
  }

  const float one[2] = {1.f, 1.f};
  bf16* dkb = static_cast<bf16*>(p.dk) + bk * p.dk_sb + h * p.dk_sh + (long long)k0 * p.dk_ss;
  bf16* dvb = static_cast<bf16*>(p.dv) + bk * p.dv_sb + h * p.dv_sh + (long long)k0 * p.dv_ss;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int row0 = (warp * MR + r) * 16 + (lane >> 2);
    store_rows<NO>(dkb, p.dk_ss, row0, p.Sk - k0, D, dk[r], one);
    store_rows<NO>(dvb, p.dv_ss, row0, p.Sk - k0, D, dv[r], one);
  }
}

template <int KD, int NO, int MR, int BN, int NSRC>
cudaError_t launch_dq_tc(const DqParams& p, int B, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes_tc<KD, MR, BN>();
  cudaError_t err = cudaFuncSetAttribute(attention_dq_tc<KD, NO, MR, BN, NSRC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + block_rows<MR>() - 1) / block_rows<MR>(), p.H, B);
  attention_dq_tc<KD, NO, MR, BN, NSRC><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KD, int NO, int MR, int BN>
cudaError_t launch_dkv_tc(const DkvParams& p, int Bk, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes_tc<KD, MR, BN>();
  cudaError_t err = cudaFuncSetAttribute(attention_dkv_tc<KD, NO, MR, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + block_rows<MR>() - 1) / block_rows<MR>(), p.H, Bk);
  attention_dkv_tc<KD, NO, MR, BN><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// Kernel C (NSRC sources) and kernel D through dispatch_no, with the tile
// rules a sweep on the card chose (PERF.md): C takes 64-key tiles and two
// row tiles per warp up to D = 80 (one above: dQ's accumulators and the two
// logits tiles would not fit the registers); D takes two key tiles per warp
// and 64-query tiles at D <= 48, one key tile and 64 queries up to D = 80,
// 32 up to D = 160 and 16 above (dK and dV hold 2 x 4 NO fp32 per lane; at
// D = 256 they spill).
template <int NSRC>
struct DqTcLaunch {
  const DqParams& p;
  int B;
  cudaStream_t stream;
  template <int KD, int NO>
  cudaError_t run() {
    constexpr int MR = NO <= 10 ? 2 : 1;
    return launch_dq_tc<KD, NO, MR, 64, NSRC>(p, B, stream);
  }
};

struct DkvTcLaunch {
  const DkvParams& p;
  int Bk;
  cudaStream_t stream;
  template <int KD, int NO>
  cudaError_t run() {
    constexpr int MR = NO <= 6 ? 2 : 1;
    constexpr int BN = NO <= 10 ? 64 : NO <= 20 ? 32 : 16;
    return launch_dkv_tc<KD, NO, MR, BN>(p, Bk, stream);
  }
};

}  // namespace tc
}  // namespace md
