// Tensor-core tile routines and kernel (attention_tc, at the end) of the
// bf16 attention kernels on mma.sync: the bf16 body of kernels A
// (self_attention.cu), B in all its modes (two_source_attention.cu: two
// sources, with the LSE output, gated) and K9, head-packed attention
// (packed_attention.cu, kernel A over G key segments), at the widths past
// the Hopper body's (attention_wgmma.cuh: D > 192, K9's G*D > 128) and
// whenever a caller names it (body 1 of the C entries). The Hopper body
// runs the softmax routine below (softmax_rows) on its wgmma accumulators.
// fp32 A and B stay on the CUDA-core body of attention_common.cuh, fp32 K9
// on its own. The bf16 backward kernels C and D (attention_bwd_mma.cuh) are
// built from the same tile routines (qk_tile, pv_tile, the loaders and the
// dispatch).
//
// One block of 4 warps owns 64 * MR query rows; each warp owns MR row
// tiles of 16 (MR = 2 lets two row tiles share every K and V fragment read
// from shared memory). Per tile of BN keys (64 or 128) a warp computes its
// 16 x BN logits tiles with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) from operands that ldmatrix
// reads out of shared memory, keeps the tile in registers, runs the online
// softmax there (exp2 with scale * log2(e) folded into one FMA; the row's
// max and sum reduced by shuffles inside the quad of lanes that holds the
// row), packs the unnormalised probabilities as bf16 A fragments as soon as
// they are computed and multiplies them into the fp32 output accumulator
// with a second mma (the FA2 register layout: no logits tile goes through
// shared memory).
//
// Widths. The contraction pads D to KD k16 steps (D = 40 -> 48, 80, 160),
// the output to NO n8 tiles (40 = 5 tiles). Columns D..16*KD of every
// shared tile are zeroed once and never written again, so the padded
// products add zeros. Shared rows are 16*KD + 8 elements long: the stride
// is an odd multiple of 16 bytes, so the 8 rows one ldmatrix reads hit 8
// different bank groups.
//
// Pipeline. K/V tiles arrive through cp.async 16-byte copies into a
// two-stage ring: the copy of tile t + 1 is in flight while tile t is
// multiplied, and one barrier per tile frees the stage that the next copy
// fills. Rows past the end of a sequence are zero-filled by the copy
// (src-size 0) and their logits masked to -inf.

#pragma once

#include "attention_common.cuh"

namespace md {
namespace tc {

constexpr int NT = 128;  // threads per block (4 warps)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

template <int KD>
struct Tile {
  static constexpr int DP = 16 * KD;  // contraction width
  static constexpr int LDS = DP + 8;  // shared row stride, elements
};

// Rows of one block: 4 warps of MR row tiles of 16.
template <int MR>
__host__ __device__ constexpr int block_rows() { return 4 * 16 * MR; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Start cp.async copies of `rows_valid` rows of D bf16 values (row stride
// `row_stride` elements) into a ROWS-row shared tile of stride LDS; the
// other rows are zero-filled. D is a multiple of 8 and every row start is
// 16-byte aligned (the Python wrappers check both).
template <int LDS, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long row_stride, int rows_valid,
                                                int D) {
  const int chunks = D >> 3;
  const uint32_t base = smem_u32(dst);
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += NT) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) << 3;
    const bool ok = r < rows_valid;
    cp_async16(base + (uint32_t)(r * LDS + c) * 2u, ok ? src + r * row_stride + c : src,
               ok ? 16 : 0);
  }
}

// Zero columns [D, DP) of `rows` consecutive shared rows, so that the padded
// products add zeros. Any block size: the grouped kernels run 2 or 4 warps.
template <int KD>
__device__ __forceinline__ void zero_pad_columns(bf16* tiles, int rows, int D) {
  using T = Tile<KD>;
  const int w = (T::DP - D) >> 3;
  if (w <= 0) return;
  for (int idx = threadIdx.x; idx < rows * w; idx += blockDim.x) {
    const int r = idx / w;
    const int c = D + ((idx - r * w) << 3);
    *reinterpret_cast<uint4*>(tiles + r * T::LDS + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Running state of one warp's row tiles: in row tile r this lane holds rows
// 16r + g and 16r + g + 8 (g = lane / 4); m in the log2 domain, l this
// lane's partial sum.
template <int NO, int MR = 1>
struct RowState {
  float m[MR][2];
  float l[MR][2];
  float acc[MR][NO][4];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      m[r][0] = m[r][1] = -INFINITY;
      l[r][0] = l[r][1] = 0.f;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.f;
    }
  }
};

// Per-lane shared-memory addresses of one warp's ldmatrix reads at k-step 0
// of a tile: the Q A fragment of row tile 0 (rows w*16*MR + lane%16, column
// 8 * (lane/16); row tile r is 16 rows on),
// the K B fragments of key n-tiles 2p, 2p+1 (keys lane%8 + 8*(lane/16),
// column 8 * ((lane/8)%2)) and the V B fragments of output n-tiles 2p, 2p+1
// (keys lane%16, column 8 * (lane/16)). Byte offsets.
template <int KD, int MR = 1>
struct LaneAddr {
  uint32_t q, k, v;
  __device__ __forceinline__ LaneAddr(int warp, int lane) {
    constexpr int LDS = Tile<KD>::LDS;
    q = (uint32_t)((warp * 16 * MR + (lane & 15)) * LDS + (lane >> 4) * 8) * 2u;
    k = (uint32_t)(((lane & 7) + (lane >> 4) * 8) * LDS + ((lane >> 3) & 1) * 8) * 2u;
    v = (uint32_t)((lane & 15) * LDS + (lane >> 4) * 8) * 2u;
  }
};

// s = Q K^T for one warp's row tiles and the tile's BN keys: s[r][j] is row
// tile r, key n-tile j (keys 8j..8j+7), fp32.
template <int KD, int MR, int BN>
__device__ __forceinline__ void qk_tile(float (&s)[MR][BN / 8][4], uint32_t q_addr,
                                        uint32_t k_addr) {
  constexpr int LDS = Tile<KD>::LDS;
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[r][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t a[MR][4];
#pragma unroll
    for (int r = 0; r < MR; ++r) ldsm_x4(a[r], q_addr + (uint32_t)(r * 16 * LDS * 2 + kk * 32));
#pragma unroll
    for (int p = 0; p < BN / 16; ++p) {
      uint32_t b[4];
      ldsm_x4(b, k_addr + (uint32_t)(p * 16 * LDS * 2 + kk * 32));
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        mma16816(s[r][2 * p], a[r], b[0], b[1]);
        mma16816(s[r][2 * p + 1], a[r], b[2], b[3]);
      }
    }
  }
}

// Online softmax over one row tile's logits, in the log2 domain: keys at or
// past `nk` are masked; the row max and the rescale factor are shared by
// the quad, the sums stay per lane until the end. Writes P = exp2(s * c - m)
// as bf16 pairs laid out as the A fragments of the PV product (k-step kk
// holds key n-tiles 2kk and 2kk + 1), so the fp32 logits die here. GATE:
// P is multiplied by `gate` after the exp, before it enters the row sum and
// is rounded to bf16; the max stays over the unscaled logits.
template <int NO, int BN, bool GATE>
__device__ __forceinline__ void softmax_rows(float (&s)[BN / 8][4], uint32_t (&pa)[BN / 16][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[NO][4], float scale_log2, int nk,
                                             float gate) {
  if (nk < BN) {
    const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + c0 + (e & 1) >= nk) s[j][e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * scale_log2);  // finite: nk >= 1
    alpha[i] = ex2(m[i] - m_new);                         // 0 on the first tile
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      s[j][e] = ex2(fmaf(s[j][e], scale_log2, -m[i]));  // masked: exp2(-inf) = 0
      if (GATE) s[j][e] *= gate;
      l[i] += s[j][e];
    }
    pa[j >> 1][2 * (j & 1)] = pack_bf16x2(s[j][0], s[j][1]);
    pa[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(s[j][2], s[j][3]);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

template <int NO, int MR, int BN, bool GATE>
__device__ __forceinline__ void softmax_tile(float (&s)[MR][BN / 8][4],
                                             uint32_t (&pa)[MR][BN / 16][4],
                                             RowState<NO, MR>& st, float scale_log2, int nk,
                                             float gate) {
#pragma unroll
  for (int r = 0; r < MR; ++r)
    softmax_rows<NO, BN, GATE>(s[r], pa[r], st.m[r], st.l[r], st.acc[r], scale_log2, nk, gate);
}

// acc += P V: P (16 x BN per row tile, bf16 -- the Pallas kernels cast P
// before the PV product too) from softmax_tile; V the tile in shared memory,
// each fragment shared by the MR row tiles. The backward kernels
// (attention_bwd_mma.cuh) use it for every product whose B operand is a
// tile read as [BN rows][D columns]: dS K, P^T dO and dS^T Q.
template <int KD, int NO, int MR, int BN>
__device__ __forceinline__ void pv_tile(float (&acc)[MR][NO][4],
                                        const uint32_t (&pa)[MR][BN / 16][4],
                                        uint32_t v_addr) {
  constexpr int LDS = Tile<KD>::LDS;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t row = v_addr + (uint32_t)(kk * 16 * LDS * 2);
#pragma unroll
    for (int p = 0; p < NO / 2; ++p) {
      uint32_t b[4];
      ldsm_x4_t(b, row + p * 32);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        mma16816(acc[r][2 * p], pa[r][kk], b[0], b[1]);
        mma16816(acc[r][2 * p + 1], pa[r][kk], b[2], b[3]);
      }
    }
    if (NO & 1) {
      uint32_t b[2];
      ldsm_x2_t(b, row + (NO / 2) * 32);
#pragma unroll
      for (int r = 0; r < MR; ++r) mma16816(acc[r][NO - 1], pa[r][kk], b[0], b[1]);
    }
  }
}

// The quad's total of each row's sum.
__device__ __forceinline__ void reduce_rows(float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
}

// Store rows `row0` and `row0 + 8` of a warp's output (acc * inv[i]) as
// bf16 pairs: this lane's columns 8n + 2*(lane%4), n < NO, below D.
template <int NO>
__device__ __forceinline__ void store_rows(bf16* base, long long row_stride, int row0,
                                           int rows, int D, const float (&acc)[NO][4],
                                           const float (&inv)[2]) {
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= rows) continue;
    bf16* orow = base + r * row_stride;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * n + c0;
      if (col < D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16x2(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
    }
  }
}

// Output n8 tiles compiled per head width: NO = D / 8 rounded up to a
// bucket; f.template run<KD, NO>() with KD = ceil(NO / 2) k16 steps.
template <typename F>
cudaError_t dispatch_no(int D, F& f) {
  const int no = (D + 7) / 8;
  if (no <= 1) return f.template run<1, 1>();
  if (no <= 2) return f.template run<1, 2>();
  if (no <= 3) return f.template run<2, 3>();
  if (no <= 4) return f.template run<2, 4>();
  if (no <= 5) return f.template run<3, 5>();
  if (no <= 6) return f.template run<3, 6>();
  if (no <= 8) return f.template run<4, 8>();
  if (no <= 10) return f.template run<5, 10>();
  if (no <= 12) return f.template run<6, 12>();
  if (no <= 15) return f.template run<8, 15>();
  if (no <= 16) return f.template run<8, 16>();
  if (no <= 20) return f.template run<10, 20>();
  if (no <= 24) return f.template run<12, 24>();
  return f.template run<16, 32>();
}

// Q (64 * MR rows), then two stages of a K and a V tile of BN rows.
template <int KD, int MR, int BN>
inline size_t smem_bytes_tc() {
  return sizeof(bf16) * (size_t)Tile<KD>::LDS * (64 * MR + 4 * BN);
}

// What attention_tc computes, by its MODE:
//   SELF        kernel A: softmax(q k^T * scale) v over the keys of src[0];
//   TWO_SOURCE  kernel B: one joint softmax over the keys of src[0] (self)
//               and then of src[1] (the bank), one running (m, l, acc);
//   GATED       kernel B gated: as TWO_SOURCE, with the bank's probabilities
//               of batch row b multiplied by p.gate[b] after the exp, inside
//               the joint max and denominator; a row gated by exactly 0 walks
//               the self tiles only, and no copy of a bank tile is issued;
//   PACKED      K9: the keys of src[0] are nseg segments of src[0].len rows,
//               one after another, each with a softmax of its own.
enum Mode : int { SELF = 0, TWO_SOURCE = 1, GATED = 2, PACKED = 3 };

// One block: 64 * MR query rows of one (batch, head); 4 warps of MR row
// tiles of 16; keys in tiles of BN through a two-stage ring. A key tile never
// straddles a source or a segment: each starts at its first key and masks its
// ragged edge, and the prefetch of tile t + 1 reads its own source's
// pointers and strides. A, B write acc / l, and the LSE when asked (B's over
// both sources); K9 adds each segment's acc / l into an fp32 output
// accumulator at the segment's end.
template <int KD, int NO, int MR, int BN, int MODE>
__global__ void __launch_bounds__(NT) attention_tc(const Params p, const int nseg) {
  constexpr bool TWO = MODE == TWO_SOURCE || MODE == GATED;
  constexpr bool PACK = MODE == PACKED;
  constexpr int LDS = Tile<KD>::LDS;
  constexpr int KV = BN * LDS;  // elements of one K or V stage
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Ks = Qs + 64 * MR * LDS;  // two stages
  bf16* Vs = Ks + 2 * KV;         // two stages

  const int D = p.D;
  const int q0 = blockIdx.x * block_rows<MR>();
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Source s0 = p.src[0];
  const Source s1 = p.src[TWO ? 1 : 0];
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh +
                   (long long)q0 * p.q_ss;
  const bf16* kb0 = static_cast<const bf16*>(s0.k) + b * s0.k_sb + h * s0.k_sh;
  const bf16* vb0 = static_cast<const bf16*>(s0.v) + b * s0.v_sb + h * s0.v_sh;
  const bf16* kb1 = static_cast<const bf16*>(s1.k) + b * s1.k_sb + h * s1.k_sh;
  const bf16* vb1 = static_cast<const bf16*>(s1.v) + b * s1.v_sb + h * s1.v_sh;
  const float gate = MODE == GATED ? p.gate[b] : 1.f;
  // tiles per segment of src[0]; B's bank tiles follow the self tiles
  const int tps = (s0.len + BN - 1) / BN;
  const int bank_tiles = TWO && gate != 0.f ? (s1.len + BN - 1) / BN : 0;
  const int ntiles = (PACK ? nseg : 1) * tps + bank_tiles;
  auto in_bank = [&](int t) { return TWO && t >= tps; };
  auto tile_in_seg = [&](int t) { return PACK ? t % tps : (in_bank(t) ? t - tps : t); };
  auto valid_keys = [&](int t) {
    return min(BN, (in_bank(t) ? s1.len : s0.len) - tile_in_seg(t) * BN);
  };
  auto load_kv = [&](int t) {
    const bool bank = in_bank(t);
    const long long k0 = (PACK ? (long long)(t / tps) * s0.len : 0LL) +
                         (long long)tile_in_seg(t) * BN;
    const long long k_ss = bank ? s1.k_ss : s0.k_ss;
    const long long v_ss = bank ? s1.v_ss : s0.v_ss;
    const int stage = t & 1;
    load_tile_async<LDS, BN>(Ks + stage * KV, (bank ? kb1 : kb0) + k0 * k_ss, k_ss,
                             valid_keys(t), D);
    load_tile_async<LDS, BN>(Vs + stage * KV, (bank ? vb1 : vb0) + k0 * v_ss, v_ss,
                             valid_keys(t), D);
  };

  zero_pad_columns<KD>(Qs, 64 * MR + 4 * BN, D);  // Q, K, V rows are contiguous
  load_tile_async<LDS, 64 * MR>(Qs, qb, p.q_ss, p.Sq - q0, D);
  load_kv(0);
  cp_async_commit();

  const LaneAddr<KD, MR> la(warp, lane);
  const uint32_t q_addr = smem_u32(Qs) + la.q;
  const float scale_log2 = p.scale * LOG2E;
  RowState<NO, MR> st;
  st.reset();
  float out[PACK ? MR : 1][PACK ? NO : 1][4] = {};  // K9's sum over segments

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();  // tile t (and Q) have landed
    __syncthreads();     // and every warp is done with tile t - 1
    if (t + 1 < ntiles) load_kv(t + 1);  // into tile t - 1's stage
    cp_async_commit();
    const int stage = t & 1;
    float s[MR][BN / 8][4];
    uint32_t pa[MR][BN / 16][4];
    qk_tile<KD, MR, BN>(s, q_addr, smem_u32(Ks + stage * KV) + la.k);
    softmax_tile<NO, MR, BN, MODE == GATED>(s, pa, st, scale_log2, valid_keys(t),
                                            in_bank(t) ? gate : 1.f);
    pv_tile<KD, NO, MR, BN>(st.acc, pa, smem_u32(Vs + stage * KV) + la.v);
    if constexpr (PACK) {
      if (tile_in_seg(t) == tps - 1) {  // the segment ends: add its normalised output
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          reduce_rows(st.l[r]);
          const float inv[2] = {1.f / st.l[r][0], 1.f / st.l[r][1]};
#pragma unroll
          for (int n = 0; n < NO; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) out[r][n][e] += st.acc[r][n][e] * inv[e >> 1];
        }
        st.reset();
      }
    }
  }

  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + (long long)q0 * p.o_ss;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int row0 = (warp * MR + r) * 16 + (lane >> 2);
    if constexpr (PACK) {
      const float one[2] = {1.f, 1.f};
      store_rows<NO>(ob, p.o_ss, row0, p.Sq - q0, D, out[r], one);
    } else {
      reduce_rows(st.l[r]);
      const float inv[2] = {1.f / st.l[r][0], 1.f / st.l[r][1]};
      if (p.lse != nullptr && (lane & 3) == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = q0 + row0 + 8 * i;
          if (row < p.Sq)
            p.lse[((long long)b * p.H + h) * p.Sq + row] = st.m[r][i] * LN2 + logf(st.l[r][i]);
        }
      }
      store_rows<NO>(ob, p.o_ss, row0, p.Sq - q0, D, st.acc[r], inv);
    }
  }
}

// Launch attention_tc over B x p.H x the query row blocks.
template <int KD, int NO, int MR, int BN, int MODE>
cudaError_t launch_tc(const Params& p, int nseg, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes_tc<KD, MR, BN>();
  cudaError_t err = cudaFuncSetAttribute(attention_tc<KD, NO, MR, BN, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + block_rows<MR>() - 1) / block_rows<MR>(), p.H, B);
  attention_tc<KD, NO, MR, BN, MODE><<<grid, NT, smem, stream>>>(p, nseg);
  return cudaGetLastError();
}

// Kernels A and B (MODE SELF, TWO_SOURCE or GATED) through dispatch_no.
// Two row tiles per warp at D <= 48, and for B up to D = 80; wider heads
// keep one (two sets of their accumulators would not fit the registers). At
// D = 80 two row tiles take 255 registers: B, with twice A's keys per
// block, runs 1.1-1.5x faster so; A spills and its batch-1 launch (64
// blocks on 132 SMs) runs slower (PERF.md). D > 160: 64-key tiles, so that
// two stages of K and V fit in shared memory.
template <int MODE>
struct AttentionLaunch {
  const Params& p;
  int B;
  cudaStream_t stream;
  template <int KD, int NO>
  cudaError_t run() {
    constexpr int MR = NO <= (MODE == SELF ? 6 : 10) ? 2 : 1;
    constexpr int BN = KD <= 10 ? 128 : 64;
    return launch_tc<KD, NO, MR, BN, MODE>(p, 1, B, stream);
  }
};

}  // namespace tc
}  // namespace md
