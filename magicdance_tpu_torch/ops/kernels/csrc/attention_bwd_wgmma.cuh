// Hopper body of the bf16 attention backward: kernel C (dQ, attention_dq.cu)
// and kernel D (dK/dV, attention_dkv.cu). wgmma on operands that TMA brings
// into a ring of shared-memory stages guarded by mbarriers, one producer warp
// and two consumer warpgroups, built from the pieces of attention_wgmma.cuh
// (the body of the forward kernels A, B and K9): rank-4 tensor maps (D, H,
// rows, B) encoded per launch with 128-byte swizzle and 64-column boxes,
// out-of-bounds zero fill instead of padding, a stride-0 batch or head read
// at coordinate 0, the TileWalk over self tiles and then bank tiles,
// setmaxnreg between the roles, and the m16n8 fragment layout of tc::
// (attention_mma.cuh) for the accumulators. It computes what
// attention_dq_tc / attention_dkv_tc (attention_bwd_mma.cuh, mma.sync)
// compute; those stay for the widths past this body's limits, for operands
// TMA cannot read and as the body a caller can name.
//
// Both kernels take P from the forward's log-sum-exp, P = exp2(s * scale *
// log2(e) - lse * log2(e)) with keys (C) or queries (D) past their end set
// to 0, and delta = rowsum(dO o O) from the caller. The fp32 tiles between
// the products stay in registers and go to the next product as bf16 A
// fragments (tc::pack_a) exactly where the JAX kernels cast to the input
// type: dS in C, P and dS in D.
//
// C (dQ). A block owns BM = 128 query rows of one (batch, head), 64 per
// consumer warpgroup; Q and dO arrive once, and each consumer thread keeps
// its rows' lse and delta in registers. K and V tiles of BN keys stream
// through the ring, the self source's tiles and then the bank's (a batch-1
// bank encoded with batch extent 1). Per tile: S = Q K^T and dP = dO V^T
// (SS wgmma, K and V K-major; P is computed from S while dP is still in
// flight), dS = P o (dP - delta) * scale rounded to bf16 A fragments, dQ +=
// dS K (RS wgmma, the same swizzled K tile read MN-major, as the forward's
// PV reads V). Tiles hold 128 keys up to KS = DQ_WIDE_TILE_KS k16 steps
// (D <= 64: S, dP and dS take 160 registers a thread there), 64 above.
//
// D (dK/dV). A block owns BM = 128 keys of one (key batch, head), 64 per
// consumer; K and V arrive once. Tiles of 64 queries (32 above KS =
// DKV_WIDE_TILE_KS: S^T, dP^T and their fragments then take 48 registers a
// thread beside dK's and dV's 160 at D = 160) of Q and dO stream through
// the ring with their fp32 lse and delta, which rank-1 TMA
// maps over the contiguous (Bq, H, Sq) rows bring into the same stage (its
// expect_tx counts them). Per tile: S^T = K Q^T and dP^T = V dO^T (SS), P^T
// from each column's LSE, dV += bf16(P^T) dO (RS, dO read MN-major; issued
// before dS^T is formed, which overlaps it), dS^T = P^T o (dP^T - delta) *
// scale rounded to bf16, dK += dS^T Q (RS, Q read MN-major). For a batch-1
// source read by Bq query batches the block walks the queries of every
// batch, so the sum over the frames stays in registers.
//
// D's query split. Where (key blocks) x H x Bk leaves SMs idle (the 77-key
// cross-attention gives 16 blocks at B = 2), the wrapper asks for nsplit > 1
// (flash_vjp.dkv_split): block x = key block + nkb * split walks its
// split's share of the query tiles and writes fp32 partial dK and dV into
// a scratch buffer the wrapper allocates, (nsplit, 2, Bk, Sk, H, D); a
// second kernel (dkv_reduce) sums the splits in order 0, 1, ... and writes
// bf16. No atomics anywhere: the same inputs give the same bits.
//
// Output columns. The RS products run N = 8 NO columns, NO = 2 KS n8 chunks
// (D = 40: 48, 80: 80, 160: 160), as full 64-column boxes and a narrower
// tail inside the next box, so the accumulators hold no idle 64-column
// padding: at D = 80 dK and dV take 80 registers a thread, not 128.
//
// Limits. C: D <= MAX_DQ = 192 (three boxes take two stages of K and V
// beside Q and dO: 192 KB of shared memory). D: D <= MAX_DKV = 160 (dK and
// dV take 8 NO registers a thread beside 96 for S^T, dP^T and their bf16
// fragments at 64-query tiles, 48 at 32; D = 192 would pass setmaxnreg's
// 232). The C entries refuse wider heads on this body and the wrappers
// send them to the mma.sync body.
//
// Ordering rules as in attention_wgmma.cuh: wgmma.fence before each batch
// of products whose registers ordinary instructions wrote; every register a
// product wrote or read is pinned after its wait (keep).

#pragma once

#include "attention_bwd_mma.cuh"
#include "attention_wgmma.cuh"

namespace md {
namespace wg {

constexpr int MAX_DQ = 192;
constexpr int MAX_DKV = 160;
constexpr int DQ_WIDE_TILE_KS = 4;   // KS up to which C's tiles hold 128 keys
constexpr int DKV_WIDE_TILE_KS = 6;  // KS up to which D's tiles hold 64 queries

__host__ __device__ constexpr int dq_tile_keys(int ks) { return ks <= DQ_WIDE_TILE_KS ? 128 : 64; }
__host__ __device__ constexpr int dkv_tile_queries(int ks) {
  return ks <= DKV_WIDE_TILE_KS ? 64 : 32;
}
// three 64-column boxes leave room for two stages only
__host__ __device__ constexpr int bwd_stages(int ncb) { return ncb >= 3 ? 2 : 3; }

// --------------------------------------------------------------------------
// products and stores
// --------------------------------------------------------------------------

#define MD_BW_ACC4(d, i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// d[C0 .. C0+W) += A B, N = 8 W columns: A (64 x 16 bf16) in registers as
// mma.sync A fragments, B (16 x N) MN-major in shared memory. W = 8 is
// attention_wgmma.cuh's wgmma_rs.
template <int C0, int W, int NO>
__device__ __forceinline__ void wgmma_rs_w(float (&d)[NO][4], const uint32_t (&a)[4],
                                           uint64_t b) {
  static_assert(W == 2 || W == 4 || W == 6 || W == 8, "N = 16, 32, 48 or 64");
  if constexpr (W == 8) {
    wgmma_rs<C0>(d, a, b);
  } else if constexpr (W == 2) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : MD_BW_ACC4(d, C0), MD_BW_ACC4(d, C0 + 1)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (W == 4) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : MD_BW_ACC4(d, C0), MD_BW_ACC4(d, C0 + 1), MD_BW_ACC4(d, C0 + 2),
          MD_BW_ACC4(d, C0 + 3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : MD_BW_ACC4(d, C0), MD_BW_ACC4(d, C0 + 1), MD_BW_ACC4(d, C0 + 2),
          MD_BW_ACC4(d, C0 + 3), MD_BW_ACC4(d, C0 + 4), MD_BW_ACC4(d, C0 + 5)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

// d (64 x 32, fp32) = or += A B^T: A and B K-major in shared memory, one
// k16 step (D's S^T and dP^T at 32-query tiles).
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : MD_BW_ACC4(d, 0), MD_BW_ACC4(d, 1), MD_BW_ACC4(d, 2), MD_BW_ACC4(d, 3)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef MD_BW_ACC4

// acc[0 .. NO) += A B over one k16 step: B's 16 rows start at b_addr, its
// 64-column boxes `box` bytes apart; full boxes, then the tail.
template <int NO>
__device__ __forceinline__ void rs_cols(float (&acc)[NO][4], const uint32_t (&a)[4],
                                        uint32_t b_addr, uint32_t box) {
  static_assert(NO % 2 == 0 && NO <= 24, "NO = 2 KS <= 24");
  if constexpr (NO >= 8) wgmma_rs_w<0, 8>(acc, a, sw128_desc(b_addr));
  if constexpr (NO >= 16) wgmma_rs_w<8, 8>(acc, a, sw128_desc(b_addr + box));
  if constexpr (NO >= 24) wgmma_rs_w<16, 8>(acc, a, sw128_desc(b_addr + 2 * box));
  if constexpr (NO % 8 != 0)
    wgmma_rs_w<NO / 8 * 8, NO % 8>(acc, a, sw128_desc(b_addr + (NO / 8) * box));
}

// One SS product over KS k16 steps: d (64 x BN) = A B^T, A's 64 rows at
// a_addr and B's BN rows at b_addr, both K-major, their 64-column boxes
// a_box and b_box bytes apart.
template <int KS, int BN>
__device__ __forceinline__ void ss_rows(float (&d)[BN / 8][4], uint32_t a_addr, uint32_t a_box,
                                        uint32_t b_addr, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t col = (kk & 3) * 32u;  // 16 columns on inside the atom
    wgmma_ss(d, sw128_desc(a_addr + (kk >> 2) * a_box + col),
             sw128_desc(b_addr + (kk >> 2) * b_box + col), kk > 0);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// Rows row0 and row0 + 8 of a warp's fp32 tile as fp32 pairs (D's split
// partials): this lane's columns 8n + 2 (lane % 4) below D.
template <int NO>
__device__ __forceinline__ void store_rows_f32(float* base, long long row_stride, int row0,
                                               int rows, int D, const float (&acc)[NO][4]) {
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= rows) continue;
    float* orow = base + r * row_stride;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * n + c0;
      if (col < D)
        *reinterpret_cast<float2*>(orow + col) = make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// --------------------------------------------------------------------------
// kernel C
// --------------------------------------------------------------------------

// Q, dO, then K and V of source 0 and of source 1 (copies of source 0's
// with one source).
struct DqMaps {
  CUtensorMap q, dout, k0, v0, k1, v1;
};

struct DqArgs {
  bf16* dq;
  const float* lse;    // (B, H, Sq) fp32
  const float* delta;  // (B, H, Sq) fp32
  long long dq_sb, dq_ss, dq_sh;
  int H, width, Sq, len0, len1, bcast;  // bcast: bits 2i / 2i + 1 of map i, as in Args
  float scale;
};

// Q [NCB][BM rows], dO [NCB][BM rows], then S x (K [NCB][BN], V [NCB][BN]),
// then the mbarriers, after aligning to the 1024-byte swizzle atom.
template <int NCB, int BN>
struct DqLayout {
  static constexpr int S = bwd_stages(NCB);
  static constexpr uint32_t Q_BOX = BM * ROW_BYTES;
  static constexpr uint32_t Q_BYTES = NCB * Q_BOX;
  static constexpr uint32_t KV_BOX = BN * ROW_BYTES;
  static constexpr uint32_t KV_BYTES = NCB * KV_BOX;
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;
  static constexpr uint32_t BAR_OFFSET = 2 * Q_BYTES + S * STAGE_BYTES;
  static constexpr size_t SMEM = 1024 + BAR_OFFSET + 8 * (2 * S + 1);
};

// KS: k16 steps of the D contraction; MODE SELF (one source) or
// TWO_SOURCE. Grid: (query row blocks of BM, H, B).
template <int KS, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    attention_dq_wgmma(const __grid_constant__ DqMaps maps, const DqArgs a) {
  constexpr int NCB = (KS + 3) / 4;
  constexpr int NO = 2 * KS;
  constexpr int BN = dq_tile_keys(KS);
  using L = DqLayout<NCB, BN>;
  extern __shared__ __align__(16) unsigned char bw_smem[];
  const uint32_t q_s = (smem_u32(bw_smem) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + L::Q_BYTES;
  const uint32_t kv_s = do_s + L::Q_BYTES;  // stage st: K, then V, at kv_s + st * STAGE_BYTES
  const uint32_t bars = q_s + L::BAR_OFFSET;
  const uint32_t q_bar = bars + 16u * L::S;
  auto full_bar = [&](int st) { return bars + 8u * st; };
  auto empty_bar = [&](int st) { return bars + 8u * (L::S + st); };

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tps = (a.len0 + BN - 1) / BN;
  const int ntiles = tps + (MODE == tc::TWO_SOURCE ? (a.len1 + BN - 1) / BN : 0);

  if (threadIdx.x == 0) {
    for (int st = 0; st < L::S; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), 4 * CONSUMERS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == CONSUMERS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * CONSUMERS) {
      auto bc = [&](int i) { return (a.bcast >> (2 * i)) & 1 ? 0 : b; };
      auto hc = [&](int i) { return (a.bcast >> (2 * i + 1)) & 1 ? 0 : h; };
      mbar_expect_tx(q_bar, 2 * L::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        tma_load_4d(q_s + cb * L::Q_BOX, &maps.q, q_bar, cb * BOX, hc(0), q0, bc(0));
        tma_load_4d(do_s + cb * L::Q_BOX, &maps.dout, q_bar, cb * BOX, hc(1), q0, bc(1));
      }
      int st = 0;
      uint32_t phase = 0;
      TileWalk<MODE, BN> tile;
      for (int t = 0; t < ntiles; ++t, tile.next(tps)) {
        const CUtensorMap* k_map = tile.src ? &maps.k1 : &maps.k0;
        const CUtensorMap* v_map = tile.src ? &maps.v1 : &maps.v0;
        const int km = 2 + 2 * tile.src;  // map index of this source's K (V: km + 1)
        const int row = tile.row(a.len0);
        mbar_wait(empty_bar(st), phase ^ 1u);
        mbar_expect_tx(full_bar(st), L::STAGE_BYTES);
        const uint32_t k_s = kv_s + st * L::STAGE_BYTES;
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          tma_load_4d(k_s + cb * L::KV_BOX, k_map, full_bar(st), cb * BOX, hc(km), row, bc(km));
          tma_load_4d(k_s + L::KV_BYTES + cb * L::KV_BOX, v_map, full_bar(st), cb * BOX,
                      hc(km + 1), row, bc(km + 1));
        }
        if (++st == L::S) {
          st = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int c0 = 2 * (lane & 3);
    const float scale_log2 = a.scale * tc::LOG2E;
    const int row0 = wgi * 64 + warp * 16 + (lane >> 2);  // this lane's rows in the block
    float lse2[2], dlt[2];
    const long long rows = ((long long)b * a.H + h) * a.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row0 + 8 * i;
      const bool ok = row < a.Sq;
      lse2[i] = ok ? a.lse[rows + row] * tc::LOG2E : 0.f;
      dlt[i] = ok ? a.delta[rows + row] : 0.f;
    }
    const uint32_t q_rows = q_s + wgi * 64 * ROW_BYTES;
    const uint32_t do_rows = do_s + wgi * 64 * ROW_BYTES;
    float acc[NO][4];
    zero(acc);

    mbar_wait(q_bar, 0);
    int st = 0;
    uint32_t phase = 0;
    TileWalk<MODE, BN> tile;
    for (int t = 0; t < ntiles; ++t, tile.next(tps)) {
      mbar_wait(full_bar(st), phase);
      __syncwarp();
      const uint32_t k_s = kv_s + st * L::STAGE_BYTES;
      const uint32_t v_s = k_s + L::KV_BYTES;

      float s[BN / 8][4], dp[BN / 8][4];  // zeroed before the fence: the products then own them
      zero(s);
      zero(dp);
      wg_fence();
      ss_rows<KS, BN>(s, q_rows, L::Q_BOX, k_s, L::KV_BOX);  // S = Q K^T
      wg_commit();
      ss_rows<KS, BN>(dp, do_rows, L::Q_BOX, v_s, L::KV_BOX);  // dP = dO V^T
      wg_commit();
      wg_wait<1>();
      keep(s);
      const int nk = tile.nk(a.len0, a.len1);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = tc::ex2(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
          s[j][e] = nk < BN && 8 * j + c0 + (e & 1) >= nk ? 0.f : pr;
        }
      wg_wait<0>();
      keep(dp);
      uint32_t ds[BN / 16][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] * (dp[j][e] - dlt[e >> 1]) * a.scale;
      tc::pack_a<BN>(s, ds);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)  // dQ += dS K
        rs_cols<NO>(acc, ds[kk], k_s + kk * 16 * ROW_BYTES, L::KV_BOX);
      wg_commit();
      wg_wait<0>();
      keep(acc);
      keep(ds);
      if (lane == 0) mbar_arrive(empty_bar(st));
      if (++st == L::S) {
        st = 0;
        phase ^= 1u;
      }
    }

    bf16* ob = a.dq + (long long)b * a.dq_sb + (long long)h * a.dq_sh + (long long)q0 * a.dq_ss;
    const float one[2] = {1.f, 1.f};
    tc::store_rows<NO>(ob, a.dq_ss, row0, a.Sq - q0, a.width, acc, one);
  }
}

// --------------------------------------------------------------------------
// kernel D
// --------------------------------------------------------------------------

// K, V, Q, dO, and the rank-1 maps of the fp32 lse and delta rows.
struct DkvMaps {
  CUtensorMap k, v, q, dout, lse, delta;
};

struct DkvArgs {
  void* dk;  // bf16 outputs, or (nsplit > 1) the fp32 partials
  void* dv;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int H, width, Sq, Sk, Bq, shared_bank, nsplit, nkb, bcast;
  float scale;
};

// K [NCB][BM rows], V [NCB][BM rows], then S x (Q [NCB][BN], dO [NCB][BN]),
// then S x (lse[BN], delta[BN]) fp32, then the mbarriers.
template <int NCB, int BN>
struct DkvLayout {
  static constexpr int S = bwd_stages(NCB);
  static constexpr uint32_t K_BOX = BM * ROW_BYTES;
  static constexpr uint32_t K_BYTES = NCB * K_BOX;
  static constexpr uint32_t T_BOX = BN * ROW_BYTES;
  static constexpr uint32_t T_BYTES = NCB * T_BOX;  // one Q or dO tile
  static constexpr uint32_t STAGE_BYTES = 2 * T_BYTES;
  static constexpr uint32_t ROW_STAGE = 2 * BN * 4;  // lse, then delta
  static constexpr uint32_t ROWS_OFFSET = 2 * K_BYTES + S * STAGE_BYTES;
  static constexpr uint32_t BAR_OFFSET = ROWS_OFFSET + S * ROW_STAGE;
  static constexpr size_t SMEM = 1024 + BAR_OFFSET + 8 * (2 * S + 1);
};

// KS: k16 steps of the D contraction. Grid: (key blocks of BM x nsplit, H,
// Bk); block x takes key block x % nkb and query-tile split x / nkb.
template <int KS>
__global__ void __launch_bounds__(THREADS, 1)
    attention_dkv_wgmma(const __grid_constant__ DkvMaps maps, const DkvArgs a) {
  constexpr int NCB = (KS + 3) / 4;
  constexpr int NO = 2 * KS;
  constexpr int BN = dkv_tile_queries(KS);
  using L = DkvLayout<NCB, BN>;
  extern __shared__ __align__(16) unsigned char bw_smem[];
  const uint32_t base = (smem_u32(bw_smem) + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + L::K_BYTES;
  const uint32_t t_s = base + 2 * L::K_BYTES;  // stage st: Q, then dO, at t_s + st * STAGE_BYTES
  const uint32_t rows_s = base + L::ROWS_OFFSET;
  const float* rows_f = reinterpret_cast<const float*>(bw_smem + (rows_s - smem_u32(bw_smem)));
  const uint32_t bars = base + L::BAR_OFFSET;
  const uint32_t kv_bar = bars + 16u * L::S;
  auto full_bar = [&](int st) { return bars + 8u * st; };
  auto empty_bar = [&](int st) { return bars + 8u * (L::S + st); };

  const int kb = blockIdx.x % a.nkb;
  const int split = blockIdx.x / a.nkb;
  const int k0 = kb * BM;
  const int h = blockIdx.y;
  const int bk = blockIdx.z;
  const int tpb = (a.Sq + BN - 1) / BN;  // query tiles per batch
  const long long all = (long long)(a.shared_bank ? a.Bq : 1) * tpb;
  const int t0 = (int)(all * split / a.nsplit);
  const int t1 = (int)(all * (split + 1) / a.nsplit);
  const int b_first = a.shared_bank ? 0 : bk;

  if (threadIdx.x == 0) {
    for (int st = 0; st < L::S; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), 4 * CONSUMERS);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == CONSUMERS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * CONSUMERS) {
      auto bc = [&](int i, int x) { return (a.bcast >> (2 * i)) & 1 ? 0 : x; };
      auto hc = [&](int i) { return (a.bcast >> (2 * i + 1)) & 1 ? 0 : h; };
      mbar_expect_tx(kv_bar, 2 * L::K_BYTES);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        tma_load_4d(k_s + cb * L::K_BOX, &maps.k, kv_bar, cb * BOX, hc(0), k0, bc(0, bk));
        tma_load_4d(v_s + cb * L::K_BOX, &maps.v, kv_bar, cb * BOX, hc(1), k0, bc(1, bk));
      }
      int st = 0;
      uint32_t phase = 0;
      int bq = b_first + t0 / tpb, ti = t0 % tpb;
      for (int t = t0; t < t1; ++t) {
        mbar_wait(empty_bar(st), phase ^ 1u);
        mbar_expect_tx(full_bar(st), L::STAGE_BYTES + L::ROW_STAGE);
        const uint32_t q_t = t_s + st * L::STAGE_BYTES;
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          tma_load_4d(q_t + cb * L::T_BOX, &maps.q, full_bar(st), cb * BOX, hc(2), ti * BN,
                      bc(2, bq));
          tma_load_4d(q_t + L::T_BYTES + cb * L::T_BOX, &maps.dout, full_bar(st), cb * BOX,
                      hc(3), ti * BN, bc(3, bq));
        }
        const int r0 = (bq * a.H + h) * a.Sq + ti * BN;  // past a row's end: masked columns
        tma_load_1d(rows_s + st * L::ROW_STAGE, &maps.lse, full_bar(st), r0);
        tma_load_1d(rows_s + st * L::ROW_STAGE + BN * 4, &maps.delta, full_bar(st), r0);
        if (++ti == tpb) {
          ti = 0;
          ++bq;
        }
        if (++st == L::S) {
          st = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int c0 = 2 * (lane & 3);
    const float scale_log2 = a.scale * tc::LOG2E;
    const int row0 = wgi * 64 + warp * 16 + (lane >> 2);  // this lane's keys in the block
    const uint32_t k_rows = k_s + wgi * 64 * ROW_BYTES;
    const uint32_t v_rows = v_s + wgi * 64 * ROW_BYTES;
    float dk[NO][4], dv[NO][4];
    zero(dk);
    zero(dv);

    mbar_wait(kv_bar, 0);
    int st = 0;
    uint32_t phase = 0;
    int ti = t0 % tpb;
    for (int t = t0; t < t1; ++t) {
      const int nq = min(BN, a.Sq - ti * BN);
      if (++ti == tpb) ti = 0;
      mbar_wait(full_bar(st), phase);
      __syncwarp();
      const uint32_t q_t = t_s + st * L::STAGE_BYTES;
      const uint32_t do_t = q_t + L::T_BYTES;
      const float* lse_s = rows_f + st * (L::ROW_STAGE / 4);
      const float* dlt_s = lse_s + BN;

      float sT[BN / 8][4], dpT[BN / 8][4];
      zero(sT);
      zero(dpT);
      wg_fence();
      ss_rows<KS, BN>(sT, k_rows, L::K_BOX, q_t, L::T_BOX);  // S^T = K Q^T
      wg_commit();
      ss_rows<KS, BN>(dpT, v_rows, L::K_BOX, do_t, L::T_BOX);  // dP^T = V dO^T
      wg_commit();
      wg_wait<1>();
      keep(sT);
      // P^T: this lane's columns (queries) 8j + c0 and 8j + c0 + 1
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + c0);
        const float l2[2] = {l.x * tc::LOG2E, l.y * tc::LOG2E};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = tc::ex2(fmaf(sT[j][e], scale_log2, -l2[e & 1]));
          sT[j][e] = nq < BN && 8 * j + c0 + (e & 1) >= nq ? 0.f : pr;
        }
      }
      uint32_t pa[BN / 16][4], da[BN / 16][4];
      tc::pack_a<BN>(sT, pa);
      wg_wait<0>();
      keep(dpT);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)  // dV += P^T dO
        rs_cols<NO>(dv, pa[kk], do_t + kk * 16 * ROW_BYTES, L::T_BOX);
      wg_commit();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(dlt_s + 8 * j + c0);
        const float dl[2] = {d.x, d.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) dpT[j][e] = sT[j][e] * (dpT[j][e] - dl[e & 1]) * a.scale;
      }
      tc::pack_a<BN>(dpT, da);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)  // dK += dS^T Q
        rs_cols<NO>(dk, da[kk], q_t + kk * 16 * ROW_BYTES, L::T_BOX);
      wg_commit();
      wg_wait<0>();
      keep(dv);
      keep(dk);
      keep(pa);
      keep(da);
      if (lane == 0) mbar_arrive(empty_bar(st));
      if (++st == L::S) {
        st = 0;
        phase ^= 1u;
      }
    }

    const int rows = a.Sk - k0;
    if (a.nsplit == 1) {
      bf16* dkb = static_cast<bf16*>(a.dk) + (long long)bk * a.dk_sb + (long long)h * a.dk_sh +
                  (long long)k0 * a.dk_ss;
      bf16* dvb = static_cast<bf16*>(a.dv) + (long long)bk * a.dv_sb + (long long)h * a.dv_sh +
                  (long long)k0 * a.dv_ss;
      const float one[2] = {1.f, 1.f};
      tc::store_rows<NO>(dkb, a.dk_ss, row0, rows, a.width, dk, one);
      tc::store_rows<NO>(dvb, a.dv_ss, row0, rows, a.width, dv, one);
    } else {  // (nsplit, 2, Bk, Sk, H, D) fp32: this split's dK, then its dV
      const long long n = (long long)gridDim.z * a.Sk * a.H * a.width;
      const long long off = (((long long)bk * a.Sk + k0) * a.H + h) * a.width;
      float* pk = static_cast<float*>(a.dk) + 2LL * split * n + off;
      const long long ss = (long long)a.H * a.width;
      store_rows_f32<NO>(pk, ss, row0, rows, a.width, dk);
      store_rows_f32<NO>(pk + n, ss, row0, rows, a.width, dv);
    }
  }
}

// dK and dV (bf16, strides in elements) = the sum of the nsplit fp32
// partials (nsplit, 2, Bk, Sk, H, D), in split order; four elements a
// thread (D is a multiple of 8). Grid: (ceil(n / 1024), 2): y = 0 dK, 1 dV.
struct ReduceArgs {
  const float* part;
  bf16* out[2];
  long long sb[2], ss[2], sh[2];
  long long n;  // Bk * Sk * H * D
  int nsplit, Sk, H, D;
};

__global__ void __launch_bounds__(256) dkv_reduce(const ReduceArgs r) {
  const long long i = 4LL * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= r.n) return;
  const int w = blockIdx.y;
  float4 acc = *reinterpret_cast<const float4*>(r.part + w * r.n + i);
  for (int s = 1; s < r.nsplit; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(r.part + (2LL * s + w) * r.n + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const int d = (int)(i % r.D);
  long long rest = i / r.D;
  const int hh = (int)(rest % r.H);
  rest /= r.H;
  const long long s = rest % r.Sk;
  const long long b = rest / r.Sk;
  bf16* o = r.out[w] + b * r.sb[w] + s * r.ss[w] + hh * r.sh[w] + d;
  *reinterpret_cast<uint2*>(o) =
      make_uint2(tc::pack_bf16x2(acc.x, acc.y), tc::pack_bf16x2(acc.z, acc.w));
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

// A rank-1 map over n contiguous fp32 values, boxes of `box`; reads past n
// arrive as zeros.
inline cudaError_t encode_rows(CUtensorMap* map, const float* base, long long n, int box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};  // a rank-1 map has no stride: not read
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base),
                            dims, strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int KS, int MODE>
cudaError_t launch_dq(const DqParams& p, int B, cudaStream_t stream) {
  constexpr int BN = dq_tile_keys(KS);
  const Source& s0 = p.src[0];
  const Source& s1 = p.src[MODE == tc::TWO_SOURCE ? 1 : 0];
  DqMaps maps;
  DqArgs a;
  a.bcast = 0;
  cudaError_t err = encode_map(&maps.q, p.q, p.D, p.H, p.Sq, B, p.q_sh, p.q_ss, p.q_sb, BM, 0,
                               &a.bcast);
  if (err == cudaSuccess)
    err = encode_map(&maps.dout, p.dout, p.D, p.H, p.Sq, B, p.do_sh, p.do_ss, p.do_sb, BM, 1,
                     &a.bcast);
  if (err == cudaSuccess)
    err = encode_map(&maps.k0, s0.k, p.D, p.H, s0.len, B, s0.k_sh, s0.k_ss, s0.k_sb, BN, 2,
                     &a.bcast);
  if (err == cudaSuccess)
    err = encode_map(&maps.v0, s0.v, p.D, p.H, s0.len, B, s0.v_sh, s0.v_ss, s0.v_sb, BN, 3,
                     &a.bcast);
  if (err == cudaSuccess && MODE == tc::TWO_SOURCE)
    err = encode_map(&maps.k1, s1.k, p.D, p.H, s1.len, B, s1.k_sh, s1.k_ss, s1.k_sb, BN, 4,
                     &a.bcast);
  if (err == cudaSuccess && MODE == tc::TWO_SOURCE)
    err = encode_map(&maps.v1, s1.v, p.D, p.H, s1.len, B, s1.v_sh, s1.v_ss, s1.v_sb, BN, 5,
                     &a.bcast);
  if (err != cudaSuccess) return err;
  if (MODE != tc::TWO_SOURCE) {
    maps.k1 = maps.k0;
    maps.v1 = maps.v0;
  }
  a.dq = static_cast<bf16*>(p.dq);
  a.lse = p.lse;
  a.delta = p.delta;
  a.dq_sb = p.dq_sb;
  a.dq_ss = p.dq_ss;
  a.dq_sh = p.dq_sh;
  a.H = p.H;
  a.width = p.D;
  a.Sq = p.Sq;
  a.len0 = s0.len;
  a.len1 = s1.len;
  a.scale = p.scale;
  const size_t smem = DqLayout<(KS + 3) / 4, BN>::SMEM;
  err = cudaFuncSetAttribute(attention_dq_wgmma<KS, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, p.H, B);
  attention_dq_wgmma<KS, MODE><<<grid, THREADS, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

template <int MODE, int KS = 1>
cudaError_t launch_dq_ks(int ks, const DqParams& p, int B, cudaStream_t stream) {
  if constexpr (KS > MAX_DQ / 16) {
    return cudaErrorInvalidValue;
  } else {
    if (ks == KS) return launch_dq<KS, MODE>(p, B, stream);
    return launch_dq_ks<MODE, KS + 1>(ks, p, B, stream);
  }
}

// Kernel C at head width p.D, nsrc sources. A template, so that only the
// source that calls it compiles its instantiations.
template <int ONE = tc::SELF>
cudaError_t launch_attention_dq(const DqParams& p, int nsrc, int B, cudaStream_t stream) {
  if (p.D > MAX_DQ) return cudaErrorInvalidValue;
  const int ks = (p.D + 15) / 16;
  if (nsrc == 1) return launch_dq_ks<ONE>(ks, p, B, stream);
  return launch_dq_ks<tc::TWO_SOURCE>(ks, p, B, stream);
}

template <int KS>
cudaError_t launch_dkv(const DkvParams& p, int Bk, cudaStream_t stream) {
  constexpr int NCB = (KS + 3) / 4;
  constexpr int BN = dkv_tile_queries(KS);
  DkvMaps maps;
  DkvArgs a;
  a.bcast = 0;
  cudaError_t err = encode_map(&maps.k, p.k, p.D, p.H, p.Sk, Bk, p.k_sh, p.k_ss, p.k_sb, BM, 0,
                               &a.bcast);
  if (err == cudaSuccess)
    err = encode_map(&maps.v, p.v, p.D, p.H, p.Sk, Bk, p.v_sh, p.v_ss, p.v_sb, BM, 1,
                     &a.bcast);
  if (err == cudaSuccess)
    err = encode_map(&maps.q, p.q, p.D, p.H, p.Sq, p.Bq, p.q_sh, p.q_ss, p.q_sb, BN, 2,
                     &a.bcast);
  if (err == cudaSuccess)
    err = encode_map(&maps.dout, p.dout, p.D, p.H, p.Sq, p.Bq, p.do_sh, p.do_ss, p.do_sb, BN,
                     3, &a.bcast);
  const long long nrows = (long long)p.Bq * p.H * p.Sq;
  if (err == cudaSuccess) err = encode_rows(&maps.lse, p.lse, nrows, BN);
  if (err == cudaSuccess) err = encode_rows(&maps.delta, p.delta, nrows, BN);
  if (err != cudaSuccess) return err;
  const bool split = p.nsplit > 1;
  a.dk = split ? static_cast<void*>(p.part) : p.dk;
  a.dv = split ? static_cast<void*>(p.part) : p.dv;
  a.dk_sb = p.dk_sb;
  a.dk_ss = p.dk_ss;
  a.dk_sh = p.dk_sh;
  a.dv_sb = p.dv_sb;
  a.dv_ss = p.dv_ss;
  a.dv_sh = p.dv_sh;
  a.H = p.H;
  a.width = p.D;
  a.Sq = p.Sq;
  a.Sk = p.Sk;
  a.Bq = p.Bq;
  a.shared_bank = p.shared_bank;
  a.nsplit = p.nsplit;
  a.nkb = (p.Sk + BM - 1) / BM;
  a.scale = p.scale;
  const size_t smem = DkvLayout<NCB, BN>::SMEM;
  err = cudaFuncSetAttribute(attention_dkv_wgmma<KS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nkb * p.nsplit, p.H, Bk);
  attention_dkv_wgmma<KS><<<grid, THREADS, smem, stream>>>(maps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  ReduceArgs r;
  r.part = p.part;
  r.out[0] = static_cast<bf16*>(p.dk);
  r.out[1] = static_cast<bf16*>(p.dv);
  r.sb[0] = p.dk_sb;
  r.ss[0] = p.dk_ss;
  r.sh[0] = p.dk_sh;
  r.sb[1] = p.dv_sb;
  r.ss[1] = p.dv_ss;
  r.sh[1] = p.dv_sh;
  r.n = (long long)Bk * p.Sk * p.H * p.D;
  r.nsplit = p.nsplit;
  r.Sk = p.Sk;
  r.H = p.H;
  r.D = p.D;
  const dim3 rgrid((unsigned)((r.n / 4 + 255) / 256), 2);
  dkv_reduce<<<rgrid, 256, 0, stream>>>(r);
  return cudaGetLastError();
}

template <int KS = 1>
cudaError_t launch_dkv_ks(int ks, const DkvParams& p, int Bk, cudaStream_t stream) {
  if constexpr (KS > MAX_DKV / 16) {
    return cudaErrorInvalidValue;
  } else {
    if (ks == KS) return launch_dkv<KS>(p, Bk, stream);
    return launch_dkv_ks<KS + 1>(ks, p, Bk, stream);
  }
}

// Kernel D at head width p.D, p.nsplit query splits (p.part: the fp32
// scratch of 2 x nsplit x Bk x Sk x H x D values when nsplit > 1).
template <int FIRST = 1>
cudaError_t launch_attention_dkv(const DkvParams& p, int Bk, cudaStream_t stream) {
  if (p.D > MAX_DKV || p.nsplit < 1 || (p.nsplit > 1 && p.part == nullptr))
    return cudaErrorInvalidValue;
  return launch_dkv_ks<FIRST>((p.D + 15) / 16, p, Bk, stream);
}

}  // namespace wg
}  // namespace md
