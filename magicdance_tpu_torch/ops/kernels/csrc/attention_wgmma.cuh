// Hopper body of the bf16 attention forward kernels: kernel A
// (self_attention.cu), kernel B in all its modes (two_source_attention.cu:
// two sources, with the LSE output, gated) and kernel K9
// (packed_attention.cu). wgmma on operands that TMA brings into a ring of
// shared-memory stages, guarded by mbarriers, with one producer warp and two
// consumer warpgroups. It computes what attention_tc (attention_mma.cuh)
// computes in the same MODE; attention_tc stays for the head widths past
// this body's limits and as the body a caller can name.
//
// What it computes, by MODE (tc::Mode):
//   SELF        kernel A: softmax(q k^T * scale) v over the keys of source 0;
//   TWO_SOURCE  kernel B: one joint softmax over the keys of source 0 (self)
//               and then of source 1 (the bank), one running (m, l, acc);
//   GATED       kernel B gated: as TWO_SOURCE, with the bank's probabilities
//               of batch row b multiplied by gate[b] after the exp, inside
//               the joint max and denominator; a row whose gate is exactly 0
//               walks the self tiles only (no bank tile is copied);
//   PACKED      K9: the keys of source 0 are nseg segments of len0 rows, one
//               after another, each with a softmax of its own; each
//               segment's acc / l is added into an fp32 output accumulator.
// In every mode the logits are fp32 and scaled in the log2 domain (one FMA
// by scale * log2(e) before the exponential), P is cast to bf16
// unnormalised before the PV product, the accumulation is fp32 and the
// output bf16. With an lse pointer (A, B) each row's natural-log
// log-sum-exp goes to lse[(b * H + h) * Sq + row] in fp32, as attention_tc
// writes it for the backward kernels C and D.
//
// Block layout. One block owns BM = 128 query rows of one (batch, head):
// two consumer warpgroups of 64 rows each (the wgmma M) and a producer
// warpgroup whose first warp's first lane issues every copy. The producer
// warpgroup gives registers to the consumers (setmaxnreg: of the 168 a
// thread of 384 gets at launch, it keeps 40 and they take 232); its other
// warps only take part in that and end. Grid: (row blocks, H, B).
//
// Copies. Each operand has a rank-4 TMA tensor map (D, H, rows, B) with the
// byte strides the wrapper passes, so one map covers the packed (B, S, H*D)
// projection output and a BSNH view alike; it is encoded on the host at
// each launch, with 128-byte swizzle: a box is 64 columns (128 bytes, the
// swizzle's width) of one head by 128 (Q) or BN (K, V) rows, so D <= 64
// takes one box a tile, D <= 128 two and D <= 192 three. Columns past D and
// rows past a source's end arrive as zeros from TMA's out-of-bounds fill, so
// nothing is padded in device memory. A dimension whose stride is 0 (a
// batch-1 bank read by every frame; any operand broadcast over batch rows or
// heads) is encoded with extent 1 and read at coordinate 0: TMA takes no
// stride of 0. Q arrives once; K and V tiles of BN keys stream through
// STAGES stages, each with a "full" mbarrier (the producer's expect_tx,
// completed by the copies' bytes) and an "empty" one (one arrival from each
// consumer warp once its products that read the stage have retired). Each
// source has its own K and V maps: no tile straddles the self and bank
// sources, and each source's ragged last tile is masked by key index. In
// PACKED mode tile t of segment g starts at key row g*len0 + 64t, so the
// last tile of a segment may hold rows of the next one: they are masked.
//
// Tiles. BN = 128 keys for A and B up to KS = 5 (D <= 80), 64 above and
// for K9 (tile_keys). A tile of 128 keys halves the waits, the row-max
// reductions and the rescales of the accumulator per key: 5-17% faster than
// 64 at D = 40 and 80 (PERF.md). Its logits and P take 96 registers,
// so wider heads, and K9 with its second accumulator, keep 64 (and at three
// boxes three stages of 128 keys would not fit in shared memory).
//
// Products. QK^T: wgmma.m64nBNk16, A = the warpgroup's 64 Q rows and B = the
// K tile, both K-major in shared memory (the descriptor steps 32 bytes
// inside the swizzle atom per k16 step, and to the next box every 4 steps);
// KS = ceil(D / 16) steps, unrolled (one instantiation per step count: a
// run-time loop was much slower, PERF.md). Online softmax in
// registers by attention_tc's routine (tc::softmax_rows: the wgmma
// accumulator has mma.sync's m16n8 layout per warp), which leaves P as bf16
// A fragments. PV: wgmma.m64n64k16 with A = P in registers and B = the V
// tile read MN-major (the same swizzled tile as for K; only the descriptor
// differs), one instruction per 64-column box per k16 step of keys.
// Epilogue: bf16 rows and columns written with masks (tc::store_rows).
//
// Exponentials. At D = 40 the exponentials (16 MUFU ex2 results per SM
// per clock) are the largest floor of the work; all of them run on
// ex2.approx. Taking 1/8 or 2/8 of them onto the FMA units (a Cody-Waite
// reduction and a degree-3 polynomial, largest relative error 1.02e-4)
// measured slower on kernel B and the gated read and at most 4.5% faster on
// kernel A at D = 40, so it was left out (PERF.md).
//
// Overlap. Inside a consumer the products and the softmax take turns
// (QK^T, softmax, PV); the two consumers overlap each other as the warp
// schedulers find them ready. Issuing QK^T of tile t + 1 beside PV of tile
// t, and a ping-pong between the consumers, measured slower (PERF.md, PR
// 15).
//
// Registers. A consumer thread holds BN / 2 logits, BN / 4 words of P and
// NO = 8 * NCB output columns' fp32 values (NCB: 64-column boxes a row): 96
// at D = 192 (BN = 64), 64 at D = 80 (BN = 128), under setmaxnreg's 232. PACKED keeps a second accumulator (segment
// and output): 128 at G*D = 128; wider packed rows do not fit. So the body
// takes D <= MAX_HEAD = 192 (A, B; at four boxes Q and three stages would
// need 256 KB of shared memory, past the 227 KB a block may have) and G*D
// <= MAX_PACKED = 128 (K9); the C entries refuse wider rows here, and the
// wrappers send them to attention_tc (ops/kernels/attention.py,
// attention_body).
//
// Ordering rules kept here: wgmma.fence before each batch of products (the
// accumulators and P were written by ordinary instructions since); the
// accumulators and P are pinned after each wgmma.wait_group (keep), so the
// compiler neither reads an accumulator early nor reuses P's registers while
// the RS product may still read them.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at run time

#include "attention_mma.cuh"

namespace md {
namespace wg {

using tc::bf16;
using tc::smem_u32;

constexpr int CONSUMERS = 2;                  // consumer warpgroups
constexpr int BM = 64 * CONSUMERS;            // query rows per block
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 3;                     // K/V ring depth
constexpr int BOX = 64;                       // columns per TMA box: 128 bytes
constexpr int MAX_HEAD = 192;                 // D of A and B this body takes
constexpr int MAX_PACKED = 128;               // G*D of K9 this body takes
constexpr int ROW_BYTES = BOX * 2;
constexpr int WIDE_TILE_KS = 5;               // KS up to which A's and B's tiles hold 128 keys

// Keys per K/V tile at KS k16 steps of the contraction in MODE (see
// "Tiles" above).
__host__ __device__ constexpr int tile_keys(int ks, int mode) {
  return mode != tc::PACKED && ks <= WIDE_TILE_KS ? 128 : 64;
}

// Shared memory of a block with NCB boxes a row (D <= 64 * NCB) and tiles
// of BN keys, after aligning to the 1024-byte swizzle atom: Q [NCB][BM
// rows], then STAGES x (K [NCB][BN rows], V [NCB][BN rows]), then the
// mbarriers.
template <int NCB, int BN>
struct Layout {
  static constexpr uint32_t Q_BOX = BM * ROW_BYTES;
  static constexpr uint32_t KV_BOX = BN * ROW_BYTES;
  static constexpr uint32_t Q_BYTES = NCB * Q_BOX;
  static constexpr uint32_t KV_BYTES = NCB * KV_BOX;  // one K or V tile
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;
  static constexpr uint32_t BAR_OFFSET = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr size_t SMEM = 1024 + BAR_OFFSET + 8 * (2 * STAGES + 1);
};

// --------------------------------------------------------------------------
// mbarriers, TMA, setmaxnreg
// --------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that lasts
// about 8 s means a fault in the ring: trap, so that the launch fails with
// an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 34))
      __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// --------------------------------------------------------------------------
// wgmma
// --------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1
// (128-byte swizzle). The 8-row (K-major) or 8-k (MN-major) groups are
// 1024 bytes apart in every tile here; the other offset is unused at the
// widths of one box, and set to the same value.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  constexpr uint64_t GROUP = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (GROUP << 16) | (GROUP << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers after a wait: each counts as rewritten here, so no use is
// moved above the wait and no register is reused before it.
template <int R>
__device__ __forceinline__ void keep(float (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[i][e])::"memory");
}
template <int R>
__device__ __forceinline__ void keep(uint32_t (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e])::"memory");
}

#define MD_WG_D32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define MD_WG_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define MD_WG_ACC4(d, i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define MD_WG_ACC32(d, c)                                                                 \
  MD_WG_ACC4(d, c + 0), MD_WG_ACC4(d, c + 1), MD_WG_ACC4(d, c + 2), MD_WG_ACC4(d, c + 3), \
      MD_WG_ACC4(d, c + 4), MD_WG_ACC4(d, c + 5), MD_WG_ACC4(d, c + 6), MD_WG_ACC4(d, c + 7)

// d (64 x 64 or 64 x 128, fp32; chunk j = columns 8j..8j+7 in mma.sync's
// m16n8 layout per warp) = or += A B^T: A and B K-major in shared memory,
// one k16 step.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MD_WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MD_WG_ACC32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MD_WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MD_WG_ACC32(d, 0), MD_WG_ACC32(d, 8)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[C0 .. C0+7] += A B: A (64 x 16 bf16) in registers as mma.sync A
// fragments, B (16 x 64) MN-major in shared memory.
template <int C0, int NO>
__device__ __forceinline__ void wgmma_rs(float (&d)[NO][4], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MD_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MD_WG_ACC32(d, C0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef MD_WG_D64
#undef MD_WG_ACC32
#undef MD_WG_ACC4
#undef MD_WG_D32

// --------------------------------------------------------------------------
// the kernel
// --------------------------------------------------------------------------

// One TMA map per operand: Q, then K and V of source 0 and of source 1 (the
// bank; copies of source 0's in the one-source modes).
struct Maps {
  CUtensorMap q, k0, v0, k1, v1;
};

// The rest of a launch's arguments. bcast: bit 2i set when map i (q, k0,
// v0, k1, v1) reads batch coordinate 0 for every batch row, bit 2i + 1 when
// it reads head coordinate 0 for every head.
struct Args {
  bf16* o;
  float* lse;         // (B, H, Sq) fp32, or nullptr
  const float* gate;  // (B,) fp32 (GATED), or nullptr
  long long o_sb, o_ss, o_sh;
  int H, width, Sq, len0, len1, nseg, bcast;
  float scale;
};

// The walk over a block's K/V tiles of BN keys, in the order the producer
// copies them and the consumers read them: the tile's source (0: self, 1:
// bank), its PACKED segment and its index in the source or segment. next()
// steps the counters, with no division; tps: tiles of source 0 (of a
// segment); len0, len1: the keys of source 0 (a segment) and 1. Kernel C's
// Hopper body (attention_bwd_wgmma.cuh) walks its keys with it too.
template <int MODE, int BN>
struct TileWalk {
  int src = 0, seg = 0, ti = 0;
  __device__ __forceinline__ int row(int len0) const { return seg * len0 + ti * BN; }
  __device__ __forceinline__ int nk(int len0, int len1) const {
    return min(BN, (src ? len1 : len0) - ti * BN);
  }
  __device__ __forceinline__ bool seg_end(int tps) const {
    return MODE == tc::PACKED && ti == tps - 1;
  }
  __device__ __forceinline__ void next(int tps) {
    if (++ti == tps) {
      if constexpr (MODE == tc::PACKED) {
        ti = 0;
        ++seg;
      } else if constexpr (MODE == tc::TWO_SOURCE || MODE == tc::GATED) {
        if (src == 0) {
          ti = 0;
          src = 1;
        }
      }
    }
  }
};

// KS: k16 steps of the QK^T contraction (ceil(D / 16)); NCB = 64-column
// boxes a row. Grid: (query row blocks of BM, H, B).
template <int KS, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    attention_wgmma(const __grid_constant__ Maps maps, const Args a) {
  constexpr int NCB = (KS + 3) / 4;
  constexpr bool TWO = MODE == tc::TWO_SOURCE || MODE == tc::GATED;
  constexpr bool PACK = MODE == tc::PACKED;
  constexpr int BN = tile_keys(KS, MODE);
  using L = Layout<NCB, BN>;
  constexpr int NO = 8 * NCB;  // n8 output chunks
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t q_s = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + L::Q_BYTES;  // stage st: K, then V, at kv_s + st * STAGE_BYTES
  const uint32_t bars = q_s + L::BAR_OFFSET;
  const uint32_t q_bar = bars + 16u * STAGES;
  auto full_bar = [&](int st) { return bars + 8u * st; };
  auto empty_bar = [&](int st) { return bars + 8u * (STAGES + st); };

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float gate = MODE == tc::GATED ? a.gate[b] : 1.f;
  const int tps = (a.len0 + BN - 1) / BN;  // tiles per segment of source 0
  const int bank_tiles = TWO && gate != 0.f ? (a.len1 + BN - 1) / BN : 0;
  const int ntiles = (PACK ? a.nseg : 1) * tps + bank_tiles;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), 4 * CONSUMERS);  // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == CONSUMERS) {
    // producer: one lane issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * CONSUMERS) {
      // batch and head coordinates of map i (broadcast dimensions read 0)
      auto bc = [&](int i) { return (a.bcast >> (2 * i)) & 1 ? 0 : b; };
      auto hc = [&](int i) { return (a.bcast >> (2 * i + 1)) & 1 ? 0 : h; };
      mbar_expect_tx(q_bar, L::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        tma_load_4d(q_s + cb * L::Q_BOX, &maps.q, q_bar, cb * BOX, hc(0), q0, bc(0));
      int st = 0;
      uint32_t phase = 0;
      TileWalk<MODE, BN> tile;
      for (int t = 0; t < ntiles; ++t, tile.next(tps)) {
        const CUtensorMap* k_map = tile.src ? &maps.k1 : &maps.k0;
        const CUtensorMap* v_map = tile.src ? &maps.v1 : &maps.v0;
        const int km = 1 + 2 * tile.src;  // map index of this source's K (V: km + 1)
        const int row = tile.row(a.len0);
        mbar_wait(empty_bar(st), phase ^ 1u);  // round 0 passes at once
        mbar_expect_tx(full_bar(st), L::STAGE_BYTES);
        const uint32_t k_s = kv_s + st * L::STAGE_BYTES;
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          tma_load_4d(k_s + cb * L::KV_BOX, k_map, full_bar(st), cb * BOX, hc(km), row, bc(km));
          tma_load_4d(k_s + L::KV_BYTES + cb * L::KV_BOX, v_map, full_bar(st), cb * BOX,
                      hc(km + 1), row, bc(km + 1));
        }
        if (++st == STAGES) {
          st = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // consumers: 64 query rows each
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const float scale_log2 = a.scale * tc::LOG2E;
    const uint32_t q_rows = q_s + wgi * 64 * ROW_BYTES;
    float out[PACK ? NO : 1][4], acc[NO][4], m[2], l[2];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < (PACK ? NO : 1); ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    mbar_wait(q_bar, 0);
    int st = 0;
    uint32_t phase = 0;
    TileWalk<MODE, BN> tile;
    for (int t = 0; t < ntiles; ++t, tile.next(tps)) {
      mbar_wait(full_bar(st), phase);
      __syncwarp();
      const uint32_t k_s = kv_s + st * L::STAGE_BYTES;
      const uint32_t v_s = k_s + L::KV_BYTES;

      float s[BN / 8][4];  // zeroed before the fence: the products then own it
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t col = (kk & 3) * 32u;  // 16 columns on inside the atom
        wgmma_ss(s, sw128_desc(q_rows + (kk >> 2) * L::Q_BOX + col),
                 sw128_desc(k_s + (kk >> 2) * L::KV_BOX + col), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      keep(s);

      uint32_t pa[BN / 16][4];
      tc::softmax_rows<NO, BN, MODE == tc::GATED>(s, pa, m, l, acc, scale_log2,
                                                  tile.nk(a.len0, a.len1),
                                                  tile.src ? gate : 1.f);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t v_k = v_s + kk * 16 * ROW_BYTES;
        wgmma_rs<0>(acc, pa[kk], sw128_desc(v_k));
        if constexpr (NCB >= 2) wgmma_rs<8>(acc, pa[kk], sw128_desc(v_k + L::KV_BOX));
        if constexpr (NCB >= 3) wgmma_rs<16>(acc, pa[kk], sw128_desc(v_k + 2 * L::KV_BOX));
      }
      wg_commit();
      wg_wait<0>();
      keep(acc);
      keep(pa);
      if (lane == 0) mbar_arrive(empty_bar(st));  // this warp is done with the stage

      if constexpr (PACK) {
        if (tile.seg_end(tps)) {  // the segment ends: add its normalised output
          tc::reduce_rows(l);
          const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
          for (int n = 0; n < NO; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              out[n][e] += acc[n][e] * inv[e >> 1];
              acc[n][e] = 0.f;
            }
          m[0] = m[1] = -INFINITY;
          l[0] = l[1] = 0.f;
        }
      }
      if (++st == STAGES) {
        st = 0;
        phase ^= 1u;
      }
    }

    const int row0 = wgi * 64 + warp * 16 + (lane >> 2);  // this lane's rows in the block
    bf16* ob = a.o + (long long)b * a.o_sb + (long long)h * a.o_sh + (long long)q0 * a.o_ss;
    if constexpr (PACK) {
      const float one[2] = {1.f, 1.f};
      tc::store_rows<NO>(ob, a.o_ss, row0, a.Sq - q0, a.width, out, one);
    } else {
      tc::reduce_rows(l);
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
      if (a.lse != nullptr && (lane & 3) == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = q0 + row0 + 8 * i;
          if (row < a.Sq)
            a.lse[((long long)b * a.H + h) * a.Sq + row] = m[i] * tc::LN2 + logf(l[i]);
        }
      }
      tc::store_rows<NO>(ob, a.o_ss, row0, a.Sq - q0, a.width, acc, inv);
    }
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's entry-point query, so the library links nothing but the runtime.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The rank-4 map (width, heads, rows, batch) of a bf16 operand with head,
// row and batch strides in elements, boxes of BOX columns x 1 head x
// box_rows rows x 1 batch row; map index i sets its broadcast bits in
// *bcast. A head or batch dimension of stride 0 (over more than one head or
// batch row) is encoded with extent 1 and read at coordinate 0; the stride
// of a dimension of extent 1 is never followed and is replaced by one TMA
// accepts. Rows of stride 0 cannot be encoded (the wrappers route such
// operands to attention_tc): cudaErrorInvalidValue.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int width, int heads,
                              long long rows, int batch, long long head_stride,
                              long long row_stride, long long batch_stride, int box_rows,
                              int i, int* bcast) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (rows > 1 && row_stride == 0) return cudaErrorInvalidValue;
  if (heads > 1 && head_stride == 0) *bcast |= 2 << (2 * i);
  if (batch > 1 && batch_stride == 0) *bcast |= 1 << (2 * i);
  const long long h_ext = head_stride != 0 ? heads : 1;
  const long long b_ext = batch_stride != 0 ? batch : 1;
  const long long head_bytes = h_ext > 1 ? 2 * head_stride : 2LL * width;
  const long long row_bytes = rows > 1 ? 2 * row_stride : head_bytes * h_ext;
  const long long batch_bytes = b_ext > 1 ? 2 * batch_stride : row_bytes * rows;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)h_ext, (cuuint64_t)rows,
                              (cuuint64_t)b_ext};
  const cuuint64_t strides[3] = {(cuuint64_t)head_bytes, (cuuint64_t)row_bytes,
                                 (cuuint64_t)batch_bytes};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One launch over B x p.H x the query row blocks, p as the C entries fill
// it (K9: H = 1, src[0] = the nseg * len key rows).
template <int KS, int MODE>
cudaError_t launch(const Params& p, int nseg, int B, cudaStream_t stream) {
  constexpr bool TWO = MODE == tc::TWO_SOURCE || MODE == tc::GATED;
  constexpr int BN = tile_keys(KS, MODE);
  const Source& s0 = p.src[0];
  const Source& s1 = p.src[TWO ? 1 : 0];
  const long long rows0 = (long long)(MODE == tc::PACKED ? nseg : 1) * s0.len;
  Maps maps;
  Args a;
  a.bcast = 0;
  cudaError_t err = encode_map(&maps.q, p.q, p.D, p.H, p.Sq, B, p.q_sh, p.q_ss, p.q_sb, BM, 0,
                               &a.bcast);
  if (err == cudaSuccess)
    err = encode_map(&maps.k0, s0.k, p.D, p.H, rows0, B, s0.k_sh, s0.k_ss, s0.k_sb, BN, 1,
                     &a.bcast);
  if (err == cudaSuccess)
    err = encode_map(&maps.v0, s0.v, p.D, p.H, rows0, B, s0.v_sh, s0.v_ss, s0.v_sb, BN, 2,
                     &a.bcast);
  if (err == cudaSuccess && TWO)
    err = encode_map(&maps.k1, s1.k, p.D, p.H, s1.len, B, s1.k_sh, s1.k_ss, s1.k_sb, BN, 3,
                     &a.bcast);
  if (err == cudaSuccess && TWO)
    err = encode_map(&maps.v1, s1.v, p.D, p.H, s1.len, B, s1.v_sh, s1.v_ss, s1.v_sb, BN, 4,
                     &a.bcast);
  if (err != cudaSuccess) return err;
  if (!TWO) {
    maps.k1 = maps.k0;
    maps.v1 = maps.v0;
  }
  a.o = static_cast<bf16*>(p.o);
  a.lse = p.lse;
  a.gate = p.gate;
  a.o_sb = p.o_sb;
  a.o_ss = p.o_ss;
  a.o_sh = p.o_sh;
  a.H = p.H;
  a.width = p.D;
  a.Sq = p.Sq;
  a.len0 = s0.len;
  a.len1 = s1.len;
  a.nseg = nseg;
  a.scale = p.scale;
  const size_t smem = Layout<(KS + 3) / 4, BN>::SMEM;
  err = cudaFuncSetAttribute(attention_wgmma<KS, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, p.H, B);
  attention_wgmma<KS, MODE><<<grid, THREADS, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

// Launch at ks = ceil(p.D / 16) k16 steps: one instantiation per step count
// up to MAX_KS (12 for A and B, D <= MAX_HEAD; 8 for K9, G*D <= MAX_PACKED).
template <int MODE, int MAX_KS, int KS = 1>
cudaError_t launch_ks(int ks, const Params& p, int nseg, int B, cudaStream_t stream) {
  if constexpr (KS > MAX_KS) {
    return cudaErrorInvalidValue;
  } else {
    if (ks == KS) return launch<KS, MODE>(p, nseg, B, stream);
    return launch_ks<MODE, MAX_KS, KS + 1>(ks, p, nseg, B, stream);
  }
}

// Kernels A and B (MODE SELF, TWO_SOURCE or GATED) at head width p.D.
template <int MODE>
cudaError_t launch_attention(const Params& p, int B, cudaStream_t stream) {
  if (p.D > MAX_HEAD) return cudaErrorInvalidValue;
  return launch_ks<MODE, MAX_HEAD / 16>((p.D + 15) / 16, p, 1, B, stream);
}

// K9 at packed width p.D (H = 1, nseg segments of p.src[0].len keys). A
// template, as launch_attention, so that only the sources that call it
// compile its instantiations.
template <int MODE = tc::PACKED>
cudaError_t launch_packed(const Params& p, int nseg, int BG, cudaStream_t stream) {
  if (p.D > MAX_PACKED) return cudaErrorInvalidValue;
  return launch_ks<MODE, MAX_PACKED / 16>((p.D + 15) / 16, p, nseg, BG, stream);
}

}  // namespace wg
}  // namespace md
