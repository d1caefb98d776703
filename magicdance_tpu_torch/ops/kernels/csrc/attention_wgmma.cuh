// Hopper body of kernel K9's bf16 path (packed_attention.cu): wgmma on
// operands that TMA brings into a ring of shared-memory stages, guarded by
// mbarriers, with one producer warp and two consumer warpgroups.
//
// What it computes is K9's function (packed_attention.cu, top): for each of
// the G key segments of S rows, softmax(q k_g^T * scale) over the segment's
// keys, P cast to bf16 unnormalised, times v_g in fp32; each segment's
// acc / l summed into the output, written in bf16. The logits contract the
// whole G*D width.
//
// Block layout. One block owns BM = 128 query rows of one BG row: two
// consumer warpgroups of 64 rows each (the wgmma M) and a producer
// warpgroup whose first warp's first lane issues every copy. The producer
// warpgroup gives registers to the consumers (setmaxnreg: of the 168 a
// thread of 384 gets at launch, it keeps 40 and they take 232); its other
// warps only take part in that and end.
//
// Copies. Each operand has a rank-3 TMA tensor map (G*D, rows, BG), encoded
// on the host at each launch from the pointers and strides, with 128-byte
// swizzle: a box is 64 columns (128 bytes, the swizzle's width) by 128 (Q)
// or 64 (K, V) rows, so G*D <= 64 takes one box a tile and G*D <= 128 two;
// columns past G*D (and rows past the tensor's end) arrive as zeros from
// TMA's out-of-bounds fill, so nothing is padded in device memory. Q arrives
// once; K and V tiles of 64 keys stream through STAGES stages, each with a
// "full" mbarrier (the producer's expect_tx, completed by the copies' bytes)
// and an "empty" one (one arrival from each consumer warp once its products
// that read the stage have retired). Tile t of segment g starts at key row
// g*S + 64t, so the last tile of a segment may hold rows of the next one:
// they are masked by key index and never used.
//
// Products. QK^T: wgmma.m64n64k16, A = the warpgroup's 64 Q rows and B = the
// K tile, both K-major in shared memory (the descriptor steps 32 bytes
// inside the swizzle atom per k16 step, and to the next box every 4 steps);
// ceil(G*D / 16) steps, unrolled (one instantiation per step count). Online
// softmax in registers by kernel A's routine (tc::softmax_rows: the wgmma
// accumulator has mma.sync's m16n8 layout per warp), which leaves P as bf16
// A fragments. PV: wgmma.m64n64k16 with A = P in registers and B = the V
// tile read MN-major (the same swizzled tile as for K; only the descriptor
// differs), one instruction per 64-column box per k16 step of keys. A
// segment keeps its own running (m, l, acc); at its end out += acc / l.
// Epilogue: bf16 rows and columns written with masks (tc::store_rows).
//
// Overlap. Inside a consumer the products and the softmax take turns
// (QK^T, softmax, PV); the two consumers overlap each other as the warp
// schedulers find them ready. Issuing QK^T of tile t + 1 beside PV of tile
// t, so that one warpgroup's softmax runs under its own products, measured
// slower at the probe's shape (PERF.md, PR 15).
//
// Registers. A consumer thread holds 32 logits, 16 words of P, and NO = 8 *
// NCB output columns' fp32 values twice (segment and output accumulator):
// 192 at G*D = 128, under setmaxnreg's 232. Wider widths do not fit; the
// wrapper routes G*D > 128 to attention_tc, and the C entry refuses them
// here.
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
constexpr int BN = 64;                        // keys per tile
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 3;                     // K/V ring depth
constexpr int BOX = 64;                       // columns per TMA box: 128 bytes
constexpr int MAX_WIDTH = 128;                // G*D this body takes
constexpr int ROW_BYTES = BOX * 2;

// Shared memory of a block with NCB boxes a row (G*D <= 64 * NCB), after
// aligning to the 1024-byte swizzle atom: Q [NCB][BM rows], then STAGES x
// (K [NCB][BN rows], V [NCB][BN rows]), then the mbarriers.
template <int NCB>
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
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
#define MD_WG_ACC4(d, i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define MD_WG_ACC32(d, c)                                                                 \
  MD_WG_ACC4(d, c + 0), MD_WG_ACC4(d, c + 1), MD_WG_ACC4(d, c + 2), MD_WG_ACC4(d, c + 3), \
      MD_WG_ACC4(d, c + 4), MD_WG_ACC4(d, c + 5), MD_WG_ACC4(d, c + 6), MD_WG_ACC4(d, c + 7)

// d (64 x 64, fp32; chunk j = columns 8j..8j+7 in mma.sync's m16n8 layout
// per warp) = or += A B^T: A and B K-major in shared memory, one k16 step.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MD_WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MD_WG_ACC32(d, 0)
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

#undef MD_WG_ACC32
#undef MD_WG_ACC4
#undef MD_WG_D32

// --------------------------------------------------------------------------
// the kernel
// --------------------------------------------------------------------------

// KS: k16 steps of the QK^T contraction (ceil(G*D / 16)); NCB = 64-column
// boxes a row (1: G*D <= 64, 2: G*D <= 128). Grid: (query row blocks of BM,
// BG).
template <int KS>
__global__ void __launch_bounds__(THREADS, 1)
    attention_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                    const long long o_sb, const long long o_ss, const int width, const int Sq,
                    const int S, const int nseg, const float scale) {
  constexpr int NCB = (KS + 3) / 4;
  using L = Layout<NCB>;
  constexpr int NO = 8 * NCB;  // n8 output chunks
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t q_s = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + L::Q_BYTES;  // stage st: K, then V, at kv_s + st * STAGE_BYTES
  const uint32_t bars = q_s + L::BAR_OFFSET;
  const uint32_t q_bar = bars + 16u * STAGES;
  auto full_bar = [&](int st) { return bars + 8u * st; };
  auto empty_bar = [&](int st) { return bars + 8u * (STAGES + st); };

  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y;
  const int tps = (S + BN - 1) / BN;  // tiles per segment
  const int ntiles = nseg * tps;

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
      mbar_expect_tx(q_bar, L::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        tma_load_3d(q_s + cb * L::Q_BOX, &q_map, q_bar, cb * BOX, q0, b);
      int st = 0, seg = 0, tile = 0;
      uint32_t phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        mbar_wait(empty_bar(st), phase ^ 1u);  // round 0 passes at once
        mbar_expect_tx(full_bar(st), L::STAGE_BYTES);
        const int row = seg * S + tile * BN;
        const uint32_t k_s = kv_s + st * L::STAGE_BYTES;
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          tma_load_3d(k_s + cb * L::KV_BOX, &k_map, full_bar(st), cb * BOX, row, b);
          tma_load_3d(k_s + L::KV_BYTES + cb * L::KV_BOX, &v_map, full_bar(st), cb * BOX, row,
                      b);
        }
        if (++tile == tps) {
          tile = 0;
          ++seg;
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
    const float scale_log2 = scale * tc::LOG2E;
    const uint32_t q_rows = q_s + wgi * 64 * ROW_BYTES;
    float out[NO][4], acc[NO][4], m[2], l[2];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[n][e] = acc[n][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    mbar_wait(q_bar, 0);
    int st = 0, tile = 0;
    uint32_t phase = 0;
    for (int t = 0; t < ntiles; ++t) {
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
      tc::softmax_rows<NO, BN, false>(s, pa, m, l, acc, scale_log2, min(BN, S - tile * BN),
                                      1.f);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t v_k = v_s + kk * 16 * ROW_BYTES;
        wgmma_rs<0>(acc, pa[kk], sw128_desc(v_k));
        if constexpr (NCB == 2) wgmma_rs<8>(acc, pa[kk], sw128_desc(v_k + L::KV_BOX));
      }
      wg_commit();
      wg_wait<0>();
      keep(acc);
      keep(pa);
      if (lane == 0) mbar_arrive(empty_bar(st));  // this warp is done with the stage

      if (++tile == tps) {  // the segment ends: add its normalised output
        tile = 0;
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
      if (++st == STAGES) {
        st = 0;
        phase ^= 1u;
      }
    }

    const float one[2] = {1.f, 1.f};
    tc::store_rows<NO>(o + (long long)b * o_sb + (long long)q0 * o_ss, o_ss,
                       wgi * 64 + warp * 16 + (lane >> 2), Sq - q0, width, out, one);
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

// The rank-3 map (width, rows, batch) of a bf16 operand with row and batch
// strides in elements, boxes of BOX columns x box_rows rows. A stride of a
// dimension of size 1 is never followed: it is replaced by one TMA accepts.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int width, long long rows,
                              long long batch, long long row_stride, long long batch_stride,
                              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long long row_bytes = rows > 1 ? 2 * row_stride : 2LL * width;
  const long long batch_bytes = batch > 1 ? 2 * batch_stride : row_bytes * rows;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)batch_bytes};
  const cuuint32_t box[3] = {BOX, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// K9 on this body: p as packed_attention.cu fills it (H = 1, src[0] = the
// G*S key rows with len = S).
template <int KS>
cudaError_t launch_packed(const Params& p, int nseg, int BG, cudaStream_t stream) {
  const Source& src = p.src[0];
  const long long keys = (long long)nseg * src.len;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = encode_map(&q_map, p.q, p.D, p.Sq, BG, p.q_ss, p.q_sb, BM);
  if (err == cudaSuccess) err = encode_map(&k_map, src.k, p.D, keys, BG, src.k_ss, src.k_sb, BN);
  if (err == cudaSuccess) err = encode_map(&v_map, src.v, p.D, keys, BG, src.v_ss, src.v_sb, BN);
  if (err != cudaSuccess) return err;
  const size_t smem = Layout<(KS + 3) / 4>::SMEM;
  err = cudaFuncSetAttribute(attention_wgmma<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, BG);
  attention_wgmma<KS><<<grid, THREADS, smem, stream>>>(q_map, k_map, v_map,
                                                       static_cast<bf16*>(p.o), p.o_sb, p.o_ss,
                                                       p.D, p.Sq, src.len, nseg, p.scale);
  return cudaGetLastError();
}

// K9 at packed width p.D <= MAX_WIDTH, by its k16 steps.
inline cudaError_t launch_packed_width(const Params& p, int nseg, int BG, cudaStream_t stream) {
  switch ((p.D + 15) / 16) {
    case 1: return launch_packed<1>(p, nseg, BG, stream);
    case 2: return launch_packed<2>(p, nseg, BG, stream);
    case 3: return launch_packed<3>(p, nseg, BG, stream);
    case 4: return launch_packed<4>(p, nseg, BG, stream);
    case 5: return launch_packed<5>(p, nseg, BG, stream);
    case 6: return launch_packed<6>(p, nseg, BG, stream);
    case 7: return launch_packed<7>(p, nseg, BG, stream);
    case 8: return launch_packed<8>(p, nseg, BG, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg
}  // namespace md
