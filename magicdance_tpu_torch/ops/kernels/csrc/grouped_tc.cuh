// Block geometry of the bf16 grouped (temporal) attention kernels on the
// tensor cores: grouped_tc (the forward, grouped_attention.cu) and
// grouped_bwd_tc (the backward, grouped_attention_bwd.cu).
//
// Both cut the N * S packed rows into key units: one (sequence, head) pair
// of BN = S rows for S >= 16; for S < 16, 16 / S consecutive sequences of
// one head packed into one 16-row tile (BN = 16) under a block-diagonal
// mask. Units are numbered u = x * H + h with the head fastest: x is the
// sequence (S >= 16) or the packed tile (S < 16), whose flat rows
// x * BN + rho (rho < BN) are row (flat % S) of sequence flat / S. A block
// of WB warps holds 16 * WB rows: 16 * WB / BN neighbouring units, that is
// neighbouring heads of the same packed rows. The helpers below work out
// each block row's element offset in every operand once, and copy the
// block's rows in 16-byte pieces in the order that keeps a warp on
// contiguous memory.

#pragma once

#include "attention_mma.cuh"
#include "grouped_common.cuh"

namespace md {
namespace tc {

constexpr int MAX_ROWS = 64;  // query rows of a block: 16 per warp, at most 4 warps

// Element offsets of the block's rows in each of `ops`, -1 past the data:
// smem row s belongs to key unit s / BN of the block, at row s % BN of that
// unit. One thread per row works them out once, so the copies do no
// division. G holds the geometry: units (ceil(N * S / BN) * H), rows (N * S:
// flat rows past it are zero-filled, never stored), H and lg_s (S = 1 << lg_s).
template <int BN, typename G, typename... Ops>
__device__ __forceinline__ void row_offsets(long long (*off)[MAX_ROWS], const G& p,
                                            long long unit0, int rows, const Ops&... ops) {
  for (int s = threadIdx.x; s < rows; s += blockDim.x) {
    const long long u = unit0 + s / BN;
    const long long x = u / p.H;
    const long long flat = x * BN + s % BN;
    const bool ok = u < p.units && flat < p.rows;
    const long long h = u - x * p.H;
    const long long n = flat >> p.lg_s;
    const long long i = flat - (n << p.lg_s);
    int j = 0;
    ((off[j++][s] = ok ? n * ops.sn + i * ops.si + h * ops.sh : -1LL), ...);
  }
}

// Visit the block's 16-byte pieces of one operand in the order that keeps a
// warp on contiguous memory: consecutive threads take consecutive pieces of
// a row, then the same row of the next key unit (the next head: contiguous
// in a packed projection). f(smem row, column) for each.
template <int BN, typename F>
__device__ __forceinline__ void for_pieces(int D, int units_here, F f) {
  const int chunks = D >> 3;
  const int per_row = units_here * chunks;
  for (int idx = threadIdx.x; idx < BN * per_row; idx += blockDim.x) {
    const int rho = idx / per_row;
    const int rest = idx - rho * per_row;
    const int ku = rest / chunks;
    f(ku * BN + rho, (rest - ku * chunks) << 3);
  }
}

// Start the cp.async copies of one operand's rows into a shared tile of
// stride LDS; rows past the data are zero-filled (src-size 0, read from the
// operand's base).
template <int LDS, int BN>
__device__ __forceinline__ void load_units(bf16* dst, const bf16* src, const long long* off,
                                           int D, int units_here) {
  const uint32_t base = smem_u32(dst);
  for_pieces<BN>(D, units_here, [&](int s, int c) {
    const long long o = off[s];
    cp_async16(base + (uint32_t)(s * LDS + c) * 2u, o >= 0 ? src + o + c : src,
               o >= 0 ? 16 : 0);
  });
}

// 16-byte stores of one output's block rows from a shared tile of stride
// LDS, in the loads' order; rows past the data are skipped.
template <int LDS, int BN>
__device__ __forceinline__ void store_units(bf16* dst, const bf16* src, const long long* off,
                                            int D, int units_here) {
  for_pieces<BN>(D, units_here, [&](int s, int c) {
    const long long o = off[s];
    if (o >= 0)
      *reinterpret_cast<uint4*>(dst + o + c) = *reinterpret_cast<const uint4*>(src + s * LDS + c);
  });
}

// Packed sequences (S < 16, BN = 16): row g (and g + 8) of a warp's 16 x 16
// logits tile sees only the keys of its own sequence, the S-aligned block
// holding it; the others are set to -inf.
template <int BN>
__device__ __forceinline__ void mask_packed(float (&s)[BN / 8][4], int lg_s) {
  if (BN != 16 || lg_s >= 4) return;
  const int g = (threadIdx.x & 31) >> 2, c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (((g + 8 * (e >> 1)) >> lg_s) != ((8 * j + c0 + (e & 1)) >> lg_s)) s[j][e] = -INFINITY;
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// Warps per block: 4 (64 rows), or 2 where 4 would give fewer than two
// blocks per SM and the units allow it (BN <= 32).
template <int BN>
inline int block_warps(long long units) {
  return BN <= 32 && (units + 64 / BN - 1) / (64 / BN) < 2LL * sm_count() ? 2 : 4;
}

// Set the unit geometry of p (whose H is set; S = 1 << lg_s rows a
// sequence, BN = max(16, S) keys a unit) and launch Launch<BN> through
// dispatch_no.
template <template <int> class Launch, typename P>
cudaError_t launch_units(P& p, long long N, int S, int D, cudaStream_t stream) {
  p.lg_s = __builtin_ctz(static_cast<unsigned>(S));  // S | 128: a power of two
  p.rows = N * S;
  const int bn = S < 16 ? 16 : S;
  p.units = (p.rows + bn - 1) / bn * p.H;
  if (bn == 16) {
    Launch<16> f{p, stream};
    return dispatch_no(D, f);
  }
  if (bn == 32) {
    Launch<32> f{p, stream};
    return dispatch_no(D, f);
  }
  Launch<64> f{p, stream};
  return dispatch_no(D, f);
}

}  // namespace tc
}  // namespace md
