// Kernel G: grouped (temporal) attention forward -- for each of N
// independent sequences of S rows and each head, softmax(q k^T * scale) v.
//
// Replaces magicdance_tpu/ops/pallas/flash.py::_grouped_attn_kernel (reached
// through _flash_attention_grouped_impl). Arithmetic in the JAX kernel's
// order: fp32 logits, unnormalised probabilities p = exp(l - max) cast to
// v's type, P V accumulated in fp32, divided by the fp32 denominator (the sum
// of the uncast p), cast to the output type.
//
// Two bodies. bf16 runs on the tensor cores (grouped_tc below); fp32 runs
// the CUDA-core body grouped_fwd of grouped_common.cuh's helpers, whose
// products are exact fp32 (on the tensor cores fp32 would be TF32, and the
// fp32 paths are the card-vs-CPU checks).
//
// What bounds the bf16 body on an H100. Per (sequence, head) the work is
// 4*S*S*D operations on 4*S*D elements (q, k, v in, o out): at S = 16 about
// 8 operations per byte, far below the card's ~295, so it is bound by device
// memory; the least time at the first motion level, (4096*16, 320), is
// 4 x 42 MB over 3.35 TB/s, ~0.05 ms. The design therefore moves each byte
// once, in 16-byte pieces, and keeps the arithmetic off the critical path:
//
//   - The unit of work is a key unit: one (sequence, head) pair for S >= 16,
//     whose BN = S keys are all it attends to; for S < 16, 16/S consecutive
//     sequences of one head packed into one 16-row tile with a
//     block-diagonal mask (-inf outside a row's own sequence), as the Pallas
//     kernel packs 128/S sequences into its 128-row tiles. Key units are
//     numbered with the head fastest, so the units of one block are
//     neighbouring heads of the same rows.
//   - One block of WB warps (4, or 2 where 4 would leave the grid under two
//     blocks per SM) owns 16*WB query rows: P = 16*WB / BN key units of
//     BN / 16 row tiles each. q, k and v arrive in bf16 shared memory by
//     cp.async 16-byte pieces, consecutive threads on consecutive pieces of
//     one packed row across the block's heads; the tile rows have
//     attention_mma.cuh's padded stride and zeroed pad columns (D = 40 ->
//     48 for the contraction).
//   - One warp owns one 16-row tile: S = Q K^T with qk_tile (mma.sync
//     m16n8k16, fp32 accumulate), the row softmax in registers (one key
//     tile, so no rescale; exp2 with the scale folded into one FMA), p
//     packed to bf16 A fragments where the JAX kernel casts p to v's type
//     while the denominator sums the fp32 p, P V with pv_tile in one to
//     four k-steps, and the division by the denominator. The output goes
//     back through the warp's own q rows in shared memory and leaves in
//     16-byte stores.
//
// Plain C interface, loaded with ctypes. q, k, v, o are (N, S, H, D) views
// (packed (N*S, H*D) projection outputs, or strided views of one fused
// projection); strides[0..11] = q, k, v, o, each (sequence, row, head) in
// elements. Returns cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for a shape the bodies do not take.

#include "attention_mma.cuh"
#include "grouped_common.cuh"

namespace md {
namespace grouped {

struct FwdParams {
  Operand q, k, v, o;
  int H, D, S;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(GT) grouped_fwd(const FwdParams p) {
  extern __shared__ float smem[];
  const int S = p.S, D = p.D, ld = D + 1, lds = S + 1;
  float* A = smem;           // S x ld: q, then v
  float* Bt = A + S * ld;    // S x ld: k
  float* P = Bt + S * ld;    // S x lds: logits, then p cast to T
  float* denom = P + S * lds;

  const long long pair = blockIdx.x;
  const long long n = pair / p.H;
  const int h = static_cast<int>(pair - n * p.H);

  load_rows<T>(A, ld, p.q, n, h, S, D);
  load_rows<T>(Bt, ld, p.k, n, h, S, D);
  __syncthreads();
  products(P, lds, A, Bt, ld, S, D, p.scale);
  __syncthreads();

  // q is consumed: v takes its place while one thread per row runs the softmax
  load_rows<T>(A, ld, p.v, n, h, S, D);
  if (threadIdx.x < S) {
    float* row = P + threadIdx.x * lds;
    float m = -INFINITY;
    for (int j = 0; j < S; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < S; ++j) {
      const float e = expf(row[j] - m);
      sum += e;
      row[j] = round_to<T>(e);
    }
    denom[threadIdx.x] = sum;
  }
  __syncthreads();

  T* o = static_cast<T*>(const_cast<void*>(p.o.p)) + n * p.o.sn + h * p.o.sh;
  for (int idx = threadIdx.x; idx < S * D; idx += GT) {
    const int i = idx / D;
    const int c = idx - i * D;
    const float* pi = P + i * lds;
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc = fmaf(pi[j], A[j * ld + c], acc);
    store1(o + i * p.o.si + c, acc / denom[i]);
  }
}

inline size_t fwd_smem(int S, int D) {
  return sizeof(float) * ((size_t)2 * S * (D + 1) + (size_t)S * (S + 1) + S);
}

// The fp32 forward: one block of GT threads per (sequence, head) pair.
inline cudaError_t launch_fwd_f32(const FwdParams& p, long long pairs, cudaStream_t stream) {
  const size_t smem = fwd_smem(p.S, p.D);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_fwd<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  grouped_fwd<float><<<(unsigned)pairs, GT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace grouped

namespace tc {

constexpr int MAX_ROWS = 64;  // query rows of a block: 16 per warp, at most 4 warps

// The bf16 forward's launch geometry. A key unit is numbered u = x * H + h:
// x is the sequence (S >= 16) or the packed 16-row tile (S < 16), whose
// flat rows x * BN + rho (rho < BN) are row (flat % S) of sequence flat / S.
struct GroupedTcParams {
  grouped::Operand q, k, v, o;
  long long units;  // key units: ceil(N * S / BN) * H
  long long rows;   // N * S: flat rows past it are zero-filled, never stored
  int H, D, lg_s;   // S = 1 << lg_s
  float scale;
};

// Element offsets of the block's rows in q, k, v and o, -1 past the data:
// smem row s belongs to key unit s / BN of the block, at row s % BN of that
// unit. One thread per row works them out once, so the copies below do no
// division.
template <int BN>
__device__ __forceinline__ void row_offsets(long long (*off)[MAX_ROWS],
                                            const GroupedTcParams& p, long long unit0,
                                            int rows) {
  for (int s = threadIdx.x; s < rows; s += blockDim.x) {
    const long long u = unit0 + s / BN;
    const long long x = u / p.H;
    const long long flat = x * BN + s % BN;
    const bool ok = u < p.units && flat < p.rows;
    const long long h = u - x * p.H;
    const long long n = flat >> p.lg_s;
    const long long i = flat - (n << p.lg_s);
    auto at = [&](const grouped::Operand& t) {
      return ok ? n * t.sn + i * t.si + h * t.sh : -1LL;
    };
    off[0][s] = at(p.q);
    off[1][s] = at(p.k);
    off[2][s] = at(p.v);
    off[3][s] = at(p.o);
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

// The bf16 body: one block of WB = blockDim.x / 32 warps, P = 16 * WB / BN
// key units of BN keys (BN = max(16, S)), one warp per 16-row tile.
template <int KD, int NO, int BN>
__global__ void __launch_bounds__(NT) grouped_tc(const GroupedTcParams p) {
  constexpr int LDS = Tile<KD>::LDS;
  extern __shared__ __align__(16) unsigned char gtc_smem[];
  const int wb = blockDim.x >> 5;
  const int rows = 16 * wb;
  const int units_here = rows / BN;
  bf16* Qs = reinterpret_cast<bf16*>(gtc_smem);
  bf16* Ks = Qs + rows * LDS;
  bf16* Vs = Ks + rows * LDS;
  const long long unit0 = (long long)blockIdx.x * units_here;
  const int D = p.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // pad columns D..16*KD of q, k and v: zero, so the padded products add 0
  {
    const int w = (Tile<KD>::DP - D) >> 3;
    for (int idx = threadIdx.x; idx < 3 * rows * w; idx += blockDim.x) {
      const int r = idx / w;
      *reinterpret_cast<uint4*>(Qs + r * LDS + D + ((idx - r * w) << 3)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __shared__ long long off[4][MAX_ROWS];  // q, k, v, o
  row_offsets<BN>(off, p, unit0, rows);
  __syncthreads();
  load_units<LDS, BN>(Qs, static_cast<const bf16*>(p.q.p), off[0], D, units_here);
  load_units<LDS, BN>(Ks, static_cast<const bf16*>(p.k.p), off[1], D, units_here);
  load_units<LDS, BN>(Vs, static_cast<const bf16*>(p.v.p), off[2], D, units_here);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int ku = warp * 16 / BN;  // this warp's key unit
  if (unit0 + ku < p.units) {     // warp-uniform
    const LaneAddr<KD, 1> la(warp, lane);
    float s[1][BN / 8][4];
    uint32_t pa[1][BN / 16][4];
    qk_tile<KD, 1, BN>(s, smem_u32(Qs) + la.q, smem_u32(Ks + ku * BN * LDS) + la.k);
    if (BN == 16 && p.lg_s < 4) {
      // packed sequences: row g (and g + 8) of the tile sees only the keys
      // of its own sequence, the S-aligned block holding it
      const int g = lane >> 2, c0 = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (((g + 8 * (e >> 1)) >> p.lg_s) != ((8 * j + c0 + (e & 1)) >> p.lg_s))
            s[0][j][e] = -INFINITY;
    }
    RowState<NO, 1> st;
    st.reset();
    softmax_tile<NO, 1, BN, false>(s, pa, st, p.scale * LOG2E, BN, 1.f);
    pv_tile<KD, NO, 1, BN>(st.acc, pa, smem_u32(Vs + ku * BN * LDS) + la.v);
    reduce_rows(st.l[0]);
    const float inv[2] = {1.f / st.l[0][0], 1.f / st.l[0][1]};
    // q is consumed: the warp's own q rows take its output
    store_rows<NO>(Qs + warp * 16 * LDS, LDS, lane >> 2, 16, D, st.acc[0], inv);
  }
  __syncthreads();

  // 16-byte stores of the block's output rows, in the loads' order
  bf16* ob = static_cast<bf16*>(const_cast<void*>(p.o.p));
  for_pieces<BN>(D, units_here, [&](int srow, int c) {
    const long long o = off[3][srow];
    if (o >= 0)
      *reinterpret_cast<uint4*>(ob + o + c) = *reinterpret_cast<const uint4*>(Qs + srow * LDS + c);
  });
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

// Launch grouped_tc<KD, NO, BN> through dispatch_no. Four warps a block
// (64 query rows), or two where four would give fewer than two blocks per
// SM and the units allow it (BN <= 32).
template <int BN>
struct GroupedLaunch {
  const GroupedTcParams& p;
  cudaStream_t stream;
  template <int KD, int NO>
  cudaError_t run() {
    int wb = 4;
    if (BN <= 32 && (p.units + 64 / BN - 1) / (64 / BN) < 2LL * sm_count()) wb = 2;
    const int units_here = 16 * wb / BN;
    const long long blocks = (p.units + units_here - 1) / units_here;
    const size_t smem = sizeof(bf16) * (size_t)Tile<KD>::LDS * 3 * 16 * wb;
    if (blocks > 0x7fffffffLL || smem > grouped::MAX_SMEM) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(grouped_tc<KD, NO, BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    grouped_tc<KD, NO, BN><<<(unsigned)blocks, 32 * wb, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace tc
}  // namespace md

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int md_grouped_attention(int dtype, const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* strides, int N, int H,
                                    int D, int S, float scale, void* stream) {
  using namespace md::grouped;
  const long long pairs = (long long)N * H;
  if (!shape_ok(S, D, N, H) || pairs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FwdParams p;
    p.q = operand(q, strides);
    p.k = operand(k, strides + 3);
    p.v = operand(v, strides + 6);
    p.o = operand(o, strides + 9);
    p.H = H;
    p.D = D;
    p.S = S;
    p.scale = scale;
    return static_cast<int>(launch_fwd_f32(p, pairs, st));
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  md::tc::GroupedTcParams p;
  p.q = operand(q, strides);
  p.k = operand(k, strides + 3);
  p.v = operand(v, strides + 6);
  p.o = operand(o, strides + 9);
  p.H = H;
  p.D = D;
  p.lg_s = __builtin_ctz(static_cast<unsigned>(S));  // S | 128: a power of two
  p.scale = scale;
  p.rows = (long long)N * S;
  const int bn = S < 16 ? 16 : S;
  p.units = (p.rows + bn - 1) / bn * H;
  cudaError_t err;
  if (bn == 16) {
    md::tc::GroupedLaunch<16> f{p, st};
    err = md::tc::dispatch_no(D, f);
  } else if (bn == 32) {
    md::tc::GroupedLaunch<32> f{p, st};
    err = md::tc::dispatch_no(D, f);
  } else {
    md::tc::GroupedLaunch<64> f{p, st};
    err = md::tc::dispatch_no(D, f);
  }
  return static_cast<int>(err);
}
