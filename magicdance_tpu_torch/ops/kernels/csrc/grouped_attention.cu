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

#include "grouped_tc.cuh"

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

// The bf16 forward's launch geometry (grouped_tc.cuh: key units, rows).
struct GroupedTcParams {
  grouped::Operand q, k, v, o;
  long long units;  // key units: ceil(N * S / BN) * H
  long long rows;   // N * S: flat rows past it are zero-filled, never stored
  int H, D, lg_s;   // S = 1 << lg_s
  float scale;
};

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

  zero_pad_columns<KD>(Qs, 3 * rows, D);  // q, k, v rows are contiguous
  __shared__ long long off[4][MAX_ROWS];  // q, k, v, o
  row_offsets<BN>(off, p, unit0, rows, p.q, p.k, p.v, p.o);
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
    mask_packed<BN>(s[0], p.lg_s);  // S < 16
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
  store_units<LDS, BN>(static_cast<bf16*>(const_cast<void*>(p.o.p)), Qs, off[3], D, units_here);
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
    const int wb = block_warps<BN>(p.units);
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
  p.scale = scale;
  return static_cast<int>(md::tc::launch_units<md::tc::GroupedLaunch>(p, N, S, D, st));
}
