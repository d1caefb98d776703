// Kernel G backward: dq, dk and dv of grouped attention in one launch, from
// probabilities recomputed from q and k (the forward keeps no statistics).
//
// Replaces magicdance_tpu/ops/pallas/flash_vjp.py::_grouped_bwd_kernel
// (reached through _grouped_bwd, the custom VJP of mha_grouped). Arithmetic
// in the JAX kernel's order, per (sequence, head): fp32 logits
// l = q k^T * scale, pn = exp(l - max) / denom in fp32, dp = dO v^T,
// delta = rowsum(pn * dp), ds = pn * (dp - delta) * scale; pn is cast to
// dO's type and ds to q's type before dv = pn^T dO, dk = ds^T q and
// dq = ds k, each accumulated in fp32.
//
// Two bodies. bf16 runs on the tensor cores (grouped_bwd_tc below); fp32
// runs the CUDA-core body grouped::grouped_bwd, whose products are exact
// fp32 (on the tensor cores fp32 would be TF32, and the fp32 paths are the
// card-vs-CPU checks).
//
// What bounds the bf16 body on an H100. Per (sequence, head) the work is
// five S x S x D products, 10*S*S*D operations, on 7*S*D elements (q, k, v,
// dO in; dq, dk, dv out), 14*S*D bytes: about 11 operations per byte at
// S = 16, far below the card's ~295, so it is bound by device memory. The
// least time at the first motion level, (4096*16, 320), is 7 x 42 MB over
// 3.35 TB/s, ~0.088 ms. The design therefore moves each byte once, in
// 16-byte pieces, and keeps the arithmetic on the tensor cores:
//
//   - Key units and blocks as in the forward (grouped_tc.cuh): one
//     (sequence, head) pair of BN = S keys for S >= 16, 16 / S sequences of
//     one head packed into one 16-row tile under a block-diagonal -inf mask
//     below; a block of 4 warps (2 where 4 would leave the grid under two
//     blocks per SM and BN <= 32) owns 16 * WB rows of neighbouring heads.
//   - q, k, v and dO arrive once each, by cp.async 16-byte pieces across
//     the block's heads, into bf16 tiles of attention_mma.cuh's padded
//     stride with zeroed pad columns (D = 40 -> 48 for the contractions);
//     q and k in a first copy group, so that the softmax runs while v and
//     dO land.
//   - Row pass, one warp per 16 query rows: S = Q K^T and dP = dO V^T
//     (qk_tile, mma.sync m16n8k16, fp32 accumulate), the softmax in
//     registers (exp2 with the scale and log2(e) folded into one FMA, the
//     division by the row's sum in fp32), delta and ds in registers (quad
//     shuffles), dQ = bf16(ds) K (pv_tile). The warp writes bf16 pn and
//     bf16 ds to two [rows][BN + 8] shared tiles (the stride an odd
//     multiple of 16 bytes, so ldmatrix reads are conflict-free).
//   - Key pass, after a barrier, one warp per 16 key rows: dV = pn^T dO and
//     then dK = ds^T Q, one accumulator at a time; the A operand is read
//     transposed from the pn and ds tiles (ldmatrix.trans), the B operand
//     through pv_tile. At S = 32 and 64 a key row sums the query rows of
//     several warps this way, with no atomics and in a fixed order, so two
//     runs give the same bits; for S < 16 the block-diagonal zeros of pn
//     and ds keep each key inside its own sequence.
//   - Each gradient goes back through a shared tile that no warp reads any
//     more (dq through v's, dv through k's, dk through q's after a barrier)
//     and leaves in 16-byte stores, in the loads' order.
//
// Why mma.sync m16n8k16 and not wgmma or TMA: the kernel is bound by bytes,
// not by the tensor cores; a 64-row wgmma would multiply across units that
// the mask then throws away; and many small blocks in flight hide the load
// latency, as in the forward. A TMA or persistent-grid variant is for a
// later change, if the times show that latency rather than bytes holds the
// kernel back.
//
// Plain C interface, loaded with ctypes. Every tensor is an (N, S, H, D) view;
// strides[0..20] = q, k, v, dout, dq, dk, dv, each (sequence, row, head) in
// elements. Returns cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for a shape the bodies do not take.

#include "attention_bwd_mma.cuh"  // pack_a
#include "grouped_tc.cuh"

namespace md {
namespace grouped {

struct BwdParams {
  Operand q, k, v, dout, dq, dk, dv;
  int H, D, S;
  float scale;
};

template <typename T>
__device__ __forceinline__ T* out_ptr(const Operand& t, long long n, int h) {
  return static_cast<T*>(const_cast<void*>(t.p)) + n * t.sn + h * t.sh;
}

// The fp32 body: one block of GT threads per (sequence, head) pair walks
// three phases with two S x D tiles resident: (q, k) -> logits and pn;
// (dO, v) -> dp, dv, delta and ds; (q, k) again -> dk, dq. Re-reading q and
// k costs 2*S*D elements per pair (they are in L2 by then) and keeps S = 64,
// D = 256 within a block's shared memory.
template <typename T>
__global__ void __launch_bounds__(GT) grouped_bwd(const BwdParams p) {
  extern __shared__ float smem[];
  const int S = p.S, D = p.D, ld = D + 1, lds = S + 1;
  float* A = smem;          // S x ld: q, then dO, then q
  float* Bt = A + S * ld;   // S x ld: k, then v, then k
  float* P = Bt + S * ld;   // S x lds: logits, then pn (fp32)
  float* DS = P + S * lds;  // S x lds: dp, then ds cast to T

  const long long pair = blockIdx.x;
  const long long n = pair / p.H;
  const int h = static_cast<int>(pair - n * p.H);
  const int tid = threadIdx.x;

  // phase 1: logits and the normalised probabilities
  load_rows<T>(A, ld, p.q, n, h, S, D);
  load_rows<T>(Bt, ld, p.k, n, h, S, D);
  __syncthreads();
  products(P, lds, A, Bt, ld, S, D, p.scale);
  __syncthreads();
  load_rows<T>(A, ld, p.dout, n, h, S, D);
  load_rows<T>(Bt, ld, p.v, n, h, S, D);
  if (tid < S) {
    float* row = P + tid * lds;
    float m = -INFINITY;
    for (int j = 0; j < S; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < S; ++j) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int j = 0; j < S; ++j) row[j] = row[j] / sum;
  }
  __syncthreads();

  // phase 2: dp = dO v^T; dv = pn^T dO; delta and ds per row
  products(DS, lds, A, Bt, ld, S, D, 1.f);
  __syncthreads();
  T* dv = out_ptr<T>(p.dv, n, h);
  for (int idx = tid; idx < S * D; idx += GT) {
    const int j = idx / D;
    const int c = idx - j * D;
    float acc = 0.f;
    for (int i = 0; i < S; ++i) acc = fmaf(round_to<T>(P[i * lds + j]), A[i * ld + c], acc);
    store1(dv + j * p.dv.si + c, acc);
  }
  if (tid < S) {
    const float* pn = P + tid * lds;
    float* row = DS + tid * lds;
    float delta = 0.f;
    for (int j = 0; j < S; ++j) delta += pn[j] * row[j];
    for (int j = 0; j < S; ++j) row[j] = round_to<T>((pn[j] * (row[j] - delta)) * p.scale);
  }
  __syncthreads();

  // phase 3: dk = ds^T q, dq = ds k
  load_rows<T>(A, ld, p.q, n, h, S, D);
  load_rows<T>(Bt, ld, p.k, n, h, S, D);
  __syncthreads();
  T* dk = out_ptr<T>(p.dk, n, h);
  T* dq = out_ptr<T>(p.dq, n, h);
  for (int idx = tid; idx < S * D; idx += GT) {
    const int r = idx / D;
    const int c = idx - r * D;
    float acc_k = 0.f, acc_q = 0.f;
    for (int i = 0; i < S; ++i) {
      acc_k = fmaf(DS[i * lds + r], A[i * ld + c], acc_k);
      acc_q = fmaf(DS[r * lds + i], Bt[i * ld + c], acc_q);
    }
    store1(dk + r * p.dk.si + c, acc_k);
    store1(dq + r * p.dq.si + c, acc_q);
  }
}

inline size_t bwd_smem(int S, int D) {
  return sizeof(float) * ((size_t)2 * S * (D + 1) + (size_t)2 * S * (S + 1));
}

inline cudaError_t launch_bwd_f32(const BwdParams& p, long long pairs, cudaStream_t stream) {
  const size_t smem = bwd_smem(p.S, p.D);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_bwd<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  grouped_bwd<float><<<(unsigned)pairs, GT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace grouped

namespace tc {

// The bf16 backward's launch geometry (grouped_tc.cuh: key units, rows).
struct GroupedBwdTcParams {
  grouped::Operand q, k, v, dout, dq, dk, dv;
  long long units;  // key units: ceil(N * S / BN) * H
  long long rows;   // N * S: flat rows past it are zero-filled, never stored
  int H, D, lg_s;   // S = 1 << lg_s
  float scale;
};

// Row stride, in elements, of the bf16 pn and ds tiles ([rows][BN]): an odd
// multiple of 16 bytes, so the 8 rows one ldmatrix reads (and the 8 rows
// one fragment store writes) fall in 8 different bank groups.
template <int BN>
__host__ __device__ constexpr int p_stride() { return BN + 8; }

// The A fragments of X^T for 16 keys of a unit over its BN query rows: X is
// a [BN][LDP] bf16 tile (row: query, column: key) whose key j0 lies at
// x_addr; ldmatrix.trans reads it transposed. k-step kk holds queries
// 16kk..16kk + 15.
template <int BN, int LDP>
__device__ __forceinline__ void load_at(uint32_t (&a)[1][BN / 16][4], uint32_t x_addr,
                                        int lane) {
  const uint32_t base =
      x_addr + (uint32_t)((((lane & 7) + ((lane >> 4) << 3)) * LDP + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) ldsm_x4_t(a[0][kk], base + (uint32_t)(kk * 16 * LDP * 2));
}

template <int NO>
__device__ __forceinline__ void zero_acc(float (&acc)[1][NO][4]) {
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] = 0.f;
}

// The bf16 body: one block of WB = blockDim.x / 32 warps, 16 * WB / BN key
// units of BN keys (BN = max(16, S)); a row pass with one warp per 16 query
// rows, then a key pass with one warp per 16 key rows.
template <int KD, int NO, int BN>
__global__ void __launch_bounds__(NT) grouped_bwd_tc(const GroupedBwdTcParams p) {
  constexpr int LDS = Tile<KD>::LDS;
  constexpr int LDP = p_stride<BN>();
  extern __shared__ __align__(16) unsigned char gbt_smem[];
  const int wb = blockDim.x >> 5;
  const int rows = 16 * wb;
  const int units_here = rows / BN;
  bf16* Qs = reinterpret_cast<bf16*>(gbt_smem);  // q, then dk
  bf16* Ks = Qs + rows * LDS;                      // k, then dv
  bf16* Vs = Ks + rows * LDS;                      // v, then dq
  bf16* dOs = Vs + rows * LDS;                     // dO
  bf16* Ps = dOs + rows * LDS;                     // bf16(pn), [rows][LDP]
  bf16* DSs = Ps + rows * LDP;                     // bf16(ds), [rows][LDP]
  const long long unit0 = (long long)blockIdx.x * units_here;
  const int D = p.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  zero_pad_columns<KD>(Qs, 4 * rows, D);  // q, k, v, dO rows are contiguous
  __shared__ long long off[7][MAX_ROWS];  // q, k, v, dO, dq, dk, dv
  row_offsets<BN>(off, p, unit0, rows, p.q, p.k, p.v, p.dout, p.dq, p.dk, p.dv);
  __syncthreads();
  // two copy groups: the softmax runs on q and k while v and dO land
  load_units<LDS, BN>(Qs, static_cast<const bf16*>(p.q.p), off[0], D, units_here);
  load_units<LDS, BN>(Ks, static_cast<const bf16*>(p.k.p), off[1], D, units_here);
  cp_async_commit();
  load_units<LDS, BN>(Vs, static_cast<const bf16*>(p.v.p), off[2], D, units_here);
  load_units<LDS, BN>(dOs, static_cast<const bf16*>(p.dout.p), off[3], D, units_here);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int ku = warp * 16 / BN;             // this warp's key unit
  const bool live = unit0 + ku < p.units;    // warp-uniform
  const int unit_row = ku * BN;              // the unit's first row in the block
  const LaneAddr<KD, 1> la(warp, lane);
  const float one[2] = {1.f, 1.f};
  float acc[1][NO][4];

  // row pass: this warp's 16 query rows
  float s[1][BN / 8][4];
  if (live) {
    qk_tile<KD, 1, BN>(s, smem_u32(Qs) + la.q, smem_u32(Ks + unit_row * LDS) + la.k);
    mask_packed<BN>(s[0], p.lg_s);  // S < 16
    // rows g and g + 8 of the tile: max, then pn = exp(l - max) / sum
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[0][j][0], s[0][j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[0][j][2], s[0][j][3]));
    }
    const float c = p.scale * LOG2E;
    float m2[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m2[i] = mx[i] * c;  // finite: every row sees its own keys
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[0][j][e] = ex2(fmaf(s[0][j][e], c, -m2[e >> 1]));  // masked: exp2(-inf) = 0
        sum[e >> 1] += s[0][j][e];
      }
    reduce_rows(sum);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][j][e] = s[0][j][e] / sum[e >> 1];
  }
  cp_async_wait<0>();
  __syncthreads();  // v and dO have landed
  if (live) {
    float dp[1][BN / 8][4], delta[2] = {0.f, 0.f};
    qk_tile<KD, 1, BN>(dp, smem_u32(dOs) + la.q, smem_u32(Vs + unit_row * LDS) + la.k);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) delta[e >> 1] += s[0][j][e] * dp[0][j][e];
    reduce_rows(delta);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[0][j][e] = s[0][j][e] * (dp[0][j][e] - delta[e >> 1]) * p.scale;  // ds
    uint32_t pa[1][BN / 16][4], da[1][BN / 16][4];
    pack_a<BN>(s[0], pa[0]);
    pack_a<BN>(dp[0], da[0]);
    // the warp's rows of the pn and ds tiles: rows g and g + 8, columns
    // 8j + c0 and 8j + c0 + 1
    const int g = lane >> 2, c0 = 2 * (lane & 3);
    bf16* prow = Ps + (warp * 16 + g) * LDP + c0;
    bf16* drow = DSs + (warp * 16 + g) * LDP + c0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<uint32_t*>(prow + i * 8 * LDP + 8 * j) = pa[0][j >> 1][2 * (j & 1) + i];
        *reinterpret_cast<uint32_t*>(drow + i * 8 * LDP + 8 * j) = da[0][j >> 1][2 * (j & 1) + i];
      }
    zero_acc<NO>(acc);
    pv_tile<KD, NO, 1, BN>(acc, da, smem_u32(Ks + unit_row * LDS) + la.v);  // dQ = ds K
  }
  __syncthreads();  // pn and ds are whole; k and v have been read for the last time

  // key pass: this warp's 16 key rows
  if (live) {
    store_rows<NO>(Vs + warp * 16 * LDS, LDS, lane >> 2, 16, D, acc[0], one);  // dq
    const int j0 = warp * 16 - unit_row;  // the warp's first key in its unit
    uint32_t at[1][BN / 16][4];
    load_at<BN, LDP>(at, smem_u32(Ps + unit_row * LDP + j0), lane);
    zero_acc<NO>(acc);
    pv_tile<KD, NO, 1, BN>(acc, at, smem_u32(dOs + unit_row * LDS) + la.v);  // dV = pn^T dO
    store_rows<NO>(Ks + warp * 16 * LDS, LDS, lane >> 2, 16, D, acc[0], one);  // dv
    load_at<BN, LDP>(at, smem_u32(DSs + unit_row * LDP + j0), lane);
    zero_acc<NO>(acc);
    pv_tile<KD, NO, 1, BN>(acc, at, smem_u32(Qs + unit_row * LDS) + la.v);  // dK = ds^T Q
  }
  __syncthreads();  // q has been read for the last time
  if (live) store_rows<NO>(Qs + warp * 16 * LDS, LDS, lane >> 2, 16, D, acc[0], one);  // dk
  __syncthreads();

  // 16-byte stores of the block's gradient rows, in the loads' order
  store_units<LDS, BN>(static_cast<bf16*>(const_cast<void*>(p.dq.p)), Vs, off[4], D, units_here);
  store_units<LDS, BN>(static_cast<bf16*>(const_cast<void*>(p.dk.p)), Qs, off[5], D, units_here);
  store_units<LDS, BN>(static_cast<bf16*>(const_cast<void*>(p.dv.p)), Ks, off[6], D, units_here);
}

// Launch grouped_bwd_tc<KD, NO, BN> through dispatch_no, with the forward's
// block rule (block_warps).
template <int BN>
struct GroupedBwdLaunch {
  const GroupedBwdTcParams& p;
  cudaStream_t stream;
  template <int KD, int NO>
  cudaError_t run() {
    const int wb = block_warps<BN>(p.units);
    const int units_here = 16 * wb / BN;
    const long long blocks = (p.units + units_here - 1) / units_here;
    const size_t smem =
        sizeof(bf16) * (size_t)(4 * Tile<KD>::LDS + 2 * p_stride<BN>()) * 16 * wb;
    if (blocks > 0x7fffffffLL || smem + sizeof(long long) * 7 * MAX_ROWS > grouped::MAX_SMEM)
      return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(grouped_bwd_tc<KD, NO, BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    grouped_bwd_tc<KD, NO, BN><<<(unsigned)blocks, 32 * wb, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace tc
}  // namespace md

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int md_grouped_attention_bwd(int dtype, const void* q, const void* k,
                                        const void* v, const void* dout, void* dq,
                                        void* dk, void* dv, const long long* strides,
                                        int N, int H, int D, int S, float scale,
                                        void* stream) {
  using namespace md::grouped;
  const long long pairs = (long long)N * H;
  if (!shape_ok(S, D, N, H) || pairs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    BwdParams p;
    p.q = operand(q, strides);
    p.k = operand(k, strides + 3);
    p.v = operand(v, strides + 6);
    p.dout = operand(dout, strides + 9);
    p.dq = operand(dq, strides + 12);
    p.dk = operand(dk, strides + 15);
    p.dv = operand(dv, strides + 18);
    p.H = H;
    p.D = D;
    p.S = S;
    p.scale = scale;
    return static_cast<int>(launch_bwd_f32(p, pairs, st));
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  md::tc::GroupedBwdTcParams p;
  p.q = operand(q, strides);
  p.k = operand(k, strides + 3);
  p.v = operand(v, strides + 6);
  p.dout = operand(dout, strides + 9);
  p.dq = operand(dq, strides + 12);
  p.dk = operand(dk, strides + 15);
  p.dv = operand(dv, strides + 18);
  p.H = H;
  p.D = D;
  p.scale = scale;
  return static_cast<int>(md::tc::launch_units<md::tc::GroupedBwdLaunch>(p, N, S, D, st));
}
