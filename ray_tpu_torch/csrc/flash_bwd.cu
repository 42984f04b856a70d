// Flash-attention backward for Hopper (sm_90a), CUDA C++ with plain C entries.
//
// Replaces the two Pallas TPU kernels launched by `_bwd` in
// ray_tpu/ops/flash_attention.py:
// - K2 `_bwd_dq_kernel` -> `flash_bwd_dq_mma_kernel` (bf16) and
//   `flash_bwd_dq_kernel` (f32): per (batch, head, q tile), walk the key
//   tiles up to the causal frontier, recompute P = exp(q k^T * scale - lse)
//   and accumulate dQ += dS K with dS = P * (dO V^T - Delta) * scale.
// - K3 `_bwd_dkv_kernel` -> `flash_bwd_dkv_mma_kernel` (bf16) and
//   `flash_bwd_dkv_kernel` (f32): per (batch, head, key tile), walk the q
//   tiles from the causal start, recompute P and dS and accumulate
//   dV += P^T dO and dK += dS^T Q.
// Delta = rowsum(dO * O), which JAX computes with jnp outside its kernels,
// is a prologue of K2 here: each K2 block sums its own rows (f32) and writes
// them to a [B, H, Tq] buffer that K3 then reads. Sums are f32; dQ, dK, dV
// are written once in the input type, as the Pallas kernels do.
//
// Design for this card, not the TPU's:
// - The TPU kernels keep a whole (b, h) row of K/V (K2) or of Q/dO (K3)
//   resident in VMEM. A Hopper block has at most 227 KB of shared memory,
//   so the other side is streamed through shared memory in tiles.
// - Two kernels, as on the TPU: P and dS are recomputed in each, but no
//   block ever adds into another block's output, so there are no atomics
//   and the gradients are deterministic, bit for bit, from run to run.
// - Inputs are read through their batch, head and time strides (unit
//   stride on Dh): the dO that autograd hands over is a transposed view.
//
// What bounds them, at the training shape (B=24, H=12, T=1024, Dh=64,
// bf16, causal; 151 M kept (q, k) pairs): K2's products (S, dP, dQ: 6 Dh
// flops a pair) are 58.0 GFLOP, 58.7 us at the bf16 tensor-core rate,
// against 229 MB read and written (q, k, v, O, dO, dQ, lse, Delta), 68.3 us
// at 3.35 TB/s: bytes bound it. K3's (S, dP, dV, dK: 8 Dh flops a pair) are
// 77.4 GFLOP, 78.2 us, against 229 MB, 68.3 us: operations bound it.
//
// bf16 runs on the tensor cores (`flash_bwd_dq_mma_kernel`,
// `flash_bwd_dkv_mma_kernel`, below): bf16 tiles by cp.async, ldmatrix into
// mma.sync, f32 accumulators. f32 keeps the first design, since TF32 would
// break the reference's f32 tolerances: 256 threads a block, four threads
// to one row of the block's own 64-row tile, each computing 16 of a tile's
// 64 scores and keeping Dh/4 accumulator columns in f32 registers; tiles
// widened to f32 in shared memory, rows padded by one float; every product
// a scalar FMA with two shared-memory loads, which shared memory's 128 B/clk
// an SM holds near 9 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_common.cuh"

namespace {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // keys per tile
constexpr int NT = 256;           // threads per block
constexpr int TPR = 4;            // threads per row of the block's own tile
constexpr int SPT = 64 / TPR;     // scores per thread per tile (16)
constexpr float NEG_INF = -1e30f; // the reference's mask value

static_assert(BQ == BK, "the causal start of K3 assumes square tiles");
static_assert(NT == BQ * TPR && NT == BK * TPR, "one row per four threads");

// element strides of batch, head and time for up to five [B, H, T, Dh] inputs
struct Strides {
  int s[15];
};

// Copy rows [t0, t0 + 64) of a [T, DH] slice (time stride st) into a padded
// f32 tile, times `mul`; rows at or past T read as 0.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long st,
                                          int t0, int Tn, float mul) {
  constexpr int LD = DH + 1;
  for (int idx = threadIdx.x; idx < 64 * DH; idx += NT) {
    const int rr = idx / DH, d = idx % DH, t = t0 + rr;
    dst[rr * LD + d] = t < Tn ? src[(long long)t * st + d] * mul : 0.f;
  }
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  // sQ (q * scale), sDO, sK, sV [64][DH+1]; sDS [BQ][BK+1]
  return sizeof(float) * (4 * 64 * (DH + 1) + BQ * (BK + 1));
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  // sK, sV, sQ (q * scale), sDO [64][DH+1]; sP, sDS [BK][BQ+1]; lse, Delta [BQ]
  return sizeof(float) * (4 * 64 * (DH + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

// K2, f32. Strides: q, k, v, o, dout. dq: contiguous [B, H, Tq, DH]; lse,
// delta: contiguous [B, H, Tq] f32 (delta is written here).
template <int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ delta,
    int H, int Tq, int Tk, Strides st, int causal, float scale) {
  constexpr int LD = DH + 1;
  constexpr int LDS = BK + 1;
  constexpr int CPT = DH / TPR;   // dQ columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BQ * LD;
  float* sK = sDO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sDS = sV + BK * LD;

  const int tid = threadIdx.x;
  const int r = tid / TPR;        // this thread's query row in the tile
  const int sub = tid % TPR;      // its lane among the row's four threads
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bq_ = (long long)b * st.s[0] + (long long)h * st.s[1];
  const long long bk_ = (long long)b * st.s[3] + (long long)h * st.s[4];
  const long long bv_ = (long long)b * st.s[6] + (long long)h * st.s[7];
  const long long bo_ = (long long)b * st.s[9] + (long long)h * st.s[10];
  const long long bd_ = (long long)b * st.s[12] + (long long)h * st.s[13];

  load_tile<DH>(sQ, q + bq_, st.s[2], q0, Tq, scale);
  load_tile<DH>(sDO, dout + bd_, st.s[14], q0, Tq, 1.f);
  __syncthreads();

  // Delta prologue: the row's four threads each sum Dh/4 products
  const int qpos = q0 + r;
  const bool row_ok = qpos < Tq;
  const long long row = ((long long)b * H + h) * Tq + qpos;
  float dl = 0.f;
  if (row_ok) {
    const float* orow = o + bo_ + (long long)qpos * st.s[11];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int d = sub + TPR * i;
      dl = fmaf(sDO[r * LD + d], orow[d], dl);
    }
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  const float lse_r = row_ok ? lse[row] : 0.f;
  if (row_ok && sub == 0) delta[row] = dl;

  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;

  int num_kb = (Tk + BK - 1) / BK;
  if (causal) num_kb = min(num_kb, (q0 + BQ + BK - 1) / BK);  // causal frontier

  for (int jk = 0; jk < num_kb; ++jk) {
    const int k0 = jk * BK;
    __syncthreads();  // the previous tile's K, V, dS are no longer read
    load_tile<DH>(sK, k + bk_, st.s[5], k0, Tk, 1.f);
    load_tile<DH>(sV, v + bv_, st.s[8], k0, Tk, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < SPT; ++j) {
      const int c = sub + TPR * j;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) {
        s = fmaf(sQ[r * LD + d], sK[c * LD + d], s);
        dp = fmaf(sDO[r * LD + d], sV[c * LD + d], dp);
      }
      const int kpos = k0 + c;
      float ds = 0.f;  // a masked key has P = exp(-1e30 - lse) = 0
      if (kpos < Tk && !(causal && kpos > qpos)) {
        const float p = expf(s - lse_r);
        ds = p * (dp - dl) * scale;
      }
      sDS[r * LDS + c] = ds;
    }
    __syncwarp();  // row r's dS is written and read by the same four lanes

    for (int c = 0; c < BK; ++c) {
      const float ds = sDS[r * LDS + c];
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[i] = fmaf(ds, sK[c * LD + sub + TPR * i], acc[i]);
    }
  }

  if (row_ok) {
    float* out = dq + row * DH;
#pragma unroll
    for (int i = 0; i < CPT; ++i) out[sub + TPR * i] = acc[i];
  }
}

// K3, f32. Strides: q, k, v, dout. dk, dv: contiguous [B, H, Tk, DH]; lse,
// delta: contiguous [B, H, Tq] f32.
template <int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    int H, int Tq, int Tk, Strides st, int causal, float scale) {
  constexpr int LD = DH + 1;
  constexpr int LDP = BQ + 1;
  constexpr int CPT = DH / TPR;   // dK and dV columns per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sDO = sQ + BQ * LD;
  float* sP = sDO + BQ * LD;
  float* sDS = sP + BK * LDP;
  float* sL = sDS + BK * LDP;
  float* sD = sL + BQ;

  const int tid = threadIdx.x;
  const int r = tid / TPR;        // this thread's key row in the tile
  const int sub = tid % TPR;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bq_ = (long long)b * st.s[0] + (long long)h * st.s[1];
  const long long bk_ = (long long)b * st.s[3] + (long long)h * st.s[4];
  const long long bv_ = (long long)b * st.s[6] + (long long)h * st.s[7];
  const long long bd_ = (long long)b * st.s[9] + (long long)h * st.s[10];
  const long long rows = ((long long)b * H + h) * Tq;  // lse/delta row 0

  load_tile<DH>(sK, k + bk_, st.s[5], k0, Tk, 1.f);
  load_tile<DH>(sV, v + bv_, st.s[8], k0, Tk, 1.f);

  const int kpos = k0 + r;
  float dk_acc[CPT], dv_acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int num_qb = (Tq + BQ - 1) / BQ;
  const int start_qb = causal ? k0 / BQ : 0;  // the first tile with q >= k0

  for (int iq = start_qb; iq < num_qb; ++iq) {
    const int q0 = iq * BQ;
    __syncthreads();  // the previous tile's Q, dO, P, dS, lse, Delta are no longer read
    load_tile<DH>(sQ, q + bq_, st.s[2], q0, Tq, scale);
    load_tile<DH>(sDO, dout + bd_, st.s[11], q0, Tq, 1.f);
    if (tid < BQ) {
      const int t = q0 + tid;
      sL[tid] = t < Tq ? lse[rows + t] : 0.f;
      sD[tid] = t < Tq ? delta[rows + t] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < SPT; ++j) {
      const int c = sub + TPR * j;  // query row in the tile
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) {
        s = fmaf(sQ[c * LD + d], sK[r * LD + d], s);
        dp = fmaf(sDO[c * LD + d], sV[r * LD + d], dp);
      }
      const int qpos = q0 + c;
      float p = 0.f, ds = 0.f;
      if (qpos < Tq && kpos < Tk && !(causal && kpos > qpos)) {
        p = expf(s - sL[c]);
        // dS without its factor `scale`: sQ already carries it, so
        // dK += dS^T (q * scale) is the reference's dK += (dS * scale)^T q
        ds = p * (dp - sD[c]);
      }
      sP[r * LDP + c] = p;
      sDS[r * LDP + c] = ds;
    }
    __syncwarp();  // row r's P and dS are written and read by the same four lanes

    for (int c = 0; c < BQ; ++c) {
      const float p = sP[r * LDP + c];
      const float ds = sDS[r * LDP + c];
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int d = sub + TPR * i;
        dv_acc[i] = fmaf(p, sDO[c * LD + d], dv_acc[i]);
        dk_acc[i] = fmaf(ds, sQ[c * LD + d], dk_acc[i]);
      }
    }
  }

  if (kpos < Tk) {
    const long long row = (((long long)b * H + h) * Tk + kpos) * DH;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      dk[row + sub + TPR * i] = dk_acc[i];
      dv[row + sub + TPR * i] = dv_acc[i];
    }
  }
}

// ------------------------------------------------------ bf16: tensor cores
constexpr float LOG2E = 1.4426950408889634f;

// K2, bf16, on the tensor cores: K3's design with the roles of q and k
// swapped. Each block owns 64 q rows, four warps of 16 rows, and q tiles
// launch heaviest first. The block loads its Q, dO and O tiles once by
// cp.async (O into the second K buffer), sums Delta = rowsum(dO * O) of its
// rows in f32 and writes it, then streams 64-key K and V tiles,
// double-buffered with cp.async, up to the causal frontier. Per tile each
// warp computes S = Q K^T and dP = dO V^T with Q, dO as A operands and K, V
// as non-transposed ldmatrix B operands; P = exp(S scale - lse) and dS =
// P (dP - Delta) in f32 fragments, lse and Delta per row (each thread holds
// rows g and g + 8); dS rounded to bf16 in registers as the A operand of
// dQ += dS K, which takes K from the same tile through ldmatrix.trans. dQ
// stays in f32 registers and is multiplied by scale once, in f32, before
// the store. No block writes another's rows and the order of every sum is
// fixed: dQ and Delta are the same bit for bit from run to run.
template <int DH>
struct DqMmaCfg {
  static constexpr int NW = 4, NT = 32 * NW;
  static constexpr int BQ = 16 * NW;  // q rows per block, 16 a warp
  static constexpr int BK = 64;       // keys per streamed tile
  // Q and dO A fragments in registers at Dh <= 64 (32 registers at Dh = 64);
  // at Dh = 128 dQ alone takes 64 registers a thread, so Q and dO are read
  // from shared memory each tile
  static constexpr bool QDO_REGS = DH <= 64;
  static constexpr int LD = rt_tc::Tile<DH>::LD;
  // sQ (later dQ's staging), sDO [BQ][LD]; sK, sV [2][BK][LD]; all bf16. O
  // passes through the second K buffer before the first key tile
  static constexpr size_t smem = sizeof(__nv_bfloat16) * (2 * BQ + 4 * BK) * LD;
};
static_assert(DqMmaCfg<64>::BQ == DqMmaCfg<64>::BK,
              "O's tile fits a K buffer, and the diagonal tile is the last");

// Strides: q, k, v, o, dout (bf16: base addresses and strides in bytes
// multiples of 16, for cp.async). dq: contiguous [B, H, Tq, DH]; lse, delta:
// contiguous [B, H, Tq] f32 (delta is written here).
template <int DH>
__global__ void __launch_bounds__(DqMmaCfg<DH>::NT) flash_bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
    int H, int Tq, int Tk, Strides st, int causal, float scale) {
  using bf16 = __nv_bfloat16;
  using C = DqMmaCfg<DH>;
  using namespace rt_tc;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT, LD = C::LD;
  constexpr int KD = DH / 16;  // k16 steps of S = Q K^T and dP = dO V^T
  constexpr int ND = DH / 8;   // n8 tiles of dQ
  constexpr int NK = BK / 8;   // n8 tiles of S and dP
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + BQ * LD;
  bf16* sK = sDO + BQ * LD;     // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;  // [2][BK][LD]
  bf16* sO = sK + BK * LD;      // the second K buffer, until the first tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  // q tiles in reverse: under causal masking the last tiles are the heaviest
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + (long long)b * st.s[0] + (long long)h * st.s[1];
  const bf16* kb = k + (long long)b * st.s[3] + (long long)h * st.s[4];
  const bf16* vb = v + (long long)b * st.s[6] + (long long)h * st.s[7];
  const bf16* ob = o + (long long)b * st.s[9] + (long long)h * st.s[10];
  const bf16* db = dout + (long long)b * st.s[12] + (long long)h * st.s[13];
  const long long bh = (long long)b * H + h;
  const int wq0 = q0 + 16 * warp;  // the warp's first q row
  const int row0 = wq0 + g;        // this thread's rows: row0, row0 + 8

  int num_kb = (Tk + BK - 1) / BK;
  if (causal) num_kb = min(num_kb, (q0 + BQ + BK - 1) / BK);  // causal frontier

  load_tile_async<BQ, DH, NT>(sQ, qb, st.s[2], q0, Tq);
  load_tile_async<BQ, DH, NT>(sDO, db, st.s[14], q0, Tq);
  load_tile_async<BQ, DH, NT>(sO, ob, st.s[11], q0, Tq);
  load_tile_async<BK, DH, NT>(sK, kb, st.s[5], 0, Tk);
  load_tile_async<BK, DH, NT>(sV, vb, st.s[8], 0, Tk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Delta prologue: two lanes to each of the warp's 16 rows, each summing
  // half of the row's dO * O in f32 from the bf16 values; each thread then
  // takes its rows' sums by shuffle. Rows at or past Tq are zero and are
  // not written.
  float dl[2];  // Delta of rows row0, row0 + 8
  {
    const int r = lane >> 1, half = lane & 1;
    const bf16* pd = sDO + (16 * warp + r) * LD + half * (DH / 2);
    const bf16* po = sO + (16 * warp + r) * LD + half * (DH / 2);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 2; c += 8) {
      const uint4 x8 = *reinterpret_cast<const uint4*>(pd + c);
      const uint4 y8 = *reinterpret_cast<const uint4*>(po + c);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x8);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(x2[i]), y = __bfloat1622float2(y2[i]);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);  // lanes 2r, 2r + 1: row r's
    dl[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
    dl[1] = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
    if (half == 0 && wq0 + r < Tq) delta[bh * Tq + wq0 + r] = sum;
  }
  // -lse of the thread's rows in log2 units (0 past Tq: those rows are zero
  // and their dQ is never written)
  const float nl[2] = {row0 < Tq ? -lse[bh * Tq + row0] * LOG2E : 0.f,
                       row0 + 8 < Tq ? -lse[bh * Tq + row0 + 8] * LOG2E : 0.f};

  const bf16* wQ = sQ + 16 * warp * LD;  // the warp's 16 q rows
  const bf16* wDO = sDO + 16 * warp * LD;
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8;  // A-operand ldmatrix
  uint32_t qf[C::QDO_REGS ? KD : 1][4], df[C::QDO_REGS ? KD : 1][4];
  if constexpr (C::QDO_REGS) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      ldmatrix_x4(qf[kd], wQ + a_off + 16 * kd);
      ldmatrix_x4(df[kd], wDO + a_off + 16 * kd);
    }
  }
  __syncthreads();  // O is read: the second K buffer is free for tile 1

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int j = 0; j < num_kb; ++j) {
    const int k0 = j * BK;
    if (j + 1 < num_kb) {  // the next tile streams in while this one computes
      load_tile_async<BK, DH, NT>(sK + ((j + 1) & 1) * BK * LD, kb, st.s[5], k0 + BK, Tk);
      load_tile_async<BK, DH, NT>(sV + ((j + 1) & 1) * BK * LD, vb, st.s[8], k0 + BK, Tk);
      cp_async_commit();
    }
    const bf16* cK = sK + (j & 1) * BK * LD;
    const bf16* cV = sV + (j & 1) * BK * LD;
    // with BQ == BK every tile up to the frontier holds kept pairs for all
    // four warps, so no warp skips one
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4], da[4];
      if constexpr (C::QDO_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[kd][i], da[i] = df[kd][i];
      } else {
        ldmatrix_x4(qa, wQ + a_off + 16 * kd);
        ldmatrix_x4(da, wDO + a_off + 16 * kd);
      }
      const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + 16 * kd + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {  // keys 16 np .. 16 np + 15
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, cK + 16 * np * LD + b_off);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        ldmatrix_x4(bv, cV + 16 * np * LD + b_off);
        mma_bf16(dp[2 * np], da, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], da, bv[2], bv[3]);
      }
    }
    // keys past Tk (zero rows, which would score 0 and give P = exp(-lse))
    // and keys past the row under causal masking get P = 0 exactly, as
    // exp(-1e30 - lse) does in the reference; only edge tiles need the test
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > wq0);
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], sl2, nl[e >> 1]));  // scale on the f32 score
        if (edge) {
          const int key = k0 + 8 * n + 2 * t4 + (e & 1);
          if (key >= Tk || (causal && key > row0 + 8 * (e >> 1))) p = 0.f;
        }
        dp[n][e] = p * (dp[n][e] - dl[e >> 1]);  // dS, without its factor scale
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // dQ += dS K, dS rounded to bf16
      uint32_t dsa[4];
      scores_to_a(dsa, dp, kk);
      const bf16* kt_row = cK + (16 * kk + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {  // columns 16 np .. 16 np + 15
        uint32_t kt[4];
        ldmatrix_x4_trans(kt, kt_row + 16 * np);
        mma_bf16(acc[2 * np], dsa, kt[0], kt[1]);
        mma_bf16(acc[2 * np + 1], dsa, kt[2], kt[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next tile has landed and this one is no longer read
  }

  // dQ goes out through the warp's own 16 rows of sQ, times scale in f32
  bf16* rows = sQ + 16 * warp * LD;
  acc_to_rows<DH>(rows, acc, scale, scale, lane);
  __syncwarp();
  store_rows<DH>(dq + bh * Tq * DH, rows, wq0, Tq, lane);
}

// K3, bf16, on the tensor cores. Each block owns 64 keys, four warps of 16
// key rows; q and dO tiles of BQ rows stream in double-buffered with
// cp.async, with their lse and Delta. Per tile each warp computes the
// transposed scores, as FA2's dK/dV kernel does: S^T = K Q^T and dP^T =
// V dO^T with K, V as A operands and Q, dO as non-transposed ldmatrix B
// operands; P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - Delta) in f32
// fragments, rounded to bf16 in registers as the A operands of dV += P^T dO
// and dK += dS^T Q, which take dO and Q through ldmatrix.trans. dK is
// multiplied by scale once, in f32, before the store. dK and dV stay in f32
// registers, no block writes another's rows, and the order of every sum is
// fixed: the output is the same bit for bit from run to run.

template <int DH>
struct DkvMmaCfg {
  static constexpr int NW = 4, NT = 128;
  static constexpr int BK = 64;                   // keys per block, 16 a warp
  static constexpr int BQ = DH == 128 ? 32 : 64;  // q rows per streamed tile
  // K/V A fragments in registers at Dh <= 64; at Dh = 128 dK and dV alone
  // take 128 registers a thread, so K and V are read from shared memory
  static constexpr bool KV_REGS = DH <= 64;
  static constexpr int LD = rt_tc::Tile<DH>::LD;
  // sK, sV [BK][LD] (later dK/dV's staging), sQ, sDO [2][BQ][LD], bf16;
  // lse and Delta [2][BQ], f32
  static constexpr size_t smem =
      sizeof(__nv_bfloat16) * (2 * BK + 4 * BQ) * LD + sizeof(float) * 4 * BQ;
};
static_assert(DkvMmaCfg<64>::BK % DkvMmaCfg<64>::BQ == 0 &&
              DkvMmaCfg<128>::BK % DkvMmaCfg<128>::BQ == 0,
              "the causal start k0 / BQ needs BQ to divide BK");

template <int DH>
__global__ void __launch_bounds__(DkvMmaCfg<DH>::NT) flash_bwd_dkv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int H, int Tq, int Tk, Strides st, int causal, float scale) {
  using bf16 = __nv_bfloat16;
  using C = DkvMmaCfg<DH>;
  using namespace rt_tc;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT, LD = C::LD;
  constexpr int KD = DH / 16;  // k16 steps of S^T = K Q^T
  constexpr int ND = DH / 8;   // n8 tiles of dK, dV
  constexpr int NQ = BQ / 8;   // n8 tiles of S^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;          // [2][BQ][LD]
  bf16* sDO = sQ + 2 * BQ * LD;     // [2][BQ][LD]
  float* sL = reinterpret_cast<float*>(sDO + 2 * BQ * LD);  // [2][BQ]
  float* sD = sL + 2 * BQ;                                  // [2][BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + (long long)b * st.s[0] + (long long)h * st.s[1];
  const bf16* kb = k + (long long)b * st.s[3] + (long long)h * st.s[4];
  const bf16* vb = v + (long long)b * st.s[6] + (long long)h * st.s[7];
  const bf16* db = dout + (long long)b * st.s[9] + (long long)h * st.s[10];
  const long long bh = (long long)b * H + h;
  const float* lb = lse + bh * Tq;
  const float* deb = delta + bh * Tq;
  const int wk0 = k0 + 16 * warp;  // the warp's first key row
  const int key0 = wk0 + g;        // this thread's keys: key0, key0 + 8

  const int num_qb = (Tq + BQ - 1) / BQ;
  const int start_qb = causal ? k0 / BQ : 0;  // the first tile with q >= k0

  // q tile iq of the stream (rows, lse, Delta) into buffer `buf`
  auto load_q_tile = [&](int iq, int buf) {
    const int q0 = iq * BQ;
    load_tile_async<BQ, DH, NT>(sQ + buf * BQ * LD, qb, st.s[2], q0, Tq);
    load_tile_async<BQ, DH, NT>(sDO + buf * BQ * LD, db, st.s[11], q0, Tq);
    if (tid < 2 * BQ) {
      const int r = tid % BQ, t = q0 + r;
      const bool ok = t < Tq;
      const float* src = tid < BQ ? lb : deb;
      cp_async_4((tid < BQ ? sL : sD) + buf * BQ + r, ok ? src + t : src, ok ? 4 : 0);
    }
  };

  load_tile_async<BK, DH, NT>(sK, kb, st.s[5], k0, Tk);
  load_tile_async<BK, DH, NT>(sV, vb, st.s[8], k0, Tk);
  if (start_qb < num_qb) load_q_tile(start_qb, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const bf16* wK = sK + 16 * warp * LD;  // the warp's 16 key rows
  const bf16* wV = sV + 16 * warp * LD;
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8;  // A-operand ldmatrix
  uint32_t kf[C::KV_REGS ? KD : 1][4], vf[C::KV_REGS ? KD : 1][4];
  if constexpr (C::KV_REGS) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      ldmatrix_x4(kf[kd], wK + a_off + 16 * kd);
      ldmatrix_x4(vf[kd], wV + a_off + 16 * kd);
    }
  }

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int iq = start_qb; iq < num_qb; ++iq) {
    const int q0 = iq * BQ, buf = (iq - start_qb) & 1;
    if (iq + 1 < num_qb) {  // the next tile streams in while this one computes
      load_q_tile(iq + 1, buf ^ 1);
      cp_async_commit();
    }
    const bf16* cQ = sQ + buf * BQ * LD;
    const bf16* cDO = sDO + buf * BQ * LD;
    const float* cL = sL + buf * BQ;
    const float* cD = sD + buf * BQ;
    // a tile wholly below the causal diagonal of all 16 keys (every q < every
    // key) adds nothing, so the warp skips it
    if (!(causal && wk0 > q0 + BQ - 1)) {
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ka[4], va[4];
        if constexpr (C::KV_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ka[i] = kf[kd][i], va[i] = vf[kd][i];
        } else {
          ldmatrix_x4(ka, wK + a_off + 16 * kd);
          ldmatrix_x4(va, wV + a_off + 16 * kd);
        }
        const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + 16 * kd + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {  // q rows 16 np .. 16 np + 15
          uint32_t bq[4], bo[4];
          ldmatrix_x4(bq, cQ + 16 * np * LD + b_off);
          mma_bf16(s[2 * np], ka, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
          ldmatrix_x4(bo, cDO + 16 * np * LD + b_off);
          mma_bf16(dp[2 * np], va, bo[0], bo[1]);
          mma_bf16(dp[2 * np + 1], va, bo[2], bo[3]);
        }
      }
      const bool edge = q0 + BQ > Tq || (causal && wk0 + 15 > q0);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int c = 8 * n + 2 * t4;  // this thread's columns c, c + 1
        const float2 l2 = *reinterpret_cast<const float2*>(cL + c);
        const float2 d2 = *reinterpret_cast<const float2*>(cD + c);
        const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E};  // -lse in log2 units
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[n][e], sl2, nl[e & 1]));
          if (edge) {
            const int qpos = q0 + c + (e & 1);
            if (qpos >= Tq || (causal && key0 + 8 * (e >> 1) > qpos)) p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - ((e & 1) ? d2.y : d2.x));
        }
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {  // P^T and dS^T rounded to bf16
        uint32_t pa[4], da[4];
        scores_to_a(pa, s, kk);
        scores_to_a(da, dp, kk);
        const int t_off = (16 * kk + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {  // columns 16 np .. 16 np + 15
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo, cDO + t_off + 16 * np);
          mma_bf16(dv_acc[2 * np], pa, bo[0], bo[1]);
          mma_bf16(dv_acc[2 * np + 1], pa, bo[2], bo[3]);
          ldmatrix_x4_trans(bq, cQ + t_off + 16 * np);
          mma_bf16(dk_acc[2 * np], da, bq[0], bq[1]);
          mma_bf16(dk_acc[2 * np + 1], da, bq[2], bq[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next tile has landed and this one is no longer read
  }

  // dK and dV go out through the warp's own 16 rows of sK and sV
  bf16* rk = sK + 16 * warp * LD;
  bf16* rv = sV + 16 * warp * LD;
  acc_to_rows<DH>(rk, dk_acc, scale, scale, lane);
  acc_to_rows<DH>(rv, dv_acc, 1.f, 1.f, lane);
  __syncwarp();
  store_rows<DH>(dk + bh * Tk * DH, rk, wk0, Tk, lane);
  store_rows<DH>(dv + bh * Tk * DH, rv, wk0, Tk, lane);
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, void* dq, float* delta,
                      int B, int H, int Tq, int Tk, const Strides& st, int causal,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<DH><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse,
      static_cast<float*>(dq), delta, H, Tq, Tk, st, causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, void* dq, float* delta,
                          int B, int H, int Tq, int Tk, const Strides& st, int causal,
                          float scale, cudaStream_t stream) {
  using C = DqMmaCfg<DH>;
  using bf16 = __nv_bfloat16;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + C::BQ - 1) / C::BQ, H, B);
  flash_bwd_dq_mma_kernel<DH><<<grid, C::NT, C::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
      static_cast<bf16*>(dq), delta, H, Tq, Tk, st, causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       int B, int H, int Tq, int Tk, const Strides& st, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + BK - 1) / BK, H, B);
  flash_bwd_dkv_kernel<DH><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
      H, Tq, Tk, st, causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv,
                           int B, int H, int Tq, int Tk, const Strides& st, int causal,
                           float scale, cudaStream_t stream) {
  using C = DkvMmaCfg<DH>;
  using bf16 = __nv_bfloat16;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + C::BK - 1) / C::BK, H, B);
  flash_bwd_dkv_mma_kernel<DH><<<grid, C::NT, C::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Tq, Tk, st, causal, scale);
  return cudaGetLastError();
}

Strides copy_strides(const int* s, int n) {
  Strides st{};
  for (int i = 0; i < n; ++i) st.s[i] = s[i];
  return st;
}

}  // namespace

// q, k, v, o, dout: [B, H, T, Dh] with unit stride on Dh; `strides` holds
// their batch, head and time element strides (15 ints, in that order; bf16:
// base addresses and strides in bytes multiples of 16, for cp.async).
// lse: contiguous [B, H, Tq] f32. Writes dq (contiguous [B, H, Tq, Dh], the
// input type) and delta (contiguous [B, H, Tq] f32). dtype 0 = float32 (FMA
// body), 1 = bfloat16 (tensor-core body). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* dq, void* delta,
                               int B, int H, int Tq, int Tk, int Dh, const int* strides,
                               int causal, float scale, int dtype, void* stream) {
  const Strides st = copy_strides(strides, 15);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define RT_DQ_ARGS (q, k, v, o, dout, l, dq, dl, B, H, Tq, Tk, st, causal, scale, s)
  if (dtype == 0) {  // f32: the FMA body
    if (Dh == 32) return (int)launch_dq<32> RT_DQ_ARGS;
    if (Dh == 64) return (int)launch_dq<64> RT_DQ_ARGS;
    if (Dh == 128) return (int)launch_dq<128> RT_DQ_ARGS;
  } else if (dtype == 1) {  // bf16: the tensor-core body
    if (Dh == 32) return (int)launch_dq_mma<32> RT_DQ_ARGS;
    if (Dh == 64) return (int)launch_dq_mma<64> RT_DQ_ARGS;
    if (Dh == 128) return (int)launch_dq_mma<128> RT_DQ_ARGS;
  }
#undef RT_DQ_ARGS
  return (int)cudaErrorInvalidValue;
}

// q, k, v, dout: [B, H, T, Dh] with unit stride on Dh; `strides` holds their
// batch, head and time element strides (12 ints; bf16: base addresses and
// strides in bytes multiples of 16, for cp.async). lse, delta: contiguous
// [B, H, Tq] f32. Writes dk, dv (contiguous [B, H, Tk, Dh], the input type).
// dtype 0 = float32 (FMA body), 1 = bfloat16 (tensor-core body).
extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dk, void* dv, int B, int H, int Tq, int Tk, int Dh,
                                const int* strides, int causal, float scale, int dtype,
                                void* stream) {
  const Strides st = copy_strides(strides, 12);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define RT_DKV_ARGS (q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, st, causal, scale, s)
  if (dtype == 0) {  // f32: the FMA body
    if (Dh == 32) return (int)launch_dkv<32> RT_DKV_ARGS;
    if (Dh == 64) return (int)launch_dkv<64> RT_DKV_ARGS;
    if (Dh == 128) return (int)launch_dkv<128> RT_DKV_ARGS;
  } else if (dtype == 1) {  // bf16: the tensor-core body
    if (Dh == 32) return (int)launch_dkv_mma<32> RT_DKV_ARGS;
    if (Dh == 64) return (int)launch_dkv_mma<64> RT_DKV_ARGS;
    if (Dh == 128) return (int)launch_dkv_mma<128> RT_DKV_ARGS;
  }
#undef RT_DKV_ARGS
  return (int)cudaErrorInvalidValue;
}
