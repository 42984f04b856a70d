// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` launched by `_fwd` in
// ray_tpu/ops/flash_attention.py (the forward K1). Same function: per
// (batch, head) an online softmax over key tiles with an f32 running max m,
// normalizer l (clamped at 1e-30) and f32 accumulator; O is written in the
// input type, lse = m + log(l) in f32. Causal mode stops at each q tile's
// causal frontier and masks by position (diagonal at 0, Tq == Tk). Ragged
// sequence ends are masked (rows past Tq are not stored, keys at or past the
// bound kv_len <= Tk score -1e30 and are never read), so any Tq, Tk work, and
// a K/V chunk zero-padded at its end (the ring's ragged chunks) is exact.
//
// What bounds it: at the training shape (B=24, H=12, T=1024, Dh=64, bf16,
// causal; 151 M kept (q, k) pairs) reading q, k, v and writing O and lse
// once is 152 MB, 45.4 us at 3.35 TB/s, and the 38.7 GFLOP of the two
// products are 39.1 us at the bf16 tensor-core rate: bytes bound it, by a
// little.
//
// Two bodies, chosen by the input type:
// - bf16 (`flash_fwd_mma_kernel`), on the tensor cores. The first design
//   widened tiles to f32 in shared memory and did every product as scalar
//   FMAs with two shared-memory loads each; shared memory's 128 B/clk an SM
//   held it near 9 TFLOP/s, 1 % of its bound. Now each warp owns 16 query
//   rows (a block 128 rows at Dh <= 64, 64 at Dh = 128) and streams 64-key
//   K/V tiles that stay bf16 in shared memory, double-buffered with
//   cp.async so the next tile loads while this one computes, rows padded so
//   ldmatrix has no bank conflicts. q's fragments are loaded into registers
//   once; S = q k^T runs on mma.sync into f32, is scaled in f32 (1/sqrt(Dh)
//   is not exact in bf16), and the online softmax works on the accumulator
//   fragments with quad shuffles for the row max and sum; l sums the f32 P.
//   P is rounded to bf16 in registers (a C fragment pair is an A fragment)
//   and O += P V takes V through ldmatrix.trans: each shared-memory byte
//   now feeds a 16x8x16 product instead of one FMA. Only tiles on the causal
//   diagonal are masked, a warp skips a tile that is wholly above it, and
//   the heaviest causal q tiles are launched first.
// - f32 (`flash_fwd_kernel`): the first design, kept because TF32 would
//   break the reference's f32 tolerances. One thread block of 256 threads per
//   (b, h, 64-row q tile); four threads own one query row, each holding 16
//   of the tile's 64 scores and Dh/4 accumulator columns in registers; tiles
//   in shared memory as f32, rows padded by one float; products are f32
//   FMAs.
//
// Both stream K/V through shared memory, where the TPU kernel keeps a whole
// row of K and V resident in VMEM: a Hopper block has at most 227 KB.
//
// Head dims past 128 (256, the widest the wrapper pads to): the Dh = 128
// tiles cannot simply be stretched. The bf16 body already holds 211-247
// registers a thread at 128, and the f32 body's accumulators would double.
// So the grid doubles instead (`rt_tc::Cols`): each block owns 128 of the
// 256 output columns of O and keeps the accumulators of Dh = 128, while its
// scores S = q k^T still run over the whole head from full-width q and K
// tiles (the bf16 body then reads q's fragments from shared memory each
// tile instead of keeping them in registers); only the owned half of V is
// loaded. S is computed twice, once in each block of a pair; both compute
// lse, the first of the pair writes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;  // the reference's mask value

// ---------------------------------------------------------------- f32: FMAs
constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per streamed tile
constexpr int NT = 256;           // threads per block
constexpr int TPR = NT / BQ;      // threads per query row (4)
constexpr int SPT = BK / TPR;     // scores per thread per tile (16)

template <int DH>
constexpr size_t smem_bytes() {
  // sQ [BQ][DH+1], sK [BK][DH+1], sV [BK][DV], sP [BQ][BK+1], all f32
  constexpr int DV = rt_tc::Cols<DH>::DV;
  return sizeof(float) * (BQ * (DH + 1) + BK * (DH + 1) + BK * DV + BQ * (BK + 1));
}

template <int DH>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int Tq, int kv_len,
    int sqb, int sqh, int sqt, int skb, int skh, int skt,
    int svb, int svh, int svt, int causal, float scale) {
  constexpr int DV = rt_tc::Cols<DH>::DV, NH = rt_tc::Cols<DH>::NH;
  constexpr int LD = DH + 1;
  constexpr int LDP = BK + 1;
  constexpr int CPT = DV / TPR;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;       // the block's DV columns of V
  float* sP = sV + BK * DV;

  const int tid = threadIdx.x;
  const int r = tid / TPR;        // the query row this thread works on
  const int sub = tid % TPR;      // its lane within the row's 4 threads
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z / NH, col0 = (blockIdx.z % NH) * DV;  // owned columns
  const float* qb = q + (long long)b * sqb + (long long)h * sqh;
  const float* kb = k + (long long)b * skb + (long long)h * skh;
  const float* vb = v + (long long)b * svb + (long long)h * svh + col0;

  // q is scaled once on load, as the reference scales q before the dot
  for (int idx = tid; idx < BQ * DH; idx += NT) {
    const int rr = idx / DH, d = idx % DH, t = q0 + rr;
    sQ[rr * LD + d] = t < Tq ? qb[(long long)t * sqt + d] * scale : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;

  const int qpos = q0 + r;
  int num_kb = (kv_len + BK - 1) / BK;
  if (causal) num_kb = min(num_kb, (q0 + BQ + BK - 1) / BK);  // causal frontier

  for (int jk = 0; jk < num_kb; ++jk) {
    const int k0 = jk * BK;
    __syncthreads();  // the previous tile's K, V, P are no longer read
    for (int idx = tid; idx < BK * DH; idx += NT) {
      const int rr = idx / DH, d = idx % DH, t = k0 + rr;
      sK[rr * LD + d] = t < kv_len ? kb[(long long)t * skt + d] : 0.f;
    }
    for (int idx = tid; idx < BK * DV; idx += NT) {
      const int rr = idx / DV, d = idx % DV, t = k0 + rr;
      sV[rr * DV + d] = t < kv_len ? vb[(long long)t * svt + d] : 0.f;
    }
    __syncthreads();

    float s[SPT];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int c = sub + TPR * j;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) dot = fmaf(sQ[r * LD + d], sK[c * LD + d], dot);
      const int kpos = k0 + c;
      if (kpos >= kv_len || (causal && kpos > qpos)) dot = NEG_INF;
      s[j] = dot;
      mx = fmaxf(mx, dot);
    }
    // the row's four threads are adjacent lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const float p = expf(s[j] - m_new);
      sP[r * LDP + sub + TPR * j] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * corr + rs;
    m = m_new;
    __syncwarp();  // row r's P is written and read by the same four lanes

#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[i] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = sP[r * LDP + c];
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[i] = fmaf(p, sV[c * DV + sub + TPR * i], acc[i]);
    }
  }

  if (qpos < Tq) {
    l = fmaxf(l, 1e-30f);
    const long long row = ((long long)b * H + h) * Tq + qpos;
    float* ob = o + row * DH + col0;
#pragma unroll
    for (int i = 0; i < CPT; ++i) ob[sub + TPR * i] = acc[i] / l;
    if (sub == 0 && col0 == 0) lse[row] = m + logf(l);
  }
}

// ----------------------------------------------------- bf16: tensor cores
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DH>
struct MmaCfg {
  static constexpr int NW = DH >= 128 ? 4 : 8;  // warps, 16 query rows each
  static constexpr int BQ = 16 * NW;            // query rows per block
  static constexpr int BK = 64;                 // keys per streamed tile
  static constexpr int NT = 32 * NW;
  static constexpr int DV = rt_tc::Cols<DH>::DV, NH = rt_tc::Cols<DH>::NH;
  // q's A fragments in registers up to Dh = 128 (32 registers there); past
  // it they are read from shared memory each tile
  static constexpr bool QREGS = DH <= 128;
  static constexpr int LD = rt_tc::Tile<DH>::LD;
  static constexpr int LDV = rt_tc::Tile<DV>::LD;
  // sQ [BQ][LD] (later O's staging), sK [2][BK][LD], sV [2][BK][LDV] (the
  // block's DV columns), all bf16
  static constexpr size_t smem = sizeof(bf16) * ((BQ + 2 * BK) * LD + 2 * BK * LDV);
};

template <int DH>
__global__ void __launch_bounds__(MmaCfg<DH>::NT) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int H, int Tq, int kv_len,
    int sqb, int sqh, int sqt, int skb, int skh, int skt,
    int svb, int svh, int svt, int causal, float scale) {
  using C = MmaCfg<DH>;
  using namespace rt_tc;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT, LD = C::LD, LDV = C::LDV, DV = C::DV;
  constexpr int KD = DH / 16;  // k16 steps of S = q k^T
  constexpr int ND = DV / 8;   // n8 tiles of the block's columns of O
  constexpr int NK = BK / 8;   // n8 tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * LD;
  bf16* sV = sK + 2 * BK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  // q tiles in reverse: under causal masking the last tiles are the heaviest
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z / C::NH, col0 = (blockIdx.z % C::NH) * DV;  // owned columns
  const bf16* qb = q + (long long)b * sqb + (long long)h * sqh;
  const bf16* kb = k + (long long)b * skb + (long long)h * skh;
  const bf16* vb = v + (long long)b * svb + (long long)h * svh + col0;
  const int wq0 = q0 + 16 * warp;  // the warp's first query row
  const int row0 = wq0 + g;        // this thread's rows: row0, row0 + 8

  int num_kb = (kv_len + BK - 1) / BK;
  if (causal) num_kb = min(num_kb, (q0 + BQ + BK - 1) / BK);  // causal frontier

  load_tile_async<BQ, DH, NT>(sQ, qb, sqt, q0, Tq);
  load_tile_async<BK, DH, NT>(sK, kb, skt, 0, kv_len);
  load_tile_async<BK, DV, NT>(sV, vb, svt, 0, kv_len);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the warp's 16 q rows as A fragments, loaded once where registers allow
  const bf16* wQ = sQ + (16 * warp + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[C::QREGS ? KD : 1][4];
  if constexpr (C::QREGS) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) ldmatrix_x4(qf[kd], wQ + kd * 16);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (in log2 units: scores times scale * log2(e)) and sum of
  // rows row0 and row0 + 8
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = scale * LOG2E;

  for (int j = 0; j < num_kb; ++j) {
    const int k0 = j * BK;
    if (j + 1 < num_kb) {  // the next tile streams in while this one computes
      load_tile_async<BK, DH, NT>(sK + ((j + 1) & 1) * BK * LD, kb, skt, k0 + BK, kv_len);
      load_tile_async<BK, DV, NT>(sV + ((j + 1) & 1) * BK * LDV, vb, svt, k0 + BK, kv_len);
      cp_async_commit();
    }
    const bf16* cK = sK + (j & 1) * BK * LD;
    const bf16* cV = sV + (j & 1) * BK * LDV;
    // a tile wholly above the diagonal for all 16 rows leaves them as they
    // are (P = 0, correction 1), so the warp skips it
    if (!(causal && k0 > wq0 + 15)) {
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qa[4];
        if constexpr (C::QREGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = qf[kd][i];
        } else {
          ldmatrix_x4(qa, wQ + kd * 16);
        }
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {  // keys 16 np .. 16 np + 15
          uint32_t kf[4];
          ldmatrix_x4(kf, cK + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD + kd * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qa, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        }
      }
      const bool edge = k0 + BK > kv_len || (causal && k0 + BK - 1 > wq0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * sl2;  // scale applied to the f32 score
          if (edge) {
            const int key = k0 + 8 * n + 2 * t4 + (e & 1);
            if (key >= kv_len || (causal && key > row0 + 8 * (e >> 1))) x = NEG_INF;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the row's four values sit in one quad
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        corr[i] = exp2f(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - mx[e >> 1]);
          rs[e >> 1] += s[n][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = l[i] * corr[i] + rs[i];  // l sums the f32 P
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // O += P V, P rounded to bf16
        uint32_t pa[4];
        scores_to_a(pa, s, kk);
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {  // columns 16 dp .. 16 dp + 15
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, cV + (16 * kk + (lane & 15)) * LDV + 16 * dp + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next tile has landed and this one is no longer read
  }

  l[0] = fmaxf(l[0], 1e-30f);
  l[1] = fmaxf(l[1], 1e-30f);
  // O goes out through the warp's own 16 rows of sQ, 16 bytes a lane
  bf16* rows = sQ + 16 * warp * LD;
  acc_to_rows<DV, LD>(rows, acc, 1.f / l[0], 1.f / l[1], lane);
  __syncwarp();
  const long long bh = (long long)b * H + h;
  store_rows<DV, LD, DH>(o + bh * Tq * DH + col0, rows, wq0, Tq, lane);
  if (t4 == 0 && col0 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < Tq) lse[bh * Tq + row0 + 8 * i] = (m[i] + log2f(l[i])) * LN2;
  }
}

// ---------------------------------------------------------------- launches
template <int DH>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int Tq, int kv_len, const int* st, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B * rt_tc::Cols<DH>::NH);
  flash_fwd_kernel<DH><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Tq, kv_len, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int Tq, int kv_len, const int* st, int causal,
                       float scale, cudaStream_t stream) {
  using C = MmaCfg<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + C::BQ - 1) / C::BQ, H, B * C::NH);
  flash_fwd_mma_kernel<DH><<<grid, C::NT, C::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, H, Tq, kv_len, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [B, H, T, Dh] with unit stride on Dh and the given element
// strides of batch, head and time (bf16: base addresses and strides in bytes
// multiples of 16, for cp.async); o: contiguous [B, H, Tq, Dh] in the input
// type; lse: contiguous [B, H, Tq] f32. Keys at or past kv_len (1 <= kv_len
// <= Tk) are masked. dtype 0 = float32 (FMA body),
// 1 = bfloat16 (tensor-core body). Returns the cudaError_t of the launch (0
// on success).
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int B, int H, int Tq, int Tk, int kv_len, int Dh,
                            int sqb, int sqh, int sqt, int skb, int skh, int skt,
                            int svb, int svh, int svt, int causal, float scale,
                            int dtype, void* stream) {
  if (kv_len < 1 || kv_len > Tk) return (int)cudaErrorInvalidValue;
  const int st[9] = {sqb, sqh, sqt, skb, skh, skt, svb, svh, svt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define RT_FWD(KIND, DH) launch_##KIND<DH>(q, k, v, o, l, B, H, Tq, kv_len, st, causal, scale, s)
  if (dtype == 0) {
    if (Dh == 32) return (int)RT_FWD(fma, 32);
    if (Dh == 64) return (int)RT_FWD(fma, 64);
    if (Dh == 128) return (int)RT_FWD(fma, 128);
    if (Dh == 256) return (int)RT_FWD(fma, 256);
  } else if (dtype == 1) {
    if (Dh == 32) return (int)RT_FWD(mma, 32);
    if (Dh == 64) return (int)RT_FWD(mma, 64);
    if (Dh == 128) return (int)RT_FWD(mma, 128);
    if (Dh == 256) return (int)RT_FWD(mma, 256);
  }
#undef RT_FWD
  return (int)cudaErrorInvalidValue;
}
