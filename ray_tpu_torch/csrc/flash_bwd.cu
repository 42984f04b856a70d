// Flash-attention backward for Hopper (sm_90a), CUDA C++ with plain C entries.
//
// Replaces the two Pallas TPU kernels launched by `_bwd` in
// ray_tpu/ops/flash_attention.py:
// - K2 `_bwd_dq_kernel` -> `flash_bwd_dq_kernel`: per (batch, head, q tile),
//   walk the key tiles up to the causal frontier, recompute
//   P = exp(q k^T * scale - lse) and accumulate dQ += dS K with
//   dS = P * (dO V^T - Delta) * scale.
// - K3 `_bwd_dkv_kernel` -> `flash_bwd_dkv_kernel`: per (batch, head, key
//   tile), walk the q tiles from the causal start, recompute P and dS and
//   accumulate dV += P^T dO and dK += dS^T Q.
// Delta = rowsum(dO * O), which JAX computes with jnp outside its kernels,
// is a prologue of K2 here: each K2 block sums its own rows (f32) and writes
// them to a [B, H, Tq] buffer that K3 then reads. All arithmetic is f32;
// dQ, dK, dV are written once in the input type, as the Pallas kernels do.
//
// Design for this card, not the TPU's:
// - The TPU kernels keep a whole (b, h) row of K/V (K2) or of Q/dO (K3)
//   resident in VMEM. A Hopper block has at most 227 KB of shared memory,
//   so the other side is streamed through shared memory in 64-row tiles.
// - Two kernels, as on the TPU: P and dS are recomputed in each, but no
//   block ever adds into another block's output, so there are no atomics
//   and the gradients are deterministic, bit for bit, from run to run.
// - 256 threads a block, four threads to one row of the block's own tile
//   (a query row in K2, a key row in K3). Each thread computes 16 of a
//   tile's 64 scores and keeps Dh/4 columns of its row's accumulators
//   (dQ; or dK and dV) in registers, in f32.
// - Tiles sit in shared memory as f32 (bf16 widened on load), rows padded
//   by one float so that the rows a warp reads fall in different banks.
//   Shared memory is 83 KB (K2) and 100 KB (K3) at Dh=64, 149 KB and 166 KB
//   at Dh=128, so the launch raises the block's dynamic shared memory limit.
// - Inputs are read through their batch, head and time strides (unit
//   stride on Dh): the dO that autograd hands over is a transposed view.
// - Products are plain f32 FMAs, not tensor cores.
//
// What bounds it: at the GPT-2-125M shape (B=4, H=12, T=1024, Dh=64, bf16,
// causal; 25.2 M kept (q, k) pairs) K2's products (S, dP, dQ: 6 Dh flops a
// pair) are 9.7 GFLOP, 9.8 us at the bf16 tensor-core rate; it reads q, k,
// v, O, dO (bf16) and lse and writes dQ and Delta, 38.1 MB, 11.4 us at
// 3.35 TB/s, so bytes bound it by a little (the Delta prologue adds the
// read of O). K3 (S, dP, dV, dK: 8 Dh flops a pair) is 12.9 GFLOP, 13.0 us,
// against q, k, v, dO, lse, Delta in and dK, dV out, 38.1 MB, 11.4 us:
// operations bound it. This first version does the products as f32 FMAs
// with two shared-memory loads per FMA and is far above both floors; mma/
// wgmma on the tensor cores, TMA loads and one fused dK/dV/dQ pass are the
// later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Copy rows [t0, t0 + 64) of a [T, DH] slice (time stride st) into a padded
// f32 tile, times `mul`; rows at or past T read as 0.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long st,
                                          int t0, int Tn, float mul) {
  constexpr int LD = DH + 1;
  for (int idx = threadIdx.x; idx < 64 * DH; idx += NT) {
    const int rr = idx / DH, d = idx % DH, t = t0 + rr;
    dst[rr * LD + d] = t < Tn ? to_f32(src[(long long)t * st + d]) * mul : 0.f;
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

// K2. Strides: q, k, v, o, dout. dq: contiguous [B, H, Tq, DH]; lse, delta:
// contiguous [B, H, Tq] f32 (delta is written here).
template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, T* __restrict__ dq, float* __restrict__ delta,
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

  load_tile<T, DH>(sQ, q + bq_, st.s[2], q0, Tq, scale);
  load_tile<T, DH>(sDO, dout + bd_, st.s[14], q0, Tq, 1.f);
  __syncthreads();

  // Delta prologue: the row's four threads each sum Dh/4 products
  const int qpos = q0 + r;
  const bool row_ok = qpos < Tq;
  const long long row = ((long long)b * H + h) * Tq + qpos;
  float dl = 0.f;
  if (row_ok) {
    const T* orow = o + bo_ + (long long)qpos * st.s[11];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int d = sub + TPR * i;
      dl = fmaf(sDO[r * LD + d], to_f32(orow[d]), dl);
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
    load_tile<T, DH>(sK, k + bk_, st.s[5], k0, Tk, 1.f);
    load_tile<T, DH>(sV, v + bv_, st.s[8], k0, Tk, 1.f);
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
    T* out = dq + row * DH;
#pragma unroll
    for (int i = 0; i < CPT; ++i) out[sub + TPR * i] = from_f32<T>(acc[i]);
  }
}

// K3. Strides: q, k, v, dout. dk, dv: contiguous [B, H, Tk, DH]; lse, delta:
// contiguous [B, H, Tq] f32.
template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
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

  load_tile<T, DH>(sK, k + bk_, st.s[5], k0, Tk, 1.f);
  load_tile<T, DH>(sV, v + bv_, st.s[8], k0, Tk, 1.f);

  const int kpos = k0 + r;
  float dk_acc[CPT], dv_acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int num_qb = (Tq + BQ - 1) / BQ;
  const int start_qb = causal ? k0 / BQ : 0;  // the first tile with q >= k0

  for (int iq = start_qb; iq < num_qb; ++iq) {
    const int q0 = iq * BQ;
    __syncthreads();  // the previous tile's Q, dO, P, dS, lse, Delta are no longer read
    load_tile<T, DH>(sQ, q + bq_, st.s[2], q0, Tq, scale);
    load_tile<T, DH>(sDO, dout + bd_, st.s[11], q0, Tq, 1.f);
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
      dk[row + sub + TPR * i] = from_f32<T>(dk_acc[i]);
      dv[row + sub + TPR * i] = from_f32<T>(dv_acc[i]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, void* dq, float* delta,
                      int B, int H, int Tq, int Tk, const Strides& st, int causal,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq),
      delta, H, Tq, Tk, st, causal, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       int B, int H, int Tq, int Tk, const Strides& st, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + BK - 1) / BK, H, B);
  flash_bwd_dkv_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, Tq, Tk, st, causal, scale);
  return cudaGetLastError();
}

Strides copy_strides(const int* s, int n) {
  Strides st{};
  for (int i = 0; i < n; ++i) st.s[i] = s[i];
  return st;
}

}  // namespace

// q, k, v, o, dout: [B, H, T, Dh] with unit stride on Dh; `strides` holds
// their batch, head and time element strides (15 ints, in that order).
// lse: contiguous [B, H, Tq] f32. Writes dq (contiguous [B, H, Tq, Dh], the
// input type) and delta (contiguous [B, H, Tq] f32). dtype 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launch (0 on success).
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* dq, void* delta,
                               int B, int H, int Tq, int Tk, int Dh, const int* strides,
                               int causal, float scale, int dtype, void* stream) {
  const Strides st = copy_strides(strides, 15);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define RT_DQ(T, DH) launch_dq<T, DH>(q, k, v, o, dout, l, dq, dl, B, H, Tq, Tk, st, causal, scale, s)
  if (dtype == 0) {
    if (Dh == 32) return (int)RT_DQ(float, 32);
    if (Dh == 64) return (int)RT_DQ(float, 64);
    if (Dh == 128) return (int)RT_DQ(float, 128);
  } else if (dtype == 1) {
    if (Dh == 32) return (int)RT_DQ(__nv_bfloat16, 32);
    if (Dh == 64) return (int)RT_DQ(__nv_bfloat16, 64);
    if (Dh == 128) return (int)RT_DQ(__nv_bfloat16, 128);
  }
#undef RT_DQ
  return (int)cudaErrorInvalidValue;
}

// q, k, v, dout: [B, H, T, Dh] with unit stride on Dh; `strides` holds their
// batch, head and time element strides (12 ints). lse, delta: contiguous
// [B, H, Tq] f32. Writes dk, dv (contiguous [B, H, Tk, Dh], the input type).
extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dk, void* dv, int B, int H, int Tq, int Tk, int Dh,
                                const int* strides, int causal, float scale, int dtype,
                                void* stream) {
  const Strides st = copy_strides(strides, 12);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define RT_DKV(T, DH) launch_dkv<T, DH>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, st, causal, scale, s)
  if (dtype == 0) {
    if (Dh == 32) return (int)RT_DKV(float, 32);
    if (Dh == 64) return (int)RT_DKV(float, 64);
    if (Dh == 128) return (int)RT_DKV(float, 128);
  } else if (dtype == 1) {
    if (Dh == 32) return (int)RT_DKV(__nv_bfloat16, 32);
    if (Dh == 64) return (int)RT_DKV(__nv_bfloat16, 64);
    if (Dh == 128) return (int)RT_DKV(__nv_bfloat16, 128);
  }
#undef RT_DKV
  return (int)cudaErrorInvalidValue;
}
