// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` launched by `_fwd` in
// ray_tpu/ops/flash_attention.py (the forward K1). Same function: per
// (batch, head) an online softmax over key tiles with an f32 running max m,
// normalizer l (clamped at 1e-30) and f32 accumulator; O is written in the
// input type, lse = m + log(l) in f32. Causal mode stops at each q tile's
// causal frontier and masks by position (diagonal at 0, Tq == Tk).
//
// Design for this card, not the TPU's:
// - The TPU kernel keeps a whole row of K and V resident in VMEM. A Hopper
//   block has at most 227 KB of shared memory, so K/V are streamed through
//   shared memory one 64-key tile at a time instead.
// - One thread block of 256 threads per (b, h, 64-row q tile); blocks run in
//   any order on the 132 SMs, nothing is carried between them. Four threads
//   own one query row: each holds 16 of the tile's 64 scores and Dh/4 of the
//   row's accumulator columns in registers; row max and sum are reduced with
//   two warp shuffles.
// - Tiles are stored in shared memory as f32 (bf16 inputs are widened on
//   load), rows padded by one float so that the 8 rows a warp touches fall
//   in different banks.
// - Products are plain f32 FMAs, not tensor cores.
//
// What bounds it: at the GPT-2-125M shape (B=4, H=12, T=1024, Dh=64, bf16,
// causal) the work's two floors are close: reading q, k, v and writing O and
// lse once is 25.4 MB, 7.6 us at 3.35 TB/s, and the 6.45 GFLOP of the two
// products are 6.5 us at the bf16 tensor-core rate, so bytes bound it by a
// little. This first version does the products as f32 FMAs with two
// shared-memory loads per FMA, which keeps it far above both floors; mma/
// wgmma on the tensor cores, TMA loads and warp specialisation are the
// later steps that close the gap. Ragged sequence ends are masked (rows past
// Tq are not stored, keys past Tk score -1e30), so any Tq, Tk work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per streamed tile
constexpr int NT = 256;           // threads per block
constexpr int TPR = NT / BQ;      // threads per query row (4)
constexpr int SPT = BK / TPR;     // scores per thread per tile (16)
constexpr float NEG_INF = -1e30f; // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int DH>
constexpr size_t smem_bytes() {
  // sQ [BQ][DH+1], sK [BK][DH+1], sV [BK][DH], sP [BQ][BK+1], all f32
  return sizeof(float) * (BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int Tq, int Tk,
    int sqb, int sqh, int sqt, int skb, int skh, int skt,
    int svb, int svh, int svt, int causal, float scale) {
  constexpr int LD = DH + 1;
  constexpr int LDP = BK + 1;
  constexpr int CPT = DH / TPR;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * DH;

  const int tid = threadIdx.x;
  const int r = tid / TPR;        // the query row this thread works on
  const int sub = tid % TPR;      // its lane within the row's 4 threads
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + (long long)b * sqb + (long long)h * sqh;
  const T* kb = k + (long long)b * skb + (long long)h * skh;
  const T* vb = v + (long long)b * svb + (long long)h * svh;

  // q is scaled once on load, as the reference scales q before the dot
  for (int idx = tid; idx < BQ * DH; idx += NT) {
    const int rr = idx / DH, d = idx % DH, t = q0 + rr;
    sQ[rr * LD + d] = t < Tq ? to_f32(qb[(long long)t * sqt + d]) * scale : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;

  const int qpos = q0 + r;
  int num_kb = (Tk + BK - 1) / BK;
  if (causal) num_kb = min(num_kb, (q0 + BQ + BK - 1) / BK);  // causal frontier

  for (int jk = 0; jk < num_kb; ++jk) {
    const int k0 = jk * BK;
    __syncthreads();  // the previous tile's K, V, P are no longer read
    for (int idx = tid; idx < BK * DH; idx += NT) {
      const int rr = idx / DH, d = idx % DH, t = k0 + rr;
      const bool ok = t < Tk;
      sK[rr * LD + d] = ok ? to_f32(kb[(long long)t * skt + d]) : 0.f;
      sV[rr * DH + d] = ok ? to_f32(vb[(long long)t * svt + d]) : 0.f;
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
      if (kpos >= Tk || (causal && kpos > qpos)) dot = NEG_INF;
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
      for (int i = 0; i < CPT; ++i) acc[i] = fmaf(p, sV[c * DH + sub + TPR * i], acc[i]);
    }
  }

  if (qpos < Tq) {
    l = fmaxf(l, 1e-30f);
    const long long row = ((long long)b * H + h) * Tq + qpos;
    T* ob = o + row * DH;
#pragma unroll
    for (int i = 0; i < CPT; ++i) ob[sub + TPR * i] = from_f32<T>(acc[i] / l);
    if (sub == 0) lse[row] = m + logf(l);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int H, int Tq, int Tk, const int* st, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int Tq, int Tk, const int* st,
                        int causal, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Tq, Tk, st, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Tq, Tk, st, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Tq, Tk, st, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [B, H, T, Dh] with unit stride on Dh and the given element
// strides of batch, head and time; o: contiguous [B, H, Tq, Dh] in the input
// type; lse: contiguous [B, H, Tq] f32. dtype 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int B, int H, int Tq, int Tk, int Dh,
                            int sqb, int sqh, int sqt, int skb, int skh, int skt,
                            int svb, int svh, int svt, int causal, float scale,
                            int dtype, void* stream) {
  const int st[9] = {sqb, sqh, sqt, skb, skh, skt, svb, svh, svt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)dispatch_dh<float>(Dh, q, k, v, o, l, B, H, Tq, Tk, st, causal, scale, s);
  if (dtype == 1)
    return (int)dispatch_dh<__nv_bfloat16>(Dh, q, k, v, o, l, B, H, Tq, Tk, st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
