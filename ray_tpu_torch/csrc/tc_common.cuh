// Tensor-core building blocks shared by the port's attention kernels
// (sm_80+ instructions, built here for sm_90a): 16-byte cp.async copies into
// shared memory, ldmatrix (plain and transposed), the bf16 m16n8k16 mma.sync
// with f32 accumulators, and the packing of two f32 values into a bf16x2
// register. Inline PTX only; no library kernels.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), which the kernels index by hand:
// - A (16 x 16, row major), 4 registers of bf16x2: a0 = (row g, cols 2t,
//   2t+1), a1 = (row g+8, cols 2t, 2t+1), a2 = (row g, cols 2t+8, 2t+9),
//   a3 = (row g+8, cols 2t+8, 2t+9).
// - B (16 x 8, k x n), 2 registers: b0 = (rows 2t, 2t+1; col g), b1 = (rows
//   2t+8, 2t+9; col g).
// - C (16 x 8, f32), 4 registers: c0, c1 = (row g, cols 2t, 2t+1); c2, c3 =
//   (row g+8, cols 2t, 2t+1).
// So the C fragments of two neighbouring n8 tiles, packed to bf16, are the
// A fragment of one k16 step: a product's scores feed the next product from
// registers, with no round trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace rt_tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory without passing through
// registers; the first `src_bytes` come from `src`, the rest are zero (0
// zero-fills the whole chunk and reads nothing). Both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// The same for 4 bytes (one f32), through L1.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and r[i] receives matrix i's fragment (lane holds
// row lane / 4, elements 2 (lane % 4) and 2 (lane % 4) + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)) : "memory");
}

// As ldmatrix_x4, each matrix transposed: lane holds column lane / 4,
// elements of rows 2 (lane % 4) and 2 (lane % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)) : "memory");
}

// d += a b on the tensor cores: a 16x16 and b 16x8 in bf16, d 16x8 in f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to nearest-even bf16 in one register, `lo` in the
// low half (the element with the lower index).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of the k16 step `kk` from the C fragments c[2kk], c[2kk+1]
// of a 16-row tile of f32 scores.
template <int N>
__device__ __forceinline__ void scores_to_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Shared-memory tiles are rows of DH bf16 padded by 16 bytes: the 8 rows an
// ldmatrix matrix reads (same column, consecutive rows) then start in 8
// different 16-byte bank groups for DH = 32, 64 and 128 (row strides of 5, 9
// and 17 chunks), so neither ldmatrix nor its .trans form has bank
// conflicts.
template <int DH>
struct Tile {
  static constexpr int LD = DH + 8;  // row stride, in bf16 elements
  static constexpr int CPR = DH / 8; // 16-byte chunks in a row
};

// Start the copy of rows [t0, t0 + ROWS) of a [Tn, DH] bf16 slice (row
// stride `st` elements) into a padded tile; rows at or past Tn are zero.
// All NT threads of the block take part; commit is left to the caller.
template <int ROWS, int DH, int NT>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long st, int t0, int Tn) {
  constexpr int CPR = Tile<DH>::CPR;
  static_assert((ROWS * CPR) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / CPR, c = idx % CPR, t = t0 + r;
    const bool ok = t < Tn;
    cp_async_16(dst + r * Tile<DH>::LD + c * 8, ok ? src + (long long)t * st + c * 8 : src,
                ok ? 16 : 0);
  }
}

// Store the 16 rows of a warp's padded bf16 tile `rows` to a contiguous
// [T, DH] slice from row t0, rows at or past Tn skipped, 16 bytes a lane.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const __nv_bfloat16* rows,
                                           int t0, int Tn, int lane) {
  constexpr int CPR = Tile<DH>::CPR;
#pragma unroll
  for (int i = 0; i < 16 * CPR / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / CPR, c = idx % CPR;
    if (t0 + r < Tn)
      *reinterpret_cast<uint4*>(dst + (long long)(t0 + r) * DH + c * 8) =
          *reinterpret_cast<const uint4*>(rows + r * Tile<DH>::LD + c * 8);
  }
}

// Write a warp's 16 x DH f32 accumulators (C fragments, one per n8 tile),
// times the per-row factors mul0 (row g) and mul1 (row g + 8), as bf16 into
// the warp's 16 rows of a padded tile.
template <int DH>
__device__ __forceinline__ void acc_to_rows(__nv_bfloat16* rows, const float (&acc)[DH / 8][4],
                                            float mul0, float mul1, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    __nv_bfloat16* p = rows + g * Tile<DH>::LD + n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<uint32_t*>(p + 8 * Tile<DH>::LD) =
        pack_bf16x2(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

}  // namespace rt_tc
