// Shared helpers for the port's hand-written Hopper kernels.
//
// The kernels take float32 or bfloat16 operands (selected by a dtype code
// at the C boundary, 0 = float32 and 1 = bfloat16, or by one entry point
// per dtype, as the 3x3 conv's) and accumulate in float32, the counterpart
// of the JAX package's `preferred_element_type=float32`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define CMT_DTYPE_F32 0
#define CMT_DTYPE_BF16 1

__device__ __forceinline__ float cmt_ld(const float* p) { return *p; }
__device__ __forceinline__ float cmt_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void cmt_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void cmt_st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One block computes a TM x TN tile of C = A (M x K) @ B (K x N) with
// float32 accumulators: RM x RN per thread, (TM/RM)*(TN/RN) threads. Thread
// (ty, tx) owns rows ty + i*(TM/RM) and columns tx + j*(TN/RN), so the
// shared-memory reads of a warp are broadcasts (A) or consecutive (B).
// `load_a(r, k)` and `load_b(k, n)` return the (gathered, zero-padded)
// operands as float; they see tile-local r/n and global k.
template <int TM, int TN, int RM, int RN, int TK, class LoadA, class LoadB>
__device__ __forceinline__ void cmt_gemm_tile(float (&acc)[RM][RN], int K,
                                              LoadA load_a, LoadB load_b) {
  constexpr int NT = (TM / RM) * (TN / RN);
  __shared__ float As[TK][TM + 1];
  __shared__ float Bs[TK][TN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % (TN / RN);
  const int ty = tid / (TN / RN);
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TM * TK; e += NT) {
      const int r = e / TK, kk = e % TK;
      As[kk][r] = (k0 + kk < K) ? load_a(r, k0 + kk) : 0.f;
    }
    for (int e = tid; e < TK * TN; e += NT) {
      const int kk = e / TN, n = e % TN;
      Bs[kk][n] = (k0 + kk < K) ? load_b(k0 + kk, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[kk][ty + i * (TM / RM)];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = Bs[kk][tx + j * (TN / RN)];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}
