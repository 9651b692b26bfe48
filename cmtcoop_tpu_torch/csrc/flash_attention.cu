// Eval multi-head attention on head-packed projections: kernel 3 of the
// port.
//
// Replaces `_flash_kernel_packed` (cmtcoop_tpu/ops/attention.py), called by
// `flash_attention_packed`: q (B, Nq, H*Dh), k/v (B, Nk, H*Dh), an additive
// per-key bias (B, Nk) float32 (0, or NEG_INF = -1e9 on padded keys), online
// softmax with the running max started at NEG_INF and the normaliser clamped
// at 1e-30. Output (B, Nq, H*Dh). The ragged query and key edges are masked
// in the kernels, so the caller pads nothing, and K and V are read straight
// out of the packed layout (no (B, H, N, Dh) transpose is ever written).
//
// bfloat16 at Dh 32 (the presets' 256 / 8 heads) runs on the tensor cores in
// kernel 7's forward (csrc/flash_train.cu `fwd_tc`), which reads these
// packed tensors as (B, H, N, Dh) views: ops/attention.py
// `flash_attention_packed` launches it through `cmt_flash_train_fwd` with
// dropout off and no (m, l). At the decoder's cross-attention (900 queries x
// 32400-44400 tokens x 8 heads) one exponential a score, not the products,
// bounds it.
//
// float32, and bf16 at Dh 4, 8, 16 (the tiny presets) -> `flash_packed_kernel`,
// the first version on the CUDA cores: one block per (32-query tile, head,
// batch) streams 64-key tiles, keeps the score tile and the running (m, l)
// in shared memory and the score and output accumulators in registers
// (4 x 4 and 4 x Dh/16 per thread, so a shared-memory load feeds several
// multiply-adds).
#include <type_traits>

#include "common.cuh"

#define CMT_NEG_INF (-1e9f)

template <typename T, int DH, int BQ>
__global__ void __launch_bounds__(4 * BQ) flash_packed_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, int nq, int nk,
    int heads, float sm_scale) {
  // 4 threads per query row; thread (ty, tx) of a 16-wide grid owns score
  // rows ty + TY*i and columns tx + 16*j (4 x 4 in registers), and output
  // rows ty + TY*i and head lanes tx + 16*j (4 x RO in registers), so each
  // shared-memory load feeds several multiply-adds.
  constexpr int BK = 64, NT = 4 * BQ, TY = BQ / 4;
  constexpr int RO = DH >= 16 ? DH / 16 : 1;
  __shared__ float Qs[BQ][DH + 1];
  __shared__ float Ks[BK][DH + 1];
  __shared__ float Vs[BK][DH + 1];
  __shared__ float S[BQ][BK + 1];
  __shared__ float kb[BK];
  __shared__ float m_s[BQ], l_s[BQ], a_s[BQ];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = heads * DH;
  const size_t qbase = (size_t)b * nq * C + (size_t)h * DH;
  const size_t kbase = (size_t)b * nk * C + (size_t)h * DH;

  for (int e = tid; e < BQ * DH; e += NT) {
    const int i = e / DH, d = e % DH;
    Qs[i][d] = (q0 + i < nq) ? cmt_ld(q + qbase + (size_t)(q0 + i) * C + d)
                             : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = CMT_NEG_INF;
    l_s[tid] = 0.f;
  }
  float o[4][RO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) o[i][j] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += BK) {
    for (int e = tid; e < BK * DH; e += NT) {
      const int j = e / DH, d = e % DH;
      const bool ok = k0 + j < nk;
      const size_t off = kbase + (size_t)(k0 + j) * C + d;
      Ks[j][d] = ok ? cmt_ld(k + off) : 0.f;
      Vs[j][d] = ok ? cmt_ld(v + off) : 0.f;
    }
    if (tid < BK)
      kb[tid] = (k0 + tid < nk) ? bias[(size_t)b * nk + k0 + tid] : 0.f;
    __syncthreads();

    // scores: s = q.k * scale + bias; keys past the ragged edge drop out
    {
      float s[4][4] = {};
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[ty + TY * i][d];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = Ks[tx + 16 * j][d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool ok = k0 + col < nk;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          S[ty + TY * i][col] = ok ? s[i][j] * sm_scale + kb[col] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: 4 consecutive lanes share a row
    {
      const int i = tid >> 2, part = tid & 3;
      float mx = -INFINITY;
      for (int j = part; j < BK; j += 4) mx = fmaxf(mx, S[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = part; j < BK; j += 4) {
        const float p = expf(S[i][j] - m_new);
        S[i][j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[i] = alpha;
        l_s[i] = alpha * l_s[i] + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // o = o * alpha + p @ v
    {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float alpha = a_s[ty + TY * i];
#pragma unroll
        for (int j = 0; j < RO; ++j) o[i][j] *= alpha;
      }
      if (tx < DH) {
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          float a[4], c[RO];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = S[ty + TY * i][kk];
#pragma unroll
          for (int j = 0; j < RO; ++j) c[j] = Vs[kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < RO; ++j) o[i][j] = fmaf(a[i], c[j], o[i][j]);
        }
      }
    }
    __syncthreads();
  }

  if (tx < DH) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + TY * i;
      if (q0 + row >= nq) continue;
      const float inv = 1.f / fmaxf(l_s[row], 1e-30f);
#pragma unroll
      for (int j = 0; j < RO; ++j)
        cmt_st(out + qbase + (size_t)(q0 + row) * C + tx + 16 * j,
               o[i][j] * inv);
    }
  }
}

template <typename T, int DH>
static void launch_one(const void* q, const void* k, const void* v,
                       const void* bias, void* out, int b, int nq, int nk,
                       int heads, float sm_scale, cudaStream_t st) {
  constexpr int BQ = 32;
  const dim3 grid((nq + BQ - 1) / BQ, heads, b);
  flash_packed_kernel<T, DH, BQ><<<grid, 4 * BQ, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out, nq,
      nk, heads, sm_scale);
}

template <typename T>
static int launch_dh(const void* q, const void* k, const void* v,
                     const void* bias, void* out, int b, int nq, int nk,
                     int heads, int dh, float sm_scale, cudaStream_t st) {
  switch (dh) {
    case 4:
      launch_one<T, 4>(q, k, v, bias, out, b, nq, nk, heads, sm_scale, st);
      break;
    case 8:
      launch_one<T, 8>(q, k, v, bias, out, b, nq, nk, heads, sm_scale, st);
      break;
    case 16:
      launch_one<T, 16>(q, k, v, bias, out, b, nq, nk, heads, sm_scale, st);
      break;
    case 32:
      // bf16 at Dh 32 is the tensor-core route's (flash_train.cu fwd_tc)
      if constexpr (std::is_same<T, float>::value) {
        launch_one<T, 32>(q, k, v, bias, out, b, nq, nk, heads, sm_scale, st);
        break;
      }
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int cmt_flash_attention_packed(int dtype, const void* q,
                                          const void* k, const void* v,
                                          const void* bias, void* out, int b,
                                          int nq, int nk, int heads, int dh,
                                          float sm_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b <= 0 || nq <= 0) return (int)cudaGetLastError();
  if (dtype == CMT_DTYPE_F32)
    return launch_dh<float>(q, k, v, bias, out, b, nq, nk, heads, dh,
                            sm_scale, st);
  if (dtype == CMT_DTYPE_BF16)
    return launch_dh<__nv_bfloat16>(q, k, v, bias, out, b, nq, nk, heads, dh,
                                    sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
