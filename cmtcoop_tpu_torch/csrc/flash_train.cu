// Training attention on (B, H, N, Dh) views: kernel 7 (the forward, with
// the (m, l) statistics and in-kernel dropout) and kernel 8 (its
// FlashAttention-2 backward, two launches: dQ, then dK / dV / d(k_bias)).
//
// Replace `_flash_kernel` (cmtcoop_tpu/ops/attention.py:73, with
// `_dropout_keep` / `_seed_tile`), `_flash_bwd_dq_kernel` (:309) and
// `_flash_bwd_dkv_kernel` (:354), reached through `flash_attention_kvmask`
// and `_flash_backward`. Semantics kept from them:
// - logits s = q.k * scale + k_bias[key]; the running max starts at
//   NEG_INF = -1e9, the normaliser l is clamped at 1e-30;
// - inverted dropout multiplies the normalised P in the accumulator only:
//   l stays the full softmax sum, so out = dropout(P) @ V;
// - the backward recomputes P = exp(s - m) / l from the saved statistics,
//   replays the keep mask on dP before ds = P * (dP - delta), and sums dS
//   over the queries into a per-(bh, key) d(k_bias) (the wrapper sums the
//   heads; a null `dkb` skips it); delta = rowsum(dO * O) comes from the
//   wrapper.
//
// Dropout: the TPU kernel seeds its core PRNG per tile, which ties the bits
// to one tiling. Here the keep bit of element (bh, i, j) is a pure function
// of (seed, bh, i, j): a row hash fmix32(fmix32(seed + bh * 0x9E3779B9) ^
// i * 0x85EBCA77), then fmix32(row ^ j * 0xC2B2AE3D) >= rate * 2^32 (the
// murmur3 finaliser; the threshold is `_dropout_keep`'s). The forward, both
// backward launches, a checkpoint's recompute and the plain PyTorch version
// (ops/attention.py `dropout_keep`, int64 arithmetic) all give the same mask
// whatever their tiling.
//
// Layout: q, k, v and dO are read through (batch, head, row) strides with
// unit stride along Dh, so the decoder passes views of its (B, N, H*Dh)
// projections and the 44400-token K/V are never copied; O, dQ, dK and dV
// are written in the packed (B, N, H, Dh) layout. The ragged query and key
// edges are masked in-kernel, so nothing is padded.
//
// What bounds it on the card: the exponentials and the products. At the
// decoder's cross-attention (1540 queries x 44400 keys x 8 heads x Dh 32)
// each pass takes one exponential a score, 547 M (0.140 ms at the
// special-function units' ~3.9 T/s), against 70 GFLOP for the forward, 105
// for the dQ pass and 140 for the dK/dV pass (0.071, 0.106 and 0.142 ms at
// the H100's 989 bf16 TFLOP/s); the dropout hash adds about ten integer
// operations a score. chip_smoke.py prints both floors beside the measured
// times. The forward and the float32 (and Dh 8) backward run every product
// on the CUDA cores in float32 with register tiles (4 x 4 scores and 4 x
// Dh/16 outputs per thread) fed from shared memory: tiles of 64 queries x
// 64 keys, 256 threads; the forward and the dQ pass walk the keys for one
// (bh, 64-query) tile, the dK/dV pass walks the queries for one (bh,
// 64-key) tile, so no reduction crosses blocks. The bf16 Dh-32 backward
// runs on the tensor cores (`bwd_tc` below).
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

#define CMT_NEG_INF (-1e9f)

// Every field is 8 bytes wide, so the ctypes mirror in ops/attention.py
// has the same layout.
struct FlashArgs {
  const void *q, *k, *v, *dout;
  const float *kbias, *m, *l, *delta;
  void *out, *dq, *dk, *dv;
  float *m_out, *l_out, *dkb;
  long long sq[3], sk[3], sv[3], sdo[3];  // (batch, head, row) strides
  long long B, H, nq, nk, dh, dtype, seed, thresh;
  double scale, keep_scale;
  // the bf16 Dh-32 dQ pass's key split: `dq_splits` ranges of
  // `dq_tiles_per_split` 64-key tiles; with more than one, float32
  // partials (dq_splits, B, Nq, H, Dh) in `dq_part`
  float* dq_part;
  long long dq_splits, dq_tiles_per_split;
};

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;

__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ unsigned row_hash(unsigned seed, unsigned bh,
                                             unsigned i) {
  return fmix32(fmix32(seed + bh * 0x9E3779B9u) ^ (i * 0x85EBCA77u));
}

// keep factor of element (row, j): keep_scale or 0
__device__ __forceinline__ float keep_factor(unsigned rh, unsigned j,
                                             unsigned thresh,
                                             float keep_scale) {
  return fmix32(rh ^ (j * 0xC2B2AE3Du)) >= thresh ? keep_scale : 0.f;
}

template <int DH>
struct Tile {
  static constexpr int LD = DH + 1;           // padded row of a Dh tile
  static constexpr int RO = DH >= 16 ? DH / 16 : 1;  // Dh lanes per thread
};

// load a (rows x DH) tile of a strided operand into shared memory as
// float, zero past `n`
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long srow, int r0, int n,
                                          int rows) {
  constexpr int LD = Tile<DH>::LD;
  for (int e = threadIdx.x; e < rows * DH; e += NT) {
    const int r = e / DH, d = e % DH;
    dst[r * LD + d] =
        (r0 + r < n) ? cmt_ld(base + (long long)(r0 + r) * srow + d) : 0.f;
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over a DH-wide tile
template <int DH>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* A,
                                         const float* Bm, int ty, int tx) {
  constexpr int LD = Tile<DH>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = Bm[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
  }
}

// write a (64 x DH) register tile (rows r0 + ty + 16 i, lanes tx + 16 j)
// in the packed (B, N, H, Dh) layout, times `mul`
template <typename T, int DH>
__device__ __forceinline__ void store_packed(T* base, const float (&acc)[4][Tile<DH>::RO],
                                             int r0, int n, int row_stride,
                                             float mul, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < Tile<DH>::RO; ++j) {
      const int d = tx + 16 * j;
      if (d < DH) cmt_st(base + (size_t)r * row_stride + d, acc[i][j] * mul);
    }
  }
}

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(NT) flash_train_fwd_kernel(FlashArgs a) {
  constexpr int LD = Tile<DH>::LD, RO = Tile<DH>::RO, LS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* S = Vs + BK * LD;
  float* kb = S + BQ * LS;
  float* m_s = kb + BK;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;
  unsigned* rh = (unsigned*)(a_s + BQ);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nq = (int)a.nq, nk = (int)a.nk, H = (int)a.H;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const float scale = (float)a.scale, keep_scale = (float)a.keep_scale;
  const unsigned thresh = (unsigned)a.thresh;
  const T* q = (const T*)a.q + b * a.sq[0] + h * a.sq[1];
  const T* k = (const T*)a.k + b * a.sk[0] + h * a.sk[1];
  const T* v = (const T*)a.v + b * a.sv[0] + h * a.sv[1];
  const float* kbias = a.kbias + (size_t)b * nk;

  load_tile<T, DH>(Qs, q, a.sq[2], q0, nq, BQ);
  if (tid < BQ) {
    m_s[tid] = CMT_NEG_INF;
    l_s[tid] = 0.f;
    if (DROP) rh[tid] = row_hash((unsigned)a.seed, bh, q0 + tid);
  }
  float o[4][RO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) o[i][j] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += BK) {
    load_tile<T, DH>(Ks, k, a.sk[2], k0, nk, BK);
    load_tile<T, DH>(Vs, v, a.sv[2], k0, nk, BK);
    if (tid < BK) kb[tid] = (k0 + tid < nk) ? kbias[k0 + tid] : 0.f;
    __syncthreads();

    {
      float s[4][4];
      dot_tile<DH>(s, Qs, Ks, ty, tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool ok = k0 + col < nk;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          S[(ty + 16 * i) * LS + col] = ok ? s[i][j] * scale + kb[col]
                                           : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, 4 consecutive lanes per row; the kept and scaled
    // probabilities go back into S, the full sum into l
    {
      const int i = tid >> 2, part = tid & 3;
      float mx = -INFINITY;
      for (int j = part; j < BK; j += 4) mx = fmaxf(mx, S[i * LS + j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = part; j < BK; j += 4) {
        const float p = expf(S[i * LS + j] - m_new);
        sum += p;
        S[i * LS + j] =
            DROP ? p * keep_factor(rh[i], k0 + j, thresh, keep_scale) : p;
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RO; ++j) o[i][j] *= alpha;
    }
    if (tx < DH) {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float p[4], c[RO];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = S[(ty + 16 * i) * LS + kk];
#pragma unroll
        for (int j = 0; j < RO; ++j) c[j] = Vs[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RO; ++j) o[i][j] = fmaf(p[i], c[j], o[i][j]);
      }
    }
    __syncthreads();
  }

  T* out = (T*)a.out + (size_t)b * nq * H * DH + (size_t)h * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const float inv = 1.f / fmaxf(l_s[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < RO; ++j) o[i][j] *= inv;
  }
  store_packed<T, DH>(out, o, q0, nq, H * DH, 1.f, ty, tx);
  if (a.m_out != nullptr && tid < BQ && q0 + tid < nq) {
    a.m_out[(size_t)bh * nq + q0 + tid] = m_s[tid];
    a.l_out[(size_t)bh * nq + q0 + tid] = l_s[tid];
  }
}

// per-row statistics of a query tile for the backward: m, max(l, 1e-30),
// delta and the dropout row hash; rows past nq get l = 1 (their P is
// zeroed by the callers)
__device__ __forceinline__ void load_row_stats(const FlashArgs& a, int bh,
                                               int q0, float* m_s,
                                               float* l_s, float* d_s,
                                               unsigned* rh, bool drop) {
  const int tid = threadIdx.x, nq = (int)a.nq;
  if (tid < BQ) {
    const bool ok = q0 + tid < nq;
    const size_t at = (size_t)bh * nq + q0 + tid;
    m_s[tid] = ok ? a.m[at] : 0.f;
    l_s[tid] = ok ? fmaxf(a.l[at], 1e-30f) : 1.f;
    d_s[tid] = ok ? a.delta[at] : 0.f;
    if (drop) rh[tid] = row_hash((unsigned)a.seed, bh, q0 + tid);
  }
}

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(NT) flash_train_bwd_dq_kernel(FlashArgs a) {
  constexpr int LD = Tile<DH>::LD, RO = Tile<DH>::RO, LS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* DS = Vs + BK * LD;
  float* kb = DS + BQ * LS;
  float* m_s = kb + BK;
  float* l_s = m_s + BQ;
  float* d_s = l_s + BQ;
  unsigned* rh = (unsigned*)(d_s + BQ);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nq = (int)a.nq, nk = (int)a.nk, H = (int)a.H;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const float scale = (float)a.scale, keep_scale = (float)a.keep_scale;
  const unsigned thresh = (unsigned)a.thresh;
  const T* q = (const T*)a.q + b * a.sq[0] + h * a.sq[1];
  const T* k = (const T*)a.k + b * a.sk[0] + h * a.sk[1];
  const T* v = (const T*)a.v + b * a.sv[0] + h * a.sv[1];
  const T* dout = (const T*)a.dout + b * a.sdo[0] + h * a.sdo[1];
  const float* kbias = a.kbias + (size_t)b * nk;

  load_tile<T, DH>(Qs, q, a.sq[2], q0, nq, BQ);
  load_tile<T, DH>(dOs, dout, a.sdo[2], q0, nq, BQ);
  load_row_stats(a, bh, q0, m_s, l_s, d_s, rh, DROP);
  float dq[4][RO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += BK) {
    load_tile<T, DH>(Ks, k, a.sk[2], k0, nk, BK);
    load_tile<T, DH>(Vs, v, a.sv[2], k0, nk, BK);
    if (tid < BK) kb[tid] = (k0 + tid < nk) ? kbias[k0 + tid] : 0.f;
    __syncthreads();

    {
      float s[4][4], dp[4][4];
      dot_tile<DH>(s, Qs, Ks, ty, tx);
      dot_tile<DH>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          float ds = 0.f;
          if (k0 + col < nk) {
            const float p =
                expf(s[i][j] * scale + kb[col] - m_s[row]) / l_s[row];
            float dpv = dp[i][j];
            if (DROP) dpv *= keep_factor(rh[row], k0 + col, thresh, keep_scale);
            ds = p * (dpv - d_s[row]);
          }
          DS[row * LS + col] = ds;
        }
      }
    }
    __syncthreads();

    if (tx < DH) {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float g[4], c[RO];
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] = DS[(ty + 16 * i) * LS + kk];
#pragma unroll
        for (int j = 0; j < RO; ++j) c[j] = Ks[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RO; ++j) dq[i][j] = fmaf(g[i], c[j], dq[i][j]);
      }
    }
    __syncthreads();
  }

  T* dqo = (T*)a.dq + (size_t)b * nq * H * DH + (size_t)h * DH;
  store_packed<T, DH>(dqo, dq, q0, nq, H * DH, scale, ty, tx);
}

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(NT) flash_train_bwd_dkv_kernel(FlashArgs a) {
  constexpr int LD = Tile<DH>::LD, RO = Tile<DH>::RO, LS = BK + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* X = dOs + BQ * LD;  // dropout(P), then dS, (query, key)
  float* kb = X + BQ * LS;
  float* dkb_s = kb + BK;
  float* m_s = dkb_s + BK;
  float* l_s = m_s + BQ;
  float* d_s = l_s + BQ;
  unsigned* rh = (unsigned*)(d_s + BQ);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nq = (int)a.nq, nk = (int)a.nk, H = (int)a.H;
  const int k0 = blockIdx.x * BK, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const float scale = (float)a.scale, keep_scale = (float)a.keep_scale;
  const unsigned thresh = (unsigned)a.thresh;
  const T* q = (const T*)a.q + b * a.sq[0] + h * a.sq[1];
  const T* k = (const T*)a.k + b * a.sk[0] + h * a.sk[1];
  const T* v = (const T*)a.v + b * a.sv[0] + h * a.sv[1];
  const T* dout = (const T*)a.dout + b * a.sdo[0] + h * a.sdo[1];

  load_tile<T, DH>(Ks, k, a.sk[2], k0, nk, BK);
  load_tile<T, DH>(Vs, v, a.sv[2], k0, nk, BK);
  if (tid < BK) {
    kb[tid] = (k0 + tid < nk) ? a.kbias[(size_t)b * nk + k0 + tid] : 0.f;
    dkb_s[tid] = 0.f;
  }
  // key rows ty + 16 i, head lanes tx + 16 j
  float dk[4][RO], dv[4][RO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < nq; q0 += BQ) {
    load_tile<T, DH>(Qs, q, a.sq[2], q0, nq, BQ);
    load_tile<T, DH>(dOs, dout, a.sdo[2], q0, nq, BQ);
    load_row_stats(a, bh, q0, m_s, l_s, d_s, rh, DROP);
    __syncthreads();

    // scores for query rows ty + 16 i, key columns tx + 16 j
    float ds[4][4];
    {
      float s[4][4], dp[4][4];
      dot_tile<DH>(s, Qs, Ks, ty, tx);
      dot_tile<DH>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i;
        const bool row_ok = q0 + row < nq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          float p = 0.f, kf = 1.f;
          if (row_ok && k0 + col < nk) {
            p = expf(s[i][j] * scale + kb[col] - m_s[row]) / l_s[row];
            if (DROP) kf = keep_factor(rh[row], k0 + col, thresh, keep_scale);
          }
          ds[i][j] = p * (dp[i][j] * kf - d_s[row]);
          X[row * LS + col] = p * kf;
        }
      }
    }
    __syncthreads();

    // dV += dropout(P)^T @ dO
    if (tx < DH) {
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float p[4], c[RO];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = X[r * LS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RO; ++j) c[j] = dOs[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RO; ++j) dv[i][j] = fmaf(p[i], c[j], dv[i][j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) X[(ty + 16 * i) * LS + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dK += dS^T @ Q; d(k_bias) += column sums of dS
    if (tx < DH) {
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float g[4], c[RO];
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] = X[r * LS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RO; ++j) c[j] = Qs[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RO; ++j) dk[i][j] = fmaf(g[i], c[j], dk[i][j]);
      }
    }
    if (a.dkb && tid < BK) {
      float acc = 0.f;
      for (int r = 0; r < BQ; ++r) acc += X[r * LS + tid];
      dkb_s[tid] += acc;
    }
    __syncthreads();
  }

  const size_t kv_base = (size_t)b * nk * H * DH + (size_t)h * DH;
  store_packed<T, DH>((T*)a.dk + kv_base, dk, k0, nk, H * DH, scale, ty, tx);
  store_packed<T, DH>((T*)a.dv + kv_base, dv, k0, nk, H * DH, 1.f, ty, tx);
  if (a.dkb && tid < BK && k0 + tid < nk)
    a.dkb[(size_t)bh * nk + k0 + tid] = dkb_s[tid];
}

// ------------------ kernel 8, bfloat16 at Dh 32: tensor cores ---------------
//
// The same arithmetic on the tensor cores, two launches as above (no float
// atomics: dQ and d(k_bias) stay deterministic). Every tile is 64 rows of
// one head (64 B each), loaded by TMA through a 4D map over the view's
// (Dh, N, H, B) with a 64-byte swizzle, zeros past the ragged edge; the same
// tile is a K-major operand of the score products (Dh contiguous) and an
// MN-major B of the Dh-wide products (wgmma m64n32k16 with tnspB). One
// producer warp streams the walked tiles into a ring of four stages, its
// lanes storing each tile's per-row scalars beside them; two consumer
// warpgroups own 64 rows each.
//   dQ pass, per (bh, 128 queries, key range): S = Q K^T and dP = dO V^T by
//   wgmma m64n64k16 from shared memory; P = 2^(S scale log2e + bias log2e -
//   m log2e) / l, the keep factor and dS = P (dP keep - delta) in registers;
//   dQ += dS K by the register-A form, dS repacked to bf16 from the score
//   accumulators. 1540 queries are 13 blocks a head, 104 at batch 1: the
//   key range is split (ops/attention.py `split_plan`) and
//   `dq_reduce_kernel` sums the float32 partials in split order.
//   dK/dV pass, per (bh, 128 keys), walking the queries transposed: S^T =
//   K Q^T and dP^T = V dO^T, both operands K-major as they sit in memory;
//   dV += dropout(P^T) dO and dK += dS^T Q by the register-A form;
//   d(k_bias) is each key row's float32 sum of dS^T, written once by the
//   block that owns the key. The per-query m, l, delta and dropout row
//   hash index columns here: the producer's lanes store them per tile.
// The keep bit is the one above: a row hash per query, computed once, and
// j * 0xC2B2AE3D per key, incremental along a row. P and dS enter their
// products as bf16 (float32 accumulators).
namespace bwd_tc {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WG = 2;                    // consumer warpgroups
constexpr int ROWS = 64 * WG;            // a block's queries (dQ) or keys
constexpr int TILE = 64 * 64;            // 64 rows x 64 B
constexpr int STAGES = 4;
constexpr int THREADS = 128 * WG + 32;   // + the producer warp
constexpr unsigned KEY_MUL = 0xC2B2AE3Du;

struct Maps {
  CUtensorMap q, k, v, dout;  // box (32, 64) each
};

// shared memory from a 1024-byte aligned base: the block's own two
// operands (WG tiles each), the ring of two walked tiles a stage, the
// stages' per-row scalars (`SCALARS` bytes a stage), the barriers
template <int SCALARS>
struct Layout {
  static constexpr int OFF_RING = 2 * WG * TILE;
  static constexpr int OFF_SC = OFF_RING + STAGES * 2 * TILE;
  static constexpr int OFF_BAR = OFF_SC + STAGES * SCALARS;
  static constexpr int SMEM = 1024 + OFF_BAR + (2 * STAGES + 1) * 8;
};
using DqLayout = Layout<64 * 4>;    // a key tile's scaled bias
using DkvLayout = Layout<64 * 16>;  // a query tile's (m2, 1/l, delta, hash)

__device__ __forceinline__ void init_barriers(uint32_t full, uint32_t empty,
                                              uint32_t own) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's expect_tx arrive and its 32 lanes' arrives
      cmt_mbar_init(full + 8 * s, 33);
      cmt_mbar_init(empty + 8 * s, 128 * WG);
    }
    cmt_mbar_init(own, 1);
    cmt_mbar_init_fence();
  }
  __syncthreads();
}

// the block's own rows of two tensors (WG tiles each), on barrier `own`
__device__ __forceinline__ void load_own(uint32_t base, const CUtensorMap* x,
                                         const CUtensorMap* y, uint32_t own,
                                         int r0, int h, int b) {
  cmt_mbar_expect_tx(own, 2 * WG * TILE);
  for (int w = 0; w < WG; ++w) {
    cmt_tma_load_4d(base + w * TILE, x, own, 0, r0 + 64 * w, h, b);
    cmt_tma_load_4d(base + (WG + w) * TILE, y, own, 0, r0 + 64 * w, h, b);
  }
}

// a warpgroup with no real row frees each stage unread
__device__ __forceinline__ void drain(uint32_t full, uint32_t empty, int n) {
  for (int i = 0; i < n; ++i) {
    cmt_mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
    cmt_mbar_arrive(empty + 8 * (i % STAGES));
  }
}

// two 64 x 64 score-shaped products over Dh (two 16-deep slices each):
// x = A1 B1^T, y = A2 B2^T, all four K-major tiles; waits for them and for
// every earlier wgmma of the warpgroup
__device__ __forceinline__ void two_scores(float (&x)[32], float (&y)[32],
                                           uint64_t a1, uint64_t b1,
                                           uint64_t a2, uint64_t b2) {
  cmt_fence_regs(x);
  cmt_fence_regs(y);
  cmt_wgmma_fence();
  Wgmma<64>::mma(x, a1, b1, 0);
  Wgmma<64>::mma(x, a1 + 2, b1 + 2);
  Wgmma<64>::mma(y, a2, b2, 0);
  Wgmma<64>::mma(y, a2 + 2, b2 + 2);
  cmt_wgmma_commit();
  cmt_wgmma_wait<0>();
  cmt_fence_regs(x);
  cmt_fence_regs(y);
}

// a 64 x 64 accumulator as four 16-column bf16 A fragments
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = cmt_pack_bf16(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) cmt_fence_regs(a[kk]);
}

// d += A B over 64 rows of K: A the fragments, B a tile read MN-major
__device__ __forceinline__ void rs_product(float (&d)[16],
                                           const uint32_t (&a)[4][4],
                                           uint32_t tile) {
  const uint64_t bd = cmt_sw64_mn_desc(tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) cmt_wgmma_rs32(d, a[kk], bd + 64 * kk);
}

__device__ __forceinline__ float keep_of(unsigned rh, unsigned jm,
                                         unsigned thresh, float keep_scale) {
  return fmix32(rh ^ jm) >= thresh ? keep_scale : 0.f;
}

// a 64-row warpgroup's accumulator (rows r0 and r0 + 8, columns 8j + 2
// quad + {0, 1}) times `mul`, to the packed (B, N, H, 32) bf16 layout
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           const float (&acc)[16],
                                           const int (&rows)[2], int n,
                                           int row_stride, float mul,
                                           int quad) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (rows[hh] >= n) continue;
    __nv_bfloat16* o = base + (size_t)rows[hh] * row_stride + 2 * quad;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * hh] * mul, acc[4 * j + 2 * hh + 1] * mul);
  }
}

template <bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ Maps maps, const FlashArgs a) {
  using L = DqLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = cmt_smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* bias_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::OFF_SC);
  const uint32_t full = base + L::OFF_BAR, empty = full + 8 * STAGES;
  const uint32_t own = empty + 8 * STAGES;

  const int nq = (int)a.nq, nk = (int)a.nk, H = (int)a.H;
  const int q0 = blockIdx.x * ROWS, split = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh - b * H;
  const int tps = (int)a.dq_tiles_per_split;
  const int t0 = split * tps;
  const int n_tiles = min((nk + 63) / 64, t0 + tps) - t0;
  init_barriers(full, empty, own);

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == WG) {  // producer: Q and dO once, then K, V and bias a tile
    if (lane == 0) load_own(base, &maps.q, &maps.dout, own, q0, h, b);
    const float* kbias = a.kbias + (size_t)b * nk;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES, k0 = (t0 + i) * 64;
      cmt_mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t t = base + L::OFF_RING + s * 2 * TILE;
        cmt_mbar_expect_tx(full + 8 * s, 2 * TILE);
        cmt_tma_load_4d(t, &maps.k, full + 8 * s, 0, k0, h, b);
        cmt_tma_load_4d(t + TILE, &maps.v, full + 8 * s, 0, k0, h, b);
      }
      for (int e = lane; e < 64; e += 32)
        bias_s[s * 64 + e] =
            k0 + e < nk ? kbias[k0 + e] * LOG2E : -INFINITY;
      cmt_mbar_arrive(full + 8 * s);
    }
    return;
  }
  if (q0 + wg * 64 >= nq) {
    drain(full, empty, n_tiles);
    return;
  }

  const int warp = (threadIdx.x % 128) / 32, quad = lane & 3;
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int rows[2] = {r0, r0 + 8};
  // per row: m log2 e, 1 / max(l, 1e-30), delta, the dropout row hash;
  // rows past Nq get P = 0 (2^-inf, times 0)
  float m2[2], il[2], dl[2];
  unsigned rh[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const bool ok = rows[hh] < nq;
    const size_t at = (size_t)bh * nq + rows[hh];
    m2[hh] = ok ? a.m[at] * LOG2E : INFINITY;
    il[hh] = ok ? 1.f / fmaxf(a.l[at], 1e-30f) : 0.f;
    dl[hh] = ok ? a.delta[at] : 0.f;
    rh[hh] = DROP ? row_hash((unsigned)a.seed, bh, rows[hh]) : 0u;
  }
  const float scale2 = (float)a.scale * LOG2E;
  const float keep_scale = (float)a.keep_scale;
  const unsigned thresh = (unsigned)a.thresh;
  const uint64_t qd = cmt_sw64_desc(base + wg * TILE);
  const uint64_t dod = cmt_sw64_desc(base + (WG + wg) * TILE);
  float dq[16], sc[32], dp[32];
  uint32_t ds[4][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ds[kk][0] = ds[kk][1] = ds[kk][2] = ds[kk][3] = 0u;
  cmt_mbar_wait(own, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, k0 = (t0 + i) * 64;
    const uint32_t t = base + L::OFF_RING + s * 2 * TILE;
    cmt_mbar_wait(full + 8 * s, (i / STAGES) & 1);
    two_scores(sc, dp, qd, cmt_sw64_desc(t), dod, cmt_sw64_desc(t + TILE));
    cmt_fence_regs(dq);  // the previous tile's dQ product is done too
    fence_a(ds);
    if (i > 0) cmt_mbar_arrive(empty + 8 * ((i - 1) % STAGES));

    const float* bs = bias_s + s * 64;
    const unsigned jm0 = (unsigned)(k0 + 2 * quad) * KEY_MUL;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * quad);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, c = e & 1;
        const float p = cmt_ex2(fmaf(sc[4 * j + e], scale2, c ? bb.y : bb.x) -
                                m2[hh]) * il[hh];
        float dpv = dp[4 * j + e];
        if (DROP)
          dpv *= keep_of(rh[hh], jm0 + (unsigned)(8 * j + c) * KEY_MUL,
                         thresh, keep_scale);
        sc[4 * j + e] = p * (dpv - dl[hh]);  // dS
      }
    }
    pack_a(ds, sc);
    cmt_wgmma_fence();
    rs_product(dq, ds, t);  // dQ += dS K, K read MN-major
    cmt_wgmma_commit();
  }
  cmt_wgmma_wait<0>();
  cmt_fence_regs(dq);
  fence_a(ds);

  const int c = H * 32;
  if (a.dq_splits == 1) {
    store_rows((__nv_bfloat16*)a.dq + (size_t)b * nq * c + h * 32, dq, rows,
               nq, c, (float)a.scale, quad);
    return;
  }
  float* part = a.dq_part + ((size_t)split * a.B + b) * nq * c + h * 32 +
                2 * quad;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (rows[hh] >= nq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(part + (size_t)rows[hh] * c + 8 * j) =
          make_float2(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
  }
}

// dq = scale * the sum of the splits' partials, in split order
__global__ void dq_reduce_kernel(const float* __restrict__ part,
                                 __nv_bfloat16* __restrict__ dq, size_t n,
                                 int splits, float scale) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[s * n + idx];
  dq[idx] = __float2bfloat16(acc * scale);
}

template <bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(const __grid_constant__ Maps maps, const FlashArgs a) {
  using L = DkvLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = cmt_smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float4* st_s = reinterpret_cast<float4*>(smem_raw + (base - raw) + L::OFF_SC);
  const uint32_t full = base + L::OFF_BAR, empty = full + 8 * STAGES;
  const uint32_t own = empty + 8 * STAGES;

  const int nq = (int)a.nq, nk = (int)a.nk, H = (int)a.H;
  const int k0 = blockIdx.x * ROWS, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int n_tiles = (nq + 63) / 64;
  init_barriers(full, empty, own);

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == WG) {  // producer: K and V once, then Q, dO and stats a tile
    if (lane == 0) load_own(base, &maps.k, &maps.v, own, k0, h, b);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES, q0 = i * 64;
      cmt_mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t t = base + L::OFF_RING + s * 2 * TILE;
        cmt_mbar_expect_tx(full + 8 * s, 2 * TILE);
        cmt_tma_load_4d(t, &maps.q, full + 8 * s, 0, q0, h, b);
        cmt_tma_load_4d(t + TILE, &maps.dout, full + 8 * s, 0, q0, h, b);
      }
      // columns past Nq get P = 0 (2^-inf, times 0)
      for (int e = lane; e < 64; e += 32) {
        const int qi = q0 + e;
        const bool ok = qi < nq;
        const size_t at = (size_t)bh * nq + qi;
        st_s[s * 64 + e] = make_float4(
            ok ? a.m[at] * LOG2E : INFINITY,
            ok ? 1.f / fmaxf(a.l[at], 1e-30f) : 0.f, ok ? a.delta[at] : 0.f,
            __uint_as_float(DROP ? row_hash((unsigned)a.seed, bh, qi) : 0u));
      }
      cmt_mbar_arrive(full + 8 * s);
    }
    return;
  }
  if (k0 + wg * 64 >= nk) {
    drain(full, empty, n_tiles);
    return;
  }

  const int warp = (threadIdx.x % 128) / 32, quad = lane & 3;
  const int r0 = k0 + wg * 64 + warp * 16 + lane / 4;
  const int rows[2] = {r0, r0 + 8};  // keys
  float bias2[2];
  unsigned km[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    bias2[hh] = rows[hh] < nk ? a.kbias[(size_t)b * nk + rows[hh]] * LOG2E
                              : -INFINITY;
    km[hh] = (unsigned)rows[hh] * KEY_MUL;
  }
  const float scale2 = (float)a.scale * LOG2E;
  const float keep_scale = (float)a.keep_scale;
  const unsigned thresh = (unsigned)a.thresh;
  const uint64_t kd = cmt_sw64_desc(base + wg * TILE);
  const uint64_t vd = cmt_sw64_desc(base + (WG + wg) * TILE);
  float dk[16], dv[16], sc[32], dp[32], dkb[2] = {0.f, 0.f};
  uint32_t pa[4][4], ds[4][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = ds[kk][r] = 0u;
  cmt_mbar_wait(own, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t t = base + L::OFF_RING + s * 2 * TILE;
    cmt_mbar_wait(full + 8 * s, (i / STAGES) & 1);
    // S^T = K Q^T, dP^T = V dO^T
    two_scores(sc, dp, kd, cmt_sw64_desc(t), vd, cmt_sw64_desc(t + TILE));

    const float4* qs = st_s + s * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 cs[2] = {qs[8 * j + 2 * quad], qs[8 * j + 2 * quad + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const float4 q = cs[e & 1];  // (m2, 1/l, delta, hash) of the column
        const float p = cmt_ex2(fmaf(sc[4 * j + e], scale2, bias2[hh]) - q.x) *
                        q.y;
        const float kf =
            DROP ? keep_of(__float_as_uint(q.w), km[hh], thresh, keep_scale)
                 : 1.f;
        const float g = p * (dp[4 * j + e] * kf - q.z);  // dS^T
        sc[4 * j + e] = p * kf;                          // dropout(P)^T
        dp[4 * j + e] = g;
        dkb[hh] += g;
      }
    }
    pack_a(pa, sc);
    pack_a(ds, dp);
    cmt_wgmma_fence();
    rs_product(dv, pa, t + TILE);  // dV += dropout(P)^T dO
    rs_product(dk, ds, t);         // dK += dS^T Q
    cmt_wgmma_commit();
    // waited here, not under the next tile's scores: with both in flight
    // the registers run out and ptxas serialises every wgmma (C7515)
    cmt_wgmma_wait<0>();
    cmt_fence_regs(dk);
    cmt_fence_regs(dv);
    fence_a(pa);
    fence_a(ds);
    cmt_mbar_arrive(empty + 8 * s);
  }

  const int c = H * 32;
  const size_t kv_base = (size_t)b * nk * c + h * 32;
  store_rows((__nv_bfloat16*)a.dk + kv_base, dk, rows, nk, c, (float)a.scale,
             quad);
  store_rows((__nv_bfloat16*)a.dv + kv_base, dv, rows, nk, c, 1.f, quad);
  if (a.dkb == nullptr) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float g = dkb[hh];
    g += __shfl_xor_sync(0xffffffffu, g, 1);
    g += __shfl_xor_sync(0xffffffffu, g, 2);
    if (quad == 0 && rows[hh] < nk) a.dkb[(size_t)bh * nk + rows[hh]] = g;
  }
}

// (batch, head, row) strides -> cmt_head_map's (row, head, batch)
static bool map_of(CUtensorMap* map, const void* ptr, const long long (&s)[3],
                   long long n, const FlashArgs& a) {
  const long long st[3] = {s[2], s[1], s[0]};
  return cmt_head_map(map, ptr, n, a.H, a.B, st, 64);
}

template <bool DROP>
int launch(bool dq_pass, const FlashArgs& a, cudaStream_t st) {
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (!map_of(&maps.q, a.q, a.sq, a.nq, a) ||
      !map_of(&maps.k, a.k, a.sk, a.nk, a) ||
      !map_of(&maps.v, a.v, a.sv, a.nk, a) ||
      !map_of(&maps.dout, a.dout, a.sdo, a.nq, a))
    return (int)cudaErrorInvalidValue;
  const unsigned bh = (unsigned)(a.B * a.H);
  if (dq_pass) {
    const long long ktiles = (a.nk + 63) / 64, tps = a.dq_tiles_per_split;
    if (tps <= 0 || a.dq_splits != (ktiles + tps - 1) / tps ||
        (a.dq_splits > 1 && a.dq_part == nullptr))
      return (int)cudaErrorInvalidValue;
    static bool smem_set[CMT_MAX_DEVICES] = {};
    cudaError_t err =
        cmt_allow_smem(dq_kernel<DROP>, DqLayout::SMEM, smem_set);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((a.nq + ROWS - 1) / ROWS),
                    (unsigned)a.dq_splits, bh);
    dq_kernel<DROP><<<grid, THREADS, DqLayout::SMEM, st>>>(maps, a);
    err = cudaGetLastError();
    if (err != cudaSuccess || a.dq_splits == 1) return (int)err;
    const size_t n = (size_t)a.B * a.nq * a.H * 32;
    dq_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        a.dq_part, (__nv_bfloat16*)a.dq, n, (int)a.dq_splits,
        (float)a.scale);
    return (int)cudaGetLastError();
  }
  static bool smem_set[CMT_MAX_DEVICES] = {};
  cudaError_t err =
      cmt_allow_smem(dkv_kernel<DROP>, DkvLayout::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.nk + ROWS - 1) / ROWS), bh);
  dkv_kernel<DROP><<<grid, THREADS, DkvLayout::SMEM, st>>>(maps, a);
  return (int)cudaGetLastError();
}

}  // namespace bwd_tc

// dynamic shared memory of each kernel, in floats
template <int DH>
constexpr int fwd_smem() {
  return (BQ + 2 * BK) * Tile<DH>::LD + BQ * (BK + 1) + BK + 4 * BQ;
}
template <int DH>
constexpr int dq_smem() {
  return (2 * BQ + 2 * BK) * Tile<DH>::LD + BQ * (BK + 1) + BK + 4 * BQ;
}
template <int DH>
constexpr int dkv_smem() {
  return (2 * BQ + 2 * BK) * Tile<DH>::LD + BQ * (BK + 1) + 2 * BK + 4 * BQ;
}

enum class Pass { kFwd, kDq, kDkv };

template <typename T, int DH, bool DROP>
int launch(Pass pass, const FlashArgs& a, cudaStream_t st) {
  const int bh = (int)(a.B * a.H);
  if (pass == Pass::kFwd) {
    const dim3 grid((unsigned)((a.nq + BQ - 1) / BQ), bh);
    const size_t bytes = fwd_smem<DH>() * sizeof(float);
    auto fn = flash_train_fwd_kernel<T, DH, DROP>;
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    fn<<<grid, NT, bytes, st>>>(a);
    return (int)cudaGetLastError();
  }
  // bf16 at Dh 32: the backward is the tensor-core route's (bwd_tc)
  if constexpr (std::is_same<T, __nv_bfloat16>::value && DH == 32) {
    return bwd_tc::launch<DROP>(pass == Pass::kDq, a, st);
  } else {
    if (pass == Pass::kDq) {
      const dim3 grid((unsigned)((a.nq + BQ - 1) / BQ), bh);
      const size_t bytes = dq_smem<DH>() * sizeof(float);
      auto fn = flash_train_bwd_dq_kernel<T, DH, DROP>;
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
      fn<<<grid, NT, bytes, st>>>(a);
    } else {
      const dim3 grid((unsigned)((a.nk + BK - 1) / BK), bh);
      const size_t bytes = dkv_smem<DH>() * sizeof(float);
      auto fn = flash_train_bwd_dkv_kernel<T, DH, DROP>;
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
      fn<<<grid, NT, bytes, st>>>(a);
    }
    return (int)cudaGetLastError();
  }
}

template <typename T, bool DROP>
int launch_dh(Pass pass, const FlashArgs& a, cudaStream_t st) {
  // the head widths of the presets: 256 / 8 heads, and the tiny 32 / 4
  switch (a.dh) {
    case 8:
      return launch<T, 8, DROP>(pass, a, st);
    case 32:
      return launch<T, 32, DROP>(pass, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch(Pass pass, const FlashArgs* a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a->B <= 0 || a->H <= 0 || a->nq <= 0 || a->nk <= 0)
    return (int)cudaGetLastError();
  const bool drop = a->thresh > 0;
  if (a->dtype == CMT_DTYPE_F32)
    return drop ? launch_dh<float, true>(pass, *a, st)
                : launch_dh<float, false>(pass, *a, st);
  if (a->dtype == CMT_DTYPE_BF16)
    return drop ? launch_dh<__nv_bfloat16, true>(pass, *a, st)
                : launch_dh<__nv_bfloat16, false>(pass, *a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int cmt_flash_train_fwd(const FlashArgs* a, void* stream) {
  return dispatch(Pass::kFwd, a, stream);
}

extern "C" int cmt_flash_train_bwd_dq(const FlashArgs* a, void* stream) {
  return dispatch(Pass::kDq, a, stream);
}

extern "C" int cmt_flash_train_bwd_dkv(const FlashArgs* a, void* stream) {
  return dispatch(Pass::kDkv, a, stream);
}
