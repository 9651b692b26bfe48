// Training attention on (B, H, N, Dh) views: kernel 7 (the forward, with
// the (m, l) statistics and in-kernel dropout) and kernel 8 (its
// FlashAttention-2 backward, two launches: dQ, then dK / dV / d(k_bias)).
// Kernel 7's bf16 Dh-32 forward (`fwd_tc`) also runs kernel 3, the eval
// attention, with dropout off.
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
// times. In float32 and at Dh 8 both kernels run every product on the CUDA
// cores in float32 with register tiles (4 x 4 scores and 4 x Dh/16 outputs
// per thread) fed from shared memory: tiles of 64 queries x 64 keys, 256
// threads; the forward and the dQ pass walk the keys for one (bh, 64-query)
// tile, the dK/dV pass walks the queries for one (bh, 64-key) tile, so no
// reduction crosses blocks. In bf16 at Dh 32 both run on the tensor cores
// (`bwd_tc` and `fwd_tc` below).
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
  // the bf16 Dh-32 forward: its key walk split into `splits` ranges of
  // `tiles_per_split` 128-key tiles; with more than one, float32 partials
  // (splits, B*H, Nq, Dh) of the unnormalised O in `o_part` and their
  // (m log2 e, l) (splits, B*H, Nq, 2) in `ml_part`
  float *o_part, *ml_part;
  long long splits, tiles_per_split;
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

constexpr unsigned KEY_MUL = 0xC2B2AE3Du;  // the keep hash's key term

// whether element (row, key) is kept, `jm` the key's term j * KEY_MUL (the
// tensor-core passes add it incrementally along a row)
__device__ __forceinline__ bool kept(unsigned rh, unsigned jm,
                                     unsigned thresh) {
  return fmix32(rh ^ jm) >= thresh;
}

// keep factor of element (row, j): keep_scale or 0
__device__ __forceinline__ float keep_factor(unsigned rh, unsigned j,
                                             unsigned thresh,
                                             float keep_scale) {
  return kept(rh, j * KEY_MUL, thresh) ? keep_scale : 0.f;
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
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// (batch, head, row) strides -> cmt_head_map's (row, head, batch), a box of
// `rows` rows
static bool map_of(CUtensorMap* map, const void* ptr, const long long (&s)[3],
                   long long n, const FlashArgs& a, int rows = 64) {
  const long long st[3] = {s[2], s[1], s[0]};
  return cmt_head_map(map, ptr, n, a.H, a.B, st, rows);
}

namespace bwd_tc {

constexpr int WG = 2;                    // consumer warpgroups
constexpr int ROWS = 64 * WG;            // a block's queries (dQ) or keys
constexpr int TILE = 64 * 64;            // 64 rows x 64 B
constexpr int STAGES = 4;
constexpr int THREADS = 128 * WG + 32;   // + the producer warp

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
          dpv *= kept(rh[hh], jm0 + (unsigned)(8 * j + c) * KEY_MUL, thresh)
                     ? keep_scale
                     : 0.f;
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
            !DROP ? 1.f
            : kept(__float_as_uint(q.w), km[hh], thresh) ? keep_scale
                                                        : 0.f;
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

// -------------- kernels 7 and 3, bfloat16 at Dh 32: tensor cores ------------
//
// The forward with kernel 8's keep bit. It is also kernel 3 (the eval
// attention, `_flash_kernel_packed`) in bf16 at Dh 32: ops/attention.py
// `flash_attention_packed` launches it on (B, H, N, Dh) views of its packed
// (B, N, H*Dh) projections, dropout off, no (m, l). One producer warp
// streams the range's K and V tiles by TMA (the 4D per-head maps over the
// strided views, 64-byte swizzle, zeros past Nk) into a ring of four
// stages, its lanes storing each tile's bias x log2 e beside it (-inf past
// Nk, so those keys are absent). Consumer warpgroups own 64 queries each: S = Q K^T by wgmma from shared
// memory; the online softmax in registers in the log2 domain (s2 = s scale
// log2 e + bias log2 e, kernel 8's formula, the max started at NEG_INF
// log2 e); l sums every P in float32; the keep bit (the row hash once per
// row, the key term j * KEY_MUL added along the row) zeroes the dropped P
// before it is packed to bf16, and 1 / (1 - rate) scales O once at the end;
// O += P V by the register-A form, V read MN-major from its tile. Rows past
// Nq are computed on TMA's zeros and never stored; a warpgroup with no real
// row drains the ring. A tile's P V stays in flight under the next tile's
// scores; ptxas then serialises the wgmma for registers (C7512: the producer
// warp makes the block count as four warpgroups), yet 192 queries x 128 keys
// measured fastest of four tiles (128 or 192 queries x 64 or 128 keys) at
// the train step's shapes, as it did for kernel 3's memories (PERF.md).
//   Grid fill: 1540 queries are 9 blocks of 192 a head, 72 at batch 1,
// under one wave of 132 SMs, so the key walk is split
// (ops/attention.py `split_plan`): each split writes its unnormalised float32
// O and (m2, l), and `merge_kernel` combines them in split order, so the
// result is deterministic. With one split the block writes out, m and l.
//   The (m, l) contract with kernel 8, which scales m back by log2 e: the
// written m is m2 ln 2 moved by an ulp or two until m log2 e gives m2 back
// (`natural_max`), so the backward's recomputed 2^(s2 - m log2 e) is the
// forward's own P even where m2 is a fully masked row's -1e9 log2 e, whose
// ulp (128) would otherwise turn P into 2^(+-128).
//   What bounds it: one exponential a score (0.140 ms at q1540 x k44400 x 8
// heads) over the tensor cores' 0.071 ms; at dropout 0.1 the keep hash's ~10
// integer operations a score on the ALU and IMAD pipes beside them.
namespace fwd_tc {

// a block's tile, ops/attention.py `FWD_TC_TILE`: WG x 64 queries, BK keys
// a walked tile
constexpr int WG = 3;                      // consumer warpgroups
constexpr int BK = 128;
constexpr int STAGES = 4;
constexpr int THREADS = 128 * WG + 32;     // + the producer warp
constexpr int Q_BYTES = 64 * 64;           // a warpgroup's 64 queries x 64 B
constexpr int KV_BYTES = BK * 64;          // one K or V tile
// from a 1024-byte aligned base: the queries, the ring of (K, V) stages,
// each stage's scaled bias, the barriers
constexpr int OFF_KV = WG * Q_BYTES;
constexpr int OFF_BIAS = OFF_KV + STAGES * 2 * KV_BYTES;
constexpr int OFF_BAR = OFF_BIAS + STAGES * BK * 4;
constexpr int SMEM = 1024 + OFF_BAR + (2 * STAGES + 1) * 8;

struct Maps {
  CUtensorMap q, k, v;  // box (32, 64) for q, (32, BK) for k and v
};

// the natural-log max written for the backward: m2 ln 2, or the float
// within two ulps of it whose product with log2 e lies nearest m2
__device__ __forceinline__ float natural_max(float m2) {
  float best = __fmul_rn(m2, LN2);
  float err = fabsf(__fmul_rn(best, LOG2E) - m2);
  float up = best, dn = best;
  for (int t = 0; t < 2; ++t) {
    up = nextafterf(up, INFINITY);
    dn = nextafterf(dn, -INFINITY);
    const float eu = fabsf(__fmul_rn(up, LOG2E) - m2);
    const float ed = fabsf(__fmul_rn(dn, LOG2E) - m2);
    if (eu < err) best = up, err = eu;
    if (ed < err) best = dn, err = ed;
  }
  return best;
}

template <bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ Maps maps, const FlashArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = cmt_smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* bias_s =
      reinterpret_cast<float*>(smem_raw + (base - raw) + OFF_BIAS);
  const uint32_t full = base + OFF_BAR, empty = full + 8 * STAGES;
  const uint32_t qbar = empty + 8 * STAGES;

  const int nq = (int)a.nq, nk = (int)a.nk, H = (int)a.H;
  const int q0 = blockIdx.x * 64 * WG, split = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh - b * H;
  const int tps = (int)a.tiles_per_split, t0 = split * tps;
  const int n_tiles = min((nk + BK - 1) / BK, t0 + tps) - t0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's expect_tx arrive and its 32 lanes' arrives
      cmt_mbar_init(full + 8 * s, 33);
      cmt_mbar_init(empty + 8 * s, 128 * WG);
    }
    cmt_mbar_init(qbar, 1);
    cmt_mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == WG) {  // producer: Q once, then K, V and bias a tile
    if (lane == 0) {
      cmt_mbar_expect_tx(qbar, WG * Q_BYTES);
      for (int w = 0; w < WG; ++w)
        cmt_tma_load_4d(base + w * Q_BYTES, &maps.q, qbar, 0, q0 + 64 * w,
                        h, b);
    }
    const float* kbias = a.kbias + (size_t)b * nk;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES, k0 = (t0 + i) * BK;
      cmt_mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t kv = base + OFF_KV + s * 2 * KV_BYTES;
        cmt_mbar_expect_tx(full + 8 * s, 2 * KV_BYTES);
        cmt_tma_load_4d(kv, &maps.k, full + 8 * s, 0, k0, h, b);
        cmt_tma_load_4d(kv + KV_BYTES, &maps.v, full + 8 * s, 0, k0, h,
                        b);
      }
      for (int e = lane; e < BK; e += 32)
        bias_s[s * BK + e] =
            k0 + e < nk ? kbias[k0 + e] * LOG2E : -INFINITY;
      cmt_mbar_arrive(full + 8 * s);
    }
    return;
  }
  if (q0 + wg * 64 >= nq) {  // no real row: free each stage unread
    for (int i = 0; i < n_tiles; ++i) {
      cmt_mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
      cmt_mbar_arrive(empty + 8 * (i % STAGES));
    }
    return;
  }

  // rows r0 = 16 warp + lane/4 and r0 + 8 of the warpgroup's 64; columns
  // 8j + 2 quad + {0, 1} of a score tile
  const int warp = (threadIdx.x % 128) / 32, quad = lane & 3;
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int rows[2] = {r0, r0 + 8};
  unsigned rh[2] = {0u, 0u};
  if (DROP) {
    rh[0] = row_hash((unsigned)a.seed, bh, rows[0]);
    rh[1] = row_hash((unsigned)a.seed, bh, rows[1]);
  }
  const unsigned thresh = (unsigned)a.thresh;
  const float scale2 = (float)a.scale * LOG2E;
  const uint64_t qd = cmt_sw64_desc(base + wg * Q_BYTES);
  float o[16], sc[BK / 2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 16; ++i) pa[i][0] = pa[i][1] = pa[i][2] = pa[i][3] = 0u;
  float m[2] = {CMT_NEG_INF * LOG2E, CMT_NEG_INF * LOG2E}, l[2] = {0.f, 0.f};
  cmt_mbar_wait(qbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, k0 = (t0 + i) * BK;
    const uint32_t kv = base + OFF_KV + s * 2 * KV_BYTES;
    cmt_mbar_wait(full + 8 * s, (i / STAGES) & 1);
    // S = Q K^T over Dh = two 16-deep slices (+32 B)
    const uint64_t kd = cmt_sw64_desc(kv);
    cmt_fence_regs(sc);
    cmt_wgmma_fence();
    Wgmma<BK>::mma(sc, qd, kd, 0);
    Wgmma<BK>::mma(sc, qd + 2, kd + 2);
    cmt_wgmma_commit();
    cmt_wgmma_wait<0>();  // and the previous tile's P V
    cmt_fence_regs(sc);
    cmt_fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) cmt_fence_regs(pa[kk]);
    if (i > 0) cmt_mbar_arrive(empty + 8 * ((i - 1) % STAGES));

    const float* bs = bias_s + s * BK;
    float mx0 = m[0], mx1 = m[1];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float2 bb =
          *reinterpret_cast<const float2*>(bs + 8 * j + 2 * quad);
      sc[4 * j] = fmaf(sc[4 * j], scale2, bb.x);
      sc[4 * j + 1] = fmaf(sc[4 * j + 1], scale2, bb.y);
      sc[4 * j + 2] = fmaf(sc[4 * j + 2], scale2, bb.x);
      sc[4 * j + 3] = fmaf(sc[4 * j + 3], scale2, bb.y);
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int d = 1; d < 4; d *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    const float a0 = cmt_ex2(m[0] - mx0), a1 = cmt_ex2(m[1] - mx1);
    m[0] = mx0;
    m[1] = mx1;
    // P, its full sum, then the keep bit: hash of (row, key k0 + 8j + 2quad
    // + c), the key term jm0 + (8j + c) KEY_MUL
    const unsigned jm0 = (unsigned)(k0 + 2 * quad) * KEY_MUL;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const float p = cmt_ex2(sc[4 * j + e] - (hh ? mx1 : mx0));
        if (hh)
          s1 += p;
        else
          s0 += p;
        sc[4 * j + e] =
            !DROP || kept(rh[hh], jm0 + (unsigned)(8 * j + (e & 1)) * KEY_MUL,
                          thresh)
                ? p
                : 0.f;
      }
    }
    l[0] = l[0] * a0 + s0;  // this lane's columns; summed over the quad
    l[1] = l[1] * a1 + s1;  // at the end
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = cmt_pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = cmt_pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = cmt_pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = cmt_pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    // O += P V: V MN-major, 16 keys (1024 B) a slice
    const uint64_t vd = cmt_sw64_mn_desc(kv + KV_BYTES);
    cmt_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      cmt_wgmma_rs32(o, pa[kk], vd + 64 * kk);
    cmt_wgmma_commit();
  }
  cmt_wgmma_wait<0>();
  cmt_fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) cmt_fence_regs(pa[kk]);
#pragma unroll
  for (int d = 1; d < 4; d *= 2) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], d);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], d);
  }

  const float ks = DROP ? (float)a.keep_scale : 1.f;
  const int c = H * 32;
  if (a.splits == 1) {
    __nv_bfloat16* out =
        (__nv_bfloat16*)a.out + (size_t)b * nq * c + h * 32 + 2 * quad;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (rows[hh] >= nq) continue;
      const float mul = ks / fmaxf(l[hh], 1e-30f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rows[hh] * c +
                                           8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] * mul,
                                  o[4 * j + 2 * hh + 1] * mul);
      if (a.m_out != nullptr && quad == 0) {
        a.m_out[(size_t)bh * nq + rows[hh]] = natural_max(m[hh]);
        a.l_out[(size_t)bh * nq + rows[hh]] = l[hh];
      }
    }
    return;
  }
  const size_t at = ((size_t)split * gridDim.z + bh) * nq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (rows[hh] >= nq) continue;
    float* op = a.o_part + (at + rows[hh]) * 32 + 2 * quad;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(op + 8 * j) =
          make_float2(o[4 * j + 2 * hh] * ks, o[4 * j + 2 * hh + 1] * ks);
    if (quad == 0)
      *reinterpret_cast<float2*>(a.ml_part + (at + rows[hh]) * 2) =
          make_float2(m[hh], l[hh]);
  }
}

// out[b, q, h*32 + d] from the splits' partials, merged in split order: M =
// max m2_s, L = sum l_s 2^(m2_s - M), O = sum O_s 2^(m2_s - M) / max(L,
// 1e-30); the row's first lane writes m = natural_max(M) and l = L. One
// thread an output element.
__global__ void merge_kernel(const float* __restrict__ opart,
                             const float* __restrict__ ml,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out, int bh_n, int nq,
                             int heads, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)bh_n * nq * 32;
  if (idx >= total) return;
  const int d = idx % 32;
  size_t t = idx / 32;
  const int h = t % heads;
  t /= heads;
  const int q = t % nq;
  const int b = (int)(t / nq);
  const size_t row = ((size_t)b * heads + h) * nq + q;
  const size_t stride = (size_t)bh_n * nq;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[(s * stride + row) * 2]);
  float den = 0.f, num = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t at = s * stride + row;
    const float w = cmt_ex2(ml[at * 2] - mx);
    den += ml[at * 2 + 1] * w;
    num += opart[at * 32 + d] * w;
  }
  out[idx] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  if (m_out != nullptr && d == 0) {
    m_out[row] = natural_max(mx);
    l_out[row] = den;
  }
}

template <bool DROP>
int launch(const FlashArgs& a, cudaStream_t st) {
  const long long tps = a.tiles_per_split;
  if (tps <= 0 || a.splits != ((a.nk + BK - 1) / BK + tps - 1) / tps ||
      (a.splits > 1 && (a.o_part == nullptr || a.ml_part == nullptr)) ||
      (a.m_out == nullptr) != (a.l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (!map_of(&maps.q, a.q, a.sq, a.nq, a) ||
      !map_of(&maps.k, a.k, a.sk, a.nk, a, BK) ||
      !map_of(&maps.v, a.v, a.sv, a.nk, a, BK))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[CMT_MAX_DEVICES] = {};
  cudaError_t err = cmt_allow_smem(fwd_kernel<DROP>, SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.nq + 64 * WG - 1) / (64 * WG)),
                  (unsigned)a.splits, (unsigned)(a.B * a.H));
  fwd_kernel<DROP><<<grid, THREADS, SMEM, st>>>(maps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  const size_t total = (size_t)a.B * a.H * a.nq * 32;
  merge_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      a.o_part, a.ml_part, (__nv_bfloat16*)a.out, a.m_out, a.l_out,
      (int)(a.B * a.H), (int)a.nq, (int)a.H, (int)a.splits);
  return (int)cudaGetLastError();
}

}  // namespace fwd_tc

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
  // bf16 at Dh 32: the tensor-core routes (fwd_tc, bwd_tc)
  if constexpr (std::is_same<T, __nv_bfloat16>::value && DH == 32) {
    return pass == Pass::kFwd
               ? fwd_tc::launch<DROP>(a, st)
               : bwd_tc::launch<DROP>(pass == Pass::kDq, a, st);
  } else {
    const int bh = (int)(a.B * a.H);
    if (pass == Pass::kFwd) {
      const dim3 grid((unsigned)((a.nq + BQ - 1) / BQ), bh);
      const size_t bytes = fwd_smem<DH>() * sizeof(float);
      auto fn = flash_train_fwd_kernel<T, DH, DROP>;
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
      fn<<<grid, NT, bytes, st>>>(a);
    } else if (pass == Pass::kDq) {
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
