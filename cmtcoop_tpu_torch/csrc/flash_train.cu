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
// What bounds it on the card: arithmetic. At the decoder's cross-attention
// (1540 queries x 44400 keys x 8 heads x Dh 32) the forward is 35 GMAC
// (~70 GFLOP), the dQ pass 52 GMAC and the dK/dV pass 70 GMAC, against
// ~55 MB of operands: at the H100's 989 bf16 TFLOP/s the least times are
// ~0.071, ~0.106 and ~0.142 ms (chip_smoke.py prints them beside the
// measured ones). This first version runs every product on the CUDA
// cores in float32 with register tiles (4 x 4 scores and 4 x Dh/16 outputs
// per thread) fed from shared memory; tensor cores (wgmma) come later.
// Tiles: 64 queries x 64 keys, 256 threads; the forward and the dQ pass
// walk the keys for one (bh, 64-query) tile, the dK/dV pass walks the
// queries for one (bh, 64-key) tile, so no reduction crosses blocks.
#include "common.cuh"

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
  if (pass == Pass::kFwd || pass == Pass::kDq) {
    const dim3 grid((unsigned)((a.nq + BQ - 1) / BQ), bh);
    if (pass == Pass::kFwd) {
      const size_t bytes = fwd_smem<DH>() * sizeof(float);
      auto fn = flash_train_fwd_kernel<T, DH, DROP>;
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
      fn<<<grid, NT, bytes, st>>>(a);
    } else {
      const size_t bytes = dq_smem<DH>() * sizeof(float);
      auto fn = flash_train_bwd_dq_kernel<T, DH, DROP>;
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
      fn<<<grid, NT, bytes, st>>>(a);
    }
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
