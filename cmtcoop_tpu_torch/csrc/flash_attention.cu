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
// bfloat16 at Dh 32 (the presets' 256 / 8 heads) -> `flash_tc`, on the
// tensor cores. What bounds it on the card: at the decoder's
// cross-attention (900 queries x 36400 or 44400 tokens x 8 heads) the
// bf16 products are 15-18 GFLOP (0.015-0.019 ms at 989 TFLOP/s), but every
// score also takes one exponential: 262-320 M a call, 0.067-0.082 ms at
// the special-function units' ~3.9 T/s. At Dh 32 the exponentials, not
// the products, are the floor. The design:
//   - a block takes 192 queries of one head (three consumer warpgroups of
//     64) and one range of 128-key tiles; one producer warp streams the
//     range's K and V tiles by TMA (a 4D map over (Dh, N, H, B) per
//     tensor, 64-byte swizzle, zeros past Nk) into a ring of four stages,
//     with the tile's bias scaled by log2 e (-inf past Nk) stored beside
//     them by its 32 lanes; the three warpgroups share each K/V tile, so
//     the L2 traffic is a third of one warpgroup a block;
//   - S = Q K^T by wgmma m64n128k16 from shared memory (two 16-deep
//     slices of Dh), the online softmax in registers in the log2 domain
//     (the row max and sum over the four lanes of a row, exp2 on the
//     special-function unit), O += P V by the register-A form of wgmma
//     m64n32k16, P repacked to bf16 straight from the score accumulators
//     and V read MN-major from the same tile TMA wrote;
//   - 900 queries are 5 blocks a head, 40 at batch 1, under a third of
//     the card: the key range is split across blocks (the plan of
//     ops/attention.py `split_plan`, from the SM count). Each split writes
//     an unnormalised float32 partial O and its (m, l); `packed_merge_kernel`
//     merges them in split order (the JAX `merge_partials` arithmetic), so
//     the result is deterministic. One split writes the output directly.
//   P enters the P V product as bf16 (l sums it in float32), as the FA2/FA3
//   kernels do; the JAX kernel multiplies in float32. A tile's P V stays in
//   flight under the next tile's scores: ptxas then serialises the wgmma
//   for registers (C7512: the producer warp makes the block count as four
//   warpgroups, 128 registers a thread), yet waiting for P V each tile,
//   which avoids that, measured slower, as did 128-query or 64-key tiles
//   at the fusion path's memories.
//
// float32, and bf16 at Dh 4, 8, 16 (the tiny presets) -> `flash_packed_kernel`,
// the first version on the CUDA cores: one block per (32-query tile, head,
// batch) streams 64-key tiles, keeps the score tile and the running (m, l)
// in shared memory and the score and output accumulators in registers
// (4 x 4 and 4 x Dh/16 per thread, so a shared-memory load feeds several
// multiply-adds).
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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
      // bf16 at Dh 32 is the tensor-core route's (flash_tc)
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

// ----------------------- bfloat16, Dh 32: tensor cores ----------------------

namespace flash_tc {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WG = 3;                // consumer warpgroups, 64 queries each
constexpr int BQ = 64 * WG;          // queries a block
constexpr int BK = 128;              // keys a tile
constexpr int STAGES = 4;
constexpr int ROW = 64;              // bytes of one head's row (Dh 32)
constexpr int Q_BYTES = 64 * ROW;    // one warpgroup's queries
constexpr int KV_BYTES = BK * ROW;   // one K or V tile
constexpr int THREADS = 128 * WG + 32;  // + the producer warp
// shared memory from a 1024-byte aligned base: the queries, the ring of
// (K, V) stages, each stage's scaled bias, the barriers
constexpr int OFF_KV = WG * Q_BYTES;
constexpr int OFF_BIAS = OFF_KV + STAGES * 2 * KV_BYTES;
constexpr int OFF_BAR = OFF_BIAS + STAGES * BK * 4;
constexpr int SMEM = 1024 + OFF_BAR + (2 * STAGES + 1) * 8;

struct Maps {
  CUtensorMap q, k, v;  // box (32, 64) for q, (32, BK) for k and v
};

struct Params {
  const float* bias;    // (B, Nk)
  __nv_bfloat16* out;   // (B, Nq, H*32), written when splits == 1
  float* opart;         // (splits, B*H, Nq, 32) unnormalised partial O
  float* ml;            // (splits, B*H, Nq, 2) their (m, l), log2 domain
  int nq, nk, heads, splits, tiles_per_split;
  float scale2;         // log2(e) / sqrt(32)
};

__global__ void __launch_bounds__(THREADS, 1)
    packed_tc_kernel(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = cmt_smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* bias_s =
      reinterpret_cast<float*>(smem_raw + (base - raw) + OFF_BIAS);
  const uint32_t full = base + OFF_BAR;  // 8 B a barrier
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t qbar = empty + 8 * STAGES;

  const int q0 = blockIdx.x * BQ, split = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int ktiles = (p.nk + BK - 1) / BK;
  const int t0 = split * p.tiles_per_split;
  const int n_tiles = min(ktiles, t0 + p.tiles_per_split) - t0;

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
  if (wg == WG) {
    // the producer warp: lane 0 issues the TMA loads, every lane stores
    // four of a tile's scaled biases
    if (lane == 0) {
      cmt_mbar_expect_tx(qbar, WG * Q_BYTES);
      for (int w = 0; w < WG; ++w)
        cmt_tma_load_4d(base + w * Q_BYTES, &maps.q, qbar, 0, q0 + 64 * w,
                        h, b);
    }
    const float* bias = p.bias + (size_t)b * p.nk;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES, k0 = (t0 + i) * BK;
      cmt_mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t kv = base + OFF_KV + s * 2 * KV_BYTES;
        cmt_mbar_expect_tx(full + 8 * s, 2 * KV_BYTES);
        cmt_tma_load_4d(kv, &maps.k, full + 8 * s, 0, k0, h, b);
        cmt_tma_load_4d(kv + KV_BYTES, &maps.v, full + 8 * s, 0, k0, h, b);
      }
      for (int e = lane; e < BK; e += 32)
        bias_s[s * BK + e] =
            k0 + e < p.nk ? bias[k0 + e] * LOG2E : -INFINITY;
      cmt_mbar_arrive(full + 8 * s);
    }
    return;
  }

  // a warpgroup whose 64 queries all lie past Nq frees each stage unread
  if (q0 + wg * 64 >= p.nq) {
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
    const int s = i % STAGES;
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

    // online softmax in the log2 domain: s2 = s * scale2 + bias * log2 e
    const float* bs = bias_s + s * BK;
    float mx0 = m[0], mx1 = m[1];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float2 bb =
          *reinterpret_cast<const float2*>(bs + 8 * j + 2 * quad);
      sc[4 * j] = fmaf(sc[4 * j], p.scale2, bb.x);
      sc[4 * j + 1] = fmaf(sc[4 * j + 1], p.scale2, bb.y);
      sc[4 * j + 2] = fmaf(sc[4 * j + 2], p.scale2, bb.x);
      sc[4 * j + 3] = fmaf(sc[4 * j + 3], p.scale2, bb.y);
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
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] = cmt_ex2(sc[4 * j] - mx0);
      sc[4 * j + 1] = cmt_ex2(sc[4 * j + 1] - mx0);
      sc[4 * j + 2] = cmt_ex2(sc[4 * j + 2] - mx1);
      sc[4 * j + 3] = cmt_ex2(sc[4 * j + 3] - mx1);
      s0 += sc[4 * j] + sc[4 * j + 1];
      s1 += sc[4 * j + 2] + sc[4 * j + 3];
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

  const int rows[2] = {r0, r0 + 8};
  if (p.splits == 1) {
    const int c = p.heads * 32;
    __nv_bfloat16* out = p.out + (size_t)b * p.nq * c + h * 32 + 2 * quad;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (rows[hh] >= p.nq) continue;
      const float inv = 1.f / fmaxf(l[hh], 1e-30f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)rows[hh] * c +
                                           8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv,
                                  o[4 * j + 2 * hh + 1] * inv);
    }
  } else {
    const size_t at = ((size_t)split * gridDim.z + bh) * p.nq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (rows[hh] >= p.nq) continue;
      float* op = p.opart + (at + rows[hh]) * 32 + 2 * quad;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(op + 8 * j) =
            make_float2(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
      if (quad == 0)
        *reinterpret_cast<float2*>(p.ml + (at + rows[hh]) * 2) =
            make_float2(m[hh], l[hh]);
    }
  }
}

// out[b, q, h*32 + d] from the splits' partials, merged in split order:
// M = max m_s, L = sum l_s 2^(m_s - M), O = sum O_s 2^(m_s - M) / max(L,
// 1e-30). One thread an output element.
__global__ void packed_merge_kernel(const float* __restrict__ opart,
                                    const float* __restrict__ ml,
                                    __nv_bfloat16* __restrict__ out, int bh_n,
                                    int nq, int heads, int splits) {
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
}

}  // namespace flash_tc

// The bf16 Dh-32 route: q, k, v bf16 (B, N, H*32) contiguous and 16-byte
// aligned, bias (B, Nk) float32, out (B, Nq, H*32). The split plan
// (`splits` ranges of `tiles_per_split` 128-key tiles, every range
// non-empty) comes from ops/attention.py `split_plan`; with more than one
// split, opart (splits, B*H, Nq, 32) and ml (splits, B*H, Nq, 2) float32
// scratch take the partials.
extern "C" int cmt_flash_attention_packed_tc(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* opart, void* ml, int b, int nq, int nk, int heads, int splits,
    int tiles_per_split, void* stream) {
  using namespace flash_tc;
  cudaStream_t st = (cudaStream_t)stream;
  if (b <= 0 || nq <= 0 || nk <= 0 || heads <= 0 || tiles_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  const int ktiles = (nk + BK - 1) / BK;
  if (splits != (ktiles + tiles_per_split - 1) / tiles_per_split ||
      (splits > 1 && (opart == nullptr || ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long c = heads * 32LL;
  const long long sq[3] = {c, 32, nq * c}, sk[3] = {c, 32, nk * c};
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (!cmt_head_map(&maps.q, q, nq, heads, b, sq, 64) ||
      !cmt_head_map(&maps.k, k, nk, heads, b, sk, BK) ||
      !cmt_head_map(&maps.v, v, nk, heads, b, sk, BK))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.bias = (const float*)bias;
  p.out = (__nv_bfloat16*)out;
  p.opart = (float*)opart;
  p.ml = (float*)ml;
  p.nq = nq;
  p.nk = nk;
  p.heads = heads;
  p.splits = splits;
  p.tiles_per_split = tiles_per_split;
  p.scale2 = (float)(1.4426950408889634 / sqrt(32.0));
  static bool smem_set[CMT_MAX_DEVICES] = {};
  cudaError_t err = cmt_allow_smem(packed_tc_kernel, SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + BQ - 1) / BQ, splits, b * heads);
  packed_tc_kernel<<<grid, THREADS, SMEM, st>>>(maps, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t total = (size_t)b * heads * nq * 32;
  packed_merge_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float*)opart, (const float*)ml, (__nv_bfloat16*)out, b * heads,
      nq, heads, splits);
  return (int)cudaGetLastError();
}
