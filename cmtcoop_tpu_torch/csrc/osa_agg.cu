// The OSA aggregate of VoVNet: a 1x1 conv over the virtual channel concat
// of a block's parts, folded eval BatchNorm, ReLU, and the per-view float32
// spatial sums that the eSE attention reads: kernel 6 of the port.
//
// Replaces `_agg_kernel` (cmtcoop_tpu/ops/conv_cf.py), reached through
// `osa_agg_cf` from `_osa_cf` (cmtcoop_tpu/models/vovnet_cf.py): one launch
// per OSA block, sum C 768 -> 256 at 160x400 per view (stage 2) up to
// 768 + 5 x 224 -> 1024 at 20x50 (stage 5).
//
// Function, per view v and pixel p of its H*W:
//   agg[v, p, :] = relu(sum_i part_i[v, p, :] @ W_i + bias)
//   gap[v, :]    = sum_p relu(...) in float32, before the cast to the parts'
//                  dtype.
// W (sum C_i, Cout) arrives with the BN scale folded in and cast to the
// parts' dtype, as the TPU wrapper folds it.
//
// What bounds it on the card: arithmetic, with the parts read once. At the
// stage-2 shape it is a GEMM of M = V*64000 pixels, N = 256, K = 768. The
// concat is never written: the K loop walks the parts in order and reads
// each A tile straight from the part that owns those channels (up to six
// pointers and channel counts, passed by value). One block owns a 128-pixel
// tile inside one view and a 128-wide Cout tile, holds the outputs in
// registers (8 x 8 per thread), applies bias and ReLU and stores once.
// Blocks run in no order, so the TPU kernel's grid-carried gap accumulator
// has no counterpart: each block reduces its tile's float32 column sums in
// shared memory and writes them as one row of a (V, tiles, Cout) partial
// buffer, and a second small kernel sums the rows in a fixed order. That
// keeps `gap` deterministic (atomics would not be). This first version runs
// on the CUDA cores in fp32; tensor cores (wgmma) are later work.
#include "common.cuh"

#define CMT_OSA_MAX_PARTS 6

struct OsaParts {
  const void* ptr[CMT_OSA_MAX_PARTS];
  int ch[CMT_OSA_MAX_PARTS];
  int n;
};

template <typename T>
__global__ void __launch_bounds__(256) osa_agg_kernel(
    OsaParts parts, const T* __restrict__ w, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ partial, int hw, int cout,
    int tiles) {
  constexpr int TM = 128, TN = 128, RM = 8, RN = 8, TK = 16;
  __shared__ float s_sum[TM / RM][TN];
  const int view = blockIdx.x / tiles;
  const int tile = blockIdx.x - view * tiles;
  const int rows = min(TM, hw - tile * TM);  // the last tile is ragged
  const size_t row0 = (size_t)view * hw + (size_t)tile * TM;
  const int n0 = blockIdx.y * TN;

  float acc[RM][RN] = {};
  int koff = 0;
  for (int p = 0; p < parts.n; ++p) {
    const T* a = (const T*)parts.ptr[p];
    const int c = parts.ch[p];
    auto load_a = [&](int r, int k) -> float {
      return r < rows ? cmt_ld(a + (row0 + r) * c + k) : 0.f;
    };
    auto load_b = [&](int k, int n) -> float {
      return (n0 + n < cout) ? cmt_ld(w + (size_t)(koff + k) * cout + n0 + n)
                             : 0.f;
    };
    cmt_gemm_tile<TM, TN, RM, RN, TK>(acc, c, load_a, load_b);
    koff += c;
  }

  const int tx = threadIdx.x % (TN / RN);
  const int ty = threadIdx.x / (TN / RN);
  float colsum[RN] = {};
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + i * (TM / RM);
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = n0 + tx + j * (TN / RN);
      if (c >= cout) continue;
      const float v = fmaxf(acc[i][j] + bias[c], 0.f);
      colsum[j] += v;
      cmt_st(out + (row0 + r) * cout + c, v);
    }
  }
#pragma unroll
  for (int j = 0; j < RN; ++j) s_sum[ty][tx + j * (TN / RN)] = colsum[j];
  __syncthreads();
  if (threadIdx.x < TN && n0 + threadIdx.x < cout) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < TM / RM; ++t) s += s_sum[t][threadIdx.x];
    partial[((size_t)view * tiles + tile) * cout + n0 + threadIdx.x] = s;
  }
}

// gap[v, c] = sum over the view's tiles of partial[v, t, c], in tile order.
__global__ void osa_gap_kernel(const float* __restrict__ partial,
                               float* __restrict__ gap, int v, int tiles,
                               int cout) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= v * cout) return;
  const int view = idx / cout;
  const int c = idx - view * cout;
  const float* p = partial + (size_t)view * tiles * cout + c;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += p[(size_t)t * cout];
  gap[idx] = s;
}

// parts p0..p5 (the first `nparts` used), each (V, H*W, c_i) contiguous;
// w (sum c_i, cout) in the parts' dtype; bias (cout,) float32; out
// (V, H*W, cout); partial (V, ceil(H*W / 128), cout) float32 scratch; gap
// (V, cout) float32.
extern "C" int cmt_osa_aggregate(int dtype, int nparts, const void* p0,
                                 const void* p1, const void* p2,
                                 const void* p3, const void* p4,
                                 const void* p5, int c0, int c1, int c2,
                                 int c3, int c4, int c5, const void* w,
                                 const void* bias, void* out, void* partial,
                                 void* gap, int v, int hw, int cout,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nparts < 1 || nparts > CMT_OSA_MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  if (v <= 0 || hw <= 0 || cout <= 0) return (int)cudaGetLastError();
  OsaParts parts;
  const void* ptrs[CMT_OSA_MAX_PARTS] = {p0, p1, p2, p3, p4, p5};
  const int chs[CMT_OSA_MAX_PARTS] = {c0, c1, c2, c3, c4, c5};
  for (int i = 0; i < CMT_OSA_MAX_PARTS; ++i) {
    parts.ptr[i] = ptrs[i];
    parts.ch[i] = chs[i];
  }
  parts.n = nparts;
  const int tiles = (hw + 127) / 128;
  dim3 grid(v * tiles, (cout + 127) / 128);
  if (dtype == CMT_DTYPE_F32)
    osa_agg_kernel<float><<<grid, 256, 0, st>>>(
        parts, (const float*)w, (const float*)bias, (float*)out,
        (float*)partial, hw, cout, tiles);
  else if (dtype == CMT_DTYPE_BF16)
    osa_agg_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        parts, (const __nv_bfloat16*)w, (const float*)bias,
        (__nv_bfloat16*)out, (float*)partial, hw, cout, tiles);
  else
    return (int)cudaErrorInvalidValue;
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  osa_gap_kernel<<<(v * cout + 255) / 256, 256, 0, st>>>(
      (const float*)partial, (float*)gap, v, tiles, cout);
  return (int)cudaGetLastError();
}
