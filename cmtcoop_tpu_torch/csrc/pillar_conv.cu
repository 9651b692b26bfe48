// Sparse-BEV x dense-z pillar convolution with the fused BN/residual/ReLU/
// occupancy epilogue: kernels 1 and 2 of the port.
//
// Replaces (cmtcoop_tpu/ops/pillar_fused.py):
//   - `_fused_kernel_v2` / `_fused_v2_compute` (9 BEV taps: the submanifold
//     3x3x3 convs and the three stride-2 down convs), entry point
//     `cmt_pillar_conv_kb9`;
//   - `_fused_kernel` (1 BEV tap: `conv_out`, kernel (3,1,1), stride
//     (2,1,1)), entry point `cmt_pillar_conv_kb1`;
//   - the in-kernel `fold_occ` occupancy of the down convs, entry point
//     `cmt_pillar_occ_fold` (= ops/pillars.py `occ_downsample`).
//
// Function: out[p, zo, :] = occ[p, zo] * relu?(scale * sum_{j, dz}
//   feats[nbr[p, j], zo*s + dz - pad, :] @ W[dz*KB + j] + bias + resid[p, zo])
// with nbr misses (== P_in) and z outside [0, Z_in) reading zero.
//
// What bounds it on the card: arithmetic on the active output rows. The
// output is multiplied by the occupancy, and at LiDAR densities only a few
// percent of the (pillar, z) rows are occupied (stage 0: ~33k of 38400 x 41),
// so the wrapper compacts the occupied rows into a list on the device (no
// host sync; the count stays in device memory) and this kernel runs an
// implicit GEMM over that list only: M = active rows, N = Cout,
// K = kz * KB * Cin. The A operand is gathered straight through the
// neighbour map, a direct row gather; the TPU kernel's one-hot gathers,
// per-dy windows, band matrices and z tiles have no counterpart here.
// Inactive rows keep the zeros the wrapper wrote. Blocks past the device
// count exit at once, so the grid can be sized by the host's upper bound.
// This first version runs on the CUDA cores (fp32 FMA, 4x4 register tiles
// through shared memory); tensor cores (wgmma) are later work.
#include <stdint.h>

#include "common.cuh"

template <typename T, int KB, int TN>
__global__ void __launch_bounds__(256) pillar_conv_kernel(
    const T* __restrict__ feats, const int* __restrict__ nbr,
    const T* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ bias, const T* __restrict__ resid,
    const int* __restrict__ rows, const int* __restrict__ count,
    T* __restrict__ out, int p_in, int z_in, int cin, int z_out, int cout,
    int kz, int zs, int zpad, int relu) {
  constexpr int RM = 4, RN = 4, TK = 16;
  constexpr int TM = 4096 / TN;  // 256 threads of 4x4 outputs
  __shared__ int s_row[TM];
  __shared__ int s_zi0[TM];
  __shared__ int s_nbr[TM][KB];

  const int n_active = *count;
  const int r0 = blockIdx.x * TM;
  if (r0 >= n_active) return;
  const int n0 = blockIdx.y * TN;

  for (int r = threadIdx.x; r < TM; r += blockDim.x) {
    const int row = (r0 + r < n_active) ? rows[r0 + r] : -1;
    const int p = row >= 0 ? row / z_out : 0;
    const int zo = row >= 0 ? row - p * z_out : 0;
    s_row[r] = row;
    s_zi0[r] = zo * zs - zpad;
#pragma unroll
    for (int j = 0; j < KB; ++j) s_nbr[r][j] = row >= 0 ? nbr[p * KB + j] : p_in;
  }
  __syncthreads();

  const int K = kz * KB * cin;
  auto load_a = [&](int r, int k) -> float {
    const int t = k / cin;
    const int ci = k - t * cin;
    const int dz = t / KB;
    const int j = t - dz * KB;
    const int src = s_nbr[r][j];
    const int zi = s_zi0[r] + dz;
    if (src >= p_in || zi < 0 || zi >= z_in) return 0.f;
    return cmt_ld(feats + ((size_t)src * z_in + zi) * cin + ci);
  };
  auto load_b = [&](int k, int n) -> float {
    return (n0 + n < cout) ? cmt_ld(w + (size_t)k * cout + n0 + n) : 0.f;
  };
  float acc[RM][RN] = {};
  cmt_gemm_tile<TM, TN, RM, RN, TK>(acc, K, load_a, load_b);

  const int tx = threadIdx.x % (TN / RN);
  const int ty = threadIdx.x / (TN / RN);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = s_row[ty + i * (TM / RM)];
    if (row < 0) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = n0 + tx + j * (TN / RN);
      if (c >= cout) continue;
      float v = acc[i][j];
      if (scale) v *= scale[c];
      if (bias) v += bias[c];
      if (resid) v += cmt_ld(resid + (size_t)row * cout + c);
      if (relu) v = fmaxf(v, 0.f);
      cmt_st(out + (size_t)row * cout + c, v);
    }
  }
}

template <typename T, int KB>
static void launch_tn(const void* feats, const void* nbr, const void* w,
                      const void* scale, const void* bias, const void* resid,
                      const void* rows, const void* count, void* out,
                      int max_rows, int p_in, int z_in, int cin, int z_out,
                      int cout, int kz, int zs, int zpad, int relu,
                      cudaStream_t st) {
#define CMT_LAUNCH(TN_)                                                       \
  do {                                                                        \
    dim3 grid((max_rows + 4096 / TN_ - 1) / (4096 / TN_),                     \
              (cout + TN_ - 1) / TN_);                                        \
    pillar_conv_kernel<T, KB, TN_><<<grid, 256, 0, st>>>(                     \
        (const T*)feats, (const int*)nbr, (const T*)w, (const float*)scale,   \
        (const float*)bias, (const T*)resid, (const int*)rows,                \
        (const int*)count, (T*)out, p_in, z_in, cin, z_out, cout, kz, zs,     \
        zpad, relu);                                                          \
  } while (0)
  // output tile (rows x channels) by Cout: 256 x 16, 128 x 32, 64 x 64.
  // Wider tiles (128 x 128, 8 x 8 per thread) measured slower: the deep
  // stages have ~10k occupied rows, too few 128-row blocks to fill 132 SMs.
  if (cout <= 16)
    CMT_LAUNCH(16);
  else if (cout <= 32)
    CMT_LAUNCH(32);
  else
    CMT_LAUNCH(64);
#undef CMT_LAUNCH
}

template <int KB>
static int pillar_conv_entry(int dtype, const void* feats, const void* nbr,
                             const void* w, const void* scale,
                             const void* bias, const void* resid,
                             const void* rows, const void* count, void* out,
                             int max_rows, int p_in, int z_in, int cin,
                             int z_out, int cout, int kz, int zs, int zpad,
                             int relu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (max_rows <= 0) return (int)cudaGetLastError();
  if (dtype == CMT_DTYPE_F32)
    launch_tn<float, KB>(feats, nbr, w, scale, bias, resid, rows, count, out,
                         max_rows, p_in, z_in, cin, z_out, cout, kz, zs, zpad,
                         relu, st);
  else if (dtype == CMT_DTYPE_BF16)
    launch_tn<__nv_bfloat16, KB>(feats, nbr, w, scale, bias, resid, rows,
                                 count, out, max_rows, p_in, z_in, cin, z_out,
                                 cout, kz, zs, zpad, relu, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Output-site occupancy of a strided conv (spconv SparseConv3d site rule):
// occ_out[p, zo] = any input occupied in the receptive field.
__global__ void pillar_occ_fold_kernel(const uint8_t* __restrict__ occ_in,
                                       const int* __restrict__ nbr,
                                       uint8_t* __restrict__ occ_out, int p_in,
                                       int z_in, int p_out, int z_out, int kb,
                                       int kz, int zs, int zpad) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p_out * z_out) return;
  const int p = idx / z_out;
  const int zo = idx - p * z_out;
  uint8_t any = 0;
  for (int j = 0; j < kb; ++j) {
    const int src = nbr[p * kb + j];
    if (src >= p_in) continue;
    for (int dz = 0; dz < kz; ++dz) {
      const int zi = zo * zs + dz - zpad;
      if (zi >= 0 && zi < z_in && occ_in[(size_t)src * z_in + zi]) any = 1;
    }
  }
  occ_out[idx] = any;
}

extern "C" {

int cmt_pillar_conv_kb9(int dtype, const void* feats, const void* nbr,
                        const void* w, const void* scale, const void* bias,
                        const void* resid, const void* rows, const void* count,
                        void* out, int max_rows, int p_in, int z_in, int cin,
                        int z_out, int cout, int kz, int zs, int zpad, int relu,
                        void* stream) {
  return pillar_conv_entry<9>(dtype, feats, nbr, w, scale, bias, resid, rows,
                              count, out, max_rows, p_in, z_in, cin, z_out,
                              cout, kz, zs, zpad, relu, stream);
}

int cmt_pillar_conv_kb1(int dtype, const void* feats, const void* nbr,
                        const void* w, const void* scale, const void* bias,
                        const void* resid, const void* rows, const void* count,
                        void* out, int max_rows, int p_in, int z_in, int cin,
                        int z_out, int cout, int kz, int zs, int zpad, int relu,
                        void* stream) {
  return pillar_conv_entry<1>(dtype, feats, nbr, w, scale, bias, resid, rows,
                              count, out, max_rows, p_in, z_in, cin, z_out,
                              cout, kz, zs, zpad, relu, stream);
}

int cmt_pillar_occ_fold(const void* occ_in, const void* nbr, void* occ_out,
                        int p_in, int z_in, int p_out, int z_out, int kb,
                        int kz, int zs, int zpad, void* stream) {
  const int n = p_out * z_out;
  if (n > 0)
    pillar_occ_fold_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)occ_in, (const int*)nbr, (uint8_t*)occ_out, p_in, z_in,
        p_out, z_out, kb, kz, zs, zpad);
  return (int)cudaGetLastError();
}

}  // extern "C"
