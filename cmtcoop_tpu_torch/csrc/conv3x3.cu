// 3x3, stride 1, pad 1 convolution with folded eval BatchNorm, an optional
// residual and ReLU on NHWC tensors: kernels 4 and 5 of the port.
//
// Replaces (cmtcoop_tpu/ops/conv_cf.py, both reached through `conv3x3_cf`):
//   - `_conv_kernel` (kernel 4): the head's BEV `shared_conv` (through
//     `conv_bn_relu_cf`, cmtcoop_tpu/models/layers.py), (1, 180, 180, 512)
//     -> 256 channels, and every VoVNet OSA 3x3 conv (`_osa_cf`,
//     cmtcoop_tpu/models/vovnet_cf.py), 128-224 channels at 160x400 down to
//     20x50 per view;
//   - `_conv_kernel_resid` (kernel 5): the same conv with a residual added
//     before the ReLU (`conv3x3_cf(residual=...)`). It is the template flag
//     RESID below, one more pointer read in the epilogue.
//
// Epilogue order, as in the TPU kernel: acc * scale + bias, + residual,
// then ReLU.
//
// What bounds it on the card: arithmetic. At the head's shape it is an
// implicit GEMM of M = 32400 pixels, N = 256, K = 9 * 512 (38 GMAC), while
// the input is 33 MB in bf16; the VoVNet convs are the same GEMM with
// M = V*H*W up to 192000 and K = 9 * Cin. The design reads the NHWC input
// directly, forming each 128 x 16 A tile in shared memory from the 3x3
// neighbourhood (zero outside the image, so no padded copy is written),
// holds a 128 x 128 output tile in registers (8 x 8 per thread) so every
// loaded element feeds eight multiply-adds, and applies scale, bias, the
// residual and ReLU before the one store. At Cout 160/192/224 the second
// 128-wide N tile is partly idle. The TPU kernel's channels-first lane
// layout, row tiles, DMA ring and lane rolls have no counterpart. This
// first version runs on the CUDA cores in fp32; tensor cores (wgmma) are
// later work.
#include "common.cuh"

template <typename T, bool RESID>
__global__ void __launch_bounds__(256) conv3x3_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const T* __restrict__ resid, T* __restrict__ out, int n, int h, int wd,
    int cin, int cout, int relu) {
  constexpr int TM = 128, TN = 128, RM = 8, RN = 8, TK = 16;
  __shared__ int s_n[TM], s_y[TM], s_x[TM];
  const int m_total = n * h * wd;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  for (int r = threadIdx.x; r < TM; r += blockDim.x) {
    const int m = m0 + r;
    if (m < m_total) {
      const int b = m / (h * wd);
      const int rem = m - b * h * wd;
      s_n[r] = b;
      s_y[r] = rem / wd;
      s_x[r] = rem - (rem / wd) * wd;
    } else {
      s_n[r] = -1;
      s_y[r] = 0;
      s_x[r] = 0;
    }
  }
  __syncthreads();

  auto load_a = [&](int r, int k) -> float {
    const int b = s_n[r];
    if (b < 0) return 0.f;
    const int tap = k / cin;
    const int ci = k - tap * cin;
    const int dy = tap / 3;
    const int yy = s_y[r] + dy - 1;
    const int xx = s_x[r] + (tap - dy * 3) - 1;
    if (yy < 0 || yy >= h || xx < 0 || xx >= wd) return 0.f;
    return cmt_ld(x + (((size_t)b * h + yy) * wd + xx) * cin + ci);
  };
  auto load_b = [&](int k, int c) -> float {
    return (n0 + c < cout) ? cmt_ld(w + (size_t)k * cout + n0 + c) : 0.f;
  };
  float acc[RM][RN] = {};
  cmt_gemm_tile<TM, TN, RM, RN, TK>(acc, 9 * cin, load_a, load_b);

  const int tx = threadIdx.x % (TN / RN);
  const int ty = threadIdx.x / (TN / RN);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty + i * (TM / RM);
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = n0 + tx + j * (TN / RN);
      if (c >= cout) continue;
      const size_t o = (size_t)m * cout + c;
      float v = acc[i][j] * scale[c] + bias[c];
      if (RESID) v += cmt_ld(resid + o);
      if (relu) v = fmaxf(v, 0.f);
      cmt_st(out + o, v);
    }
  }
}

template <typename T>
static void launch_conv3x3(dim3 grid, cudaStream_t st, const void* x,
                           const void* w, const void* scale, const void* bias,
                           const void* resid, void* out, int n, int h, int wd,
                           int cin, int cout, int relu) {
  if (resid != nullptr)
    conv3x3_kernel<T, true><<<grid, 256, 0, st>>>(
        (const T*)x, (const T*)w, (const float*)scale, (const float*)bias,
        (const T*)resid, (T*)out, n, h, wd, cin, cout, relu);
  else
    conv3x3_kernel<T, false><<<grid, 256, 0, st>>>(
        (const T*)x, (const T*)w, (const float*)scale, (const float*)bias,
        nullptr, (T*)out, n, h, wd, cin, cout, relu);
}

// `resid` NULL selects kernel 4, non-NULL kernel 5 (same shape as `out`).
extern "C" int cmt_conv3x3_bn_relu(int dtype, const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   const void* resid, void* out, int n, int h,
                                   int wd, int cin, int cout, int relu,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int m_total = n * h * wd;
  if (m_total <= 0) return (int)cudaGetLastError();
  dim3 grid((m_total + 127) / 128, (cout + 127) / 128);
  if (dtype == CMT_DTYPE_F32)
    launch_conv3x3<float>(grid, st, x, w, scale, bias, resid, out, n, h, wd,
                          cin, cout, relu);
  else if (dtype == CMT_DTYPE_BF16)
    launch_conv3x3<__nv_bfloat16>(grid, st, x, w, scale, bias, resid, out, n,
                                  h, wd, cin, cout, relu);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
