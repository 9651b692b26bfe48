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
//     before the ReLU (`conv3x3_cf(residual=...)`), the template flag RESID
//     below: one more read in the epilogue.
//
// Epilogue order, as in the TPU kernel: acc * scale + bias, + residual,
// then ReLU, in float32; one store in the input's dtype.
//
// Both routes read the weight packed once by the wrapper
// (ops/conv_cf.py `pack_conv3x3_weight`): (Cout, 9 * cin_pad), K-major, K
// index tap * cin_pad + ci with tap = dy * 3 + dx and zeros for ci >= Cin,
// cin_pad = Cin rounded up to CHUNK. The dtype picks the route, explicitly:
//
// bfloat16 -> `conv3x3_tc_kernel`, an implicit GEMM on the tensor cores:
// M = N*H*W output pixels, N = Cout, K = 9 * cin_pad.
//   What bounds it: arithmetic. The head's conv is 38 GMAC (0.077 ms at the
//   card's 989 TFLOP/s) against 33 MB of input (0.010 ms at 3.35 TB/s); the
//   VoVNet convs have the same ratio or higher. So the design feeds wgmma:
//   - A by TMA: a 4D tensor map over the NHWC input (C, W, H, N); K step
//     (tap, chunk) loads the box (64 channels, 16 x, 4 or 8 y, 1 image) at
//     (c0, x0 + dx - 1, y0 + dy - 1, n). TMA zero-fills what lies outside
//     the image (negative coordinates included) and the channels past Cin,
//     so no padded copy is ever written and ragged edges cost nothing. The
//     box is one 128-byte row per pixel with the 128-byte swizzle, the
//     K-major layout wgmma reads.
//   - B by a 2D TMA map over the packed weight, box (64, BN), same swizzle.
//     BN is Cout rounded up to one of WIDTHS (one wgmma of that width per
//     16-deep K slice), so one block covers all of Cout and every A tile is
//     read once; Cout > 256 raises (no caller has one). The weight's map is
//     fixed per pack: `cmt_conv3x3_tc_weight_map` encodes it once and the
//     wrapper keeps it beside the packed weight, so a launch encodes only
//     the input's map.
//   - a ring of STAGES (A, B) buffers with full/empty mbarriers: one
//     producer warp (one thread of it) keeps the TMA loads in flight; WG
//     consumer warpgroups (64 output rows each) run wgmma asynchronously
//     and free a stage once the wgmma after it has been issued
//     (wait_group 1). With a lone producer warp the block's launch bound
//     leaves every thread 224 (WG = 2) or 200 (WG = 1, two blocks per SM)
//     registers, room for a 256-wide accumulator (128 floats a thread)
//     with no setmaxnreg.
//   - filling the card: the wrapper's plan (`conv3x3_plan`) takes WG = 2
//     (128-pixel 8x16 boxes, one block per SM) when that grid fills a
//     wave, else WG = 1 (64-pixel 4x16 boxes, two blocks per SM): stage
//     4's 40x100 views give 70 / 210 blocks instead of 35 / 105. No
//     split-K: stage 5 (20x50) stays under a wave, but its convs are ~1%
//     of the FLOPs.
//   - the epilogue reads scale, bias (and the residual) and writes bf16
//     pairs straight from the accumulator registers, clipped at the image
//     and channel edges.
//   Not done yet: a persistent grid that overlaps one tile's epilogue with
//   the next tile's loads, a TMA store of the output, 32-channel chunks for
//   Cin 160 and 224 (the zero-filled tail of the last 64-channel chunk
//   wastes 17% and 12.5% of their K).
//   It needs Cin and Cout multiples of 8 (TMA's 16-byte strides, bf16
//   pairs in the epilogue): the wrapper raises on anything else.
//
// float32 -> `conv3x3_f32_kernel`, the first version of the port on the
// CUDA cores (the float32 checks only: chip_smoke's small detectors and its
// float32 cases, the card tests): 128 x 128 output tiles of 8 x 8 a thread
// over 16-deep K tiles staged in shared memory, A gathered from the 3x3
// neighbourhood with zeros outside the image.
//
// The TPU kernel's channels-first lane layout, row tiles, DMA ring and lane
// rolls have no counterpart.
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

// ---------------------------- float32 route -------------------------------

template <bool RESID>
__global__ void __launch_bounds__(256) conv3x3_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ resid, float* __restrict__ out, int n, int h,
    int wd, int cin, int cin_pad, int cout, int relu) {
  constexpr int TM = 128, TN = 128, RM = 8, RN = 8, TK = 16;
  __shared__ int s_n[TM], s_y[TM], s_x[TM];
  const int m_total = n * h * wd;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const size_t k_pad = (size_t)9 * cin_pad;
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
    return x[(((size_t)b * h + yy) * wd + xx) * cin + ci];
  };
  auto load_b = [&](int k, int c) -> float {
    if (n0 + c >= cout) return 0.f;
    const int tap = k / cin;
    return w[(size_t)(n0 + c) * k_pad + tap * cin_pad + (k - tap * cin)];
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
      if (RESID) v += resid[o];
      if (relu) v = fmaxf(v, 0.f);
      out[o] = v;
    }
  }
}

// `resid` NULL selects kernel 4, non-NULL kernel 5 (same shape as `out`).
extern "C" int cmt_conv3x3_bn_relu_f32(const void* x, const void* w,
                                       const void* scale, const void* bias,
                                       const void* resid, void* out, int n,
                                       int h, int wd, int cin, int cin_pad,
                                       int cout, int relu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int m_total = n * h * wd;
  if (m_total <= 0) return (int)cudaGetLastError();
  dim3 grid((m_total + 127) / 128, (cout + 127) / 128);
  if (resid != nullptr)
    conv3x3_f32_kernel<true><<<grid, 256, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)scale,
        (const float*)bias, (const float*)resid, (float*)out, n, h, wd, cin,
        cin_pad, cout, relu);
  else
    conv3x3_f32_kernel<false><<<grid, 256, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)scale,
        (const float*)bias, nullptr, (float*)out, n, h, wd, cin, cin_pad,
        cout, relu);
  return (int)cudaGetLastError();
}

// --------------------------- bfloat16 route --------------------------------

namespace conv_tc {

constexpr int CHUNK = 64;  // input channels per K step: one 128-byte row
constexpr int BOX_W = 16;  // output pixels along x per tile row

template <int BN, int WG>
struct Cfg {
  static constexpr int BM = 64 * WG;      // output pixels per block
  static constexpr int BOX_H = 4 * WG;    // their rows: BOX_H x BOX_W
  static constexpr int A_BYTES = BM * CHUNK * 2;
  static constexpr int B_BYTES = BN * CHUNK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // WG = 2: one block per SM; WG = 1: two blocks per SM
  static constexpr int BUDGET = WG == 2 ? 200 * 1024 : 108 * 1024;
  static constexpr int FIT = BUDGET / STAGE;
  static constexpr int STAGES = FIT > 6 ? 6 : (FIT < 2 ? 2 : FIT);
  // 1024 for aligning the swizzled tiles, then the ring, then its barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static constexpr int THREADS = 128 * WG + 32;  // + the producer warp
};

template <int BN, int WG, bool RESID>
__global__ void __launch_bounds__(128 * WG + 32, WG == 1 ? 2 : 1)
    conv3x3_tc_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ resid,
                      __nv_bfloat16* __restrict__ out, int h, int wd,
                      int cout, int tiles_w, int tiles_h, int chunks,
                      int relu) {
  using C = Cfg<BN, WG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (cmt_smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_ring = base;
  const uint32_t b_ring = a_ring + C::STAGES * C::A_BYTES;
  const uint32_t full = b_ring + C::STAGES * C::B_BYTES;  // 8 B a barrier
  const uint32_t empty = full + C::STAGES * 8;

  int t = blockIdx.x;
  const int x0 = (t % tiles_w) * BOX_W;
  t /= tiles_w;
  const int y0 = (t % tiles_h) * C::BOX_H;
  const int img = t / tiles_h;
  const int ksteps = 9 * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      cmt_mbar_init(full + 8 * s, 1);
      cmt_mbar_init(empty + 8 * s, 128 * WG);
    }
    cmt_mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WG) {
    // the producer warp: one thread issues every TMA load
    if (threadIdx.x == 128 * WG) {
      for (int k = 0; k < ksteps; ++k) {
        const int s = k % C::STAGES;
        cmt_mbar_wait(empty + 8 * s, ((k / C::STAGES) & 1) ^ 1);
        const int tap = k / chunks;
        const int c0 = (k - tap * chunks) * CHUNK;
        const int dy = tap / 3, dx = tap - 3 * dy;
        cmt_mbar_expect_tx(full + 8 * s, C::STAGE);
        cmt_tma_load_4d(a_ring + s * C::A_BYTES, &tm_x, full + 8 * s, c0,
                        x0 + dx - 1, y0 + dy - 1, img);
        cmt_tma_load_2d(b_ring + s * C::B_BYTES, &tm_w, full + 8 * s,
                        tap * chunks * CHUNK + c0, 0);
      }
    }
  } else {
    // consumer warpgroup `wg`: output rows wg*64 .. wg*64 + 63 of the tile
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const uint32_t a_rows = wg * 64 * (CHUNK * 2);
    for (int k = 0; k < ksteps; ++k) {
      const int s = k % C::STAGES;
      cmt_mbar_wait(full + 8 * s, (k / C::STAGES) & 1);
      const uint64_t da = cmt_sw128_desc(a_ring + s * C::A_BYTES + a_rows);
      const uint64_t db = cmt_sw128_desc(b_ring + s * C::B_BYTES);
      cmt_fence_regs(acc);
      cmt_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk)  // 32 B = 2 descriptor units
        Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
      cmt_wgmma_commit();
      cmt_wgmma_wait<1>();
      cmt_fence_regs(acc);
      // the wgmma of step k - 1 has finished reading its stage
      if (k > 0) cmt_mbar_arrive(empty + 8 * ((k - 1) % C::STAGES));
    }
    cmt_wgmma_wait<0>();
    cmt_fence_regs(acc);

    // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
    // 16w + lane/4 (+ 8); register 4j + 2hh + e is column 8j + 2(lane%4) + e
    // of row half hh. A warp's 16 rows are one tile row of 16 pixels.
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int y = y0 + wg * 4 + warp;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int xx = x0 + lane / 4 + 8 * hh;
      if (y >= h || xx >= wd) continue;
      const size_t row = (((size_t)img * h + y) * wd + xx) * cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        if (c >= cout) continue;
        float v0 = acc[4 * j + 2 * hh] * scale[c] + bias[c];
        float v1 = acc[4 * j + 2 * hh + 1] * scale[c + 1] + bias[c + 1];
        if (RESID) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(resid + row + c);
          v0 += __low2float(r);
          v1 += __high2float(r);
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + row + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// the dynamic shared memory limit of one instantiation, raised once per
// device (an attribute of the function in the current device's context)
template <int BN, int WG, bool RESID>
static cudaError_t allow_smem() {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(conv3x3_tc_kernel<BN, WG, RESID>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<BN, WG>::SMEM);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <int BN, int WG, bool RESID>
static int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                  const void* scale, const void* bias, const void* resid,
                  void* out, int n, int h, int wd, int cin_pad, int cout,
                  int tiles_w, int relu, cudaStream_t st) {
  using C = Cfg<BN, WG>;
  cudaError_t err = allow_smem<BN, WG, RESID>();
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (h + C::BOX_H - 1) / C::BOX_H;
  conv3x3_tc_kernel<BN, WG, RESID>
      <<<n * tiles_h * tiles_w, C::THREADS, C::SMEM, st>>>(
          tm_x, tm_w, (const float*)scale, (const float*)bias,
          (const __nv_bfloat16*)resid, (__nv_bfloat16*)out, h, wd, cout,
          tiles_w, tiles_h, cin_pad / CHUNK, relu);
  return (int)cudaGetLastError();
}

template <int BN>
static int launch_wg(int wg, const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                     const void* scale, const void* bias, const void* resid,
                     void* out, int n, int h, int wd, int cin_pad, int cout,
                     int tiles_w, int relu, cudaStream_t st) {
#define CMT_CONV_TC_LAUNCH(WG, RESID)                                        \
  return launch<BN, WG, RESID>(tm_x, tm_w, scale, bias, resid, out, n, h, wd, \
                               cin_pad, cout, tiles_w, relu, st)
  if (wg == 1) {
    if (resid != nullptr) CMT_CONV_TC_LAUNCH(1, true);
    CMT_CONV_TC_LAUNCH(1, false);
  }
  if (resid != nullptr) CMT_CONV_TC_LAUNCH(2, true);
  CMT_CONV_TC_LAUNCH(2, false);
#undef CMT_CONV_TC_LAUNCH
}

static bool valid_width(int bn) {
  return bn == 64 || bn == 128 || bn == 160 || bn == 192 || bn == 224 ||
         bn == 256;
}

}  // namespace conv_tc

// The packed weight's tensor map: (Cout, 9 * cin_pad) bf16, box (CHUNK, bn)
// with the 128-byte swizzle, zeros for the rows past Cout; written to the
// 128 bytes at `map_out` (host memory), which the launches below read.
extern "C" int cmt_conv3x3_tc_weight_map(const void* w, int cin_pad,
                                         int cout, int bn, void* map_out) {
  using namespace conv_tc;
  if (cin_pad <= 0 || cin_pad % CHUNK || cout <= 0 || cout % 8 ||
      !valid_width(bn) || cout > bn)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)9 * cin_pad, (cuuint64_t)cout};
  const cuuint64_t strides[1] = {(cuuint64_t)9 * cin_pad * 2};
  const cuuint32_t box[2] = {CHUNK, (cuuint32_t)bn};
  CUtensorMap map;
  if (!cmt_bf16_map(&map, w, 2, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  memcpy(map_out, &map, sizeof(map));
  return (int)cudaSuccess;
}

// The launch plan (bn, wg, tiles_w, tiles_h) comes from ops/conv_cf.py
// `conv3x3_plan` and is checked here against this source's tile geometry:
// tiles of (4 * wg) x BOX_W pixels covering the image exactly, one block
// over all of Cout. `w_map` is the weight's map from
// `cmt_conv3x3_tc_weight_map` (made with the same bn). `resid` NULL
// selects kernel 4, non-NULL kernel 5. All tensors bf16 except scale and
// bias (float32).
extern "C" int cmt_conv3x3_bn_relu_tc(const void* x, const void* w_map,
                                      const void* scale, const void* bias,
                                      const void* resid, void* out, int n,
                                      int h, int wd, int cin, int cin_pad,
                                      int cout, int bn, int wg, int tiles_w,
                                      int tiles_h, int relu, void* stream) {
  using namespace conv_tc;
  cudaStream_t st = (cudaStream_t)stream;
  if (n * h * wd <= 0) return (int)cudaGetLastError();
  if (cin % 8 || cout % 8 || cin_pad % CHUNK || cin_pad < cin ||
      cin_pad - cin >= CHUNK || !valid_width(bn) || cout > bn ||
      (wg != 1 && wg != 2) || tiles_w != (wd + BOX_W - 1) / BOX_W ||
      tiles_h != (h + 4 * wg - 1) / (4 * wg))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w;
  memcpy(&tm_w, w_map, sizeof(tm_w));
  const cuuint64_t x_dims[4] = {(cuuint64_t)cin, (cuuint64_t)wd,
                                (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t x_strides[3] = {(cuuint64_t)cin * 2,
                                   (cuuint64_t)wd * cin * 2,
                                   (cuuint64_t)h * wd * cin * 2};
  const cuuint32_t x_box[4] = {CHUNK, BOX_W, (cuuint32_t)(4 * wg), 1};
  if (!cmt_bf16_map(&tm_x, x, 4, x_dims, x_strides, x_box))
    return (int)cudaErrorInvalidValue;
#define CMT_CONV_TC(BN)                                                     \
  case BN:                                                                  \
    return launch_wg<BN>(wg, tm_x, tm_w, scale, bias, resid, out, n, h, wd, \
                         cin_pad, cout, tiles_w, relu, st);
  switch (bn) {
    CMT_CONV_TC(64)
    CMT_CONV_TC(128)
    CMT_CONV_TC(160)
    CMT_CONV_TC(192)
    CMT_CONV_TC(224)
    CMT_CONV_TC(256)
  }
#undef CMT_CONV_TC
  return (int)cudaErrorInvalidValue;
}
