// One-warpgroup products that check, on the card, the Hopper primitives of
// hopper.cuh that the bf16 flash kernels (kernels 3 and 8) are built on,
// each on its own before any flash loop uses it. The operands are
// row-major bf16 of 64-byte rows (32 columns, one attention head), loaded
// by TMA with the 64-byte swizzle; the results are float32, row-major.
// tests/test_torch_kernels.py holds each against torch.matmul.
//   which 0: d (64 x 32) = a (64 x 32) b^T, b (32 x 32): Wgmma<32>, both
//            operands K-major (cmt_sw64_desc), two 16-deep slices (+32 B);
//   which 1: d (64 x 32) = a (64 x 32) b, b (32 x 32): Wgmma<32> with B
//            MN-major (cmt_sw64_mn_desc, tnspB), two slices (+1024 B);
//   which 2: x (64 x 64) = a (64 x 32) b^T, b (64 x 32): Wgmma<64> on
//            64-byte rows (the flash kernels' score product), then
//            d (64 x 32) = bf16(x) c, c (64 x 32): the register-A form,
//            x's accumulators repacked to bf16 A fragments, c MN-major.
//   which 3: the pillar convs' A path (csrc/pillar_conv.cu): d (64 x 16) =
//            g (64 x 64) b^T, b (16 x 64) by TMA with the 128-byte
//            swizzle, g's row r = a[idx[r]] (a: 64 rows of 64 bf16, idx
//            int32 in c), gathered by cp.async in 16-byte pieces into the
//            same swizzle, a zero row where idx[r] < 0 (src-size 0); then
//            the proxy fence, the block barrier and Wgmma<16>, four
//            16-deep slices (+32 B each) of cmt_sw128_desc.
#include <string.h>

#include "hopper.cuh"

namespace {

struct Maps {
  CUtensorMap a, b, c;
};

template <int WHICH>
__global__ void __launch_bounds__(128)
    wgmma_selftest_kernel(const __grid_constant__ Maps maps, int b_rows,
                          float* __restrict__ d, float* __restrict__ x) {
  __shared__ uint8_t raw_s[4 * 4096];
  const uint32_t raw = cmt_smem_addr(raw_s);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ta = base, tb = base + 4096, tc = base + 8192;
  const uint32_t bar = base + 12288;
  if (threadIdx.x == 0) {
    cmt_mbar_init(bar, 1);
    cmt_mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    cmt_mbar_expect_tx(bar, 4096 + b_rows * 64 + (WHICH == 2 ? 4096 : 0));
    cmt_tma_load_2d(ta, &maps.a, bar, 0, 0);
    cmt_tma_load_2d(tb, &maps.b, bar, 0, 0);
    if (WHICH == 2) cmt_tma_load_2d(tc, &maps.c, bar, 0, 0);
  }
  cmt_mbar_wait(bar, 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  const uint64_t ad = cmt_sw64_desc(ta);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  if constexpr (WHICH == 0) {
    const uint64_t bd = cmt_sw64_desc(tb);
    cmt_fence_regs(acc);
    cmt_wgmma_fence();
    Wgmma<32>::mma<0>(acc, ad, bd, 0);
    Wgmma<32>::mma<0>(acc, ad + 2, bd + 2);
    cmt_wgmma_commit();
    cmt_wgmma_wait<0>();
    cmt_fence_regs(acc);
  } else if constexpr (WHICH == 1) {
    const uint64_t bd = cmt_sw64_mn_desc(tb);
    cmt_fence_regs(acc);
    cmt_wgmma_fence();
    Wgmma<32>::mma<1>(acc, ad, bd, 0);
    Wgmma<32>::mma<1>(acc, ad + 2, bd + 64);
    cmt_wgmma_commit();
    cmt_wgmma_wait<0>();
    cmt_fence_regs(acc);
  } else {
    float xs[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) xs[i] = 0.f;
    const uint64_t bd = cmt_sw64_desc(tb);
    cmt_fence_regs(xs);
    cmt_wgmma_fence();
    Wgmma<64>::mma(xs, ad, bd, 0);
    Wgmma<64>::mma(xs, ad + 2, bd + 2);
    cmt_wgmma_commit();
    cmt_wgmma_wait<0>();
    cmt_fence_regs(xs);
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = cmt_pack_bf16(xs[8 * kk + 2 * r], xs[8 * kk + 2 * r + 1]);
    const uint64_t cd = cmt_sw64_mn_desc(tc);
    cmt_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      cmt_wgmma_rs32(acc, pa[kk], cd + 64 * kk, kk > 0);
    cmt_wgmma_commit();
    cmt_wgmma_wait<0>();
    cmt_fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) cmt_fence_regs(pa[kk]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[(r0 + 8 * (e >> 1)) * 64 + 8 * j + c0 + (e & 1)] = xs[4 * j + e];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d[(r0 + 8 * (e >> 1)) * 32 + 8 * j + c0 + (e & 1)] = acc[4 * j + e];
}

// which 3: one warpgroup, its A gathered by cp.async
__global__ void __launch_bounds__(128)
    gather_selftest_kernel(const __grid_constant__ CUtensorMap map_b,
                           const __nv_bfloat16* __restrict__ a,
                           const int* __restrict__ idx,
                           float* __restrict__ d) {
  __shared__ uint8_t raw_s[1024 + 8192 + 2048 + 8];
  const uint32_t ta = (cmt_smem_addr(raw_s) + 1023u) & ~1023u;
  const uint32_t tb = ta + 8192, bar = tb + 2048;
  if (threadIdx.x == 0) {
    cmt_mbar_init(bar, 1);
    cmt_mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    cmt_mbar_expect_tx(bar, 2048);
    cmt_tma_load_2d(tb, &map_b, bar, 0, 0);
  }
  // two threads a row, pieces h, h + 2, h + 4, h + 6
  const int r = threadIdx.x / 2, h = threadIdx.x % 2;
  const int src = idx[r];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = h + 2 * i;
    cmt_cp_async16(ta + cmt_sw128_offset(r, q),
                   a + (src >= 0 ? src : 0) * 64 + 8 * q, src >= 0 ? 16 : 0);
  }
  cmt_cp_async_commit();
  cmt_cp_async_wait<0>();
  cmt_fence_proxy_async();
  __syncthreads();
  cmt_mbar_wait(bar, 0);

  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  const uint64_t da = cmt_sw128_desc(ta), db = cmt_sw128_desc(tb);
  cmt_fence_regs(acc);
  cmt_wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Wgmma<16>::mma(acc, da + 2 * kk, db + 2 * kk);
  cmt_wgmma_commit();
  cmt_wgmma_wait<0>();
  cmt_fence_regs(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d[(r0 + 8 * (e >> 1)) * 16 + 8 * j + c0 + (e & 1)] = acc[4 * j + e];
}

bool row_map(CUtensorMap* map, const void* ptr, int rows) {
  const cuuint64_t dims[2] = {32, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {64};
  const cuuint32_t box[2] = {32, (cuuint32_t)rows};
  return (size_t)ptr % 16 == 0 &&
         cmt_bf16_map(map, ptr, 2, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace

// a, b, c bf16 row-major (c only for which 2), d float32 (64, 32), x float32
// (64, 64) for which 2; which 3: a (64, 64) and b (16, 64) bf16, c the
// int32 row map (64,), d float32 (64, 16). One block of one warpgroup on
// `stream`.
extern "C" int cmt_wgmma_selftest(int which, const void* a, const void* b,
                                  const void* c, void* d, void* x,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (which == 3) {
    CUtensorMap map_b;
    const cuuint64_t dims[2] = {64, 16};
    const cuuint64_t strides[1] = {128};
    const cuuint32_t box[2] = {64, 16};
    if ((size_t)a % 16 || (size_t)b % 16 ||
        !cmt_bf16_map(&map_b, b, 2, dims, strides, box))
      return (int)cudaErrorInvalidValue;
    gather_selftest_kernel<<<1, 128, 0, st>>>(
        map_b, (const __nv_bfloat16*)a, (const int*)c, (float*)d);
    return (int)cudaGetLastError();
  }
  const int b_rows = which == 2 ? 64 : 32;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (which < 0 || which > 2 || !row_map(&maps.a, a, 64) ||
      !row_map(&maps.b, b, b_rows) ||
      (which == 2 && !row_map(&maps.c, c, 64)))
    return (int)cudaErrorInvalidValue;
  float* df = (float*)d;
  float* xf = (float*)x;
  if (which == 0)
    wgmma_selftest_kernel<0><<<1, 128, 0, st>>>(maps, b_rows, df, xf);
  else if (which == 1)
    wgmma_selftest_kernel<1><<<1, 128, 0, st>>>(maps, b_rows, df, xf);
  else
    wgmma_selftest_kernel<2><<<1, 128, 0, st>>>(maps, b_rows, df, xf);
  return (int)cudaGetLastError();
}
