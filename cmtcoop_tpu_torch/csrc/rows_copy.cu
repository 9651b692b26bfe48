// Row-layout pin: kernel 10 of the port.
//
// Replaces the identity kernel of `_pin_rows_layout`
// (cmtcoop_tpu/ops/pillar_fused.py:59, body :73), which copies (P, W) packed
// rows block by block so that XLA keeps them row-major on the cold fallback
// branch of `fused_pillar_conv`. Entry point `cmt_rows_copy`.
//
// Function: dst = src for a contiguous (rows, row_bytes) array of any
// element type, into a new row-major array. The port's pillar kernels
// gather through the neighbour map and take no fallback branch, so no path
// of the port runs this kernel; it is held against `clone()`.
//
// What bounds it on the card: bytes (each byte read once and written once).
// Each block copies a block of whole rows, about 16 KB, with 16-byte vector
// loads and stores when the row bytes and both pointers allow it (4-byte or
// 1-byte words otherwise); consecutive threads touch consecutive words.
#include <stdint.h>

#include <cuda_runtime.h>

template <typename V>
__global__ void __launch_bounds__(256) rows_copy_kernel(
    const V* __restrict__ src, V* __restrict__ dst, long long rows,
    long long row_words, long long rows_per_block) {
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long nr =
      rows - r0 < rows_per_block ? rows - r0 : rows_per_block;
  const long long n = nr * row_words;
  const V* s = src + r0 * row_words;
  V* d = dst + r0 * row_words;
  const long long bd = blockDim.x;
  long long e = threadIdx.x;
  // four loads in flight per thread before their stores
  for (; e + 3 * bd < n; e += 4 * bd) {
    const V a0 = s[e], a1 = s[e + bd], a2 = s[e + 2 * bd], a3 = s[e + 3 * bd];
    d[e] = a0;
    d[e + bd] = a1;
    d[e + 2 * bd] = a2;
    d[e + 3 * bd] = a3;
  }
  for (; e < n; e += bd) d[e] = s[e];
}

template <typename V>
static int rows_copy_launch(const void* src, void* dst, long long rows,
                            long long row_bytes, cudaStream_t stream) {
  const long long rpb =
      row_bytes >= 16384 ? 1 : 16384 / (row_bytes > 0 ? row_bytes : 1);
  const long long blocks = (rows + rpb - 1) / rpb;
  rows_copy_kernel<V><<<(unsigned)blocks, 256, 0, stream>>>(
      (const V*)src, (V*)dst, rows, row_bytes / (long long)sizeof(V), rpb);
  return (int)cudaGetLastError();
}

extern "C" {

int cmt_rows_copy(const void* src, void* dst, long long rows,
                  long long row_bytes, void* stream) {
  if (rows <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  const uintptr_t a = (uintptr_t)src | (uintptr_t)dst;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && a % 16 == 0)
    return rows_copy_launch<uint4>(src, dst, rows, row_bytes, s);
  if (row_bytes % 4 == 0 && a % 4 == 0)
    return rows_copy_launch<uint32_t>(src, dst, rows, row_bytes, s);
  return rows_copy_launch<uint8_t>(src, dst, rows, row_bytes, s);
}

}  // extern "C"
