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
// The array is copied as one flat run of words: 16 bytes when the total
// and both pointers allow it (4 or 1 otherwise), one word a thread, blocks
// of 1024 threads, so that the block scheduler keeps as many loads in
// flight as the SMs hold and no thread loops. At (40960, 768) in bf16 and
// float32 this matched clone() where more words a thread, persistent
// grid-stride loops, streaming cache hints and TMA bulk copies through
// shared memory were slower (chip_smoke.py times it beside clone()).
#include <stdint.h>

#include <cuda_runtime.h>

constexpr int kThreads = 1024;

template <typename V>
__global__ void __launch_bounds__(kThreads) rows_copy_kernel(
    const V* __restrict__ src, V* __restrict__ dst, long long n) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e < n) dst[e] = src[e];
}

template <typename V>
static int rows_copy_launch(const void* src, void* dst, long long bytes,
                            cudaStream_t stream) {
  const long long n = bytes / (long long)sizeof(V);
  rows_copy_kernel<V><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                        0, stream>>>((const V*)src, (V*)dst, n);
  return (int)cudaGetLastError();
}

extern "C" {

int cmt_rows_copy(const void* src, void* dst, long long rows,
                  long long row_bytes, void* stream) {
  if (rows <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  const long long bytes = rows * row_bytes;
  const uintptr_t a = (uintptr_t)src | (uintptr_t)dst;
  cudaStream_t s = (cudaStream_t)stream;
  if (bytes % 16 == 0 && a % 16 == 0)
    return rows_copy_launch<uint4>(src, dst, bytes, s);
  if (bytes % 4 == 0 && a % 4 == 0)
    return rows_copy_launch<uint32_t>(src, dst, bytes, s);
  return rows_copy_launch<uint8_t>(src, dst, bytes, s);
}

}  // extern "C"
