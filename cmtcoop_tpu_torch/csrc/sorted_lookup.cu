// Sorted-key lookup: kernel 9 of the port.
//
// Replaces `_count_kernel` / `window_counts` (cmtcoop_tpu/ops/lookup_kernel.py),
// the compare-count inside `sorted_lookup` (cmtcoop_tpu/ops/sparse_utils.py)
// that every neighbour map of the pillar and voxel machinery bottoms out in.
// Entry point `cmt_sorted_lookup`.
//
// Function: for an int32 query q and d in [0, run], c_d = #{keys < q + d}
// over the whole sorted int32 key array (q + d in 64 bits; a sentinel query
// INT32_MAX stays INT32_MAX for every d); then pos[i, d] = c_d and
// hit[i, d] = (c_{d+1} > c_d) and q is no sentinel, for d < run. The TPU
// kernel counts inside a 128-query block's window of 512 keys and needs an
// overflow guard with an exact fallback; this search is exact at any
// density, so there is neither.
//
// What bounds it on the card: bytes, at the bound (keys and queries read
// once, pos and hit written once). The neighbour maps' query columns are not
// sorted (out-of-bounds taps are sentinels in the middle of a column), so
// each thread owns one query: a binary search of the keys for q, then for
// each d a galloping search from c_d for q + d + 1, which is one or two
// probes when the keys are distinct ids. The keys (at most 65536 on the main
// paths, 256 KB) stay in L2 and the top of the search tree in L1, so the
// searches cost cache latency; neighbouring queries probe neighbouring keys.
#include <limits.h>
#include <stdint.h>

#include <cuda_runtime.h>

// First index in [lo, hi) whose key is >= t, hi if none.
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int lo, int hi, long long t) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)__ldg(keys + mid) < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The same over [lo, n), probing lo, lo + 1, lo + 3, lo + 7, ... first.
__device__ __forceinline__ int gallop(const int* __restrict__ keys, int lo,
                                      int n, long long t) {
  int b = 1;
  while (lo + b <= n && (long long)__ldg(keys + lo + b - 1) < t) {
    lo += b;
    b <<= 1;
  }
  return lower_bound(keys, lo, min(lo + b - 1, n), t);
}

__global__ void __launch_bounds__(256) sorted_lookup_kernel(
    const int* __restrict__ keys, int n_keys, const int* __restrict__ queries,
    int n, int run, int* __restrict__ pos, uint8_t* __restrict__ hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int q = queries[i];
  const bool sentinel = q == INT_MAX;
  int c = lower_bound(keys, 0, n_keys, (long long)q);
  for (int d = 0; d < run; ++d) {
    const long long t = sentinel ? (long long)INT_MAX : (long long)q + d + 1;
    const int next = gallop(keys, c, n_keys, t);
    pos[(size_t)i * run + d] = c;
    hit[(size_t)i * run + d] = (!sentinel && next > c) ? 1 : 0;
    c = next;
  }
}

extern "C" {

int cmt_sorted_lookup(const void* keys, int n_keys, const void* queries, int n,
                      int run, void* pos, void* hit, void* stream) {
  if (n > 0)
    sorted_lookup_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const int*)keys, n_keys, (const int*)queries, n, run, (int*)pos,
        (uint8_t*)hit);
  return (int)cudaGetLastError();
}

}  // extern "C"
