// Fused neighbour map: kernel 9 of the port.
//
// Replaces `_count_kernel` / `window_counts` (cmtcoop_tpu/ops/lookup_kernel.py),
// the compare-count inside `sorted_lookup` (cmtcoop_tpu/ops/sparse_utils.py)
// that every neighbour map of the pillar and voxel machinery bottoms out in,
// together with the query formation and the select around it. Entry point
// `cmt_neighbor_map`.
//
// Function: output sites (coords (n_out, dims) int32, z y x or y x, and a
// mask) over an input grid of extent (D, H, W) (D = 1 for a 2-D grid) whose
// active cells are the sorted int32 linear ids `keys` (an INT32_MAX tail on
// padding rows). Tap k = (kz_, ky_, kx_), row-major over the kernel, reads
// the cell src = coords * stride + k - pad; map[o, k] is the row of `keys`
// holding lin(src) = (z * H + y) * W + x when the site is valid, src is in
// bounds and the key is present, else n_keys. The first such row, as
// `torch.searchsorted` gives it; exact at any density.
//
// What bounds it on the card: the bytes are small (keys, coords and mask
// read once, the map written once; 8 MB and 2.4 us at the largest map),
// and what the kernel spends is the latency of dependent key probes and of
// its block's phases. Its design:
// - no query array: a lane forms its queries in registers from the coords,
//   staged once per tile of 128 sites in shared memory;
// - row runs: the kx taps of one (kz_, ky_) pair read kx consecutive ids,
//   so one search per run gives them all (the first tap's lower bound, then
//   a step past each key equal to the previous tap's id);
// - tile brackets: over the tile's valid sites a run's first ids lie in
//   [q_min, q_max]; one warp's cooperative 32-ary search (each step every
//   lane probes one of 32 evenly spaced keys and a ballot picks the
//   sub-range, ~4 steps at 65536 keys) gives lo = lower_bound(q_min) and
//   hi = lower_bound(q_max + kx), both at once. On a sorted site list a tap
//   column is sorted too (the offset is an additive constant, a stride keeps
//   the lexicographic order), so the bracket holds about as many keys as
//   the tile has sites. Then a warp takes 32 sites of one run and each lane
//   binary-searches inside the bracket, a few probes in a few L1 lines. The
//   bracket is correct for any site order: it only gets wider. Brackets a
//   warp of 32 sites (4 searches a tile and run, not 1), a table of sampled
//   keys in shared memory in place of the search, and the brackets' keys
//   staged in shared memory for the lanes each timed slower;
// - writes: the tile's (sites x K) results are staged in shared memory and
//   written as contiguous rows of the map.
#include <limits.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace nmap {

constexpr int kTile = 128;   // output sites a block owns: 4 warps' groups
constexpr int kWarps = 12;   // warps a block; they share the tile's items
constexpr int kMaxTaps = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int shape[3];   // input grid extent (D, H, W)
  int ksize[3];   // kernel extent per axis
  int stride[3];
  int pad[3];
};

// lower_bound(t0) and lower_bound(t1) over keys[0, n), by the whole warp:
// each step splits a live range [lo, hi) into 32 chunks, lane j probes the
// last key of chunk j, and the ballot's count of keys < t is the chunk that
// holds the answer. Every value here is warp-uniform.
__device__ __forceinline__ void warp_bracket(const int* __restrict__ keys,
                                             int n, int t0, int t1, int lane,
                                             int& r0, int& r1) {
  int lo0 = 0, hi0 = n, lo1 = 0, hi1 = n;
  while (lo0 < hi0 || lo1 < hi1) {
    const int c0 = (hi0 - lo0 + 31) >> 5, c1 = (hi1 - lo1 + 31) >> 5;
    const int i0 = lo0 + (lane + 1) * c0 - 1, i1 = lo1 + (lane + 1) * c1 - 1;
    // while both ranges agree (the first steps, as a rule) one probe serves
    const bool p0 = lo0 < hi0 && i0 < hi0, p1 = lo1 < hi1 && i1 < hi1;
    const int k0 = p0 ? __ldg(keys + i0) : 0;
    const int k1 = p1 ? (p0 && i1 == i0 ? k0 : __ldg(keys + i1)) : 0;
    const bool b0 = p0 && k0 < t0, b1 = p1 && k1 < t1;
    const int j0 = __popc(__ballot_sync(kFull, b0));
    const int j1 = __popc(__ballot_sync(kFull, b1));
    if (lo0 < hi0) {
      const int nlo = lo0 + j0 * c0;
      hi0 = min(nlo + c0 - 1, hi0);
      lo0 = nlo;
    }
    if (lo1 < hi1) {
      const int nlo = lo1 + j1 * c1;
      hi1 = min(nlo + c1 - 1, hi1);
      lo1 = nlo;
    }
  }
  r0 = lo0;
  r1 = lo1;
}

// First index in [lo, hi) whose key is >= t, hi if none.
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int lo, int hi, int t) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The first id of run `run` (the (kz_, ky_) pair's kx taps) of tile site
// `i` in *q, and whether some tap of the run can hit: the site valid, z and
// y in bounds, the run's x span meeting [0, W).
__device__ __forceinline__ bool run_query(const int (*s_src)[kTile],
                                          const uint8_t* s_ok, int i, int run,
                                          const Geometry& g, int* q) {
  const int z = s_src[0][i] + run / g.ksize[1];
  const int y = s_src[1][i] + run % g.ksize[1];
  const int x0 = s_src[2][i];
  const bool live = s_ok[i] && z >= 0 && z < g.shape[0] && y >= 0 &&
                    y < g.shape[1] && x0 + g.ksize[2] > 0 && x0 < g.shape[2];
  *q = live ? (z * g.shape[1] + y) * g.shape[2] + x0 : 0;
  return live;
}

__global__ void __launch_bounds__(kWarps * 32) neighbor_map_kernel(
    const int* __restrict__ keys, int n_keys, const int* __restrict__ coords,
    const uint8_t* __restrict__ mask, int n_out, int dims, Geometry g,
    int* __restrict__ out) {
  extern __shared__ int s_map[];     // [kTile][K]
  __shared__ int s_src[3][kTile];    // coords * stride - pad per axis
  __shared__ uint8_t s_ok[kTile];
  __shared__ int s_lo[kMaxTaps], s_hi[kMaxTaps];  // a bracket a run
  const int kx = g.ksize[2];
  const int runs = g.ksize[0] * g.ksize[1];
  const int n_taps = runs * kx;
  const int tile0 = blockIdx.x * kTile;
  const int n_tile = min(kTile, n_out - tile0);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const bool ok = i < n_tile && mask[tile0 + i];
    s_ok[i] = ok;
    for (int a = 0; a < 3; ++a) {
      const int c = (a < 3 - dims || !ok)
                        ? 0
                        : coords[(size_t)(tile0 + i) * dims + a - (3 - dims)];
      s_src[a][i] = c * g.stride[a] - g.pad[a];
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // 1. a warp brackets each run over the whole tile: the keys from
  // lower_bound(q_min) to lower_bound(q_max + kx) hold every tap's key
  for (int run = warp; run < runs; run += kWarps) {
    int q_min = INT_MAX, q_max = INT_MIN;
    for (int i = lane; i < kTile; i += 32) {
      int q;
      if (run_query(s_src, s_ok, i, run, g, &q)) {
        q_min = min(q_min, q);
        q_max = max(q_max, q);
      }
    }
    q_min = __reduce_min_sync(kFull, q_min);
    q_max = __reduce_max_sync(kFull, q_max);
    int lo = 0, hi = 0;
    if (q_min <= q_max)
      warp_bracket(keys, n_keys, q_min, q_max + kx, lane, lo, hi);
    if (lane == 0) {
      s_lo[run] = lo;
      s_hi[run] = hi;
    }
  }
  __syncthreads();
  // 2. a warp takes 32 sites of one run: each lane's lower bound of its
  // run's first id inside the bracket, then a step past each tap's id
  for (int item = warp; item < (kTile / 32) * runs; item += kWarps) {
    const int site = (item & 3) * 32 + lane;
    const int run = item >> 2;
    int q0;
    const bool live = run_query(s_src, s_ok, site, run, g, &q0);
    const int hi = s_hi[run];
    const int x0 = s_src[2][site];
    int* row = s_map + site * n_taps + run * kx;
    int pos = live ? lower_bound(keys, s_lo[run], hi, q0) : hi;
    for (int j = 0; j < kx; ++j) {
      const int t = q0 + j;
      const bool in_x = x0 + j >= 0 && x0 + j < g.shape[2];
      const bool hit = live && in_x && pos < hi && __ldg(keys + pos) == t;
      row[j] = hit ? pos : n_keys;
      while (live && pos < hi && __ldg(keys + pos) <= t) ++pos;
    }
  }
  __syncthreads();
  int* dst = out + (size_t)tile0 * n_taps;
  for (int i = threadIdx.x; i < n_tile * n_taps; i += blockDim.x)
    dst[i] = s_map[i];
}

}  // namespace nmap

extern "C" {

// geom: 12 ints, the input grid's (D, H, W), the kernel's extent, the
// stride and the pad, each z y x (a 2-D map passes D = 1, kz = 1, stride
// 1, pad 0 and `dims` 2).
int cmt_neighbor_map(const void* keys, int n_keys, const void* coords,
                     const void* mask, int n_out, int dims, const int* geom,
                     void* out, void* stream) {
  nmap::Geometry g;
  for (int a = 0; a < 3; ++a) {
    g.shape[a] = geom[a];
    g.ksize[a] = geom[3 + a];
    g.stride[a] = geom[6 + a];
    g.pad[a] = geom[9 + a];
  }
  const int n_taps = g.ksize[0] * g.ksize[1] * g.ksize[2];
  if (n_taps < 1 || n_taps > nmap::kMaxTaps || (dims != 2 && dims != 3))
    return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    const int blocks = (n_out + nmap::kTile - 1) / nmap::kTile;
    const size_t smem = (size_t)nmap::kTile * n_taps * sizeof(int);
    nmap::neighbor_map_kernel<<<blocks, nmap::kWarps * 32, smem,
                                (cudaStream_t)stream>>>(
        (const int*)keys, n_keys, (const int*)coords, (const uint8_t*)mask,
        n_out, dims, g, (int*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
