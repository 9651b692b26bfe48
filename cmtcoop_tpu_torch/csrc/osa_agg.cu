// The OSA aggregate of VoVNet: a 1x1 conv over the virtual channel concat
// of a block's parts, folded eval BatchNorm, ReLU, and the per-view float32
// spatial sums that the eSE attention reads: kernel 6 of the port.
//
// Replaces `_agg_kernel` (cmtcoop_tpu/ops/conv_cf.py), reached through
// `osa_agg_cf` from `_osa_cf` (cmtcoop_tpu/models/vovnet_cf.py): one launch
// per OSA block, sum C 768 -> 256 at 160x400 per view (stage 2) up to
// 1024 + 5 x 224 -> 1024 at 20x50 (stage 5).
//
// Function, per view v and pixel p of its H*W:
//   agg[v, p, :] = relu(sum_i part_i[v, p, :] @ W_i + bias)
//   gap[v, :]    = sum_p relu(...) in float32, before the cast to the parts'
//                  dtype.
// W has the BN scale folded in float32 and is then cast to the parts' dtype,
// as the TPU wrapper folds it. Both routes read it packed once by the
// wrapper (ops/conv_cf.py `pack_osa_weight`): (Cout, kpad), K-major, part i's
// channels at K rows koff_i .. koff_i + C_i - 1 with koff_i the sum of the
// earlier parts' C rounded up to CHUNK (64), zeros in between.
//
// Blocks run in no order, so the TPU kernel's grid-carried gap accumulator
// has no counterpart: each block sums its tile's float32 columns over its
// real pixels and writes them as one row of a (V, tiles, Cout) partial
// buffer, and `osa_gap_kernel` sums the rows in a fixed order. That keeps
// `gap` deterministic (atomics would not be).
//
// bfloat16 -> `osa_tc::osa_agg_tc_kernel`, a GEMM on the tensor cores: M =
// the pixels of one view, N = Cout, K = the parts' channels in order.
//   What bounds it: at stage 2 the bytes (each part read once, 768 channels
//   in and 256 out per pixel: 0.118 ms at 3.35 TB/s for V3), at stages 3 to
//   5 the operations (1056-2144 channels in against 512-1024 out). So the
//   design feeds wgmma and reads each part once:
//   - A by TMA: each part has its own 3D tensor map over its (C_i, H*W, V)
//     extent, box (64 channels, BM pixels, 1 view). A tile lies inside one
//     view, so the gap sums stay per view; TMA zero-fills the rows past the
//     view's H*W (they are not the next view's) and the channels past C_i.
//     The concat is never written: each K step reads one 64-channel chunk
//     straight from the part that holds it. The maps change with the
//     activations, so the entry point encodes them at each launch and
//     passes them with the weight's map as one __grid_constant__ struct
//     (7 x 128 B).
//   - Channel tails: parts of 160 and 224 channels end in half a chunk
//     (32 channels). The box still loads 64 channels (the rest
//     zero-filled: no bytes read) and the packed weight has zero rows
//     there, but such a step issues only the two 16-deep wgmma slices that
//     hold its channels, so the tail costs no tensor-core work. The K walk
//     takes every part's full chunks first and the tails after them, so
//     that each step's wgmma run without a branch between them (a branch
//     there makes ptxas fence every wgmma). 32-channel chunks with a
//     64-byte swizzle would save only the shared-memory space and double
//     the steps of every other chunk.
//   - B by a 2D map over the packed weight, box (64, BN): BN columns of
//     Cout a block (64, 128, 192 or 256), rows past Cout zero-filled. The
//     weight's map is fixed per pack: `cmt_osa_agg_tc_weight_map` encodes it
//     once and the wrapper keeps it with the pack.
//   - a ring of STAGES (A, B) buffers with full/empty mbarriers: one
//     producer warp (one thread of it) keeps the TMA loads in flight; two
//     consumer warpgroups (64 pixels each) run wgmma asynchronously with
//     float32 accumulators in registers and free a stage once the wgmma
//     after it has been issued, as csrc/conv3x3.cu does.
//   - filling the card: a block covers BM = 128 pixels and BN = 256, 192,
//     128 or 64 columns. 64 and 128 columns run two blocks an SM, so that
//     one block's epilogue overlaps the other's main loop. The wrapper's
//     plan (`osa_agg_plan`) picks BN by a wave-quantized cost model fitted
//     to a sweep of every tile at every fusion-path shape (PERF.md): stage 4
//     (4000 pixels a view, Cout 768) and stage 5 (1000, Cout 1024) would
//     leave the card under a wave with 128 x 256 tiles. 64-pixel tiles (one
//     consumer warpgroup) measured slower than 128-pixel ones at every
//     shape and are not built. The block index runs over the column tiles
//     fastest, so the blocks that share an A tile run together and read it
//     from L2. No split-K.
//   - the epilogue adds the bias, applies ReLU in float32 and stores bf16
//     pairs straight from the accumulator registers, skipping the
//     zero-filled rows past the view's end (relu(bias) > 0 there): they
//     are neither stored nor summed. Each warp sums its 16 rows by
//     shuffles, and the consumer warps' rows are summed in a fixed order in
//     shared memory into the block's partial row.
//   It needs every C_i and Cout a multiple of 8 and the parts 16-byte
//   aligned (TMA's 16-byte strides and addresses, bf16 pairs in the
//   epilogue): the wrapper raises on anything else.
//   Tried and dropped: clusters of two blocks sharing each B tile by TMA
//   multicast (a quarter to a third less L2-to-SM traffic a K step) ran no
//   faster at any fusion-path shape (PERF.md), so L2 traffic is not what
//   holds the kernel near 40% of the bf16 peak. Not done yet: a persistent
//   grid that overlaps one tile's epilogue with the next tile's loads, a
//   TMA store of the output.
//
// float32 -> `osa_agg_f32_kernel`, the first version of the port on the
// CUDA cores (the float32 checks only): 128 x 128 output tiles of 8 x 8 a
// thread over 16-deep K tiles staged in shared memory, A read straight from
// the part that owns the channels.
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

#define CMT_OSA_MAX_PARTS 6
#define CMT_OSA_CHUNK 64  // channels per K step and per packed K block

// the parts' channel counts, in order
struct OsaChans {
  int c[CMT_OSA_MAX_PARTS];
  int n;
};

__host__ __device__ __forceinline__ int cmt_osa_round(int c) {
  return (c + CMT_OSA_CHUNK - 1) / CMT_OSA_CHUNK * CMT_OSA_CHUNK;
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

static int osa_gap(const void* partial, void* gap, int v, int tiles,
                   int cout, cudaStream_t st) {
  osa_gap_kernel<<<(v * cout + 255) / 256, 256, 0, st>>>(
      (const float*)partial, (float*)gap, v, tiles, cout);
  return (int)cudaGetLastError();
}

// ---------------------------- float32 route -------------------------------

struct OsaParts {
  const float* ptr[CMT_OSA_MAX_PARTS];
};

__global__ void __launch_bounds__(256) osa_agg_f32_kernel(
    OsaParts parts, OsaChans ch, const float* __restrict__ w, int kpad,
    const float* __restrict__ bias, float* __restrict__ out,
    float* __restrict__ partial, int hw, int cout, int tiles) {
  constexpr int TM = 128, TN = 128, RM = 8, RN = 8, TK = 16;
  __shared__ float s_sum[TM / RM][TN];
  const int view = blockIdx.x / tiles;
  const int tile = blockIdx.x - view * tiles;
  const int rows = min(TM, hw - tile * TM);  // the last tile is ragged
  const size_t row0 = (size_t)view * hw + (size_t)tile * TM;
  const int n0 = blockIdx.y * TN;

  float acc[RM][RN] = {};
  int koff = 0;
  for (int p = 0; p < ch.n; ++p) {
    const float* a = parts.ptr[p];
    const int c = ch.c[p];
    auto load_a = [&](int r, int k) -> float {
      return r < rows ? a[(row0 + r) * c + k] : 0.f;
    };
    auto load_b = [&](int k, int n) -> float {
      return (n0 + n < cout) ? w[(size_t)(n0 + n) * kpad + koff + k] : 0.f;
    };
    cmt_gemm_tile<TM, TN, RM, RN, TK>(acc, c, load_a, load_b);
    koff += cmt_osa_round(c);
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
      out[(row0 + r) * cout + c] = v;
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

// parts p0..p5 (the first `nparts` used), each (V, H*W, c_i) contiguous
// float32; w the packed (cout, kpad) float32 weight; bias (cout,) float32;
// out (V, H*W, cout); partial (V, ceil(H*W / 128), cout) float32 scratch;
// gap (V, cout) float32.
extern "C" int cmt_osa_aggregate_f32(int nparts, const void* p0,
                                     const void* p1, const void* p2,
                                     const void* p3, const void* p4,
                                     const void* p5, int c0, int c1, int c2,
                                     int c3, int c4, int c5, const void* w,
                                     int kpad, const void* bias, void* out,
                                     void* partial, void* gap, int v, int hw,
                                     int cout, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nparts < 1 || nparts > CMT_OSA_MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  if (v <= 0 || hw <= 0 || cout <= 0) return (int)cudaGetLastError();
  const void* ptrs[CMT_OSA_MAX_PARTS] = {p0, p1, p2, p3, p4, p5};
  const int chs[CMT_OSA_MAX_PARTS] = {c0, c1, c2, c3, c4, c5};
  OsaParts parts;
  OsaChans ch;
  int k = 0;
  for (int i = 0; i < CMT_OSA_MAX_PARTS; ++i) {
    parts.ptr[i] = (const float*)ptrs[i];
    ch.c[i] = chs[i];
    if (i < nparts) k += cmt_osa_round(chs[i]);
  }
  ch.n = nparts;
  if (k != kpad) return (int)cudaErrorInvalidValue;
  const int tiles = (hw + 127) / 128;
  dim3 grid(v * tiles, (cout + 127) / 128);
  osa_agg_f32_kernel<<<grid, 256, 0, st>>>(
      parts, ch, (const float*)w, kpad, (const float*)bias, (float*)out,
      (float*)partial, hw, cout, tiles);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return osa_gap(partial, gap, v, tiles, cout, st);
}

// --------------------------- bfloat16 route --------------------------------

namespace osa_tc {

constexpr int CHUNK = CMT_OSA_CHUNK;

// A chunk of more than 32 real channels takes all four 16-deep wgmma
// slices; one of at most 32 (a part's tail) takes two.
__host__ __device__ __forceinline__ bool cmt_osa_full_chunk(int c, int c0) {
  return c - c0 > CMT_OSA_CHUNK / 2;
}

constexpr int WG = 2;        // consumer warpgroups a block
constexpr int BM = 64 * WG;  // pixels a block

template <int BN>
struct Cfg {
  static constexpr int A_BYTES = BM * CHUNK * 2;
  static constexpr int B_BYTES = BN * CHUNK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // two blocks per SM, so that one's epilogue overlaps the other's main
  // loop, except for 192 and 256 columns (their 96 or 128 accumulators a
  // thread leave the registers for one)
  static constexpr int BLOCKS = BN > 128 ? 1 : 2;
  static constexpr int BUDGET = BLOCKS == 1 ? 200 * 1024 : 100 * 1024;
  static constexpr int FIT = BUDGET / STAGE;
  static constexpr int STAGES = FIT > 6 ? 6 : (FIT < 2 ? 2 : FIT);
  // one float32 row of column sums per consumer warp
  static constexpr int SUMS = 4 * WG * BN * 4;
  // 1024 for aligning the swizzled tiles, then the ring, its barriers and
  // the sums
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8 + SUMS;
  static constexpr int THREADS = 128 * WG + 32;  // + the producer warp
};

// the parts' maps and the packed weight's, passed by value
struct Maps {
  CUtensorMap a[CMT_OSA_MAX_PARTS];
  CUtensorMap w;
};

// One K step of a consumer warpgroup: wait for stage k's tiles, issue S
// 16-deep wgmma slices on them, and free stage k - 1 once the wgmma after
// it has been issued (wait_group 1). S is a constant, so no branch lies
// between the wgmma of a step.
template <int BN, int S>
__device__ __forceinline__ void consume_step(float (&acc)[BN / 2], int k,
                                             uint32_t a_ring,
                                             uint32_t b_ring, uint32_t full,
                                             uint32_t empty,
                                             uint32_t a_rows) {
  using C = Cfg<BN>;
  const int s = k % C::STAGES;
  cmt_mbar_wait(full + 8 * s, (k / C::STAGES) & 1);
  const uint64_t da = cmt_sw128_desc(a_ring + s * C::A_BYTES + a_rows);
  const uint64_t db = cmt_sw128_desc(b_ring + s * C::B_BYTES);
  cmt_fence_regs(acc);
  cmt_wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < S; ++kk)  // 32 B = 2 descriptor units
    Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
  cmt_wgmma_commit();
  cmt_wgmma_wait<1>();
  cmt_fence_regs(acc);
  if (k > 0) cmt_mbar_arrive(empty + 8 * ((k - 1) % C::STAGES));
}

template <int BN>
__global__ void __launch_bounds__(128 * WG + 32, Cfg<BN>::BLOCKS)
    osa_agg_tc_kernel(const __grid_constant__ Maps maps, const OsaChans ch,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ partial, int hw, int cout,
                      int tiles, int col_tiles) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = cmt_smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_ring = base;
  const uint32_t b_ring = a_ring + C::STAGES * C::A_BYTES;
  const uint32_t full = b_ring + C::STAGES * C::B_BYTES;  // 8 B a barrier
  const uint32_t empty = full + C::STAGES * 8;
  float* s_sum =
      reinterpret_cast<float*>(smem_raw + (empty + C::STAGES * 8 - raw));

  // block -> (view, pixel tile, column tile), column tiles fastest
  int t = blockIdx.x;
  const int n0 = (t % col_tiles) * BN;
  t /= col_tiles;
  const int tile = t % tiles;
  const int view = t / tiles;
  const int m0 = tile * BM;  // the tile's first pixel in its view

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
    // the producer warp: one thread issues every TMA load, the parts'
    // full chunks first, then their tails
    if (threadIdx.x == 128 * WG) {
      int k = 0;
      for (int pass = 0; pass < 2; ++pass) {
        int koff = 0;
        for (int p = 0; p < ch.n; ++p) {
          for (int c0 = 0; c0 < ch.c[p]; c0 += CHUNK) {
            if (cmt_osa_full_chunk(ch.c[p], c0) != (pass == 0)) continue;
            const int s = k % C::STAGES;
            cmt_mbar_wait(empty + 8 * s, ((k / C::STAGES) & 1) ^ 1);
            cmt_mbar_expect_tx(full + 8 * s, C::STAGE);
            cmt_tma_load_3d(a_ring + s * C::A_BYTES, &maps.a[p],
                            full + 8 * s, c0, m0, view);
            cmt_tma_load_2d(b_ring + s * C::B_BYTES, &maps.w, full + 8 * s,
                            koff + c0, n0);
            ++k;
          }
          koff += cmt_osa_round(ch.c[p]);
        }
      }
    }
    return;
  }

  // consumer warpgroup `wg`: pixels m0 + wg*64 .. + 63 of the tile, in
  // the producer's order: `n_full` steps of four slices, then the tails'
  // steps of two (a tail's slices past its channels, if any, meet zeros)
  int n_full = 0, n_steps = 0;
  for (int p = 0; p < ch.n; ++p) {
    for (int c0 = 0; c0 < ch.c[p]; c0 += CHUNK, ++n_steps)
      n_full += cmt_osa_full_chunk(ch.c[p], c0);
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t a_rows = wg * 64 * (CHUNK * 2);
  int k = 0;
  for (; k < n_full; ++k)
    consume_step<BN, 4>(acc, k, a_ring, b_ring, full, empty, a_rows);
  for (; k < n_steps; ++k)
    consume_step<BN, 2>(acc, k, a_ring, b_ring, full, empty, a_rows);
  cmt_wgmma_wait<0>();
  cmt_fence_regs(acc);

  // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16w + lane/4 (+ 8); register 4j + 2hh + e is column 8j + 2(lane%4) + e
  // of row half hh. Rows past the view's end are zero-filled A rows.
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
  const bool ok0 = row < hw, ok1 = row + 8 < hw;
  __nv_bfloat16* o0 = out + ((size_t)view * hw + row) * cout + n0;
  __nv_bfloat16* o1 = o0 + (size_t)8 * cout;
  float* srow = s_sum + (wg * 4 + warp) * BN;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (n0 + 8 * j >= cout) break;  // warp-uniform: cout % 8 == 0
    const int c = 8 * j + 2 * (lane % 4);
    const float b0 = bias[n0 + c], b1 = bias[n0 + c + 1];
    const float v00 = fmaxf(acc[4 * j] + b0, 0.f);
    const float v01 = fmaxf(acc[4 * j + 1] + b1, 0.f);
    const float v10 = fmaxf(acc[4 * j + 2] + b0, 0.f);
    const float v11 = fmaxf(acc[4 * j + 3] + b1, 0.f);
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
          __floats2bfloat162_rn(v00, v01);
    if (ok1)
      *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
          __floats2bfloat162_rn(v10, v11);
    float s0 = (ok0 ? v00 : 0.f) + (ok1 ? v10 : 0.f);
    float s1 = (ok0 ? v01 : 0.f) + (ok1 ? v11 : 0.f);
#pragma unroll
    for (int d = 4; d < 32; d *= 2) {  // over the warp's 8 row pairs
      s0 += __shfl_xor_sync(0xffffffffu, s0, d);
      s1 += __shfl_xor_sync(0xffffffffu, s1, d);
    }
    if (lane < 4) {
      srow[c] = s0;
      srow[c + 1] = s1;
    }
  }
  cmt_named_sync(1, 128 * WG);  // the consumer warps only
  for (int c = threadIdx.x; c < BN && n0 + c < cout; c += 128 * WG) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4 * WG; ++w) s += s_sum[w * BN + c];
    partial[((size_t)view * tiles + tile) * cout + n0 + c] = s;
  }
}

// the dynamic shared memory limit of one instantiation, raised once per
// device (an attribute of the function in the current device's context)
template <int BN>
static cudaError_t allow_smem() {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(osa_agg_tc_kernel<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<BN>::SMEM);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <int BN>
static int launch(const Maps& maps, const OsaChans& ch, const void* bias,
                  void* out, void* partial, int v, int hw, int cout,
                  int tiles, int col_tiles, cudaStream_t st) {
  using C = Cfg<BN>;
  cudaError_t err = allow_smem<BN>();
  if (err != cudaSuccess) return (int)err;
  osa_agg_tc_kernel<BN>
      <<<v * tiles * col_tiles, C::THREADS, C::SMEM, st>>>(
          maps, ch, (const float*)bias, (__nv_bfloat16*)out,
          (float*)partial, hw, cout, tiles, col_tiles);
  return (int)cudaGetLastError();
}

static bool valid_width(int bn) {
  return bn == 64 || bn == 128 || bn == 192 || bn == 256;
}

}  // namespace osa_tc

// The packed weight's tensor map: (cout, kpad) bf16, box (CHUNK, bn) with
// the 128-byte swizzle, zeros for the rows past Cout; written to the 128
// bytes at `map_out` (host memory), which the launches below read.
extern "C" int cmt_osa_agg_tc_weight_map(const void* w, int kpad, int cout,
                                         int bn, void* map_out) {
  using namespace osa_tc;
  if (kpad <= 0 || kpad % CHUNK || cout <= 0 || cout % 8 ||
      !valid_width(bn) || (size_t)w % 16)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)kpad, (cuuint64_t)cout};
  const cuuint64_t strides[1] = {(cuuint64_t)kpad * 2};
  const cuuint32_t box[2] = {CHUNK, (cuuint32_t)bn};
  CUtensorMap map;
  if (!cmt_bf16_map(&map, w, 2, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  memcpy(map_out, &map, sizeof(map));
  return (int)cudaSuccess;
}

// The launch plan (bn, tiles, col_tiles) comes from ops/conv_cf.py
// `osa_agg_plan` and is checked here against this source's tile geometry:
// tiles of BM pixels covering each view's hw pixels exactly, column
// tiles of bn covering Cout, the parts' chunks filling kpad. `w_map` is the
// packed weight's map from `cmt_osa_agg_tc_weight_map` (made with the same
// bn). Parts and out bf16, bias float32 (cout,), partial (V, tiles, cout)
// and gap (V, cout) float32.
extern "C" int cmt_osa_aggregate_tc(int nparts, const void* p0,
                                    const void* p1, const void* p2,
                                    const void* p3, const void* p4,
                                    const void* p5, int c0, int c1, int c2,
                                    int c3, int c4, int c5, const void* w_map,
                                    const void* bias, void* out,
                                    void* partial, void* gap, int v, int hw,
                                    int cout, int kpad, int bn, int tiles,
                                    int col_tiles, void* stream) {
  using namespace osa_tc;
  cudaStream_t st = (cudaStream_t)stream;
  if (nparts < 1 || nparts > CMT_OSA_MAX_PARTS || v <= 0 || hw <= 0 ||
      cout <= 0 || cout % 8 || !valid_width(bn) ||
      tiles != (hw + BM - 1) / BM ||
      col_tiles != (cout + bn - 1) / bn)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[CMT_OSA_MAX_PARTS] = {p0, p1, p2, p3, p4, p5};
  const int chs[CMT_OSA_MAX_PARTS] = {c0, c1, c2, c3, c4, c5};
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  memcpy(&maps.w, w_map, sizeof(maps.w));
  OsaChans ch;
  ch.n = nparts;
  int k = 0;
  for (int i = 0; i < CMT_OSA_MAX_PARTS; ++i) {
    ch.c[i] = i < nparts ? chs[i] : 0;
    if (i >= nparts) continue;
    const int c = chs[i];
    if (c <= 0 || c % 8 || (size_t)ptrs[i] % 16)
      return (int)cudaErrorInvalidValue;
    k += cmt_osa_round(c);
    const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)hw,
                                (cuuint64_t)v};
    const cuuint64_t strides[2] = {(cuuint64_t)c * 2,
                                   (cuuint64_t)hw * c * 2};
    const cuuint32_t box[3] = {CHUNK, BM, 1};
    if (!cmt_bf16_map(&maps.a[i], ptrs[i], 3, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  if (k != kpad) return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  switch (bn) {
    case 64:
      err = launch<64>(maps, ch, bias, out, partial, v, hw, cout, tiles,
                       col_tiles, st);
      break;
    case 128:
      err = launch<128>(maps, ch, bias, out, partial, v, hw, cout, tiles,
                        col_tiles, st);
      break;
    case 192:
      err = launch<192>(maps, ch, bias, out, partial, v, hw, cout, tiles,
                        col_tiles, st);
      break;
    case 256:
      err = launch<256>(maps, ch, bias, out, partial, v, hw, cout, tiles,
                        col_tiles, st);
      break;
  }
  if (err != 0) return err;
  return osa_gap(partial, gap, v, tiles, cout, st);
}
