// Sparse-BEV x dense-z pillar convolution with the fused BN/residual/ReLU/
// occupancy epilogue: kernels 1 and 2 of the port.
//
// Replaces (cmtcoop_tpu/ops/pillar_fused.py):
//   - `_fused_kernel_v2` / `_fused_v2_compute` (9 BEV taps: the submanifold
//     3x3x3 convs and the three stride-2 down convs): KB = 9 below;
//   - `_fused_kernel` (1 BEV tap: `conv_out`, kernel (3,1,1), stride
//     (2,1,1)): KB = 1;
//   - the in-kernel `fold_occ` occupancy of the down convs, entry point
//     `cmt_pillar_occ_fold` (= ops/pillars.py `occ_downsample`).
//
// Function: out[p, zo, :] = occ[p, zo] * relu?(scale * sum_{j, dz}
//   feats[nbr[p, j], zo*s + dz - pad, :] @ W[dz*KB + j] + bias + resid[p, zo])
// with nbr misses (== P_in) and z outside [0, Z_in) reading zero.
//
// Both routes run an implicit GEMM over the occupied output rows only: the
// output is multiplied by the occupancy, and at LiDAR densities only 2-19%
// of the (pillar, z) rows are occupied, so the wrapper compacts them into a
// list on the device once per occupancy (no host sync; the count stays in
// device memory): M = active rows, N = Cout, K = KB * kz * Cin. A is
// gathered straight through the neighbour map; the TPU kernel's one-hot
// gathers, per-dy windows, band matrices and z tiles have no counterpart.
// Inactive rows keep the zeros the wrapper wrote. The dtype picks the
// route, explicitly:
//
// bfloat16 -> `pillar_tc::pillar_conv_tc_kernel`, on the tensor cores.
//   What bounds it: bytes. Each conv's products on the occupied rows are at
//   most ~10 GFLOP (0.01 ms at 989 TFLOP/s), while each dense (P, Z, C)
//   input, residual and output is read or written once (the encoder's ~1.9
//   GB an agent, ~0.6 ms at 3.35 TB/s), and the gathers hit each occupied
//   input row up to 27 times from L2. So the design keeps 16-byte gathers
//   in flight and lets wgmma do the arithmetic:
//   - K is walked in (j, dz, ci) order with Cin padded to a multiple of 8
//     (`cin_pad`; the wrapper pads Cin 5 to 8 once), in steps of CHUNK = 64
//     (one 128-byte row a tile row), so the K of one tap j is one
//     contiguous run of kz * cin_pad bf16, feats[nbr[p, j], zi0 .. zi0 +
//     kz - 1, :], and each 16-byte piece of it lies inside one dz. A table
//     in shared memory, built once a block, maps each piece of the K walk to
//     (j, dz, ci), so the index work is per piece, not per element; pieces
//     past the end of K read nothing.
//   - A (BM = 64 * WG rows x 64) is gathered by cp.async, two threads a row,
//     16 bytes a piece (neighbouring lanes on neighbouring pieces), into the
//     128-byte swizzle wgmma's descriptor reads; a miss, a z outside the
//     input or the K tail copies 0 bytes and zero-fills (src-size 0).
//   - B is the weight packed once per module (ops/pillar_fused.py
//     `pack_pillar_weight`: (Cout, k_pad) K-major, zero rows past K),
//     streamed in (64 x BN) chunks by 2D TMA into the same ring; BN is Cout
//     rounded up to 16, 32, 64 or 128, so one block covers all of Cout and
//     each gathered row is read once. TMA zero-fills columns past Cout.
//   - a ring of STAGES (A, B) buffers. Every thread gathers, then waits for
//     its own copies (cp.async.wait_group), fences them to the async proxy
//     (fence.proxy.async: wgmma reads shared memory there) and meets the
//     others at a block barrier; step k + 2's gathers are issued right after
//     that barrier, into the stage whose wgmma (step k - 2) every warpgroup
//     has waited for, so they are in flight while step k's wgmma runs.
//   - a persistent grid (the plan's SMs x blocks an SM) whose blocks walk
//     the tiles blockIdx.x, + gridDim.x, ... up to the device count; the
//     ring runs on across a block's tiles, so one tile's epilogue overlaps
//     the next tile's gathers.
//   - the epilogue in registers: a quad of lanes exchanges its
//     accumulators by shuffles so that each lane holds 8 consecutive
//     columns of a row, then float32 scale and bias, the residual (one
//     16-byte load), ReLU, and one 16-byte store at the row's dense offset.
//   - deterministic: no split-K, no atomics.
//   BM follows from BN (`wg_of`): 128 rows for Cout <= 64, whose levels'
//   occupied rows give more than a wave of such tiles, else 64.
//
// float32 -> `pillar_conv_f32_kernel`, the first version of the port on the
// CUDA cores (fp32 FMA, 4x4 register tiles through shared memory), kept
// for the float32 checks (chip_smoke's gather-vs-pillar check and slice
// parity, its float32 cases, the card tests). It reads the (kz*KB, Cin,
// Cout) weight and sizes its grid by the host's row bound; blocks past the
// device count exit at once.
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

// ---------------------------- float32 route -------------------------------

template <int KB, int TN>
__global__ void __launch_bounds__(256) pillar_conv_f32_kernel(
    const float* __restrict__ feats, const int* __restrict__ nbr,
    const float* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ resid,
    const int* __restrict__ rows, const int* __restrict__ count,
    float* __restrict__ out, int p_in, int z_in, int cin, int z_out,
    int cout, int kz, int zs, int zpad, int relu) {
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
    return feats[((size_t)src * z_in + zi) * cin + ci];
  };
  auto load_b = [&](int k, int n) -> float {
    return (n0 + n < cout) ? w[(size_t)k * cout + n0 + n] : 0.f;
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
      if (resid) v += resid[(size_t)row * cout + c];
      if (relu) v = fmaxf(v, 0.f);
      out[(size_t)row * cout + c] = v;
    }
  }
}

template <int KB>
static void launch_f32(const void* feats, const void* nbr, const void* w,
                       const void* scale, const void* bias, const void* resid,
                       const void* rows, const void* count, void* out,
                       int max_rows, int p_in, int z_in, int cin, int z_out,
                       int cout, int kz, int zs, int zpad, int relu,
                       cudaStream_t st) {
#define CMT_LAUNCH(TN_)                                                       \
  do {                                                                        \
    dim3 grid((max_rows + 4096 / TN_ - 1) / (4096 / TN_),                     \
              (cout + TN_ - 1) / TN_);                                        \
    pillar_conv_f32_kernel<KB, TN_><<<grid, 256, 0, st>>>(                    \
        (const float*)feats, (const int*)nbr, (const float*)w,                \
        (const float*)scale, (const float*)bias, (const float*)resid,         \
        (const int*)rows, (const int*)count, (float*)out, p_in, z_in, cin,    \
        z_out, cout, kz, zs, zpad, relu);                                     \
  } while (0)
  // output tile (rows x channels) by Cout: 256 x 16, 128 x 32, 64 x 64
  if (cout <= 16)
    CMT_LAUNCH(16);
  else if (cout <= 32)
    CMT_LAUNCH(32);
  else
    CMT_LAUNCH(64);
#undef CMT_LAUNCH
}

// --------------------------- bfloat16 route --------------------------------

namespace pillar_tc {

constexpr int CHUNK = 64;       // K elements a step: one 128-byte tile row
constexpr int MAX_KSTEPS = 64;  // K up to 4096 (Cin up to 151 at KB 9)
constexpr int STAGES = 4;       // gathers run STAGES - 2 steps ahead

// warpgroups a block: tiles of 128 rows for Cout <= 64, of 64 rows for
// Cout 128 (its levels have ~10k occupied rows, 84 tiles of 128, under a
// wave of the card; the levels of Cout <= 64 have 33k-76k)
constexpr int wg_of(int bn) { return bn <= 64 ? 2 : 1; }

template <int BN, int KB>
struct Cfg {
  static constexpr int WG = wg_of(BN);
  static constexpr int BM = 64 * WG;  // rows a tile: one warpgroup a 64
  static constexpr int THREADS = 128 * WG;
  static constexpr int A_BYTES = BM * CHUNK * 2;
  static constexpr int B_BYTES = BN * CHUNK * 2;
  // 1024 for aligning the swizzled tiles, the ring, its barriers, the K
  // table (8 pieces a step) and the tile rows' neighbours
  static constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES) +
                              8 * STAGES + 4 * MAX_KSTEPS * 8 + 4 * BM * KB;
};

// `cout` <= BN output columns of `acc` (m64nBNk16 layout) for one row
// half: each quad of lanes exchanges its 2-column pieces so that lane c
// holds the 8 columns of group 4 * gs + c, then the epilogue writes them.
template <int BN>
__device__ __forceinline__ void store_row_half(
    const float (&acc)[BN / 2], int hh, int row, int lane,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ out,
    int cout, int relu) {
  constexpr int NG = BN / 8;  // 8-column groups
  const int c = lane % 4;
#pragma unroll
  for (int gs = 0; gs < (NG + 3) / 4; ++gs) {
    float ax[4], ay[4], bx[4], by[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int g = 4 * gs + s;
      ax[s] = g < NG ? acc[4 * g + 2 * hh] : 0.f;
      ay[s] = g < NG ? acc[4 * g + 2 * hh + 1] : 0.f;
      bx[s] = by[s] = 0.f;
    }
    // round r: send my piece of group 4gs + (c ^ r) to lane c ^ r, which
    // sends me its piece of group 4gs + c: columns 2 (c ^ r), +1
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = c ^ r;
      float sx = ax[0], sy = ay[0];
#pragma unroll
      for (int s = 1; s < 4; ++s) {
        sx = t == s ? ax[s] : sx;
        sy = t == s ? ay[s] : sy;
      }
      if (r) {
        sx = __shfl_xor_sync(0xffffffffu, sx, r);
        sy = __shfl_xor_sync(0xffffffffu, sy, r);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        bx[s] = t == s ? sx : bx[s];
        by[s] = t == s ? sy : by[s];
      }
    }
    const int col = 8 * (4 * gs + c);
    if (row < 0 || 4 * gs + c >= NG || col >= cout) continue;
    float v[8];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      v[2 * s] = bx[s];
      v[2 * s + 1] = by[s];
    }
    if (scale) {
      const float4 s0 = *reinterpret_cast<const float4*>(scale + col);
      const float4 s1 = *reinterpret_cast<const float4*>(scale + col + 4);
      v[0] *= s0.x; v[1] *= s0.y; v[2] *= s0.z; v[3] *= s0.w;
      v[4] *= s1.x; v[5] *= s1.y; v[6] *= s1.z; v[7] *= s1.w;
    }
    if (bias) {
      const float4 b0 = *reinterpret_cast<const float4*>(bias + col);
      const float4 b1 = *reinterpret_cast<const float4*>(bias + col + 4);
      v[0] += b0.x; v[1] += b0.y; v[2] += b0.z; v[3] += b0.w;
      v[4] += b1.x; v[5] += b1.y; v[6] += b1.z; v[7] += b1.w;
    }
    const size_t o = (size_t)row * cout + col;
    if (resid) {
      const uint4 rv = *reinterpret_cast<const uint4*>(resid + o);
      const uint32_t rw[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&rw[s]);
        v[2 * s] += __low2float(p);
        v[2 * s + 1] += __high2float(p);
      }
    }
    if (relu) {
#pragma unroll
      for (int s = 0; s < 8; ++s) v[s] = fmaxf(v[s], 0.f);
    }
    *reinterpret_cast<uint4*>(out + o) =
        make_uint4(cmt_pack_bf16(v[0], v[1]), cmt_pack_bf16(v[2], v[3]),
                   cmt_pack_bf16(v[4], v[5]), cmt_pack_bf16(v[6], v[7]));
  }
}

template <int BN, int KB>
__global__ void __launch_bounds__(128 * wg_of(BN), 2) pillar_conv_tc_kernel(
    const __grid_constant__ CUtensorMap tm_w,
    const __nv_bfloat16* __restrict__ feats, const int* __restrict__ nbr,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ resid, const int* __restrict__ rows,
    const int* __restrict__ count, __nv_bfloat16* __restrict__ out,
    int p_in, int z_in, int cin_pad, int z_out, int cout, int kz, int zs,
    int zpad, int relu, int ksteps) {
  using C = Cfg<BN, KB>;
  constexpr int BM = C::BM;
  const int n_rows = *count;
  const int n_tiles = (n_rows + BM - 1) / BM;
  if ((int)blockIdx.x >= n_tiles) return;
  const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = my_tiles * ksteps;  // the block's K steps, all tiles

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = cmt_smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_ring = base;
  const uint32_t b_ring = a_ring + STAGES * C::A_BYTES;
  const uint32_t full = b_ring + STAGES * C::B_BYTES;  // 8 B a barrier
  int* tab = reinterpret_cast<int*>(smem_raw + (full - raw) + 8 * STAGES);
  int* s_src = tab + MAX_KSTEPS * 8;  // (BM, KB): the rows' input pillars

  // the K table: piece i (elements 8i .. 8i + 7) of the (j, dz, ci) walk
  // -> j | dz << 4 | ci << 6, or j = 15 past the end of K
  const int run = kz * cin_pad;
  for (int i = threadIdx.x; i < ksteps * 8; i += blockDim.x) {
    const int k = 8 * i;
    int e = 15;
    if (k < KB * run) {
      const int j = k / run;
      const int dz = (k - j * run) / cin_pad;
      e = j | (dz << 4) | ((k - j * run - dz * cin_pad) << 6);
    }
    tab[i] = e;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) cmt_mbar_init(full + 8 * s, 1);
    cmt_mbar_init_fence();
  }
  __syncthreads();

  // the gathers: thread (r, h) copies pieces h, h + 2, h + 4, h + 6 of tile
  // row r at each step; (gk, gt) is the next step to issue: K step gk of
  // the block's tile number gt
  const int r = threadIdx.x / 2, h = threadIdx.x % 2;
  const CUtensorMap* w_map = &tm_w;
  int gk = 0, gt = 0, zi0 = 0;
  auto issue = [&](int step) {
    const int s = step % STAGES;
    if (gk == 0) {  // a new tile: this row's output voxel and neighbours
      const int i = (blockIdx.x + gt * gridDim.x) * BM + r;
      const int row = i < n_rows ? rows[i] : -1;
      const int p = row >= 0 ? row / z_out : 0;
      zi0 = (row - p * z_out) * zs - zpad;
      if (h == 0) {
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          const int src = row >= 0 ? nbr[p * KB + j] : p_in;
          s_src[r * KB + j] = src < p_in ? src : -1;
        }
      }
      __syncwarp();
    }
    const uint32_t a_st = a_ring + s * C::A_BYTES;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = h + 2 * i;
      const int e = tab[gk * 8 + q];
      const int j = e & 15;
      const __nv_bfloat16* src = feats;
      uint32_t bytes = 0;
      if (j < KB) {
        const int sp = s_src[r * KB + j];
        const int zi = zi0 + ((e >> 4) & 3);
        if (sp >= 0 && zi >= 0 && zi < z_in) {
          src = feats + ((size_t)sp * z_in + zi) * cin_pad + (e >> 6);
          bytes = 16;
        }
      }
      cmt_cp_async16(a_st + cmt_sw128_offset(r, q), src, bytes);
    }
    if (threadIdx.x == 0) {
      cmt_mbar_expect_tx(full + 8 * s, C::B_BYTES);
      cmt_tma_load_2d(b_ring + s * C::B_BYTES, w_map, full + 8 * s,
                      gk * CHUNK, 0);
    }
    if (++gk == ksteps) {
      gk = 0;
      ++gt;
    }
  };

  for (int g = 0; g < STAGES - 2; ++g) {
    if (g < total) issue(g);
    cmt_cp_async_commit();
  }
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int ck = 0, ct = 0;  // the K step and tile number the wgmma are on
  for (int g = 0; g < total; ++g) {
    const int s = g % STAGES;
    cmt_cp_async_wait<STAGES - 3>();  // this thread's pieces of step g
    cmt_fence_proxy_async();
    __syncthreads();  // everyone's pieces of step g; wgmma g - 2 done
    if (g + STAGES - 2 < total) issue(g + STAGES - 2);
    cmt_cp_async_commit();
    cmt_mbar_wait(full + 8 * s, (g / STAGES) & 1);
    const uint64_t da =
        cmt_sw128_desc(a_ring + s * C::A_BYTES + wg * 64 * (CHUNK * 2));
    const uint64_t db = cmt_sw128_desc(b_ring + s * C::B_BYTES);
    cmt_fence_regs(acc);
    cmt_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CHUNK / 16; ++kk)  // 32 B = 2 descriptor units
      Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
    cmt_wgmma_commit();
    cmt_wgmma_wait<1>();
    cmt_fence_regs(acc);
    if (++ck == ksteps) {
      cmt_wgmma_wait<0>();
      cmt_fence_regs(acc);
      const int i0 = (blockIdx.x + ct * gridDim.x) * BM + wg * 64 +
                     warp * 16 + lane / 4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + 8 * hh;
        store_row_half<BN>(acc, hh, i < n_rows ? rows[i] : -1, lane, scale,
                           bias, resid, out, cout, relu);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      ck = 0;
      ++ct;
    }
  }
}

template <int BN, int KB>
static int launch(const CUtensorMap& tm_w, const void* feats, const void* nbr,
                  const void* scale, const void* bias, const void* resid,
                  const void* rows, const void* count, void* out, int p_in,
                  int z_in, int cin_pad, int z_out, int cout, int kz, int zs,
                  int zpad, int relu, int ksteps, int grid, cudaStream_t st) {
  using C = Cfg<BN, KB>;
  static_assert(C::SMEM <= 232448 - 1024, "a block's shared memory");
  static bool done[CMT_MAX_DEVICES] = {};
  cudaError_t err =
      cmt_allow_smem(pillar_conv_tc_kernel<BN, KB>, C::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  pillar_conv_tc_kernel<BN, KB><<<grid, C::THREADS, C::SMEM, st>>>(
      tm_w, (const __nv_bfloat16*)feats, (const int*)nbr, (const float*)scale,
      (const float*)bias, (const __nv_bfloat16*)resid, (const int*)rows,
      (const int*)count, (__nv_bfloat16*)out, p_in, z_in, cin_pad, z_out,
      cout, kz, zs, zpad, relu, ksteps);
  return (int)cudaGetLastError();
}

static bool valid_width(int bn) {
  return bn == 16 || bn == 32 || bn == 64 || bn == 128;
}

}  // namespace pillar_tc

extern "C" {

// float32, the CUDA-core route: `w` is (kz*KB, Cin, Cout), `max_rows` the
// host's bound on the active rows (P_out * Z_out)
int cmt_pillar_conv_f32(int kb, const void* feats, const void* nbr,
                        const void* w, const void* scale, const void* bias,
                        const void* resid, const void* rows, const void* count,
                        void* out, int max_rows, int p_in, int z_in, int cin,
                        int z_out, int cout, int kz, int zs, int zpad, int relu,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (max_rows <= 0) return (int)cudaGetLastError();
  if (kb == 9)
    launch_f32<9>(feats, nbr, w, scale, bias, resid, rows, count, out,
                  max_rows, p_in, z_in, cin, z_out, cout, kz, zs, zpad, relu,
                  st);
  else if (kb == 1)
    launch_f32<1>(feats, nbr, w, scale, bias, resid, rows, count, out,
                  max_rows, p_in, z_in, cin, z_out, cout, kz, zs, zpad, relu,
                  st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The packed bf16 weight's tensor map: (Cout, k_pad) K-major, box (CHUNK,
// bn) with the 128-byte swizzle, zeros for the columns past Cout; written
// to the 128 bytes at `map_out` (host memory), which the launches read.
int cmt_pillar_tc_weight_map(const void* w, int k_pad, int cout, int bn,
                             void* map_out) {
  using namespace pillar_tc;
  if (k_pad <= 0 || k_pad % CHUNK || k_pad > CHUNK * MAX_KSTEPS ||
      cout <= 0 || cout % 8 || !valid_width(bn) || cout > bn ||
      (size_t)w % 16)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)k_pad, (cuuint64_t)cout};
  const cuuint64_t strides[1] = {(cuuint64_t)k_pad * 2};
  const cuuint32_t box[2] = {CHUNK, (cuuint32_t)bn};
  CUtensorMap map;
  if (!cmt_bf16_map(&map, w, 2, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  memcpy(map_out, &map, sizeof(map));
  return (int)cudaSuccess;
}

// bfloat16, the tensor-core route. The plan (bn, ksteps, grid) comes from
// ops/pillar_fused.py `pillar_conv_plan` and is checked here against this
// source's geometry; the rows a tile follow from bn (`wg_of`). `w_map` is
// the packed weight's map from `cmt_pillar_tc_weight_map` (made with the
// same bn); feats is (P_in, Z_in, cin_pad), out and resid (P_out, Z_out,
// Cout), all bf16 and 16-byte aligned; scale and bias float32 (Cout,) or
// NULL; rows / count the active rows from the wrapper.
int cmt_pillar_conv_tc(int kb, const void* feats, const void* nbr,
                       const void* w_map, const void* scale, const void* bias,
                       const void* resid, const void* rows, const void* count,
                       void* out, int p_in, int z_in, int cin_pad, int z_out,
                       int cout, int kz, int zs, int zpad, int relu, int bn,
                       int ksteps, int grid, void* stream) {
  using namespace pillar_tc;
  cudaStream_t st = (cudaStream_t)stream;
  const int k_real = kb * kz * cin_pad;
  if (cin_pad <= 0 || cin_pad % 8 || kz < 1 || kz > 3 || cout % 8 ||
      !valid_width(bn) || cout > bn || ksteps > MAX_KSTEPS ||
      ksteps * CHUNK < k_real || ksteps * CHUNK - k_real >= CHUNK ||
      grid <= 0 || (size_t)feats % 16 || (size_t)out % 16 ||
      (size_t)resid % 16 || (size_t)scale % 16 || (size_t)bias % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_w;
  memcpy(&tm_w, w_map, sizeof(tm_w));
#define CMT_PILLAR_TC(BN, KB)                                               \
  if (bn == BN && kb == KB)                                                 \
    return launch<BN, KB>(tm_w, feats, nbr, scale, bias, resid, rows,       \
                          count, out, p_in, z_in, cin_pad, z_out, cout, kz, \
                          zs, zpad, relu, ksteps, grid, st);
#define CMT_PILLAR_TC_KB(BN) \
  CMT_PILLAR_TC(BN, 9)       \
  CMT_PILLAR_TC(BN, 1)
  CMT_PILLAR_TC_KB(16)
  CMT_PILLAR_TC_KB(32)
  CMT_PILLAR_TC_KB(64)
  CMT_PILLAR_TC_KB(128)
#undef CMT_PILLAR_TC_KB
#undef CMT_PILLAR_TC
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

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

extern "C" int cmt_pillar_occ_fold(const void* occ_in, const void* nbr,
                                   void* occ_out, int p_in, int z_in,
                                   int p_out, int z_out, int kb, int kz,
                                   int zs, int zpad, void* stream) {
  const int n = p_out * z_out;
  if (n > 0)
    pillar_occ_fold_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)occ_in, (const int*)nbr, (uint8_t*)occ_out, p_in, z_in,
        p_out, z_out, kb, kz, zs, zpad);
  return (int)cudaGetLastError();
}
