"""Fused pillar convolution: conv (+BN eval) (+residual) (+ReLU)
(+occupancy) in one kernel (counterpart of cmtcoop_tpu/ops/pillar_fused.py).

`fused_pillar_conv` takes the plain version for a CPU tensor and launches
the hand-written CUDA kernel (csrc/pillar_conv.cu) for a CUDA tensor:
kernel 1 for 9 BEV taps (the submanifold convs and the strided down convs),
kernel 2 for 1 BEV tap (`conv_out`). Both run an implicit GEMM over the
occupied output rows (`active_rows`, compacted on the device), the dtype
picking the route: bfloat16 on the tensor cores (wgmma, A gathered by
cp.async through the neighbour map, B the weight packed by
`pack_pillar_weight` in the kernel's K order, launched by
`pillar_conv_plan`), float32 on the CUDA cores. `fused_pillar_conv_packed`
is the same on operands packed once and rows compacted once per
occupancy, as the eval encoder holds them. The JAX package's packed rows,
band matrices, windows, retry ladder and XLA fallback have no
counterpart: the neighbour map is gathered directly, which is exact at any
density.

`pin_rows` is kernel 10 (csrc/rows_copy.cu), the row-major identity copy of
the JAX package's `_pin_rows_layout`. That copy pinned XLA's layout on the
retry ladder's fallback branch, which the port does not have, so no path of
the port calls it; it is held against its plain version, `clone()`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from cmtcoop_tpu_torch import _build
from cmtcoop_tpu_torch.ops.conv_cf import sm_count
from cmtcoop_tpu_torch.ops.pillars import occ_downsample, pillar_conv


def fused_pillar_conv_reference(feats, nbr, weights, *, kz=3, z_stride=1,
                                z_pad=1, scale=None, bias=None, occ_out=None,
                                residual=None, relu=False, occ_in=None,
                                fold_occ=False):
    """Plain PyTorch version: `pillar_conv` plus the epilogue in float32
    (the twin of the JAX package's `_xla_reference`), with
    `occ_downsample` for `fold_occ`."""
    if fold_occ:
        occ_out = occ_downsample(occ_in, nbr, kz, z_stride, z_pad)
    out = pillar_conv(feats, nbr, weights, kz, z_stride, z_pad).float()
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    if residual is not None:
        out = out + residual.float()
    if relu:
        out = torch.relu(out)
    if occ_out is not None:
        out = out * occ_out.float()[..., None]
    out = out.to(feats.dtype)
    return (out, occ_out) if fold_occ else out


def fused_pillar_conv(
    feats: torch.Tensor,                   # (P_in, Z_in, Cin)
    nbr: torch.Tensor,                     # (P_out, KB) int32, miss -> P_in
    weights: torch.Tensor,                 # (kz*KB, Cin, Cout) z-major
    *,
    kz: int = 3,
    z_stride: int = 1,
    z_pad: int = 1,
    scale: Optional[torch.Tensor] = None,     # (Cout,) BN eval scale
    bias: Optional[torch.Tensor] = None,      # (Cout,) BN eval bias
    occ_out: Optional[torch.Tensor] = None,   # (P_out, Z_out) bool
    residual: Optional[torch.Tensor] = None,  # (P_out, Z_out, Cout)
    relu: bool = False,
    occ_in: Optional[torch.Tensor] = None,    # (P_in, Z_in) bool
    fold_occ: bool = False,
):
    """Returns (P_out, Z_out, Cout) in the feature dtype; with
    `fold_occ=True` (down convs) also the output occupancy
    `occ_downsample(occ_in, nbr, ...)`, which then masks the output. On a
    CUDA tensor the operands are packed for this call
    (`pack_pillar_weight`); the eval modules hold theirs
    (`PillarConvPack`) and call `fused_pillar_conv_packed`."""
    kw = dict(z_stride=z_stride, z_pad=z_pad, occ_out=occ_out,
              residual=residual, relu=relu, occ_in=occ_in, fold_occ=fold_occ)
    if feats.device.type == "cpu":
        return fused_pillar_conv_reference(feats, nbr, weights, kz=kz,
                                           scale=scale, bias=bias, **kw)
    if feats.device.type != "cuda":
        raise ValueError(f"fused_pillar_conv: no kernel for {feats.device}")
    for name, t in (("scale", scale), ("bias", bias)):
        _require(t is None or (t.shape == (weights.shape[-1],)
                               and t.dtype == torch.float32
                               and t.device == feats.device),
                 f"{name} must be float32 (Cout,) on the feats device")
    _require(weights.dim() == 3 and weights.shape[0] % kz == 0,
             f"weights must be (kz*KB, Cin, Cout), got "
             f"{tuple(weights.shape)}")
    return fused_pillar_conv_packed(
        feats, nbr, pack_pillar_weight(weights, scale, bias, feats.dtype, kz),
        **kw)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_pillar_conv: {msg}")


# ---------------------------- the packed operands ---------------------------

# the bf16 kernel (csrc/pillar_conv.cu `pillar_tc`, which checks a plan
# against its own copy of these): K elements a step (one 128-byte tile
# row), the most K steps, the ring's stages, the widths it is built for
# (Cout is rounded up to one; a wider Cout raises) and the channel multiple
# its 16-byte gathers need (Cin is padded to it)
CHUNK = 64
MAX_KSTEPS = 64
STAGES = 4
TC_WIDTHS = (16, 32, 64, 128)
CIN_ALIGN = 8
# shared memory an H100 SM gives its blocks, and what each block reserves
SM_SMEM, BLOCK_SMEM_RESERVED = 233472, 1024


def cin_padded(cin: int) -> int:
    return -(-cin // CIN_ALIGN) * CIN_ALIGN


def k_steps(kb: int, kz: int, cin: int) -> int:
    """K steps of the bf16 kernel's (j, dz, ci) walk: KB * kz * cin_pad
    rounded up to CHUNK."""
    return -(-kb * kz * cin_padded(cin) // CHUNK)


@dataclasses.dataclass(eq=False)
class PackedPillarConv:
    """A pillar conv's operands as both kernel routes read them."""
    weight: torch.Tensor  # (Cout, k_steps * CHUNK), the bf16 kernel's K walk
    scale: Optional[torch.Tensor]  # (Cout,) float32, the folded BN
    bias: Optional[torch.Tensor]   # (Cout,) float32
    source: torch.Tensor  # (kz*KB, Cin, Cout): the plain version's and the
    #                       float32 kernel's operand
    kz: int
    # the bf16 kernel's TMA map of `weight` (128 bytes of host memory),
    # encoded at the first launch and fixed for the pack's life
    tc_map: Optional[ctypes.Array] = None

    @property
    def kb(self) -> int:
        return self.source.shape[0] // self.kz

    @property
    def cin(self) -> int:
        return self.source.shape[1]

    @property
    def cout(self) -> int:
        return self.source.shape[2]


def pack_pillar_weight(weights: torch.Tensor, scale: Optional[torch.Tensor],
                       bias: Optional[torch.Tensor], dtype,
                       kz: int = 3) -> PackedPillarConv:
    """(kz*KB, Cin, Cout) z-major -> (Cout, k_pad) in `dtype`, K-major in the
    bf16 kernel's (j, dz, ci) order: column (j * kz + dz) * cin_pad + ci
    holds weights[dz * KB + j, ci], zero for ci >= Cin and past KB * kz *
    cin_pad (cin_pad = Cin rounded up to CIN_ALIGN, k_pad = k_steps *
    CHUNK); scale and bias as contiguous float32; the weights themselves,
    contiguous, for the plain version and the float32 kernel."""
    taps, cin, cout = weights.shape
    kb = taps // kz
    cin_pad = cin_padded(cin)
    with torch.no_grad():
        src = weights.detach().contiguous()
        wk = torch.zeros(cout, k_steps(kb, kz, cin) * CHUNK, dtype=dtype,
                         device=weights.device)
        wk[:, :kb * kz * cin_pad].view(cout, kb, kz, cin_pad)[..., :cin] = \
            src.view(kz, kb, cin, cout).permute(3, 1, 0, 2)
        return PackedPillarConv(
            wk, None if scale is None else scale.detach().float().contiguous(),
            None if bias is None else bias.detach().float().contiguous(),
            src, kz)


def tile_rows(bn: int) -> int:
    """Rows a tile of the bf16 kernel, fixed by its width (csrc/pillar_conv.cu
    `wg_of`): 128 (two warpgroups) for bn <= 64, else 64."""
    return 128 if bn <= 64 else 64


class PillarPlan(NamedTuple):
    """The bf16 kernel's launch: `grid` persistent blocks walk tiles of `bm`
    active rows (block b takes tiles b, b + grid, ... up to the device
    count) and all `bn` >= Cout columns; each tile runs K in `ksteps` steps
    of CHUNK; `smem` bytes a block, `per_sm` blocks an SM."""
    bn: int
    cin_pad: int
    ksteps: int
    per_sm: int
    grid: int
    smem: int

    @property
    def bm(self) -> int:
        return tile_rows(self.bn)


def tc_smem(bn: int, kb: int) -> int:
    """Dynamic shared memory of one bf16 block (csrc/pillar_conv.cu
    `Cfg::SMEM`): 1024 to align the ring, STAGES of (A, B) tiles, their
    barriers, the K table, the tile rows' neighbours."""
    bm = tile_rows(bn)
    return (1024 + STAGES * (bm + bn) * CHUNK * 2 + 8 * STAGES
            + 4 * MAX_KSTEPS * 8 + 4 * bm * kb)


@functools.lru_cache(maxsize=None)
def pillar_conv_plan(kb: int, kz: int, cin: int, cout: int, max_rows: int,
                     n_sms: int) -> PillarPlan:
    """The bf16 kernel's plan for a conv of KB BEV taps and kz z taps, Cin
    -> Cout, with at most `max_rows` active output rows (P_out * Z_out), on
    a card of `n_sms` SMs. The rows a tile follow from the width
    (`tile_rows`): the count of active rows stays on the device, and on the
    benchmark clouds the Cout-128 convs (the last level, the down conv into
    it and conv_out) have ~10k occupied rows, 84 tiles of 128, under a wave
    of a 132-SM card, so they take tiles of 64, while the levels of Cout <=
    64 have 33k-76k and take tiles of 128. As many blocks as fit an SM, at
    most two (their threads' registers), and no more than the row bound has
    tiles. Raises ValueError
    on what the kernel does not take: KB other than 1 or 9, kz over 3, Cout
    not a multiple of 8 or over 128, K over MAX_KSTEPS steps."""
    ksteps = k_steps(kb, kz, cin)
    if (kb not in (1, 9) or not 1 <= kz <= 3 or cout % 8
            or cout > TC_WIDTHS[-1] or ksteps > MAX_KSTEPS):
        raise ValueError(
            f"fused_pillar_conv: the bfloat16 kernel takes KB 1 or 9, kz <= "
            f"3, Cout a multiple of 8 up to {TC_WIDTHS[-1]} and K up to "
            f"{MAX_KSTEPS * CHUNK}, got KB {kb}, kz {kz}, Cin {cin}, Cout "
            f"{cout}")
    bn = next(b for b in TC_WIDTHS if b >= cout)
    smem = tc_smem(bn, kb)
    per_sm = min(2, SM_SMEM // (smem + BLOCK_SMEM_RESERVED))
    grid = max(1, min(-(-max_rows // tile_rows(bn)), n_sms * per_sm))
    return PillarPlan(bn, cin_padded(cin), ksteps, per_sm, grid, smem)


# ------------------------------ the active rows -----------------------------

class ActiveRows(NamedTuple):
    """The occupied (pillar, z) rows of `occ`, compacted in row order on the
    device: rows int32 (P*Z + 1,) with rows[:count] valid, count int32
    (1,). No host synchronisation: the count stays on the device."""
    occ: torch.Tensor
    rows: torch.Tensor
    count: torch.Tensor


def active_rows(occ: torch.Tensor) -> ActiveRows:
    """`ActiveRows` of `occ`: the encoder computes them once per occupancy
    and passes them to every conv whose output occupancy it is."""
    flat = occ.reshape(-1)
    m = flat.numel()
    pos = torch.cumsum(flat, 0, dtype=torch.int32)
    rows = torch.empty(m + 1, dtype=torch.int32, device=occ.device)
    target = torch.where(flat, pos.long() - 1, m)
    rows.scatter_(0, target, torch.arange(m, dtype=torch.int32,
                                          device=occ.device))
    return ActiveRows(occ, rows, pos[-1:])


def fold_occupancy(occ_in: torch.Tensor, nbr: torch.Tensor, kz: int,
                   z_stride: int, z_pad: int) -> torch.Tensor:
    """A strided conv's output occupancy, `occ_downsample` (the kernel
    `cmt_pillar_occ_fold` on a CUDA tensor)."""
    if occ_in.device.type == "cpu":
        return occ_downsample(occ_in, nbr, kz, z_stride, z_pad)
    if occ_in.device.type != "cuda":
        raise ValueError(f"fused_pillar_conv: no kernel for {occ_in.device}")
    p_in, z_in = occ_in.shape
    p_out, kb = nbr.shape
    _require(occ_in.dtype == torch.bool and occ_in.is_contiguous()
             and nbr.dtype == torch.int32 and nbr.is_contiguous(),
             "fold_occ takes contiguous bool occ_in (P_in, Z_in) and int32 "
             "nbr")
    z_out = (z_in + 2 * z_pad - kz) // z_stride + 1
    occ = torch.empty(p_out, z_out, dtype=torch.bool, device=occ_in.device)
    _build.check(_build.lib().cmt_pillar_occ_fold(
        occ_in.data_ptr(), nbr.data_ptr(), occ.data_ptr(), p_in, z_in,
        p_out, z_out, kb, kz, z_stride, z_pad,
        _build.stream_ptr(occ_in.device)), "cmt_pillar_occ_fold")
    return occ


# ------------------------------ the packed call -----------------------------

def fused_pillar_conv_packed(
    feats: torch.Tensor, nbr: torch.Tensor, packed: PackedPillarConv, *,
    z_stride: int = 1, z_pad: int = 1,
    occ_out: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None, relu: bool = False,
    occ_in: Optional[torch.Tensor] = None, fold_occ: bool = False,
    rows: Optional[ActiveRows] = None):
    """`fused_pillar_conv` on operands from `pack_pillar_weight`. `rows`,
    the `active_rows` of occ_out, may be given (it must be of that very
    tensor); else they are compacted here. Runs kernel 1 (KB 9) or 2 (KB
    1): bf16 on the tensor cores, float32 on the CUDA cores."""
    kw = dict(kz=packed.kz, z_stride=z_stride, z_pad=z_pad,
              scale=packed.scale, bias=packed.bias, occ_out=occ_out,
              residual=residual, relu=relu, occ_in=occ_in, fold_occ=fold_occ)
    if feats.device.type == "cpu":
        return fused_pillar_conv_reference(feats, nbr, packed.source, **kw)
    if feats.device.type != "cuda":
        raise ValueError(f"fused_pillar_conv: no kernel for {feats.device}")
    dev = feats.device
    _require(feats.dim() == 3 and feats.is_contiguous(),
             "feats must be contiguous (P_in, Z_in, Cin)")
    p_in, z_in, cin = feats.shape
    _require(nbr.dim() == 2 and nbr.dtype == torch.int32
             and nbr.is_contiguous() and nbr.device == dev,
             "nbr must be contiguous int32 (P_out, KB) on the feats device")
    p_out, kb = nbr.shape
    kz, cout = packed.kz, packed.cout
    _require(kb in (1, 9), f"KB must be 9 or 1, got {kb}")
    _require(packed.kb == kb and packed.cin == cin
             and packed.weight.device == dev,
             f"weights packed for KB {packed.kb}, Cin {packed.cin} on "
             f"{packed.weight.device} do not match nbr {tuple(nbr.shape)} "
             f"and feats {tuple(feats.shape)} on {dev}")
    z_out = (z_in + 2 * z_pad - kz) // z_stride + 1
    _require(residual is None or (
        residual.shape == (p_out, z_out, cout) and residual.dtype ==
        feats.dtype and residual.is_contiguous() and residual.device == dev),
        "residual must be contiguous (P_out, Z_out, Cout) in the feats dtype")
    if fold_occ:
        _require(occ_out is None and rows is None and occ_in is not None
                 and occ_in.shape == (p_in, z_in),
                 "fold_occ takes occ_in (P_in, Z_in) and no occ_out or rows")
        occ = fold_occupancy(occ_in, nbr, kz, z_stride, z_pad)
    else:
        _require(occ_out is not None and occ_out.shape == (p_out, z_out)
                 and occ_out.dtype == torch.bool,
                 "the kernel takes bool occ_out (P_out, Z_out)")
        occ = occ_out
    if rows is None:
        rows = active_rows(occ)
    _require(rows.occ is occ, "rows must be the active_rows of occ_out")
    # the kernel writes the occupied rows only; the rest stay zero
    out = torch.zeros(p_out, z_out, cout, dtype=feats.dtype, device=dev)
    name = "pillar_conv_kb9" if kb == 9 else "pillar_conv_kb1"
    lib, stream = _build.lib(), _build.stream_ptr(dev)
    tail = (_build.ptr(packed.scale), _build.ptr(packed.bias),
            _build.ptr(residual), rows.rows.data_ptr(),
            rows.count.data_ptr(), out.data_ptr())
    if feats.dtype == torch.bfloat16:
        plan = pillar_conv_plan(kb, kz, cin, cout, p_out * z_out,
                                sm_count(dev))
        _require(packed.weight.dtype == torch.bfloat16,
                 "bf16 feats need a bf16 pack")
        x = feats
        if plan.cin_pad != cin:  # 16-byte gathers: Cin padded once
            x = torch.nn.functional.pad(feats, (0, plan.cin_pad - cin))
        _require(all(p % 16 == 0 for p in (x.data_ptr(),) + tail[:3]
                     if p is not None),
                 "feats, scale, bias and the residual must be 16-byte "
                 "aligned")
        _build.check(lib.cmt_pillar_conv_tc(
            kb, x.data_ptr(), nbr.data_ptr(), _weight_map(packed, plan.bn),
            *tail, p_in, z_in, plan.cin_pad, z_out, cout, kz, z_stride,
            z_pad, int(relu), plan.bn, plan.ksteps, plan.grid, stream),
            "cmt_pillar_conv_tc")
    elif feats.dtype == torch.float32:
        w = packed.source.float()  # as the plain version casts it
        _build.check(lib.cmt_pillar_conv_f32(
            kb, feats.data_ptr(), nbr.data_ptr(), w.data_ptr(), *tail,
            p_out * z_out, p_in, z_in, cin, z_out, cout, kz, z_stride,
            z_pad, int(relu), stream), "cmt_pillar_conv_f32")
    else:
        raise TypeError(f"fused_pillar_conv: kernels take float32 or "
                        f"bfloat16, got {feats.dtype}")
    _build.count(name, (kb, p_in, z_in, cin, p_out, z_out, cout,
                        residual is not None))
    return (out, occ) if fold_occ else out


def _weight_map(packed: PackedPillarConv, bn: int) -> ctypes.Array:
    """The packed weight's TMA map for the bf16 kernel (its width `bn`
    follows from Cout), encoded once."""
    if packed.tc_map is None:
        buf = ctypes.create_string_buffer(128)
        _build.check(_build.lib().cmt_pillar_tc_weight_map(
            packed.weight.data_ptr(), packed.weight.shape[1], packed.cout,
            bn, buf), "cmt_pillar_tc_weight_map")
        packed.tc_map = buf
    return packed.tc_map


def gather_wgmma_check(a: torch.Tensor, b: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """The bf16 pillar kernel's A path alone (csrc/wgmma_selftest.cu, which
    3): a[idx] (64 rows of 64, a zero row where idx < 0) gathered by
    cp.async into the 128-byte swizzle, times b (16, 64)^T by wgmma
    m64n16k16, float32 (64, 16). a (64, 64) and b bf16, idx int32 (64,),
    all on the card."""
    a, b, idx = (t.contiguous() for t in (a, b, idx))
    if (a.shape != (64, 64) or b.shape != (16, 64) or idx.shape != (64,)
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
            or idx.dtype != torch.int32
            or any(t.device.type != "cuda" for t in (a, b, idx))):
        raise ValueError("gather_wgmma_check: bf16 a (64, 64), b (16, 64) "
                         "and int32 idx (64,) on the card")
    d = torch.empty(64, 16, dtype=torch.float32, device=a.device)
    _build.check(_build.lib().cmt_wgmma_selftest(
        3, a.data_ptr(), b.data_ptr(), idx.data_ptr(), d.data_ptr(), None,
        _build.stream_ptr(a.device)), "cmt_wgmma_selftest")
    return d


def pin_rows_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 10: a row-major copy."""
    return x.clone()


def pin_rows(x: torch.Tensor) -> torch.Tensor:
    """A new row-major copy of the contiguous (P, W) tensor `x`, of any
    element type (kernel 10 on a CUDA tensor)."""
    if x.device.type == "cpu":
        return pin_rows_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"pin_rows: no kernel for {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("pin_rows: x must be a contiguous (P, W) tensor")
    out = torch.empty_like(x)
    if x.numel():
        _build.check(_build.lib().cmt_rows_copy(
            x.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1] * x.element_size(), _build.stream_ptr(x.device)),
            "cmt_rows_copy")
        _build.count("rows_copy")
    return out
