"""The image-path convolutions on NHWC tensors (counterparts of
cmtcoop_tpu/ops/conv_cf.py):

- `conv3x3_bn_relu`: fused 3x3 conv + folded eval BatchNorm (+ residual)
  + ReLU, the counterpart of `conv3x3_cf` (kernel 4, and kernel 5 with a
  residual); `conv3x3_bn_relu_packed` is the same on operands packed once
  by `pack_conv3x3_weight`, as the eval modules hold them;
- `osa_aggregate`: the OSA aggregate, a 1x1 conv over the virtual concat of
  a block's parts + folded BN + ReLU with the eSE spatial sums as a second
  output, the counterpart of `osa_agg_cf` (kernel 6);
  `osa_aggregate_packed` is the same on operands packed once by
  `pack_osa_weight`, as the eval modules hold them.

Each takes its plain version for a CPU tensor and launches its hand-written
CUDA kernel (csrc/conv3x3.cu, csrc/osa_agg.cu) for a CUDA tensor. Each
kernel has two routes, chosen by dtype: bfloat16 runs a tensor-core GEMM
(wgmma fed by TMA) with the launch plan of `conv3x3_plan` or
`osa_agg_plan`; float32 runs the CUDA-core kernel that serves the float32
checks. The TPU kernels'
channels-first lane layout (`to_cf` / `from_cf` / `lane_mask`) has no
counterpart: the kernels read and write NHWC.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cmtcoop_tpu_torch import _build

MAX_PARTS = 6  # part pointers the aggregate kernel takes
# the bf16 conv kernel (csrc/conv3x3.cu, which checks a plan against its
# own copy of these): input channels per K step (one 128-byte swizzled
# row), output pixels along x per tile row, and the block widths it is
# built for (Cout is rounded up to one; a wider Cout raises)
CHUNK = 64
BOX_W = 16
WIDTHS = (64, 128, 160, 192, 224, 256)
# the bf16 aggregate kernel's column tile widths (csrc/osa_agg.cu)
AGG_WIDTHS = (64, 128, 192, 256)


def fold_bn(weight, bias, running_mean, running_var, eps: float):
    """Eval BatchNorm as an affine (scale, bias), float32."""
    scale = weight.float() * torch.rsqrt(running_var.float() + eps)
    return scale, bias.float() - running_mean.float() * scale


def conv3x3_bn_relu_reference(x, weight, scale, bias, relu: bool = True,
                              residual: Optional[torch.Tensor] = None):
    """Plain version: F.conv2d in float32 on the dtype-rounded operands,
    then y * scale + bias (+ residual) and ReLU, cast back to x's dtype."""
    w = weight.to(x.dtype).float()
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w, padding=1)
    y = y.permute(0, 2, 3, 1) * scale.float() + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


@dataclasses.dataclass(eq=False)
class PackedConv3x3:
    """A 3x3 conv's operands as both kernel routes read them."""
    weight: torch.Tensor  # (Cout, 9 * cin_pad) in the compute dtype
    scale: torch.Tensor  # (Cout,) float32, the folded BN
    bias: torch.Tensor  # (Cout,) float32
    source: torch.Tensor  # the (Cout, Cin, 3, 3) weight: the plain operand
    # the bf16 kernel's TMA map of `weight` (128 bytes of host memory),
    # encoded at the first launch and fixed for the pack's life
    tc_map: Optional[ctypes.Array] = None

    @property
    def cin(self) -> int:
        return self.source.shape[1]

    @property
    def cout(self) -> int:
        return self.source.shape[0]


def pack_conv3x3_weight(weight: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, dtype) -> PackedConv3x3:
    """(Cout, Cin, 3, 3) -> (Cout, 9 * cin_pad) in `dtype`, K-major: column
    tap * cin_pad + ci holds weight[:, ci, dy, dx] with tap = dy * 3 + dx,
    zero for ci >= Cin (cin_pad = Cin rounded up to CHUNK, the K rows the
    bf16 kernel's zero-filled channel tail meets); scale and bias as
    contiguous float32."""
    cout, cin = weight.shape[:2]
    cin_pad = -(-cin // CHUNK) * CHUNK
    with torch.no_grad():
        wk = torch.zeros(cout, 3, 3, cin_pad, dtype=dtype,
                         device=weight.device)
        wk[..., :cin] = weight.permute(0, 2, 3, 1)
        return PackedConv3x3(wk.reshape(cout, 9 * cin_pad),
                             scale.detach().float().contiguous(),
                             bias.detach().float().contiguous(), weight)


class ConvPlan(NamedTuple):
    """The bf16 kernel's launch: blocks of `wg` consumer warpgroups cover a
    (4 * wg) x BOX_W pixel box of one image and all `bn` >= Cout channels;
    the grid is N * tiles_h * tiles_w blocks, x fastest; each block runs K
    in 9 taps x cin_pad / CHUNK steps."""
    bn: int
    wg: int
    tiles_w: int
    tiles_h: int
    cin_pad: int


@functools.lru_cache(maxsize=None)
def conv3x3_plan(n: int, h: int, w: int, cin: int, cout: int,
                 n_sms: int) -> ConvPlan:
    """The bf16 kernel's plan for x (n, h, w, cin) -> cout channels on a
    card of `n_sms` SMs: 128-pixel tiles (two consumer warpgroups, one
    block per SM) when they fill a wave, else 64-pixel tiles (one
    warpgroup, two blocks per SM). Raises ValueError unless Cin and Cout
    are multiples of 8 (TMA needs 16-byte strides) and Cout <= 256 (one
    block covers all of Cout)."""
    if cin % 8 or cout % 8 or cout > WIDTHS[-1]:
        raise ValueError(f"conv3x3_bn_relu: the bfloat16 kernel takes Cin and "
                         f"Cout multiples of 8 and Cout <= {WIDTHS[-1]}, got "
                         f"x {(n, h, w, cin)} -> Cout {cout}")
    bn = next(b for b in WIDTHS if b >= cout)
    tiles_w = -(-w // BOX_W)
    wg = 2 if n * -(-h // 8) * tiles_w >= n_sms else 1
    return ConvPlan(bn, wg, tiles_w, -(-h // (4 * wg)),
                    -(-cin // CHUNK) * CHUNK)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _weight_map(packed: PackedConv3x3, bn: int) -> ctypes.Array:
    """The packed weight's TMA map for the bf16 kernel, encoded once."""
    if packed.tc_map is None:
        buf = ctypes.create_string_buffer(128)
        _build.check(_build.lib().cmt_conv3x3_tc_weight_map(
            packed.weight.data_ptr(), packed.weight.shape[1] // 9,
            packed.cout, bn, buf), "cmt_conv3x3_tc_weight_map")
        packed.tc_map = buf
    return packed.tc_map


def conv3x3_bn_relu_packed(x: torch.Tensor, packed: PackedConv3x3,
                           relu: bool = True,
                           residual: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """`conv3x3_bn_relu` on operands from `pack_conv3x3_weight` in x's
    dtype. With a residual it runs kernel 5 (counted as
    `conv3x3_bn_relu_resid`), else kernel 4."""
    if x.device.type == "cpu":
        return conv3x3_bn_relu_reference(x, packed.source, packed.scale,
                                          packed.bias, relu, residual)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_relu: no kernel for {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("conv3x3_bn_relu: x must be contiguous NHWC")
    n, h, w, cin = x.shape
    cout = packed.cout
    cin_pad = packed.weight.shape[1] // 9
    if (packed.cin != cin or packed.weight.dtype != x.dtype
            or packed.weight.device != x.device
            or packed.scale.device != x.device):
        raise ValueError(f"conv3x3_bn_relu: weight packed for Cin "
                         f"{packed.cin} {packed.weight.dtype} on "
                         f"{packed.weight.device} does not match x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if residual is not None and (
            residual.shape != (n, h, w, cout) or residual.dtype != x.dtype
            or residual.device != x.device or not residual.is_contiguous()):
        raise ValueError("conv3x3_bn_relu: residual must be a contiguous "
                         f"{(n, h, w, cout)} tensor like x")
    out = torch.empty(n, h, w, cout, dtype=x.dtype, device=x.device)
    rest = (packed.scale.data_ptr(), packed.bias.data_ptr(),
            _build.ptr(residual), out.data_ptr())
    stream = _build.stream_ptr(x.device)
    if x.dtype == torch.bfloat16:
        plan = conv3x3_plan(n, h, w, cin, cout, sm_count(x.device))
        if x.data_ptr() % 16 or (rest[2] or 0) % 16:
            raise ValueError("conv3x3_bn_relu: x and the residual must be "
                             "16-byte aligned for TMA")
        _build.check(_build.lib().cmt_conv3x3_bn_relu_tc(
            x.data_ptr(), _weight_map(packed, plan.bn), *rest, n, h, w, cin,
            cin_pad, cout, plan.bn, plan.wg, plan.tiles_w, plan.tiles_h,
            int(relu), stream), "cmt_conv3x3_bn_relu_tc")
    elif x.dtype == torch.float32:
        _build.check(_build.lib().cmt_conv3x3_bn_relu_f32(
            x.data_ptr(), packed.weight.data_ptr(), *rest, n, h, w, cin,
            cin_pad, cout, int(relu), stream), "cmt_conv3x3_bn_relu_f32")
    else:
        raise TypeError(f"conv3x3_bn_relu: kernels take float32 or "
                        f"bfloat16, got {x.dtype}")
    _build.count("conv3x3_bn_relu" if residual is None
                 else "conv3x3_bn_relu_resid", (n, h, w, cin, cout))
    return out


def conv3x3_bn_relu(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    relu: bool = True,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, H, W, Cin), weight (Cout, Cin, 3, 3) (torch layout), scale and
    bias (Cout,) float32, residual None or (N, H, W, Cout) in x's dtype ->
    (N, H, W, Cout) in x's dtype; stride 1, pad 1. With a residual it runs
    kernel 5 (counted as `conv3x3_bn_relu_resid`), else kernel 4. Packs the
    weight on every call: the eval modules hold theirs packed."""
    if x.device.type == "cpu":
        return conv3x3_bn_relu_reference(x, weight, scale, bias, relu,
                                          residual)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_relu: no kernel for {x.device}")
    cout = weight.shape[0]
    if (x.dim() != 4 or weight.shape != (cout, x.shape[-1], 3, 3)
            or weight.device != x.device):
        raise ValueError(f"conv3x3_bn_relu: weight {tuple(weight.shape)} does "
                         f"not match x {tuple(x.shape)}")
    if scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError("conv3x3_bn_relu: scale and bias must be (Cout,)")
    return conv3x3_bn_relu_packed(
        x, pack_conv3x3_weight(weight, scale, bias, x.dtype), relu, residual)


def _fold_agg_weight(weight, scale, dtype):
    """(sum C, Cout) weight with the BN scale folded in, then cast to the
    parts' dtype (the TPU wrapper's order: fold first, cast second)."""
    return (weight.float() * scale.float()[None, :]).to(dtype)


def osa_aggregate_reference(parts: Sequence[torch.Tensor],
                            weight: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: torch.cat of the parts, a float32 matmul with the
    folded weight, bias and ReLU; gap sums the float32 map per view."""
    dt = parts[0].dtype
    cat = torch.cat([p.float() for p in parts], dim=-1)
    y = cat @ _fold_agg_weight(weight, scale, dt).float() + bias.float()
    y = torch.relu(y)
    return y.to(dt), y.sum(dim=(1, 2))


def agg_k_offsets(chans: Sequence[int]) -> Tuple[int, ...]:
    """Each part's first K row in the packed aggregate weight, then kpad:
    the parts' channel counts rounded up to CHUNK, summed in order."""
    offs = [0]
    for c in chans:
        offs.append(offs[-1] + -(-c // CHUNK) * CHUNK)
    return tuple(offs)


@dataclasses.dataclass(eq=False)
class PackedAgg:
    """An OSA aggregate's operands as both kernel routes read them."""
    weight: torch.Tensor  # (Cout, kpad) in the compute dtype, K-major
    bias: torch.Tensor  # (Cout,) float32, the folded BN's
    chans: Tuple[int, ...]  # the parts' channel counts, in order
    source: torch.Tensor  # the (sum C, Cout) weight: the plain operand
    scale: torch.Tensor  # (Cout,) float32, the folded BN's
    # the bf16 kernel's TMA maps of `weight` (128 bytes of host memory
    # each) by column tile width, encoded at the first launch with that
    # width and fixed for the pack's life
    tc_maps: dict = dataclasses.field(default_factory=dict)

    @property
    def cout(self) -> int:
        return self.source.shape[1]


def pack_osa_weight(weight: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, chans: Sequence[int],
                    dtype) -> PackedAgg:
    """(sum C, Cout) weight and the folded BN -> (Cout, kpad) in `dtype`,
    K-major: the scale folded in float32 and cast first (the TPU wrapper's
    order), then part i's rows at K columns agg_k_offsets(chans)[i] ..
    + C_i - 1, zero up to the next part's (the K rows the bf16 kernel's
    zero-filled channel tails meet); scale and bias as contiguous
    float32."""
    chans = tuple(int(c) for c in chans)
    cout = weight.shape[1]
    if weight.dim() != 2 or weight.shape[0] != sum(chans):
        raise ValueError(f"osa_aggregate: weight {tuple(weight.shape)} does "
                         f"not match the parts' {sum(chans)} channels")
    if scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError("osa_aggregate: scale and bias must be (Cout,)")
    offs = agg_k_offsets(chans)
    with torch.no_grad():
        folded = _fold_agg_weight(weight, scale, dtype)
        wk = torch.zeros(cout, offs[-1], dtype=dtype, device=weight.device)
        row = 0
        for c, k0 in zip(chans, offs):
            wk[:, k0:k0 + c] = folded[row:row + c].t()
            row += c
        return PackedAgg(wk, bias.detach().float().contiguous(), chans,
                         weight, scale.detach().float().contiguous())


AGG_BM = 128  # pixels a block of the bf16 aggregate kernel


class AggPlan(NamedTuple):
    """The bf16 aggregate kernel's launch: blocks cover AGG_BM pixels of
    one view and `bn` columns of Cout; the grid is V * tiles * col_tiles
    blocks, column tiles fastest, then the view's pixel tiles; each block
    runs K in one step per CHUNK of each part (kpad / CHUNK steps, a
    part's tail included). 64 and 128 columns run two blocks an SM."""
    bn: int
    tiles: int
    col_tiles: int
    kpad: int

    @property
    def blocks(self) -> int:  # a view's
        return self.tiles * self.col_tiles

    @property
    def per_sm(self) -> int:
        return 1 if self.bn > 128 else 2


def osa_agg_plans(v: int, hw: int, chans: Sequence[int],
                  cout: int) -> Tuple[AggPlan, ...]:
    """Every plan the bf16 aggregate kernel takes for parts (v, hw, C_i) ->
    cout channels, widest columns first, none wider than Cout needs.
    Raises ValueError unless every C_i and Cout is a multiple of 8 (TMA
    needs 16-byte strides)."""
    if cout % 8 or any(c % 8 or c <= 0 for c in chans):
        raise ValueError(f"osa_aggregate: the bfloat16 kernel takes channel "
                         f"counts that are multiples of 8, got parts "
                         f"{tuple(chans)} -> Cout {cout}")
    widest = next(b for b in AGG_WIDTHS if b >= min(cout, AGG_WIDTHS[-1]))
    kpad = agg_k_offsets(chans)[-1]
    return tuple(AggPlan(bn, -(-hw // AGG_BM), -(-cout // bn), kpad)
                 for bn in AGG_WIDTHS[::-1] if bn <= widest)


def agg_plan_cost(plan: AggPlan, v: int, n_sms: int) -> float:
    """A plan's modelled time, in columns an SM: the blocks go out n_sms *
    per_sm at a time, each SM's share of the last, partial wave counting as
    the most blocks any SM takes in it; a 64-column tile runs at 0.65 of
    the others' rate a column (both fitted to chip_smoke's sweep of every
    tile, PERF.md)."""
    full, rest = divmod(v * plan.blocks, n_sms * plan.per_sm)
    slots = full * plan.per_sm + -(-rest // n_sms)
    return slots * plan.bn / (0.65 if plan.bn == 64 else 1.0)


@functools.lru_cache(maxsize=None)
def osa_agg_plan(v: int, hw: int, chans: Tuple[int, ...], cout: int,
                 n_sms: int) -> AggPlan:
    """The bf16 aggregate kernel's plan for parts (v, hw, C_i) -> cout
    channels on a card of `n_sms` SMs: of `osa_agg_plans`, the least
    `agg_plan_cost`; on a tie the one whose grid fills a wave of the card,
    then, with 16 K steps or more, the wider tile (its longer main loop
    hides its epilogue), else the one of two blocks an SM (whose epilogue
    the other block's main loop hides). Raises ValueError unless every C_i
    and Cout is a multiple of 8."""
    plans = osa_agg_plans(v, hw, chans, cout)
    long_k = plans[0].kpad >= 16 * CHUNK

    def key(p):
        return (agg_plan_cost(p, v, n_sms), v * p.blocks < n_sms,
                0 if long_k else -p.per_sm, -p.bn)
    return min(plans, key=key)


def _agg_weight_map(packed: PackedAgg, bn: int) -> ctypes.Array:
    """The packed weight's TMA map for column tiles of `bn`, encoded
    once."""
    if bn not in packed.tc_maps:
        buf = ctypes.create_string_buffer(128)
        _build.check(_build.lib().cmt_osa_agg_tc_weight_map(
            packed.weight.data_ptr(), packed.weight.shape[1], packed.cout,
            bn, buf), "cmt_osa_agg_tc_weight_map")
        packed.tc_maps[bn] = buf
    return packed.tc_maps[bn]


def osa_aggregate_packed(parts: Sequence[torch.Tensor], packed: PackedAgg,
                         plan: Optional[AggPlan] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`osa_aggregate` on operands from `pack_osa_weight` in the parts'
    dtype, as the eval modules hold them. `plan` (bf16 only) replaces
    `osa_agg_plan`'s with another of `osa_agg_plans`, to compare them."""
    p0 = parts[0]
    if p0.device.type == "cpu":
        return osa_aggregate_reference(parts, packed.source, packed.scale,
                                       packed.bias)
    if p0.device.type != "cuda":
        raise ValueError(f"osa_aggregate: no kernel for {p0.device}")
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"osa_aggregate: takes 1 to {MAX_PARTS} parts, got "
                         f"{len(parts)}")
    v, h, w = p0.shape[:3]
    for p in parts:
        if not (p.dim() == 4 and p.shape[:3] == (v, h, w)
                and p.dtype == p0.dtype and p.device == p0.device
                and p.is_contiguous()):
            raise ValueError("osa_aggregate: parts must be contiguous NHWC "
                             "tensors of one (V, H, W), dtype and device")
    chans = tuple(p.shape[3] for p in parts)
    if (chans != packed.chans or packed.weight.dtype != p0.dtype
            or packed.weight.device != p0.device
            or packed.bias.device != p0.device):
        raise ValueError(f"osa_aggregate: weight packed for parts "
                         f"{packed.chans} {packed.weight.dtype} on "
                         f"{packed.weight.device} does not match parts "
                         f"{chans} {p0.dtype} on {p0.device}")
    cout, hw = packed.cout, h * w
    kpad = packed.weight.shape[1]
    out = torch.empty(v, h, w, cout, dtype=p0.dtype, device=p0.device)
    gap = torch.empty(v, cout, dtype=torch.float32, device=p0.device)
    pad = MAX_PARTS - len(parts)
    ptrs = [p.data_ptr() for p in parts] + [None] * pad
    stream = _build.stream_ptr(p0.device)
    if p0.dtype == torch.bfloat16:
        plan = plan or osa_agg_plan(v, hw, chans, cout, sm_count(p0.device))
        if any(p.data_ptr() % 16 for p in parts):
            raise ValueError("osa_aggregate: parts must be 16-byte aligned "
                             "for TMA")
        partial = torch.empty(v, plan.tiles, cout, dtype=torch.float32,
                              device=p0.device)
        _build.check(_build.lib().cmt_osa_aggregate_tc(
            len(parts), *ptrs, *chans, *[0] * pad,
            _agg_weight_map(packed, plan.bn), packed.bias.data_ptr(),
            out.data_ptr(), partial.data_ptr(), gap.data_ptr(), v, hw, cout,
            kpad, plan.bn, plan.tiles, plan.col_tiles, stream),
            "cmt_osa_aggregate_tc")
    elif p0.dtype == torch.float32:
        partial = torch.empty(v, -(-hw // 128), cout, dtype=torch.float32,
                              device=p0.device)
        _build.check(_build.lib().cmt_osa_aggregate_f32(
            len(parts), *ptrs, *chans, *[0] * pad,
            packed.weight.data_ptr(), kpad, packed.bias.data_ptr(),
            out.data_ptr(), partial.data_ptr(), gap.data_ptr(), v, hw, cout,
            stream), "cmt_osa_aggregate_f32")
    else:
        raise TypeError(f"osa_aggregate: kernels take float32 or bfloat16, "
                        f"got {p0.dtype}")
    _build.count("osa_aggregate", (v, h, w) + chans + (cout,))
    return out, gap


def osa_aggregate(parts: Sequence[torch.Tensor], weight: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """parts: 1 to 6 NHWC tensors (V, H, W, C_i) of one dtype; weight
    (sum C_i, Cout); scale and bias (Cout,) the folded BN. Returns agg =
    relu(concat(parts) @ (weight * scale) + bias) as (V, H, W, Cout) in the
    parts' dtype, and gap (V, Cout) float32, the per-view sum of the float32
    post-ReLU values. The concat is never materialized on the card. Packs
    the weight on every call: the eval modules hold theirs packed."""
    p0 = parts[0]
    if p0.device.type == "cpu":
        return osa_aggregate_reference(parts, weight, scale, bias)
    if p0.device.type != "cuda":
        raise ValueError(f"osa_aggregate: no kernel for {p0.device}")
    if weight.device != p0.device:
        raise ValueError("osa_aggregate: weight and parts on other devices")
    return osa_aggregate_packed(parts, pack_osa_weight(
        weight, scale, bias, [p.shape[-1] for p in parts], p0.dtype))
