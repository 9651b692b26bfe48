"""The image-path convolutions on NHWC tensors (counterparts of
cmtcoop_tpu/ops/conv_cf.py):

- `conv3x3_bn_relu`: fused 3x3 conv + folded eval BatchNorm (+ residual)
  + ReLU, the counterpart of `conv3x3_cf` (kernel 4, and kernel 5 with a
  residual);
- `osa_aggregate`: the OSA aggregate, a 1x1 conv over the virtual concat of
  a block's parts + folded BN + ReLU with the eSE spatial sums as a second
  output, the counterpart of `osa_agg_cf` (kernel 6).

Each takes its plain version for a CPU tensor and launches its hand-written
CUDA kernel (csrc/conv3x3.cu, csrc/osa_agg.cu) for a CUDA tensor. The TPU
kernels' channels-first lane layout (`to_cf` / `from_cf` / `lane_mask`) has
no counterpart: the kernels read and write NHWC.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cmtcoop_tpu_torch import _build

MAX_PARTS = 6  # part pointers the aggregate kernel takes


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


def conv3x3_bn_relu(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    relu: bool = True,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, H, W, Cin), weight (Cout, Cin, 3, 3) (torch layout), scale and
    bias (Cout,) float32, residual None or (N, H, W, Cout) in x's dtype ->
    (N, H, W, Cout) in x's dtype; stride 1, pad 1. With a residual it runs
    kernel 5 (counted as `conv3x3_bn_relu_resid`), else kernel 4."""
    if x.device.type == "cpu":
        return conv3x3_bn_relu_reference(x, weight, scale, bias, relu,
                                          residual)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_relu: no kernel for {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("conv3x3_bn_relu: x must be contiguous NHWC")
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    if weight.shape != (cout, cin, 3, 3) or weight.device != x.device:
        raise ValueError(f"conv3x3_bn_relu: weight {tuple(weight.shape)} does "
                         f"not match Cin {cin}")
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    if scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError("conv3x3_bn_relu: scale and bias must be (Cout,)")
    if residual is not None and (
            residual.shape != (n, h, w, cout) or residual.dtype != x.dtype
            or residual.device != x.device or not residual.is_contiguous()):
        raise ValueError("conv3x3_bn_relu: residual must be a contiguous "
                         f"{(n, h, w, cout)} tensor like x")
    # (Cout, Cin, 3, 3) -> (9*Cin, Cout), row (dy*3 + dx)*Cin + ci
    wk = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(9 * cin, cout)
    wk = wk.contiguous()
    out = torch.empty(n, h, w, cout, dtype=x.dtype, device=x.device)
    _build.check(_build.lib().cmt_conv3x3_bn_relu(
        _build.dtype_code(x.dtype), x.data_ptr(), wk.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), _build.ptr(residual),
        out.data_ptr(), n, h, w, cin, cout, int(relu),
        _build.stream_ptr(x.device)), "cmt_conv3x3_bn_relu")
    _build.count("conv3x3_bn_relu" if residual is None
                 else "conv3x3_bn_relu_resid")
    return out


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


def osa_aggregate(parts: Sequence[torch.Tensor], weight: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """parts: 2 to 6 NHWC tensors (V, H, W, C_i) of one dtype; weight
    (sum C_i, Cout); scale and bias (Cout,) the folded BN. Returns agg =
    relu(concat(parts) @ (weight * scale) + bias) as (V, H, W, Cout) in the
    parts' dtype, and gap (V, Cout) float32, the per-view sum of the float32
    post-ReLU values. The concat is never materialized on the card."""
    p0 = parts[0]
    if p0.device.type == "cpu":
        return osa_aggregate_reference(parts, weight, scale, bias)
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
    chans = [p.shape[3] for p in parts]
    cout = weight.shape[-1]
    if weight.shape != (sum(chans), cout) or weight.device != p0.device:
        raise ValueError(f"osa_aggregate: weight {tuple(weight.shape)} does "
                         f"not match the parts' {sum(chans)} channels")
    bias = bias.to(torch.float32).contiguous()
    if scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError("osa_aggregate: scale and bias must be (Cout,)")
    wk = _fold_agg_weight(weight, scale, p0.dtype).contiguous()
    tiles = -(-(h * w) // 128)
    out = torch.empty(v, h, w, cout, dtype=p0.dtype, device=p0.device)
    partial = torch.empty(v, tiles, cout, dtype=torch.float32,
                          device=p0.device)
    gap = torch.empty(v, cout, dtype=torch.float32, device=p0.device)
    pad = MAX_PARTS - len(parts)
    _build.check(_build.lib().cmt_osa_aggregate(
        _build.dtype_code(p0.dtype), len(parts),
        *[p.data_ptr() for p in parts], *[None] * pad, *chans, *[0] * pad,
        wk.data_ptr(), bias.data_ptr(), out.data_ptr(), partial.data_ptr(),
        gap.data_ptr(), v, h * w, cout, _build.stream_ptr(p0.device)),
        "cmt_osa_aggregate")
    _build.count("osa_aggregate")
    return out, gap
