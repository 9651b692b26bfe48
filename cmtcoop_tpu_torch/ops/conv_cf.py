"""Fused 3x3 conv + folded eval BatchNorm + ReLU on NHWC tensors
(counterpart of `conv3x3_cf` in cmtcoop_tpu/ops/conv_cf.py, as reached
through `conv_bn_relu_cf`).

`conv3x3_bn_relu` takes the plain version for a CPU tensor and launches the
hand-written CUDA kernel (csrc/conv3x3.cu, kernel 4) for a CUDA tensor. The
TPU kernel's channels-first lane layout (`to_cf` / `from_cf`) has no
counterpart: the kernel reads and writes NHWC.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cmtcoop_tpu_torch import _build


def fold_bn(weight, bias, running_mean, running_var, eps: float):
    """Eval BatchNorm as an affine (scale, bias), float32."""
    scale = weight.float() * torch.rsqrt(running_var.float() + eps)
    return scale, bias.float() - running_mean.float() * scale


def conv3x3_bn_relu_reference(x, weight, scale, bias, relu: bool = True):
    """Plain version: F.conv2d in float32 on the dtype-rounded operands,
    then y * scale + bias and ReLU, cast back to the input dtype."""
    w = weight.to(x.dtype).float()
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w, padding=1)
    y = y.permute(0, 2, 3, 1) * scale.float() + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def conv3x3_bn_relu(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    relu: bool = True) -> torch.Tensor:
    """x (N, H, W, Cin), weight (Cout, Cin, 3, 3) (torch layout), scale and
    bias (Cout,) float32 -> (N, H, W, Cout) in x's dtype; stride 1, pad 1."""
    if x.device.type == "cpu":
        return conv3x3_bn_relu_reference(x, weight, scale, bias, relu)
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
    # (Cout, Cin, 3, 3) -> (9*Cin, Cout), row (dy*3 + dx)*Cin + ci
    wk = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(9 * cin, cout)
    wk = wk.contiguous()
    out = torch.empty(n, h, w, cout, dtype=x.dtype, device=x.device)
    _build.check(_build.lib().cmt_conv3x3_bn_relu(
        _build.dtype_code(x.dtype), x.data_ptr(), wk.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h, w, cin, cout,
        int(relu), _build.stream_ptr(x.device)), "cmt_conv3x3_bn_relu")
    _build.count("conv3x3_bn_relu")
    return out
