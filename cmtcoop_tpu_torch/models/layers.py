"""Shared building blocks (counterpart of cmtcoop_tpu/models/layers.py).

Parameters stay float32 and keep the reference's mmdet3d state_dict names;
each layer computes in the `compute_dtype` it was built with (bfloat16 on
the card), accumulating in float32 where the kernels or cuBLAS do, as the
JAX package's `dtype` does.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cmtcoop_tpu_torch.ops.conv_cf import (PackedAgg, PackedConv3x3,
                                           conv3x3_bn_relu_packed, fold_bn,
                                           pack_conv3x3_weight,
                                           pack_osa_weight)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 (NCHW) holding the reference's `weight`, `bias`,
    `running_mean`, `running_var` (no `num_batches_tracked`). Eval: folded
    to an affine (`fold()`, also what the fused kernels take). Train: the
    batch's mean and biased variance in float32 normalise, and the running
    statistics move as flax's do, r = momentum * r + (1 - momentum) * stat,
    with `momentum` the flax one (0.9 = torch 0.1, 0.99 = torch 0.01). Not
    `F.batch_norm`: it would store the unbiased variance and take
    1 - momentum. `masked` is the JAX package's `MaskedBatchNorm` (eps 1e-3,
    momentum 0.99): statistics over the valid rows only."""

    def __init__(self, c: int, eps: float, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def fold(self):
        """(scale, bias) float32 with y = x * scale + bias."""
        return fold_bn(self.weight, self.bias, self.running_mean,
                       self.running_var, self.eps)

    @torch.no_grad()
    def _update(self, mean, var) -> None:
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
        self.running_var.mul_(m).add_(var, alpha=1.0 - m)

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not self.training:
            s, b = self.fold()
            return (x.float() * s.view(shape) + b.view(shape)).to(x.dtype)
        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        mean = xf.mean(dims)
        var = (xf - mean.view(shape)).square().mean(dims)
        self._update(mean, var)
        y = (xf - mean.view(shape)) * (
            self.weight * torch.rsqrt(var + self.eps)).view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)

    def masked(self, x, mask):
        """x (..., C) with mask (...): normalised, times the mask, in x's
        dtype; in train mode with the statistics of the rows where mask."""
        if not self.training:
            s, b = self.fold()
            y = x.float() * s + b
        else:
            m = mask.reshape(-1, 1).float()
            xf = x.reshape(-1, x.shape[-1]).float()
            cnt = m.sum().clamp(min=1.0)
            mean = (xf * m).sum(0) / cnt
            var = ((xf - mean).square() * m).sum(0) / cnt
            self._update(mean, var)
            y = (x.float() - mean) * (self.weight * torch.rsqrt(
                var + self.eps)) + self.bias
        return (y * mask[..., None]).to(x.dtype)


def _pack_key(dtype, *tensors) -> list:
    """What a held pack is keyed by: the compute dtype, and each source
    tensor's data pointer (which moving to another device changes) and
    version counter (`load_state_dict` copies in place and so bumps it; an
    inference tensor keeps none, so for one only a new pointer counts)."""
    key = [dtype]
    for t in tensors:
        key += (t.data_ptr(), 0 if t.is_inference() else t._version)
    return key


class ConvPack:
    """The packed operands of a 3x3 conv + BatchNorm (`pack_conv3x3_weight`
    of the weight and the folded BN), held by its module for eval. Rebuilt
    when the compute dtype changes or when the weight or a BN tensor is
    replaced, moved or changed in place (`_pack_key`). This trades
    device memory (a bf16 copy of each 3x3 weight, ~50 MB for a VoVNet-99
    agent) for the cast, permute, copy and BN fold that each of the fusion
    frame's 162 conv launches would otherwise repeat: about a thousand
    small launches a frame."""

    def __init__(self):
        self.key, self.packed = None, None

    def __call__(self, weight: torch.Tensor, bn: BatchNorm,
                 dtype) -> PackedConv3x3:
        key = _pack_key(dtype, weight, bn.weight, bn.bias, bn.running_mean,
                        bn.running_var)
        if key != self.key:
            self.packed = pack_conv3x3_weight(weight, *bn.fold(), dtype)
            self.key = key
        return self.packed


class AggPack:
    """The packed operands of an OSA aggregate (`pack_osa_weight` of the
    1x1 concat conv's weight with its BN folded in, for the parts' channel
    counts), held by its module for eval and rebuilt as `ConvPack`'s (the
    channel counts join the key). It saves the fold, transpose, cast and
    copy that each of the fusion frame's 32 aggregate launches would
    otherwise repeat, and keeps the weight's TMA maps."""

    def __init__(self):
        self.key, self.packed = None, None

    def __call__(self, weight: torch.Tensor, bn: BatchNorm,
                 chans: Sequence[int], dtype) -> PackedAgg:
        """weight (Cout, sum C, 1, 1), the torch layout of the 1x1 conv."""
        key = _pack_key(dtype, weight, bn.weight, bn.bias, bn.running_mean,
                        bn.running_var) + [tuple(chans)]
        if key != self.key:
            self.packed = pack_osa_weight(weight[:, :, 0, 0].t(), *bn.fold(),
                                          chans, dtype)
            self.key = key
        return self.packed


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype` (input and weights cast)."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 compute_dtype=torch.float32):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Conv2d):
    """Bias-free nn.Conv2d (NCHW) computing in the input's dtype, torch-style
    centred padding ((k-1)//2 on both sides, not XLA SAME)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                         bias=False)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                        self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """Bias-free nn.ConvTranspose2d computing in the input's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__(cin, cout, k, stride=stride, bias=False)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None,
                                  self.stride)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in float32, output in `compute_dtype`; eps 1e-6, flax's
    default (not torch's 1e-5)."""

    def __init__(self, c: int, eps: float = 1e-6,
                 compute_dtype=torch.float32):
        super().__init__(c, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class ConvBNReLU(nn.Module):
    """3x3 stride-1 Conv2d(bias=False) + BatchNorm + ReLU on NHWC: the head's
    `shared_conv`. Eval: one launch of kernel 4 (`conv3x3_bn_relu`) on the
    operands packed once (`ConvPack`). Train:
    `F.conv2d` + batch-statistics BN + ReLU under autograd, as the JAX
    train path takes the XLA conv (kernel 4 has no backward). State:
    `conv.weight`, `bn.*`."""

    def __init__(self, cin: int, cout: int, eps: float = 1e-5):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3)
        self.bn = BatchNorm(cout, eps)
        self.pack = ConvPack()

    def forward(self, x_nhwc):
        if self.training:
            y = self.conv(x_nhwc.permute(0, 3, 1, 2))
            return torch.relu(self.bn(y)).permute(0, 2, 3, 1)
        x = x_nhwc.contiguous()
        return conv3x3_bn_relu_packed(
            x, self.pack(self.conv.weight, self.bn, x.dtype), relu=True)


class MLP(nn.Sequential):
    """Linear -> ReLU -> Linear (state `0.*`, `2.*`)."""

    def __init__(self, cin: int, hidden: int, cout: int,
                 compute_dtype=torch.float32):
        super().__init__(Linear(cin, hidden, compute_dtype=compute_dtype),
                         nn.ReLU(),
                         Linear(hidden, cout, compute_dtype=compute_dtype))


class FFN(nn.Module):
    """mmcv FFN: x + Linear(ReLU(Linear(x))) (state `layers.0.0.*`,
    `layers.1.*`); no dropout, as the JAX decoder's FFN dropout is 0.0."""

    def __init__(self, c: int, hidden: int, compute_dtype=torch.float32):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Linear(c, hidden, compute_dtype=compute_dtype),
                          nn.ReLU()),
            Linear(hidden, c, compute_dtype=compute_dtype))

    def forward(self, x):
        return x + self.layers(x)
