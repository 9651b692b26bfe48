"""Shared building blocks, eval only (counterpart of
cmtcoop_tpu/models/layers.py).

Parameters stay float32 and keep the reference's mmdet3d state_dict names;
each layer computes in the `compute_dtype` it was built with (bfloat16 on
the card), accumulating in float32 where the kernels or cuBLAS do, as the
JAX package's `dtype` does.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cmtcoop_tpu_torch.ops.conv_cf import conv3x3_bn_relu, fold_bn


class BatchNorm(nn.Module):
    """Eval BatchNorm over dim 1 (NCHW), folded to an affine. Holds the
    reference's `weight`, `bias`, `running_mean`, `running_var` (no
    `num_batches_tracked`: eval only). Also the eval fold of the JAX
    package's `MaskedBatchNorm` (eps 1e-3), through `fold()`."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def fold(self):
        """(scale, bias) float32 with y = x * scale + bias."""
        return fold_bn(self.weight, self.bias, self.running_mean,
                       self.running_var, self.eps)

    def forward(self, x):
        s, b = self.fold()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x.float() * s.view(shape) + b.view(shape)).to(x.dtype)


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
    """3x3 stride-1 Conv2d(bias=False) + eval BatchNorm + ReLU on NHWC, one
    launch of kernel 4 (`conv3x3_bn_relu`): the head's `shared_conv`.
    State: `conv.weight`, `bn.*`."""

    def __init__(self, cin: int, cout: int, eps: float = 1e-5):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3)
        self.bn = BatchNorm(cout, eps)

    def forward(self, x_nhwc):
        scale, bias = self.bn.fold()
        return conv3x3_bn_relu(x_nhwc.contiguous(), self.conv.weight, scale,
                               bias, relu=True)


class MLP(nn.Sequential):
    """Linear -> ReLU -> Linear (state `0.*`, `2.*`)."""

    def __init__(self, cin: int, hidden: int, cout: int,
                 compute_dtype=torch.float32):
        super().__init__(Linear(cin, hidden, compute_dtype=compute_dtype),
                         nn.ReLU(),
                         Linear(hidden, cout, compute_dtype=compute_dtype))


class FFN(nn.Module):
    """mmcv FFN, eval: x + Linear(ReLU(Linear(x))) (state
    `layers.0.0.*`, `layers.1.*`)."""

    def __init__(self, c: int, hidden: int, compute_dtype=torch.float32):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Linear(c, hidden, compute_dtype=compute_dtype),
                          nn.ReLU()),
            Linear(hidden, c, compute_dtype=compute_dtype))

    def forward(self, x):
        return x + self.layers(x)
