"""ResNet image backbone on NHWC tensors (counterpart of
cmtcoop_tpu/models/resnet.py): mmdet's `ResNet(depth=50, out_indices=(2,
3), norm_eval=True, with_cp=True, style='pytorch')` of the reference's
CMT_Nuscenes/fusion/cmt_voxel0100_r50_800x320_cbgs.py.

- The stem is a 7x7 stride-2 conv (pad 3) + BN + ReLU, then a 3x3 stride-2
  max pool with pad 1 (floor mode).
- Each bottleneck is 1x1 -> 3x3 (the block's stride, 'pytorch' style) ->
  1x1 to 4x the width, each conv + BN, ReLU after the first two; the
  identity (a 1x1 conv of the block's stride + BN where the width or the
  stride changes) is added before the last ReLU.
- Eval: every BN is folded into its conv when a block's weights are packed
  (`layers.ModulePack`, rebuilt when a weight changes), and every conv is
  one cuDNN call on the channels-last view (`conv_bn_act`): the stem's and
  the first two convs' bias and ReLU fused into it, the last conv's bias,
  residual add and ReLU fused into it, the identity's BN shift joined to
  the last conv's bias. Kernel 4 takes the stride-1 3x3 convs of layers
  1-3 by its shape rules, but on the card cuDNN ran each of them faster
  (PERF.md §6), so none goes to it; with no hand-written kernel the
  detector replays the branch as CUDA graph segments (models/detector.py).
- Train mode (the JAX train path): plain `F.conv2d` under autograd with BN
  frozen at its running statistics (`norm_eval`) while its affine gets
  gradients, each block checkpointed (`with_cp`).

State keys follow mmdet: `conv1.weight`, `bn1.*`,
`layer{s}.{b}.conv{1,2,3}.weight`, `layer{s}.{b}.bn{1,2,3}.*`,
`layer{s}.{b}.downsample.{0,1}.*`, so a reference checkpoint loads as it
is and the JAX package takes the same dict through `convert_resnet`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cmtcoop_tpu_torch.models.layers import BatchNorm, Conv2d, ModulePack
from cmtcoop_tpu_torch.models.vovnet import conv2d_nhwc
from cmtcoop_tpu_torch.utils.profiling import span

BLOCKS = {50: (3, 4, 6, 3)}  # bottleneck blocks per stage
EXPANSION = 4
BN_EPS = 1e-5


class FoldedConv(NamedTuple):
    """A conv with its eval BatchNorm folded in, as cuDNN takes it."""
    weight: torch.Tensor  # (Cout, Cin, kh, kw) x BN scale, compute dtype,
    #                       channels-last
    bias: Optional[torch.Tensor]  # (Cout,) compute dtype, or None
    stride: int
    padding: int


def fold_conv(conv: nn.Conv2d, bn: BatchNorm, dtype, with_bias: bool = True,
              extra_bias: Optional[torch.Tensor] = None) -> FoldedConv:
    """`conv` (bias-free) and `bn` as one conv: the weight times the BN
    scale, folded in float32 and then cast; the BN shift (plus
    `extra_bias`, float32) as the bias unless `with_bias` is false."""
    scale, shift = bn.fold()
    w = conv.weight.float() * scale.view(-1, 1, 1, 1)
    if extra_bias is not None:
        shift = shift + extra_bias
    return FoldedConv(
        w.to(dtype).contiguous(memory_format=torch.channels_last),
        shift.to(dtype) if with_bias else None, conv.stride[0],
        conv.padding[0])


def conv_bn_act(x: torch.Tensor, f: FoldedConv, relu: bool = True,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC x through a folded conv, + `residual` (NHWC; with `relu`
    only), + ReLU, in x's dtype. On the card one cuDNN call on the
    channels-last view with the bias, the residual add and the ReLU fused
    (`cudnn_convolution_relu`, `cudnn_convolution_add_relu`; without a
    ReLU, `F.conv2d`). On the CPU the plain float32 conv on the
    dtype-rounded operands."""
    if residual is not None and not relu:
        raise ValueError("conv_bn_act: a residual is added before the ReLU")
    xc = x.permute(0, 3, 1, 2)
    st, pad, dil = (f.stride,) * 2, (f.padding,) * 2, (1, 1)
    if x.is_cuda:
        if residual is not None:
            y = torch.cudnn_convolution_add_relu(
                xc, f.weight, residual.permute(0, 3, 1, 2), 1.0, f.bias, st,
                pad, dil, 1)
        elif relu:
            y = torch.cudnn_convolution_relu(xc, f.weight, f.bias, st, pad,
                                             dil, 1)
        else:
            y = F.conv2d(xc, f.weight, f.bias, st, pad)
        return y.permute(0, 2, 3, 1)
    y = F.conv2d(xc.float(), f.weight.float(),
                 None if f.bias is None else f.bias.float(), st, pad)
    if residual is not None:
        y = y + residual.permute(0, 3, 1, 2).float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def _bn(y, bn: BatchNorm, relu: bool):
    """Frozen BN (its running statistics; the affine stays
    differentiable), + ReLU where `relu`, in float32."""
    s, b = bn.fold()
    y = y.float() * s + b
    return torch.relu(y) if relu else y


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) + identity, ReLU."""

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1)
        self.bn1 = BatchNorm(planes, BN_EPS)
        self.conv2 = Conv2d(planes, planes, 3, stride)
        self.bn2 = BatchNorm(planes, BN_EPS)
        self.conv3 = Conv2d(planes, planes * EXPANSION, 1)
        self.bn3 = BatchNorm(planes * EXPANSION, BN_EPS)
        self.downsample = None
        if stride != 1 or cin != planes * EXPANSION:
            self.downsample = nn.Sequential(
                Conv2d(cin, planes * EXPANSION, 1, stride),
                BatchNorm(planes * EXPANSION, BN_EPS))
        self.pack = ModulePack()

    def _plain(self, x):
        dt = x.dtype
        out = _bn(conv2d_nhwc(x, self.conv1.weight), self.bn1, True).to(dt)
        out = _bn(conv2d_nhwc(out, self.conv2.weight, stride=self.conv2.stride,
                              padding=1), self.bn2, True).to(dt)
        out = _bn(conv2d_nhwc(out, self.conv3.weight), self.bn3, False)
        idn = x.float()
        if self.downsample is not None:
            conv, bn = self.downsample
            idn = _bn(conv2d_nhwc(x, conv.weight, stride=conv.stride), bn,
                      False)
        return torch.relu(out + idn).to(dt)

    def _folded(self, dtype):
        """(conv1, conv2, conv3, identity conv or None), folded."""
        if self.downsample is None:
            down, shift = None, None
        else:
            conv, bn = self.downsample
            down, shift = fold_conv(conv, bn, dtype, False), bn.fold()[1]
        return (fold_conv(self.conv1, self.bn1, dtype),
                fold_conv(self.conv2, self.bn2, dtype),
                fold_conv(self.conv3, self.bn3, dtype, extra_bias=shift),
                down)

    def forward(self, x):
        if self.training:
            return self._plain(x)
        c1, c2, c3, down = self.pack(x.dtype, lambda: self._folded(x.dtype),
                                     *self.parameters(), *self.buffers())
        idn = x if down is None else conv_bn_act(x, down, relu=False)
        return conv_bn_act(conv_bn_act(conv_bn_act(x, c1), c2), c3,
                           residual=idn)


class ResNet(nn.Module):
    """ResNet-`depth` ('pytorch' style) on NHWC images (N, H, W, 3) in the
    compute dtype; returns {name: NHWC map} for `out_features`
    ("layer1".."layer4"). `out_channels` gives each feature's width."""

    def __init__(self, depth: int = 50,
                 out_features: Sequence[str] = ("layer3", "layer4")):
        super().__init__()
        if depth not in BLOCKS:
            raise ValueError(f"ResNet-{depth} is not ported (depths "
                             f"{sorted(BLOCKS)})")
        self.out_features = tuple(out_features)
        self.conv1 = Conv2d(3, 64, 7, 2)
        self.bn1 = BatchNorm(64, BN_EPS)
        self.stem_pack = ModulePack()
        self.out_channels = {}
        cin = 64
        for si, n in enumerate(BLOCKS[depth]):
            planes = 64 * 2 ** si
            self.add_module(f"layer{si + 1}", nn.Sequential(*[
                Bottleneck(cin if b == 0 else planes * EXPANSION, planes,
                           (1 if si == 0 else 2) if b == 0 else 1)
                for b in range(n)]))
            cin = planes * EXPANSION
            self.out_channels[f"layer{si + 1}"] = cin

    def _stem(self, x):
        if self.training:
            x = _bn(conv2d_nhwc(x, self.conv1.weight, stride=2, padding=3),
                    self.bn1, True).to(x.dtype)
        else:
            x = conv_bn_act(x, self.stem_pack(
                x.dtype, lambda: fold_conv(self.conv1, self.bn1, x.dtype),
                self.conv1.weight, *self.bn1.parameters(),
                *self.bn1.buffers()))
        y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)
        return y.permute(0, 2, 3, 1).contiguous()

    def forward(self, x) -> Dict[str, torch.Tensor]:
        with span("resnet.stem"):
            x = self._stem(x)
        outputs = {}
        for i in range(1, 5):
            name = f"layer{i}"
            with span(f"resnet.{name}"):
                for block in getattr(self, name):
                    x = (checkpoint(block, x, use_reentrant=False)
                         if self.training else block(x))
            if name in self.out_features:
                outputs[name] = x
        return outputs
