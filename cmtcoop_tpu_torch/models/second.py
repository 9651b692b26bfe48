"""SECOND dense BEV backbone + SECONDFPN neck (counterpart of
cmtcoop_tpu/models/second.py).

Plain dense convolutions: the JAX package leaves them to XLA, the port to
`F.conv2d` / `F.conv_transpose2d`. NHWC at the module boundary, NCHW in
channels-last memory inside. BN eps 1e-3, flax momentum 0.99 (torch 0.01)
in train mode. State keys follow mmdet3d
(`blocks.{i}.{3j}` conv, `.{3j+1}` BN; `deblocks.{i}.0` conv or deconv,
`.1` BN).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from cmtcoop_tpu_torch.models.layers import (BatchNorm, Conv2d,
                                             ConvTranspose2d)

BN_EPS, BN_MOMENTUM = 1e-3, 0.99


def _to_nchw(x):
    return x.permute(0, 3, 1, 2)


class SECOND(nn.Module):
    def __init__(self, in_channels: int,
                 out_channels: Sequence[int] = (128, 256),
                 layer_nums: Sequence[int] = (5, 5),
                 layer_strides: Sequence[int] = (1, 2)):
        super().__init__()
        blocks = []
        cin = in_channels
        for cout, n, stride in zip(out_channels, layer_nums, layer_strides):
            mods = []
            for j in range(n + 1):
                mods += [Conv2d(cin, cout, 3, stride if j == 0 else 1),
                         BatchNorm(cout, BN_EPS, BN_MOMENTUM), nn.ReLU()]
                cin = cout
            blocks.append(nn.Sequential(*mods))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x_nhwc):
        """(B, H, W, C) -> tuple of NCHW stage outputs."""
        x = _to_nchw(x_nhwc)
        outs = []
        for blk in self.blocks:
            x = blk(x)
            outs.append(x)
        return tuple(outs)


class SECONDFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (128, 256),
                 out_channels: Sequence[int] = (256, 256),
                 upsample_strides: Sequence[int] = (1, 2)):
        super().__init__()
        deblocks = []
        for cin, cout, s in zip(in_channels, out_channels, upsample_strides):
            up = (ConvTranspose2d(cin, cout, s, s) if s > 1
                  else Conv2d(cin, cout, 1))
            deblocks.append(nn.Sequential(
                up, BatchNorm(cout, BN_EPS, BN_MOMENTUM), nn.ReLU()))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, feats):
        """NCHW stage outputs -> concatenated NHWC BEV (B, H, W, sum C)."""
        ups = [blk(x) for blk, x in zip(self.deblocks, feats)]
        return torch.cat(ups, dim=1).permute(0, 2, 3, 1).contiguous()
