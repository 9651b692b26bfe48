"""VoVNet image backbone and CPFPN neck on NHWC tensors (counterparts of
cmtcoop_tpu/models/vovnet.py and of its TPU eval path,
cmtcoop_tpu/models/vovnet_cf.py).

- The three stem convs (3x3, strides 2/1/2, torch padding) are plain
  `F.conv2d` + folded BN + ReLU, as they are XLA convs in the JAX package.
- Each OSA block runs its 3x3 convs through kernel 4 (`conv3x3_bn_relu`)
  and its aggregate through kernel 6 (`osa_aggregate_packed`), whose float32
  spatial sums give the eSE attention, exactly as `_osa_cf` does; the
  identity is added after the eSE scale, for every block after a stage's
  first. eSE runs in every block, whatever the reference's SE flag says.
- Stages 3 to 5 start with a 3x3 stride-2 ceil-mode max pool.
- Train mode (the JAX train path): every conv is a plain `F.conv2d` and
  the aggregate a `torch.cat` + 1x1 conv under autograd (kernels 4 and 6
  have no backward); BN stays frozen at its running statistics
  (`norm_eval`, the reference's vovnet.py:381-390) while its affine gets
  gradients; each OSA block is checkpointed (`remat`, as the JAX
  package's `nn.remat(OSAModule)`), which is safe because frozen BN makes
  a block a pure function. CPFPN has no BN and is the same in both modes.

State keys follow the reference (`stem.stem_1/conv.weight`,
`stage4.OSA4_2.layers.3.OSA4_2_3/norm.running_var`,
`stage4.OSA4_2.concat.OSA4_2_concat/conv.weight`, `…ese.fc.weight`; the
neck's `lateral_convs.{i}.conv.*` and `fpn_convs.0.conv.*`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from cmtcoop_tpu_torch.models.layers import (AggPack, BatchNorm, Conv2d,
                                             ConvPack)
from cmtcoop_tpu_torch.ops.conv_cf import (conv3x3_bn_relu_packed,
                                           osa_aggregate_packed)

STAGE_SPECS: Dict[str, dict] = {
    "V-19-slim-eSE": dict(
        stem=(64, 64, 128), stage_conv_ch=(64, 80, 96, 112),
        stage_out_ch=(112, 256, 384, 512), layer_per_block=3,
        block_per_stage=(1, 1, 1, 1)),
    "V-19-eSE": dict(
        stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
        stage_out_ch=(256, 512, 768, 1024), layer_per_block=3,
        block_per_stage=(1, 1, 1, 1)),
    "V-39-eSE": dict(
        stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
        stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
        block_per_stage=(1, 1, 2, 2)),
    "V-57-eSE": dict(
        stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
        stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
        block_per_stage=(1, 1, 4, 3)),
    "V-99-eSE": dict(
        stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
        stage_out_ch=(256, 512, 768, 1024), layer_per_block=5,
        block_per_stage=(1, 3, 9, 3)),
}
BN_EPS = 1e-5


def conv2d_nhwc(x, weight, bias=None, stride: int = 1, padding: int = 0):
    """F.conv2d on an NHWC tensor through its channels-last NCHW view, in
    x's dtype; returns NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride, padding)
    return y.permute(0, 2, 3, 1)


def max_pool_ceil(x):
    """3x3 stride-2 max pool with ceil_mode=True, NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1).contiguous()


def _bn_relu(y, bn: BatchNorm):
    """Frozen BN (its running statistics; the affine stays differentiable)
    + ReLU, computed in float32, in y's dtype."""
    s, b = bn.fold()
    return torch.relu(y.float() * s + b).to(y.dtype)


def _conv_unit(name: str, cin: int, cout: int, k: int, stride: int = 1):
    """The reference's conv unit: `{name}/conv` (no bias), `{name}/norm`,
    `{name}/relu`."""
    return [(f"{name}/conv", Conv2d(cin, cout, k, stride)),
            (f"{name}/norm", BatchNorm(cout, BN_EPS)),
            (f"{name}/relu", nn.ReLU())]


class eSE(nn.Module):
    """Holds the eSE attention's 1x1 `fc` (with bias)."""

    def __init__(self, c: int):
        super().__init__()
        self.fc = nn.Conv2d(c, c, 1)


class OSAModule(nn.Module):
    """One OSA block, eval: `layer_per_block` 3x3 conv units (one launch of
    kernel 4 each, on operands packed once: `packs`), the aggregate over
    [x, conv outputs] (one launch of kernel 6, on operands packed once:
    `agg_pack`), eSE from the aggregate's spatial sums, and the identity
    when `identity`."""

    def __init__(self, cin: int, stage_ch: int, concat_ch: int,
                 layer_per_block: int, name: str, identity: bool):
        super().__init__()
        self.identity = identity
        self.layers = nn.ModuleList([
            nn.Sequential(OrderedDict(_conv_unit(
                f"{name}_{i}", cin if i == 0 else stage_ch, stage_ch, 3)))
            for i in range(layer_per_block)])
        self.packs = [ConvPack() for _ in range(layer_per_block)]
        self.concat = nn.Sequential(OrderedDict(_conv_unit(
            f"{name}_concat", cin + layer_per_block * stage_ch, concat_ch,
            1)))
        self.agg_pack = AggPack()
        self.ese = eSE(concat_ch)

    def _plain(self, x):
        """The block's convs and aggregate as plain ops under autograd
        (train mode), BN folded at its running statistics."""
        parts = [x]
        for layer in self.layers:
            y = conv2d_nhwc(parts[-1], layer[0].weight, padding=1)
            parts.append(_bn_relu(y, layer[1]))
        agg = _bn_relu(conv2d_nhwc(torch.cat(parts, dim=-1),
                                   self.concat[0].weight), self.concat[1])
        return agg, agg.float().sum(dim=(1, 2))

    def forward(self, x):
        if self.training:
            agg, gap = self._plain(x)
        else:
            parts = [x]
            for layer, pack in zip(self.layers, self.packs):
                parts.append(conv3x3_bn_relu_packed(
                    parts[-1], pack(layer[0].weight, layer[1], x.dtype)))
            agg, gap = osa_aggregate_packed(parts, self.agg_pack(
                self.concat[0].weight, self.concat[1],
                [p.shape[-1] for p in parts], x.dtype))
        # eSE from the spatial sums: mean, float32 fc, hard sigmoid
        fc = self.ese.fc
        s = gap / float(x.shape[1] * x.shape[2])
        s = s @ fc.weight[:, :, 0, 0].t().float() + fc.bias.float()
        s = (torch.clamp(s + 3.0, 0.0, 6.0) / 6.0).to(agg.dtype)
        out = agg * s[:, None, None, :]
        if self.identity:
            out = out + x
        return out


class VoVNet(nn.Module):
    """VoVNet-eSE of `spec_name` on NHWC images (N, H, W, 3) in the compute
    dtype; returns {name: NHWC map} for `out_features` ("stem",
    "stage2".."stage5"). `out_channels` gives each feature's width."""

    def __init__(self, spec_name: str = "V-99-eSE",
                 out_features: Sequence[str] = ("stage4", "stage5"),
                 input_ch: int = 3):
        super().__init__()
        spec = STAGE_SPECS[spec_name]
        stem = spec["stem"]
        self.out_features = tuple(out_features)
        self.stem = nn.Sequential(OrderedDict(
            _conv_unit("stem_1", input_ch, stem[0], 3, 2)
            + _conv_unit("stem_2", stem[0], stem[1], 3, 1)
            + _conv_unit("stem_3", stem[1], stem[2], 3, 2)))
        self.out_channels = {"stem": stem[2]}
        cin = stem[2]
        for i in range(4):
            s = i + 2
            stage = nn.Sequential()
            for b in range(spec["block_per_stage"][i]):
                stage.add_module(f"OSA{s}_{b + 1}", OSAModule(
                    cin, spec["stage_conv_ch"][i], spec["stage_out_ch"][i],
                    spec["layer_per_block"], f"OSA{s}_{b + 1}", b > 0))
                cin = spec["stage_out_ch"][i]
            self.add_module(f"stage{s}", stage)
            self.out_channels[f"stage{s}"] = cin

    def forward(self, x) -> Dict[str, torch.Tensor]:
        units = list(self.stem)
        for conv, bn in zip(units[0::3], units[1::3]):
            y = conv2d_nhwc(x, conv.weight, stride=conv.stride,
                            padding=conv.padding)
            x = _bn_relu(y, bn).contiguous()
        outputs = {}
        if "stem" in self.out_features:
            outputs["stem"] = x
        for i in range(4):
            name = f"stage{i + 2}"
            if i:
                x = max_pool_ceil(x)
            for block in getattr(self, name):
                x = (checkpoint(block, x, use_reentrant=False)
                     if self.training else block(x))
            if name in self.out_features:
                outputs[name] = x
        return outputs


class _ConvSlot(nn.Module):
    """Holds a conv under `.conv`, as mmcv's ConvModule does."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.conv = conv


class CPFPN(nn.Module):
    """Checkpoint-friendly FPN, eval: a 1x1 lateral conv (with bias) per
    level, nearest x2 top-down sums (repeat, then crop to the finer level),
    and a 3x3 `fpn0` conv (with bias, pad 1) on level 0 only. Returns
    (fpn0(level 0), laterals 1 .. num_outs-1), NHWC in the input dtype."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 2):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList([
            _ConvSlot(nn.Conv2d(c, out_channels, 1)) for c in in_channels])
        self.fpn_convs = nn.ModuleList([
            _ConvSlot(nn.Conv2d(out_channels, out_channels, 3, padding=1))])

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        laterals = [conv2d_nhwc(x, m.conv.weight, m.conv.bias)
                    for m, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            fine = laterals[i - 1]
            up = laterals[i].repeat_interleave(2, dim=1).repeat_interleave(
                2, dim=2)[:, :fine.shape[1], :fine.shape[2]]
            laterals[i - 1] = fine + up
        fpn0 = self.fpn_convs[0].conv
        outs = [conv2d_nhwc(laterals[0], fpn0.weight, fpn0.bias,
                            padding=1).contiguous()]
        outs.extend(laterals[1:self.num_outs])
        return tuple(outs)
