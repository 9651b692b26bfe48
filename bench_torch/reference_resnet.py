"""The plain reference of CMT's real-time nuScenes fusion detector
(CMT_Nuscenes/fusion/cmt_voxel0100_r50_800x320_cbgs.py): the single-agent,
multi-task reference (reference_single.py) with its image backbone a
ResNet-50 in place of VoVNet, in plain PyTorch, float32, TF32 off, on a
configuration file's widths and the single detector's state names.

The backbone is mmdet's `ResNet(depth=50, out_indices=(2, 3),
style='pytorch')` in eval: a 7x7 stride-2 conv (pad 3) + BN + ReLU, a 3x3
stride-2 max pool (pad 1), then `stage_blocks` bottlenecks a stage (1x1 ->
3x3 with the stage's stride on a stage's first block -> 1x1 to
`expansion` x the width, each conv + BN, ReLU after the first two, the
identity through a 1x1 conv of the block's stride + BN where the width or
the stride changes, added before the last ReLU), every BN at its running
statistics, unfolded. It returns `layer3` and `layer4` (strides 16 and 32,
1024 and 2048 channels), which the reference's CPFPN takes as it takes
VoVNet's stages. It imports nothing of the program and no JAX.

Departures from the published model: the weights are seeded, not trained,
and the images and clouds come from the benchmark's generator, not
nuScenes; the ranges are those of the JAX package's preset, the nuScenes
`pc_range` of +-54 m with the 1024 x 0.1 m grid of the config's
`sparse_shape`, so the voxels cover -54 to +48.4 m in x and y while the
head normalises positions over +-54 m (CMT's voxel0100 configs may use
+-51.2 m, where 1024 x 0.1 m fits; the source file was not at hand). The
layers and the decode are as published (no score threshold, no NMS).

`precision="fp8"` is `Reference`'s control, one precision step below the
configuration's bfloat16.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from bench_torch.reference_single import SingleReference


class ResNetReference(SingleReference):
    """`SingleReference` with a ResNet image backbone (`camera` widths:
    `stage_blocks`, `base_channels`, `expansion`, `out_features`,
    `bn_eps`)."""

    def vovnet(self, x, prefix: str) -> Dict[str, torch.Tensor]:
        """(V, 3, H, W) images -> {"layer1".."layer4" named in
        `out_features`: NCHW map}; the name is the one `image_tokens`
        calls."""
        cam = self.cfg["camera"]
        eps = cam["bn_eps"]

        def unit(x, name, bn, stride=1, pad=0, relu=True):
            y = self.conv2d(x, self.p[f"{name}.weight"], None, stride, pad)
            y = self.bn(y, bn, eps)
            return torch.relu(y) if relu else y

        x = unit(x, f"{prefix}.conv1", f"{prefix}.bn1", 2, 3)
        x = F.max_pool2d(x, 3, 2, 1)
        out = {}
        for s, blocks in enumerate(cam["stage_blocks"]):
            for b in range(blocks):
                m = f"{prefix}.layer{s + 1}.{b}"
                stride = 2 if s > 0 and b == 0 else 1
                y = unit(x, f"{m}.conv1", f"{m}.bn1")
                y = unit(y, f"{m}.conv2", f"{m}.bn2", stride, 1)
                y = unit(y, f"{m}.conv3", f"{m}.bn3", relu=False)
                if f"{m}.downsample.0.weight" in self.p:
                    x = unit(x, f"{m}.downsample.0", f"{m}.downsample.1",
                             stride, relu=False)
                x = torch.relu(y + x)
            if f"layer{s + 1}" in cam["out_features"]:
                out[f"layer{s + 1}"] = x
        return out
