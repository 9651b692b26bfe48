"""Preset -> model construction (counterpart of cmtcoop_tpu/models/build.py),
plus seeded random weights for runs without a checkpoint."""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from cmtcoop_tpu_torch.configs.presets import Preset
from cmtcoop_tpu_torch.models.cmt_head import GroupedDense, GroupLayerNorm
from cmtcoop_tpu_torch.models.detector import CmtCoopDetector, CmtDetector
from cmtcoop_tpu_torch.models.layers import BatchNorm
from cmtcoop_tpu_torch.models.pillar_encoder import SparseConvWeight


def build_detector(preset: Preset, train: bool = False,
                   dtype: torch.dtype = torch.float32, device=None,
                   **overrides) -> nn.Module:
    """The detector of `preset`, computing in `dtype` (parameters stay
    float32), in train mode (`train`, with the preset's training caps) or
    eval mode on `device`. `extractor_kwargs` / `head_kwargs` update the
    preset's; other overrides (e.g. `agents`) go to the detector."""
    ek = preset.extractor_kwargs(train)
    ek.update(overrides.pop("extractor_kwargs", {}))
    hk = preset.head_kwargs()
    hk.update(overrides.pop("head_kwargs", {}))
    common = dict(use_lidar=preset.use_lidar, use_camera=preset.use_camera,
                  extractor_kwargs=ek, head_kwargs=hk, compute_dtype=dtype,
                  **overrides)
    cls = CmtCoopDetector if preset.domain == "coop" else CmtDetector
    model = cls(**common)
    return model.to(device).train(train)


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer from `generator` (a CPU generator),
    in module order: fan-in scaled uniform weights (bound 1/sqrt(fan_in),
    the JAX package's variance_scaling(1/3, fan_in, uniform)), norm scales
    near 1, small biases and running means, running variances in
    [0.5, 1.5], reference points in [0, 1]."""

    def uniform(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            uniform(mod.weight, 0.8, 1.2)
            uniform(mod.bias, -0.1, 0.1)
            uniform(mod.running_mean, -0.1, 0.1)
            uniform(mod.running_var, 0.5, 1.5)
        elif isinstance(mod, (nn.LayerNorm, GroupLayerNorm)):
            uniform(mod.weight, 0.8, 1.2)
            uniform(mod.bias, -0.1, 0.1)
        elif isinstance(mod, nn.Embedding):
            uniform(mod.weight, 0.0, 1.0)
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d,
                              SparseConvWeight, GroupedDense)):
            w = mod.weight
            # (I, O, kh, kw) for a deconv; output channels first otherwise
            fan_in = (w.shape[0] * w[0, 0].numel()
                      if isinstance(mod, nn.ConvTranspose2d) else w[0].numel())
            bound = 1.0 / math.sqrt(fan_in)
            uniform(w, -bound, bound)
            if getattr(mod, "bias", None) is not None:
                uniform(mod.bias, -bound, bound)
        for pname, p in mod.named_parameters(recurse=False):
            if pname in ("in_proj_weight", "in_proj_bias"):
                bound = 1.0 / math.sqrt(p.shape[-1]) if p.dim() > 1 else 0.02
                uniform(p, -bound, bound)
    return model
