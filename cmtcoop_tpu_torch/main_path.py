"""The port's main paths at full width: the eval forward of
`cmt_lidar_coop_tumtraf` and of `cmt_fusion_coop_tumtraf` (the flagship:
LiDAR plus 1 vehicle and 3 infrastructure cameras at 640x1600) in bfloat16,
batch 1, with seeded random weights, on the JAX package's benchmark batch
(two 65536-point ray-cast clouds, images kept for the camera branch), and
one frame of either (forward + top-300 decode). chip_smoke.py and
profile_path.py drive them; the overrides are those of the JAX `bench.py`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from cmtcoop_tpu_torch import _build
from cmtcoop_tpu_torch.configs.presets import get_preset
from cmtcoop_tpu_torch.core.coder import decode_boxes
from cmtcoop_tpu_torch.data.synthetic import coop_batch
from cmtcoop_tpu_torch.models.build import build_detector, random_init_

PRESET = "cmt_lidar_coop_tumtraf"
FUSION_PRESET = "cmt_fusion_coop_tumtraf"
PATHS = (PRESET, FUSION_PRESET)
# the kernels each path launches (kernel 5, the conv with a residual, is on
# no path: the OSA identity is added after the eSE scale)
PATH_KERNELS = {PRESET: _build.KERNELS[:4],
                FUSION_PRESET: _build.KERNELS[:4] + ("osa_aggregate",)}
SEED = 0
MAX_VOXELS = 65536
# per-level pillar caps, calibrated on the benchmark clouds
PILLAR_CAPS = (38400, 40960, 24064, 11264)
N_POINTS = 65536
IMG_HW = (640, 1600)
VIEWS = (1, 3)  # vehicle, infrastructure cameras
CAMERA_KEYS = ("imgs", "lidar2img", "img2lidar")
CODES = ("center", "height", "dim", "rot", "vel")


def build_main_path(
        device, preset: str = PRESET
) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """(model, batch) on `device` for one of `PATHS`: the full-width
    detector with weights from `SEED` and the benchmark batch drawn from
    `SEED` (the points, and the images and cameras when the preset has the
    camera branch)."""
    p = get_preset(preset)
    model = build_detector(p, dtype=torch.bfloat16,
                           extractor_kwargs=dict(max_voxels=MAX_VOXELS,
                                                 pillar_caps=PILLAR_CAPS))
    random_init_(model, torch.Generator().manual_seed(SEED))
    model.to(device)
    np_batch = coop_batch(1, N_POINTS, *VIEWS, IMG_HW, seed=SEED)
    keep = ("points",) + (CAMERA_KEYS if p.use_camera else ())
    batch = {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()
             if any(s in k for s in keep)}
    return model, batch


def frame(model: torch.nn.Module, batch: Dict[str, torch.Tensor]):
    """One frame: the forward and the top-300 decode of the last decoder
    layer, synchronised. Returns (task_outs, decoded)."""
    task_outs, _ = model(batch)
    t = task_outs[0]
    codes = torch.cat([t[k][-1, 0] for k in CODES], -1)
    dec = decode_boxes([t["cls_logits"][-1, 0]], [codes])
    if dec.scores.is_cuda:
        torch.cuda.synchronize()
    return task_outs, dec
