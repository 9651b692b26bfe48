"""The port's main paths at full width: the eval forward of
`cmt_lidar_coop_tumtraf` (with the pillar encoder, and as `GATHER_PATH`
with the gather sparse encoder of the reference's semantics) and of
`cmt_fusion_coop_tumtraf` (the flagship: LiDAR plus 1 vehicle and 3
infrastructure cameras at 640x1600) in bfloat16,
batch 1, with seeded random weights, on the JAX package's benchmark batch
(two 65536-point ray-cast clouds, images kept for the camera branch), and
one frame of either (forward + top-300 decode); and the train step of
`cmt_fusion_coop_tumtraf` (DN with 128 GT slots, dropout 0.1, grid mask,
clipped AdamW) on the same batch with its ground truth. chip_smoke.py and
profile_path.py drive them; the overrides are those of the JAX `bench.py`
and `tools/probe_train_step.py`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from cmtcoop_tpu_torch import _build
from cmtcoop_tpu_torch.configs.presets import get_preset, post_center_range
from cmtcoop_tpu_torch.core.coder import decode_boxes
from cmtcoop_tpu_torch.data.synthetic import coop_batch
from cmtcoop_tpu_torch.models.build import build_detector, random_init_
from cmtcoop_tpu_torch.train.optim import AdamW
from cmtcoop_tpu_torch.train.train_step import make_train_step

PRESET = "cmt_lidar_coop_tumtraf"
FUSION_PRESET = "cmt_fusion_coop_tumtraf"
PATHS = (PRESET, FUSION_PRESET)
GATHER_PATH = PRESET + " gather"
TRAIN_PATH = FUSION_PRESET + " train"
# the kernels each path launches (kernel 5, the conv with a residual, and
# kernel 10, the row-layout copy, are on no path: the OSA identity is added
# after the eSE scale, and the port's pillar kernels take no fallback branch
# to pin a layout on; the train path runs kernels 7 and 8 and no other eval
# kernel, as the JAX train path; every LiDAR path's neighbour maps run
# kernel 9, one launch a map, and the gather path no pillar kernel)
_LIDAR = ("pillar_conv_kb9", "pillar_conv_kb1", "flash_attention_packed",
          "conv3x3_bn_relu", "neighbor_map")
PATH_KERNELS = {PRESET: _LIDAR,
                FUSION_PRESET: _LIDAR + ("osa_aggregate",),
                GATHER_PATH: ("flash_attention_packed", "conv3x3_bn_relu",
                              "neighbor_map"),
                TRAIN_PATH: ("flash_train_fwd", "flash_train_bwd_dq",
                             "flash_train_bwd_dkv", "neighbor_map")}
# the neighbour maps a frame or step of each path builds, one kernel-9
# launch each: per agent 7 on the pillar encoder (a subm map a level and 3
# down maps) and 8 on the gather one (4 subm maps, 3 down maps, conv_out's)
MAP_LAUNCHES = {PRESET: 14, FUSION_PRESET: 14, GATHER_PATH: 16,
                TRAIN_PATH: 14}
SEED = 0
# the decode's post-centre range, one for every path (all are TUMTraf's)
DECODE_RANGE = post_center_range(get_preset(FUSION_PRESET))
MAX_VOXELS = 65536
# per-level pillar caps, calibrated on the benchmark clouds
PILLAR_CAPS = (38400, 40960, 24064, 11264)
# the gather encoder's active-set caps after each downsample and conv_out:
# the JAX defaults (60000 each) drop stage-1 sites on the benchmark clouds
# (76938 there), so calibrated on them as the pillar caps were (the largest
# count of the two clouds + 20%, rounded up to a multiple of 256)
SPARSE_CAPS = (92416, 52992, 13056, 12288)
N_POINTS = 65536
IMG_HW = (640, 1600)
VIEWS = (1, 3)  # vehicle, infrastructure cameras
CAMERA_KEYS = ("imgs", "lidar2img", "img2lidar")
CODES = ("center", "height", "dim", "rot", "vel")
TRAIN_MAX_GT = 128  # 5 DN groups: 640 DN queries ahead of the 900
TRAIN_TOTAL_STEPS = 100  # the schedules' length


def build_main_path(
        device, preset: str = PRESET
) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """(model, batch) on `device` for one of `PATHS` or `GATHER_PATH`: the
    full-width detector with weights from `SEED` and the benchmark batch
    drawn from `SEED` (the points, and the images and cameras when the
    preset has the camera branch)."""
    ek = dict(max_voxels=MAX_VOXELS, pillar_caps=PILLAR_CAPS)
    if preset == GATHER_PATH:
        preset = PRESET
        ek.update(encoder_impl="gather", sparse_stage_caps=SPARSE_CAPS)
    p = get_preset(preset)
    model = build_detector(p, dtype=torch.bfloat16, extractor_kwargs=ek)
    random_init_(model, torch.Generator().manual_seed(SEED))
    model.to(device)
    np_batch = coop_batch(1, N_POINTS, *VIEWS, IMG_HW, seed=SEED)
    keep = ("points",) + (CAMERA_KEYS if p.use_camera else ())
    batch = {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()
             if any(s in k for s in keep)}
    return model, batch


def frame(model: torch.nn.Module, batch: Dict[str, torch.Tensor]):
    """One frame: the forward and the top-300 decode of the last decoder
    layer inside `DECODE_RANGE`, synchronised. Returns (task_outs,
    decoded)."""
    task_outs, _ = model(batch)
    t = task_outs[0]
    codes = torch.cat([t[k][-1, 0] for k in CODES], -1)
    dec = decode_boxes([t["cls_logits"][-1, 0]], [codes],
                       post_center_range=DECODE_RANGE)
    if dec.scores.is_cuda:
        torch.cuda.synchronize()
    return task_outs, dec


def build_train_path(device):
    """(model, batch, optimizer, step) of the full-width train step on
    `device`: `cmt_fusion_coop_tumtraf` in train mode, bfloat16 compute on
    float32 parameters from `SEED`, `TRAIN_MAX_GT` GT slots, the benchmark
    batch with its ground truth, AdamW over `TRAIN_TOTAL_STEPS`; `step(batch)`
    runs one step (train/train_step.py)."""
    p = get_preset(FUSION_PRESET)
    model = build_detector(p, train=True, dtype=torch.bfloat16,
                           extractor_kwargs=dict(max_voxels=MAX_VOXELS,
                                                 pillar_caps=PILLAR_CAPS),
                           head_kwargs=dict(max_gt=TRAIN_MAX_GT))
    random_init_(model, torch.Generator().manual_seed(SEED))
    model.to(device)
    np_batch = coop_batch(1, N_POINTS, *VIEWS, IMG_HW, max_gt=TRAIN_MAX_GT,
                          seed=SEED)
    batch = {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()}
    optimizer = AdamW(model.named_parameters(), TRAIN_TOTAL_STEPS)
    step = make_train_step(model, optimizer, p.tasks, SEED)
    return model, batch, optimizer, step


def sparse_telemetry(extractor, points, points_mask) -> Dict[str, object]:
    """The gather encoder's cap telemetry for one sample's cloud: voxels
    (raw, dropped at `max_voxels`) and, per downsample and `conv_out`, the
    uncapped number of output sites beside its cap (a frame that drops
    sites measures another function)."""
    vox, stats = extractor.voxelize(points, points_mask, return_stats=True)
    enc = extractor.pts_middle_encoder
    maps = enc.maps(vox.coords, vox.mask)
    caps = enc.stage_caps[:len(maps.n_sites) - 1] + enc.stage_caps[-1:]
    return dict(n_voxels_raw=int(stats["n_voxels_raw"]),
                n_voxels_dropped=int(stats["n_voxels_dropped"]),
                sites=[(int(n), c) for n, c in zip(maps.n_sites, caps)])
