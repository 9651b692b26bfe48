"""The port's main paths at full width: the eval forward of
`cmt_lidar_coop_tumtraf` (with the pillar encoder, and as `GATHER_PATH`
with the gather sparse encoder of the reference's semantics) and of
`cmt_fusion_coop_tumtraf` (the flagship: LiDAR plus 1 vehicle and 3
infrastructure cameras at 640x1600) in bfloat16,
batch 1, with seeded random weights, on the JAX package's benchmark batch
(two 65536-point ray-cast clouds, images kept for the camera branch); of
the single-agent nuScenes detector `cmt_fusion_nuscenes` (`NUSC_PATH`: six
640x1600 views, six task groups) on a 300000-row ten-sweep ray-cast cloud;
one frame of any of them (forward + top-300 decode); and the train step of
`cmt_fusion_coop_tumtraf` (DN with 128 GT slots, dropout 0.1, grid mask,
clipped AdamW) on the same batch with its ground truth. chip_smoke.py and
profile_path.py drive them; the overrides are those of the JAX `bench.py`
and `tools/probe_train_step.py`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from cmtcoop_tpu_torch import _build
from cmtcoop_tpu_torch.configs.presets import get_preset, post_center_range
from cmtcoop_tpu_torch.core.coder import decode_boxes
from cmtcoop_tpu_torch.data.synthetic import coop_batch, raycast_cloud
from cmtcoop_tpu_torch.models.build import build_detector, random_init_
from cmtcoop_tpu_torch.train.optim import AdamW
from cmtcoop_tpu_torch.train.train_step import make_train_step

PRESET = "cmt_lidar_coop_tumtraf"
FUSION_PRESET = "cmt_fusion_coop_tumtraf"
PATHS = (PRESET, FUSION_PRESET)
GATHER_PATH = PRESET + " gather"
TRAIN_PATH = FUSION_PRESET + " train"
NUSC_PATH = "cmt_fusion_nuscenes"
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
                NUSC_PATH: _LIDAR + ("osa_aggregate",),
                GATHER_PATH: ("flash_attention_packed", "conv3x3_bn_relu",
                              "neighbor_map"),
                TRAIN_PATH: ("flash_train_fwd", "flash_train_bwd_dq",
                             "flash_train_bwd_dkv", "neighbor_map")}
# the neighbour maps a frame or step of each path builds, one kernel-9
# launch each: per agent 7 on the pillar encoder (a subm map a level and 3
# down maps) and 8 on the gather one (4 subm maps, 3 down maps, conv_out's)
MAP_LAUNCHES = {PRESET: 14, FUSION_PRESET: 14, GATHER_PATH: 16,
                TRAIN_PATH: 14, NUSC_PATH: 7}
SEED = 0
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
# `NUSC_PATH`'s cloud and caps: the preset's 300000 rows and eval voxel cap,
# and pillar caps calibrated on 10-sweep nuScenes-like clouds (those of
# bench_torch/configs/cmt_fusion_nuscenes.json)
NUSC_POINTS = 300000
NUSC_MAX_VOXELS = 160000
NUSC_PILLAR_CAPS = (87040, 48640, 18688, 6144)
NUSC_VIEWS = 6


def build_main_path(
        device, preset: str = PRESET
) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """(model, batch) on `device` for one of `PATHS`, `GATHER_PATH` or
    `NUSC_PATH`: the full-width detector with weights from `SEED` and the
    benchmark batch drawn from `SEED` (the points, and the images and
    cameras when the preset has the camera branch)."""
    ek = dict(max_voxels=MAX_VOXELS, pillar_caps=PILLAR_CAPS)
    if preset == GATHER_PATH:
        preset = PRESET
        ek.update(encoder_impl="gather", sparse_stage_caps=SPARSE_CAPS)
    if preset == NUSC_PATH:
        ek = dict(max_voxels=NUSC_MAX_VOXELS, pillar_caps=NUSC_PILLAR_CAPS)
    p = get_preset(preset)
    model = build_detector(p, dtype=torch.bfloat16, extractor_kwargs=ek)
    random_init_(model, torch.Generator().manual_seed(SEED))
    model.to(device)
    np_batch = (single_batch(NUSC_POINTS, NUSC_VIEWS, IMG_HW, SEED)
                if preset == NUSC_PATH else
                coop_batch(1, N_POINTS, *VIEWS, IMG_HW, seed=SEED))
    keep = ("points",) + (CAMERA_KEYS if p.use_camera else ())
    batch = {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()
             if any(s in k for s in keep)}
    return model, batch


def single_batch(n_points: int, views: int, img_hw: Tuple[int, int],
                 seed: int = SEED) -> Dict[str, np.ndarray]:
    """A single-agent batch at batch 1 as numpy arrays (`points` (1,
    n_points, 5), `points_mask`, `imgs`, `lidar2img`, `img2lidar`): ten
    sweeps of a 32-beam lidar 1.84 m above the ground, nuScenes' lidar
    height, each a ray cast (`raycast_cloud`: 1084 azimuths, 70 m range,
    six objects of its own) from a sensor 0.25 m further back than the
    next one's (5 m/s at 20 Hz), with its time lag (s) in the fifth column,
    subsampled or padded to `n_points` rows (seed 0: 218979 rows, 72327
    pillars and 44170, 13844, 4674 cells at the downsampled levels, under
    `NUSC_PILLAR_CAPS`); `views` noise images behind randomly shifted
    identity cameras, as `coop_batch` draws them."""
    rng = np.random.default_rng(seed)
    sweeps = []
    for i in range(10):
        xyz = raycast_cloud(rng, n_beams=32, n_az=1084, ground_z=-1.84,
                            max_r=70.0, n_obj=6)
        xyz[:, 0] -= 0.25 * i
        sweeps.append(np.concatenate(
            [xyz, rng.uniform(0, 1, (len(xyz), 1)),
             np.full((len(xyz), 1), 0.05 * i)], 1).astype(np.float32))
    cloud = np.concatenate(sweeps)
    if len(cloud) > n_points:
        cloud = cloud[np.sort(rng.choice(len(cloud), n_points,
                                         replace=False))]
    points = np.zeros((1, n_points, 5), np.float32)
    points[0, :len(cloud)] = cloud
    mask = np.zeros((1, n_points), bool)
    mask[0, :len(cloud)] = True
    h, w = img_hw
    l2i = np.tile(np.eye(4, dtype=np.float32), (1, views, 1, 1))
    l2i[..., :3, 3] = rng.normal(size=(1, views, 3)) * 2
    return {"points": points, "points_mask": mask,
            "imgs": rng.normal(size=(1, views, h, w, 3)).astype(np.float32),
            "lidar2img": l2i,
            "img2lidar": np.linalg.inv(l2i).astype(np.float32)}


def frame(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
          path: str = PRESET):
    """One frame: the forward and the top-300 decode of the last decoder
    layer of every task group inside the post-centre range of `path`'s
    preset, synchronised. Returns (task_outs, decoded)."""
    task_outs, _ = model(batch)
    dec = decode_boxes(
        [t["cls_logits"][-1, 0] for t in task_outs],
        [torch.cat([t[k][-1, 0] for k in CODES], -1) for t in task_outs],
        post_center_range=post_center_range(get_preset(path.split()[0])))
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
