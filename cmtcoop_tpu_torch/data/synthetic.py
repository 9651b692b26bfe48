"""Synthetic inputs, numpy only, drawing from their generators in the same
order as the JAX package's, so one seed gives the same arrays in both:

- the training stream of `--synthetic` runs (`synthetic_scene`,
  `synthetic_sample`, `synthetic_batch_iter`; cmtcoop_tpu/data/synthetic.py):
  scenes of a few boxes whose surfaces are dense point clusters, so an
  overfit run has real signal;
- the clouds and layout of the JAX package's benchmark batch
  (`__graft_entry__._raycast_cloud` and `_coop_batch`);
- the small batches of the port's parity checks."""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from cmtcoop_tpu_torch.configs.presets import Preset
from cmtcoop_tpu_torch.data import formats


def synthetic_scene(preset: Preset, rng: np.random.Generator,
                    n_objects: int = 8, n_bg: int = 4000,
                    pts_per_obj: int = 300) -> Dict:
    """`n_objects` boxes in the inner 70% of the preset's range, each with
    `pts_per_obj` points inside it, over `n_bg` ground points. Returns
    `points` (N, 5), bottom-centred `gt_boxes_3d` (n, 9), `gt_labels_3d`."""
    lo = np.asarray(preset.pc_range[:3])
    hi = np.asarray(preset.pc_range[3:])
    boxes = np.zeros((n_objects, 9), np.float32)
    boxes[:, :2] = rng.uniform(lo[:2] * 0.7, hi[:2] * 0.7, (n_objects, 2))
    boxes[:, 2] = rng.uniform(lo[2] + 0.2, lo[2] + 1.0, n_objects)
    boxes[:, 3:6] = rng.uniform([1.6, 3.5, 1.4], [2.6, 8.0, 3.5],
                                (n_objects, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_objects)
    labels = rng.integers(0, len(preset.class_names), n_objects)

    pts = []
    for b in boxes:
        local = rng.uniform(-0.5, 0.5, (pts_per_obj, 3)) * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        x = local[:, 0] * c - local[:, 1] * s + b[0]
        y = local[:, 0] * s + local[:, 1] * c + b[1]
        z = local[:, 2] + b[2] + b[5] / 2
        inten = rng.uniform(0, 1, (pts_per_obj, 1))
        pts.append(np.concatenate(
            [np.stack([x, y, z], -1), inten,
             np.zeros((pts_per_obj, 1))], -1))
    ground = np.concatenate([
        rng.uniform(lo, hi, (n_bg, 3)),
        rng.uniform(0, 1, (n_bg, 1)), np.zeros((n_bg, 1))], -1)
    ground[:, 2] = lo[2] + np.abs(rng.normal(0, 0.05, n_bg))
    points = np.concatenate(pts + [ground]).astype(np.float32)
    return dict(points=points, gt_boxes_3d=boxes,
                gt_labels_3d=labels.astype(np.int64))


def synthetic_sample(preset: Preset, rng: np.random.Generator,
                     with_gt: bool = True) -> Dict[str, np.ndarray]:
    """One fixed-shape model sample for the preset's topology: each agent
    sees the scene's points with its own noise and, with the camera branch,
    random images (1 view for the vehicle, `num_views` for the others)
    behind a fixed pinhole `lidar2img`."""
    prefixes = (("vehicle_", "infrastructure_")
                if preset.domain == "coop" else ("",))
    scene = synthetic_scene(preset, rng)
    sample: Dict = {}
    for p in prefixes:
        if preset.use_lidar:
            noise = rng.normal(0, 0.02, scene["points"].shape).astype(
                np.float32)
            sample[p + "points"] = scene["points"] + noise
        if preset.use_camera:
            v = preset.num_views if p != "vehicle_" else 1
            h, w = preset.img_size
            sample[p + "imgs"] = rng.normal(
                size=(v, h, w, 3)).astype(np.float32)
            l2i = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
            l2i[:, 0, 0] = l2i[:, 1, 1] = 1000.0
            l2i[:, 0, 3] = w / 2
            l2i[:, 1, 3] = h / 2
            sample[p + "lidar2img"] = l2i
    if with_gt:
        sample["gt_boxes_3d"] = scene["gt_boxes_3d"]
        sample["gt_labels_3d"] = scene["gt_labels_3d"]
    out = formats.sample_to_model_batch(
        sample, max_points=preset.max_points, max_gt=preset.max_gt,
        prefixes=prefixes, with_gt=with_gt)
    for p in prefixes:
        if preset.use_camera:
            out[p + "imgs"] = sample[p + "imgs"]
            out[p + "lidar2img"] = sample[p + "lidar2img"]
            out[p + "img2lidar"] = np.linalg.inv(
                sample[p + "lidar2img"]).astype(np.float32)
    return out


def synthetic_batch_iter(preset: Preset, batch_size: int,
                         seed: int = 0,
                         n_scenes: int = 4) -> Iterator[Dict]:
    """Cycles a pool of `n_scenes` samples (sample i from `seed + i`) ->
    overfittable batches of `batch_size`, without end."""
    pool = [synthetic_sample(preset, np.random.default_rng(seed + i))
            for i in range(n_scenes)]
    i = 0
    while True:
        batch = [pool[(i + j) % n_scenes] for j in range(batch_size)]
        i += batch_size
        yield formats.collate(batch)


def raycast_cloud(rng: np.random.Generator, n_beams: int = 64,
                  n_az: int = 1024, sensor_z: float = 0.0,
                  ground_z: float = -7.7, max_r: float = 71.5,
                  n_obj: int = 60) -> np.ndarray:
    """Spinning-lidar ray cast (64 beams x 1024 azimuths): ground returns,
    cylinder objects with their shadows, no-return rays dropped. Returns
    (K, 3) float32 xyz."""
    elev = np.deg2rad(np.linspace(-45.0, 22.5, n_beams))
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    e, a = np.meshgrid(elev, az, indexing="ij")
    dz, dxy = np.sin(e), np.cos(e)
    with np.errstate(divide="ignore"):
        t_g = np.where(dz < -1e-6, (ground_z - sensor_z) / dz, np.inf)
    ox = rng.uniform(-60, 60, n_obj)
    oy = rng.uniform(-60, 60, n_obj)
    orad = rng.uniform(1.0, 2.5, n_obj)
    oh = rng.uniform(1.5, 3.5, n_obj)
    o_r = np.hypot(ox, oy)
    o_az = np.arctan2(oy, ox)
    t_best = t_g.copy()
    for i in range(n_obj):
        if o_r[i] < 3.0:
            continue
        dang = (a - o_az[i] + np.pi) % (2 * np.pi) - np.pi
        hit_az = np.abs(dang) < np.arctan(orad[i] / o_r[i])
        t_obj = o_r[i] / np.maximum(dxy, 1e-6)
        z_at = sensor_z + t_obj * dz
        hit = hit_az & (z_at > ground_z) & (z_at < ground_z + oh[i])
        t_best = np.where(hit & (t_obj < t_best), t_obj, t_best)
    hit_any = np.isfinite(t_best)
    t = np.where(hit_any, t_best, 0.0) + rng.normal(0, 0.02, t_best.shape)
    valid = hit_any & (t * dxy < max_r) & (t > 2.0)
    x = (t * dxy * np.cos(a))[valid]
    y = (t * dxy * np.sin(a))[valid]
    z = (sensor_z + t * dz)[valid]
    return np.stack([x, y, z], -1).astype(np.float32)


def coop_batch(batch_size: int, n_points: int, veh_views: int,
               infra_views: int, img_hw: Tuple[int, int],
               max_gt: Optional[int] = None,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """Cooperative batch as numpy arrays: per agent prefix (`vehicle_`,
    `infrastructure_`) `points` (B, n_points, 5), `points_mask`, `imgs`,
    `lidar2img`, `img2lidar`; with `max_gt`, `gt_boxes` / `gt_labels` /
    `gt_mask`. The images are drawn even when a caller drops them, so the
    generator advances exactly as in the JAX package."""
    rng = np.random.default_rng(seed)
    h, w = img_hw
    batch: Dict[str, np.ndarray] = {}

    def lidar_like_cloud(n):
        xyz = raycast_cloud(rng)
        if len(xyz) > n:
            xyz = xyz[rng.choice(len(xyz), n, replace=False)]
        k = len(xyz)
        pts = np.zeros((n, 5), np.float32)
        pts[:k, :3] = xyz
        pts[:k, 3] = rng.uniform(0, 1, k)
        mask = np.zeros(n, bool)
        mask[:k] = True
        return pts, mask

    for prefix, v in (("vehicle_", veh_views),
                      ("infrastructure_", infra_views)):
        clouds = [lidar_like_cloud(n_points) for _ in range(batch_size)]
        batch[prefix + "points"] = np.stack([c[0] for c in clouds])
        batch[prefix + "points_mask"] = np.stack([c[1] for c in clouds])
        batch[prefix + "imgs"] = rng.normal(
            size=(batch_size, v, h, w, 3)).astype(np.float32)
        l2i = np.tile(np.eye(4, dtype=np.float32), (batch_size, v, 1, 1))
        l2i[..., :3, 3] = rng.normal(size=(batch_size, v, 3)) * 2
        batch[prefix + "lidar2img"] = l2i
        batch[prefix + "img2lidar"] = np.linalg.inv(l2i).astype(np.float32)
    if max_gt is not None:
        gt = np.zeros((batch_size, max_gt, 9), np.float32)
        gt[..., :2] = rng.uniform(-50, 50, (batch_size, max_gt, 2))
        gt[..., 2] = rng.uniform(-6, -2, (batch_size, max_gt))
        gt[..., 3:6] = rng.uniform(0.5, 4, (batch_size, max_gt, 3))
        batch["gt_boxes"] = gt
        batch["gt_labels"] = rng.integers(
            0, 7, (batch_size, max_gt)).astype(np.int32)
        batch["gt_mask"] = np.ones((batch_size, max_gt), bool)
    return batch


def small_coop_batch() -> Dict[str, np.ndarray]:
    """The points of the small cooperative detector's checks
    (configs/presets.py `SMALL_COOP_*`): two 2048-point ray-cast clouds
    (seed 0), shrunk by 0.2 into its 32 m range."""
    b = coop_batch(1, 2048, 1, 1, (8, 16), seed=0)
    b = {k: v for k, v in b.items() if "points" in k}
    for a in ("vehicle_", "infrastructure_"):
        b[a + "points"][..., :3] *= 0.2
    return b


def pinhole_lidar2img(h: int, w: int, yaw: float) -> np.ndarray:
    """(4, 4) lidar -> image projection of a pinhole camera at the lidar's
    origin looking along the lidar x axis turned by `yaw` about z, with
    fx = fy = w/2 and the principal point at the image centre: a point at
    (x, y, z) maps to (u*d, v*d, d, 1), depth d along the view."""
    c, s = np.cos(yaw), np.sin(yaw)
    # lidar -> camera axes: right = -y', down = -z, forward = x'
    rot = np.array([[s, -c, 0.0], [0.0, 0.0, -1.0], [c, s, 0.0]])
    k = np.array([[w / 2, 0.0, w / 2], [0.0, w / 2, h / 2], [0.0, 0.0, 1.0]])
    l2i = np.eye(4)
    l2i[:3, :3] = k @ rot
    return l2i.astype(np.float32)


def small_fusion_batch() -> Dict[str, np.ndarray]:
    """The batch of the small cooperative fusion detector's checks
    (configs/presets.py `SMALL_FUSION_*`): the clouds of
    `small_coop_batch()`, plus 64x128 images (seed 1) from 1 vehicle view
    looking along +x and 2 infrastructure views looking along +x and -x,
    each a `pinhole_lidar2img` camera (a 90 degree horizontal field of view,
    so some queries land in an image and some in none), and their
    inverses as `img2lidar`."""
    h, w = 64, 128
    b = small_coop_batch()
    rng = np.random.default_rng(1)
    for a, yaws in (("vehicle_", (0.0,)), ("infrastructure_", (0.0, np.pi))):
        b[a + "imgs"] = rng.normal(
            size=(1, len(yaws), h, w, 3)).astype(np.float32)
        l2i = np.stack([pinhole_lidar2img(h, w, y) for y in yaws])[None]
        b[a + "lidar2img"] = l2i
        b[a + "img2lidar"] = np.linalg.inv(l2i).astype(np.float32)
    return b


def small_fusion_train_batch() -> Dict[str, np.ndarray]:
    """`small_fusion_batch()` plus the ground truth of the small train-step
    checks: 4 GT slots (slot 2 padding) inside its 32 m range, label 0 (the
    tiny preset's one class), drawn from seed 5."""
    b = small_fusion_batch()
    rng = np.random.default_rng(5)
    gt = np.zeros((1, 4, 9), np.float32)
    gt[..., :2] = rng.uniform(-12, 12, (1, 4, 2))
    gt[..., 2] = rng.uniform(-3, 1, (1, 4))
    gt[..., 3:6] = rng.uniform(0.5, 4, (1, 4, 3))
    gt[..., 6] = rng.uniform(-3, 3, (1, 4))
    gt[..., 7:] = rng.normal(size=(1, 4, 2))
    b["gt_boxes"] = gt
    b["gt_labels"] = np.zeros((1, 4), np.int32)
    b["gt_mask"] = np.array([[True, True, False, True]])
    return b
