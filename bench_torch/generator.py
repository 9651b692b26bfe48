"""The traffic generator: a pool of distinct cooperative frames drawn from
the run's seed, as a traffic file's parameters ask.

`raycast_cloud` and `coop_batch` are copies of the port's
`cmtcoop_tpu_torch/data/synthetic.py` functions of the same names (numpy
only), kept here so that no change to the program can move the traffic.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


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
    generator advances alike for every configuration."""
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


def frame_seed(seed: int, index: int) -> int:
    """The seed of pool frame `index` of a run seeded `seed` (any whole
    number >= 0, also past 64 bits)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def frame_pool(traffic: dict, config: dict, seed: int
               ) -> List[Dict[str, np.ndarray]]:
    """`traffic["pool"]` distinct host frames for `config`: the clouds of
    `traffic["points"]` points (scaled by `traffic.get("cloud_scale", 1)`
    about the sensor), and the camera arrays where the configuration has
    the camera branch. Frame i comes from `frame_seed(seed, i)`."""
    views = config["views"]
    hw = tuple(config["image_hw"])
    scale = float(traffic.get("cloud_scale", 1.0))
    keep = ("points", "points_mask")
    if config.get("camera"):
        keep += ("imgs", "lidar2img", "img2lidar")
    pool = []
    for i in range(int(traffic["pool"])):
        b = coop_batch(int(traffic["batch"]), int(traffic["points"]),
                       views["vehicle"], views["infrastructure"], hw,
                       seed=frame_seed(seed, i))
        frame = {}
        for agent in ("vehicle_", "infrastructure_"):
            for k in keep:
                frame[agent + k] = np.ascontiguousarray(b[agent + k])
            if scale != 1.0:
                frame[agent + "points"][..., :3] *= scale
        pool.append(frame)
    return pool
