"""The traffic generator of single-agent nuScenes-like frames: a pool of
distinct frames drawn from the run's seed, as a traffic file's parameters
ask (numpy only, nothing of the program).

Each frame is one static street scene seen by a car driving along a
circular arc:

- The cloud aggregates `sweeps` sweeps of a 32-beam spinning lidar
  (HDL-32E-like: elevations -30.67 to +10.67 degrees, `azimuths` rays a
  beam, 70 m range, 2 cm range noise) taken at `sweep_hz` from the ego
  poses of the last `sweeps / sweep_hz` seconds, the ego driving at a
  constant speed drawn from `ego_speed_mps` (m/s) and a constant yaw
  rate drawn from `yaw_rate_rps` (rad/s), each sweep moved into the
  newest sweep's frame as nuScenes' sweep alignment does, so that static
  returns of successive sweeps overlap. Returns within 1 m of the sensor
  are dropped, as nuScenes drops the ego car's. Each point holds x, y, z,
  an intensity and its sweep's time lag (s), nuScenes' five columns. The
  cloud is padded (or subsampled) to `points` rows.
- The scene: a ground plane `sensor_height` below the sensor, a building
  facade along each side of the road, and `objects` upright cylinders
  (cars, poles, people) on the ground.
- The six views: a nuScenes-like camera ring (front, front-right,
  back-right, back, back-left, front-left at 0, -55, -110, 180, 110, 55
  degrees of yaw), 1266-pixel focal length on 1600 x 900 images resized
  to `image_hw`'s width and cropped to its lowest rows, each image noise
  with the newest sweep's points painted in at their projections
  (brighter nearer); `lidar2img` is each camera's projection and
  `img2lidar` its inverse.

Departures from nuScenes, none of which the compared numbers see: the
intensity is drawn in [0, 1) (nuScenes stores 0-255), the facades are
planes and the objects cylinders, and the camera sits at the lidar.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from bench_torch.generator import frame_seed

ELEV_DEG = (-30.67, 10.67)
MAX_RANGE = 70.0
MIN_RANGE = 1.0
FOCAL = 1266.0
FULL_HW = (900, 1600)
CAMERA_YAWS_DEG = (0.0, -55.0, -110.0, 180.0, 110.0, 55.0)


def _scene(rng: np.random.Generator, n_obj: int) -> Dict[str, np.ndarray]:
    """Facades at y = -left and y = +right of the road (world frame, the
    newest pose at the origin looking along +x) and upright cylinders."""
    half = rng.uniform(6.0, 15.0, 2)
    ox = rng.uniform(-60.0, 60.0, n_obj)
    side = rng.choice([-1.0, 1.0], n_obj)
    oy = side * rng.uniform(1.5, np.where(side > 0, half[1], half[0]) - 0.3)
    return dict(walls=np.array([-half[0], half[1]]), ox=ox, oy=oy,
                orad=rng.uniform(0.2, 2.2, n_obj),
                oh=rng.uniform(1.0, 3.5, n_obj),
                wall_h=rng.uniform(6.0, 20.0, 2))


def _sweep(rng: np.random.Generator, scene: Dict[str, np.ndarray],
           pos: np.ndarray, yaw: float, sensor_height: float,
           n_beams: int, n_az: int) -> np.ndarray:
    """One sweep from the sensor at `pos` (world x, y) with heading `yaw`:
    (K, 3) world xyz, the ground at z = -sensor_height."""
    elev = np.deg2rad(np.linspace(*ELEV_DEG, n_beams))
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False) + \
        rng.uniform(0, 2 * np.pi / n_az)  # each sweep's own phase
    e, a = np.meshgrid(elev, az + yaw, indexing="ij")
    dz, dxy = np.sin(e), np.cos(e)
    dx, dy = dxy * np.cos(a), dxy * np.sin(a)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(dz < -1e-6, -sensor_height / dz, np.inf)
        for wy, wh in zip(scene["walls"], scene["wall_h"]):
            tw = (wy - pos[1]) / dy
            zw = tw * dz
            hit = (tw > 0) & (zw < wh - sensor_height)
            t = np.where(hit & (tw < t), tw, t)
    for cx, cy, r, h in zip(scene["ox"], scene["oy"], scene["orad"],
                            scene["oh"]):
        # |pos + s * (dx, dy) - c| = r, s the horizontal distance over dxy
        px, py = pos[0] - cx, pos[1] - cy
        b = px * dx + py * dy
        c = px * px + py * py - r * r
        qa = dx * dx + dy * dy
        disc = b * b - qa * c
        ok = (disc > 0) & (c > 0)
        with np.errstate(invalid="ignore"):
            s = np.where(ok, (-b - np.sqrt(np.maximum(disc, 0))) / qa,
                         np.inf)
        z = s * dz
        hit = ok & (s > 0) & (z > -sensor_height) & \
            (z < h - sensor_height) & (s < t)
        t = np.where(hit, s, t)
    t = t + rng.normal(0, 0.02, t.shape)
    keep = np.isfinite(t) & (t < MAX_RANGE) & (t * dxy > MIN_RANGE)
    x = pos[0] + (t * dx)[keep]
    y = pos[1] + (t * dy)[keep]
    z = (t * dz)[keep]
    return np.stack([x, y, z], -1)


def _ego_poses(rng: np.random.Generator, traffic: dict):
    """Each sweep's (position, yaw, time lag) in the newest pose's frame,
    newest first: a constant speed and yaw rate, each drawn from its
    traffic range, along the arc behind it."""
    sweeps, hz = int(traffic["sweeps"]), float(traffic["sweep_hz"])
    speed = rng.uniform(*map(float, traffic["ego_speed_mps"]))
    rate = rng.uniform(*map(float, traffic["yaw_rate_rps"]))
    out = []
    for i in range(sweeps):
        ti = -i / hz
        yaw = rate * ti
        if abs(rate) > 1e-6:
            x = speed * np.sin(yaw) / rate
            y = speed * (1 - np.cos(yaw)) / rate
        else:
            x, y = speed * ti, 0.0
        out.append((np.array([x, y]), yaw, -ti))
    return out


def cloud(rng: np.random.Generator, traffic: dict) -> np.ndarray:
    """One frame's aggregated cloud: (K, 5) float32 x, y, z, intensity,
    time lag in the newest sweep's frame (module docstring)."""
    scene = _scene(rng, int(traffic["objects"]))
    h = float(traffic["sensor_height"])
    parts = []
    for pos, yaw, lag in _ego_poses(rng, traffic):
        xyz = _sweep(rng, scene, pos, yaw, h, int(traffic["beams"]),
                     int(traffic["azimuths"]))
        pts = np.zeros((len(xyz), 5), np.float32)
        pts[:, :3] = xyz
        pts[:, 3] = rng.uniform(0, 1, len(xyz))
        pts[:, 4] = lag
        parts.append(pts)
    return np.concatenate(parts)


def camera_ring(image_hw) -> np.ndarray:
    """(6, 4, 4) lidar2img of the six cameras for `image_hw` images: 1600 x
    900 ones resized to the width asked for and cropped to their lowest
    rows (nuScenes' eval resize and crop at 640 x 1600)."""
    h, w = image_hw
    scale = w / FULL_HW[1]
    focal = FOCAL * scale
    cy = FULL_HW[0] * scale / 2.0 - (FULL_HW[0] * scale - h)
    k = np.array([[focal, 0, w / 2.0, 0], [0, focal, cy, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]])
    out = []
    for yaw in np.deg2rad(CAMERA_YAWS_DEG):
        c, s = np.cos(yaw), np.sin(yaw)
        # lidar (x fwd, y left, z up) -> camera (x right, y down, z fwd)
        ext = np.eye(4)
        ext[:3, :3] = [[s, -c, 0], [0, 0, -1], [c, s, 0]]
        out.append(k @ ext)
    return np.stack(out).astype(np.float32)


def render(rng: np.random.Generator, pts: np.ndarray,
           lidar2img: np.ndarray, image_hw) -> np.ndarray:
    """(V, H, W, 3) float32 images: noise with `pts` painted in."""
    h, w = image_hw
    v = len(lidar2img)
    imgs = rng.normal(size=(v, h, w, 3)).astype(np.float32)
    homo = np.concatenate([pts[:, :3], np.ones((len(pts), 1), np.float32)],
                          1)
    for i in range(v):
        p = homo @ lidar2img[i].T
        front = p[:, 2] > 0.5
        u = (p[front, 0] / p[front, 2]).astype(np.int64)
        r = (p[front, 1] / p[front, 2]).astype(np.int64)
        inside = (u >= 0) & (u < w) & (r >= 0) & (r < h)
        depth = p[front, 2][inside]
        imgs[i, r[inside], u[inside]] = (4.0 - np.log(depth))[:, None]
    return imgs


def frame_pool(traffic: dict, config: dict, seed: int
               ) -> List[Dict[str, np.ndarray]]:
    """`traffic["pool"]` distinct host frames at batch 1 (`points`,
    `points_mask`, and with the camera branch `imgs`, `lidar2img`,
    `img2lidar`); frame i comes from `generator.frame_seed(seed, i)`."""
    n = int(traffic["points"])
    hw = tuple(config["image_hw"])
    pool = []
    for i in range(int(traffic["pool"])):
        rng = np.random.default_rng(frame_seed(seed, i))
        pts = cloud(rng, traffic)
        if len(pts) > n:
            pts = pts[np.sort(rng.choice(len(pts), n, replace=False))]
        frame = {"points": np.zeros((1, n, 5), np.float32),
                 "points_mask": np.zeros((1, n), bool)}
        frame["points"][0, :len(pts)] = pts
        frame["points_mask"][0, :len(pts)] = True
        if config.get("camera"):
            l2i = camera_ring(hw)
            newest = pts[pts[:, 4] == 0]
            frame["imgs"] = render(rng, newest, l2i, hw)[None]
            frame["lidar2img"] = l2i[None]
            frame["img2lidar"] = np.linalg.inv(l2i).astype(np.float32)[None]
        pool.append(frame)
    return pool
