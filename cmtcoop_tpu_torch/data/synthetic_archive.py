"""Synthesize a miniature raw TUMTraf/OpenLabel archive on disk
(counterpart of cmtcoop_tpu/data/synthetic_archive.py).

The rehearsal harness for real data (VERDICT r3 #4): builds, from scratch,
the exact on-disk layout `python -m cmtcoop_tpu_torch.tools.create_data`
consumes — PCD clouds in all THREE encodings (ascii / binary /
binary_compressed: real TUMTraf archives ship compressed), OpenLabel label
JSONs with cuboid+quaternion objects and the vehicle->infrastructure
transform, and camera images — so the create_data -> train -> test chain
can run end to end without the real archive. For one seed the clouds,
labels and layout are byte-equal to the JAX package's archive; each camera
image is the same uint8 array, stored losslessly as `{ts}_{cam}.npy` where
the JAX package encodes it as a JPEG, so no image decoder is needed. Used by
tests/test_torch_data_*.py and chip_smoke.py (at the TUMTraf cameras'
1200x1920).

Reference layout: a9coop_converter.py:86-170 (split dirs, sensor subdirs,
file naming `{ts}_{sensor}.pcd`).
"""
from __future__ import annotations

import json
import os

import numpy as np

from cmtcoop_tpu_torch.data.converters.pcd import lzf_compress_literal

CAMS = ("s110_camera_basler_south1_8mm", "s110_camera_basler_south2_8mm",
        "s110_camera_basler_north_8mm", "vehicle_camera_basler_16mm")
REG_DIR = (
    "s110_lidar_ouster_south_and_vehicle_lidar_robosense_registered")


def _pcd_header(n, fmt):
    return (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
        "TYPE F F F F\nCOUNT 1 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA {fmt}\n").encode("ascii")


def write_pcd(path, pts, inten, fmt):
    n = len(pts)
    cols = [pts[:, 0], pts[:, 1], pts[:, 2], inten]
    with open(path, "wb") as f:
        f.write(_pcd_header(n, fmt))
        if fmt == "ascii":
            np.savetxt(f, np.stack(cols, -1), fmt="%.6g")
        elif fmt == "binary":
            rec = np.zeros(n, dtype=[(c, np.float32) for c in "xyzi"])
            for name, col in zip("xyzi", cols):
                rec[name] = col.astype(np.float32)
            f.write(rec.tobytes())
        else:  # binary_compressed: SoA payload + lzf + size prefix
            buf = b"".join(c.astype(np.float32).tobytes() for c in cols)
            comp = lzf_compress_literal(buf)
            f.write(np.array([len(comp), len(buf)], np.uint32).tobytes())
            f.write(comp)


def make_scene(rng, n_obj=4, n_ground=1500, pts_per_obj=120):
    """Clustered boxes + points on them (infra/registered frame)."""
    boxes = np.zeros((n_obj, 7), np.float32)
    boxes[:, :2] = rng.uniform(-40, 40, (n_obj, 2))
    boxes[:, 2] = rng.uniform(-6, -3, n_obj)          # z center
    boxes[:, 3:6] = rng.uniform(1.5, 4.0, (n_obj, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_obj)
    pts = [rng.uniform(-60, 60, (n_ground, 3)).astype(np.float32)]
    pts[0][:, 2] = rng.uniform(-7.5, -7.0, n_ground)  # ground
    for b in boxes:
        local = rng.uniform(-0.5, 0.5, (pts_per_obj, 3)) * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        rot = local.copy()
        rot[:, 0] = local[:, 0] * c - local[:, 1] * s
        rot[:, 1] = local[:, 0] * s + local[:, 1] * c
        pts.append((rot + b[:3]).astype(np.float32))
    return boxes, np.concatenate(pts)


def yaw_to_quat(yaw):
    # parse_openlabel_objects: yaw = euler_z of (x,y,z,w); box stores -yaw
    return [0.0, 0.0, float(np.sin(yaw / 2)), float(np.cos(yaw / 2))]


def make_openlabel(boxes, names, num_pts, ts, v2i):
    objs = {}
    for i, (b, nm, npts) in enumerate(zip(boxes, names, num_pts)):
        objs[f"obj{i}"] = {"object_data": {
            "type": nm,
            "cuboid": {
                "val": [float(b[0]), float(b[1]), float(b[2])]
                + yaw_to_quat(b[6])
                + [float(b[3]), float(b[4]), float(b[5])],
                "attributes": {"num": [
                    {"name": "num_points", "val": int(npts)}]},
            }}}
    return {"openlabel": {"frames": {"0": {
        "frame_properties": {
            "timestamp": ts,
            "point_cloud_file_names": [
                f"{ts}_vehicle_lidar_robosense.pcd",
                f"{ts}_000000_s110_lidar_ouster_south.pcd"],
            "transforms": {
                "vehicle_lidar_robosense_to_s110_lidar_ouster_south": {
                    "transform_src_to_dst": {
                        "matrix4x4": v2i.tolist()}}},
        },
        "objects": objs,
    }}}}


def build_raw_archive(root, split_dir, n_frames, seed, n_obj=4,
                      n_ground=1500, pts_per_obj=120, img_hw=(256, 512)):
    """Write a `n_frames`-frame raw split under `root/split_dir`."""
    rng = np.random.default_rng(seed)
    sd = os.path.join(root, split_dir)
    for sub in ("vehicle_lidar_robosense", "s110_lidar_ouster_south",
                REG_DIR):
        os.makedirs(os.path.join(sd, "point_clouds", sub), exist_ok=True)
    os.makedirs(os.path.join(sd, "labels_point_clouds", REG_DIR),
                exist_ok=True)
    for cam in CAMS:
        os.makedirs(os.path.join(sd, "images", cam), exist_ok=True)

    names_pool = ["CAR", "TRUCK", "VAN", "PEDESTRIAN"]
    v2i = np.eye(4, dtype=np.float32)
    v2i[:3, 3] = [3.0, -2.0, 0.1]
    fmts = ["ascii", "binary", "binary_compressed"]
    for fi in range(n_frames):
        ts = f"16466673{fi:02d}_0000000{fi:02d}"
        boxes, reg_pts = make_scene(rng, n_obj, n_ground, pts_per_obj)
        names = [names_pool[i % len(names_pool)] for i in range(len(boxes))]
        # vehicle cloud: registered cloud pulled back through inv(v2i)
        h = np.concatenate(
            [reg_pts, np.ones((len(reg_pts), 1), np.float32)], -1)
        veh_pts = (h @ np.linalg.inv(v2i).T)[:, :3]
        infra_pts = reg_pts[::2]
        inten = rng.uniform(0, 255, len(reg_pts)).astype(np.float32)
        clouds = {
            "vehicle_lidar_robosense": veh_pts,
            "s110_lidar_ouster_south": infra_pts,
            REG_DIR: reg_pts,
        }
        for si, (sub, pts) in enumerate(clouds.items()):
            fmt = fmts[(fi + si) % 3]   # every encoding gets exercised
            write_pcd(
                os.path.join(sd, "point_clouds", sub, f"{ts}_{sub}.pcd"),
                pts, inten[:len(pts)], fmt)
        lbl = make_openlabel(boxes, names, [pts_per_obj] * len(boxes), ts,
                             v2i)
        with open(os.path.join(sd, "labels_point_clouds", REG_DIR,
                               f"{ts}.json"), "w") as f:
            json.dump(lbl, f)
        for cam in CAMS:
            img = rng.integers(0, 255, (*img_hw, 3), np.uint8)
            np.save(os.path.join(sd, "images", cam, f"{ts}_{cam}.npy"), img)
