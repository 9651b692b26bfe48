"""TUMTraf intersection (single-agent infrastructure) converter
(counterpart of cmtcoop_tpu/data/converters/a9_nusc.py).

Rebuild of tools/data_converter/a9_converter.py (A92Nusc): PCD -> .bin and
OpenLabel registered-lidar labels -> `a9_nusc_infos_{split}.pkl` with the
south1/south2 camera calibration tables (a9_converter.py:135-186, public
TUMTraf calibration)."""
from __future__ import annotations

import os
import pickle
from glob import glob
from typing import Dict, List

import numpy as np

from cmtcoop_tpu_torch.data.converters.a9coop import (
    SPLIT_DIRS, _cam_info, parse_openlabel_objects)
from cmtcoop_tpu_torch.data.converters.pcd import pcd_to_bin

LIDAR2EGO = np.asarray(
    [[0.99011437, -0.13753536, -0.02752358, 2.3728100375737995],
     [0.13828977, 0.99000475, 0.02768645, -16.19297517556697],
     [0.02344061, -0.03121898, 0.99923766, -8.620000000000005]], np.float32)
LIDAR2S1IMG = np.asarray(
    [[7.04216073e02, -1.37317442e03, -4.32235765e02, -2.03369364e04],
     [-9.28351327e01, -1.77543929e01, -1.45629177e03, 9.80290034e02],
     [8.71736000e-01, -9.03453000e-02, -4.81574000e-01, -2.58546000e00]],
    np.float32)
LIDAR2S2IMG = np.asarray(
    [[1546.63215008, -436.92407115, -295.58362676, 1319.79271737],
     [93.20805656, 47.90351592, -1482.13403199, 687.84781276],
     [0.73326062, 0.59708904, -0.32528854, -1.30114325]], np.float32)
SOUTH1_INTRINSICS = np.asarray(
    [[1400.3096617691212, 0.0, 967.7899705163408],
     [0.0, 1403.041082755918, 581.7195041357244],
     [0.0, 0.0, 1.0]], np.float32)
SOUTH1_2_LIDAR = np.asarray(
    [[-0.10087585, -0.51122875, 0.88484734, 1.90816304],
     [-1.0776537, 0.03094424, -0.10792235, -14.05913251],
     [0.01956882, -0.93122171, -0.45454375, 0.72290242]], np.float32)
SOUTH2_INTRINSICS = np.asarray(
    [[1029.2795655594014, 0.0, 982.0311857478633],
     [0.0, 1122.2781391971948, 1129.1480997238505],
     [0.0, 0.0, 1.0]], np.float32)
SOUTH2_2_LIDAR = np.asarray(
    [[0.49709212, -0.19863714, 0.64202357, -0.03734614],
     [-0.60406415, -0.17852863, 0.50214409, 2.52095055],
     [0.01173726, -0.77546627, -0.70523436, 0.54322305]], np.float32)

LIDAR_DIR = "s110_lidar_ouster_south"


def convert_split(load_dir: str, save_dir: str, split: str) -> List[Dict]:
    sdir = SPLIT_DIRS[split]
    test = split == "testing"
    os.makedirs(os.path.join(save_dir, LIDAR_DIR), exist_ok=True)

    pcds = sorted(glob(os.path.join(
        load_dir, sdir, "point_clouds", LIDAR_DIR, "*")))
    bins = []
    for p in pcds:
        stem = os.path.splitext(os.path.basename(p))[0]
        out = os.path.join(save_dir, LIDAR_DIR, stem + ".bin")
        if not os.path.exists(out):
            pcd_to_bin(p, out)
        bins.append(out)
    labels = sorted(glob(os.path.join(
        load_dir, sdir, "labels_point_clouds", LIDAR_DIR, "*")))
    img_s1 = sorted(glob(os.path.join(
        load_dir, sdir, "images", "s110_camera_basler_south1_8mm", "*")))
    img_s2 = sorted(glob(os.path.join(
        load_dir, sdir, "images", "s110_camera_basler_south2_8mm", "*")))

    infos = []
    for i, label_path in enumerate(labels):
        props, boxes, names, num_pts = parse_openlabel_objects(label_path)
        ts = props["timestamp"]
        info = dict(
            lidar_path=bins[i], lidar_anno_path=label_path, sweeps=[],
            lidar2ego=LIDAR2EGO, timestamp=ts,
            location="s110",
            cams={
                "s110_camera_basler_south1_8mm": _cam_info(
                    img_s1[i], "s110_camera_basler_south1_8mm",
                    LIDAR2S1IMG, SOUTH1_2_LIDAR, SOUTH1_INTRINSICS, ts),
                "s110_camera_basler_south2_8mm": _cam_info(
                    img_s2[i], "s110_camera_basler_south2_8mm",
                    LIDAR2S2IMG, SOUTH2_2_LIDAR, SOUTH2_INTRINSICS, ts),
            })
        if not test:
            info.update(
                gt_boxes=boxes, gt_names=np.asarray(names),
                gt_velocity=np.zeros((len(boxes), 2), np.float32),
                num_lidar_pts=np.asarray(num_pts),
                num_radar_pts=np.zeros(len(boxes), np.int64),
                valid_flag=np.ones(len(boxes), bool))
        infos.append(info)
    return infos


def convert_all(load_dir: str, save_dir: str,
                splits=("training", "validation", "testing")) -> None:
    os.makedirs(save_dir, exist_ok=True)
    for split in splits:
        infos = convert_split(load_dir, save_dir, split)
        tag = {"training": "train", "validation": "val",
               "testing": "test"}[split]
        out = os.path.join(save_dir, f"a9_nusc_infos_{tag}.pkl")
        with open(out, "wb") as f:
            pickle.dump(dict(infos=infos, metadata=dict(version="r1")), f)
        print(f"{split}: {len(infos)} samples -> {out}")
