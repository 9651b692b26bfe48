"""TraffiX/TUMTraf cooperative dataset converter (OpenLabel -> infos pkl;
counterpart of cmtcoop_tpu/data/converters/a9coop.py).

Rebuild of tools/data_converter/a9coop_converter.py:18-404: converts the raw
dataset (PCD clouds + OpenLabel JSON labels + camera JPGs) into the pkl info
format both frameworks consume, with the same directory layout, fixed sensor
calibration tables (public TUMTraf calibration, a9coop_converter.py:172-241)
and box convention (z at center, yaw = -euler_z of the quaternion,
a9coop_converter.py:313-346).

Also builds the GT-paste database from the *registered* clouds — fixing the
reference's latent defect where the coop GT database referenced undefined
loader classes (create_gt_database.py:300-344, SURVEY §2.1 #30).
"""
from __future__ import annotations

import json
import os
import pickle
from glob import glob
from typing import Dict, List, Optional

import numpy as np

from cmtcoop_tpu_torch.data.converters.pcd import pcd_to_bin
from cmtcoop_tpu_torch.data.pipelines import box_np
from cmtcoop_tpu_torch.data.pipelines.transforms import open_image

# ---- fixed TUMTraf sensor calibration (a9coop_converter.py:172-241) ----
INFRA_LIDAR2S1IMG = np.asarray(
    [[1279.275240545117, -862.9254609474538, -443.6558546306608,
      -16164.33175985643],
     [-57.00793327192514, -67.92432779187584, -1461.785310749125,
      -806.9258947569469],
     [0.7901272773742676, 0.3428181111812592, -0.508108913898468,
      3.678680419921875]], dtype=np.float32)
INFRA_LIDAR2S2IMG = np.asarray(
    [[1546.63215008, -436.92407115, -295.58362676, 1319.79271737],
     [93.20805656, 47.90351592, -1482.13403199, 687.84781276],
     [0.73326062, 0.59708904, -0.32528854, -1.30114325]], dtype=np.float32)
INFRA_LIDAR2N1IMG = np.asarray(
    [[-185.2891049687059, -1504.063395597006, -525.9215327879701,
      -23336.12843138125],
     [-240.2665682659353, 220.6722195428702, -1567.287260600104,
      6362.243306159624],
     [0.6863989233970642, -0.4493367969989777, -0.5717979669570923,
      -6.750176429748535]], dtype=np.float32)
SOUTH1_INTRINSICS = np.asarray(
    [[1400.3096617691212, 0.0, 967.7899705163408],
     [0.0, 1403.041082755918, 581.7195041357244],
     [0.0, 0.0, 1.0]], dtype=np.float32)
SOUTH1_2_INFRALIDAR = np.asarray(
    [[0.41204962, -0.45377758, 0.7901276, 2.158825],
     [-0.9107832, -0.23010845, 0.34281868, -15.5765505],
     [0.02625162, -0.86089253, -0.5081085, 0.08758777]], dtype=np.float32)
SOUTH2_INTRINSICS = np.asarray(
    [[1029.2795655594014, 0.0, 982.0311857478633],
     [0.0, 1122.2781391971948, 1129.1480997238505],
     [0.0, 0.0, 1.0]], dtype=np.float32)
SOUTH2_2_INFRALIDAR = np.asarray(
    [[0.6353517, -0.24219051, 0.7332613, -0.03734626],
     [-0.7720766, -0.217673, 0.5970893, 2.5209506],
     [0.01500183, -0.9454958, -0.32528937, 0.543223]], dtype=np.float32)
NORTH_INTRINSICS = np.asarray(
    [[1315.158203125, 0.0, 962.7348338975571],
     [0.0, 1362.7757568359375, 580.6482296623581],
     [0.0, 0.0, 1.0]], dtype=np.float32)
NORTH_2_INFRALIDAR = np.asarray(
    [[-0.56460226, -0.4583457, 0.6863989, 0.64204305],
     [-0.8248329, 0.34314296, -0.4493365, -16.182753],
     [-0.02958117, -0.81986094, -0.57179797, 1.6824605]], dtype=np.float32)
VEHICLE_LIDAR2IMG = np.asarray(
    [[1019.929965441548, -2613.286262078907, 184.6794570200418,
      370.7180273597151],
     [589.8963703919744, -24.09642935106967, -2623.908527352794,
      -139.3143336725661],
     [0.9841844439506531, 0.1303769648075104, 0.1199281811714172,
      -0.1664766669273376]], dtype=np.float32)
VEHICLE_CAM_INTRINSICS = np.asarray(
    [[2726.55, 0.0, 685.235],
     [0.0, 2676.64, 262.745],
     [0.0, 0.0, 1.0]], dtype=np.float32)
VEHICLE_CAM2LIDAR = np.asarray(
    [[0.12672871, 0.12377692, 0.9841849, 0.14573078],
     [-0.9912245, -0.02180046, 0.13037732, 0.19717109],
     [0.03759337, -0.99207014, 0.11992808, -0.02214238]], dtype=np.float32)

VEHICLE_LIDAR_DIR = "vehicle_lidar_robosense"
INFRA_LIDAR_DIR = "s110_lidar_ouster_south"
REGISTERED_LIDAR_DIR = (
    "s110_lidar_ouster_south_and_vehicle_lidar_robosense_registered")
SPLIT_DIRS = {"training": "train", "validation": "val", "testing": "test"}


def quat_to_yaw(quat_xyzw) -> float:
    """euler z of an (x, y, z, w) quaternion; the converter negates it."""
    from scipy.spatial.transform import Rotation
    return float(Rotation.from_quat(np.asarray(quat_xyzw)).as_euler(
        "xyz", degrees=False)[2])


def parse_openlabel_objects(label_path: str):
    """OpenLabel frame -> (frame_properties, gt_boxes (N, 7), names,
    num_lidar_pts). Box: (x, y, z_center, sx, sy, sz, -yaw)."""
    with open(label_path) as f:
        anno = json.load(f)
    frame = None
    for j in anno["openlabel"]["frames"]:
        frame = anno["openlabel"]["frames"][j]
    props = frame["frame_properties"]
    boxes, names, num_pts = [], [], []
    for oid in frame.get("objects", {}):
        od = frame["objects"][oid]["object_data"]
        val = od["cuboid"]["val"]
        loc = np.asarray(val[:3], np.float32)
        dim = np.asarray(val[7:], np.float32)
        yaw = quat_to_yaw(val[3:7])
        boxes.append(np.concatenate([loc, dim, [-yaw]]))
        names.append(od["type"])
        n = 0
        for attr in od["cuboid"].get("attributes", {}).get("num", []):
            if attr["name"] == "num_points":
                n = attr["val"]
        num_pts.append(n)
    boxes = (np.stack(boxes).astype(np.float32) if boxes
             else np.zeros((0, 7), np.float32))
    return props, boxes, names, np.asarray(num_pts)


def _cam_info(data_path, cam_type, lidar2image, sensor2lidar, intrinsics,
              ts):
    return dict(data_path=data_path, type=cam_type, lidar2image=lidar2image,
                sensor2lidar=sensor2lidar, camera_intrinsics=intrinsics,
                timestamp=ts)


def convert_split(load_dir: str, save_dir: str, split: str) -> List[Dict]:
    """One split: PCD -> .bin + infos list (a9coop_converter.py:79-357)."""
    sdir = SPLIT_DIRS[split]
    test = split == "testing"
    os.makedirs(save_dir, exist_ok=True)
    for sub in (VEHICLE_LIDAR_DIR, INFRA_LIDAR_DIR, REGISTERED_LIDAR_DIR):
        os.makedirs(os.path.join(save_dir, sub), exist_ok=True)

    def convert_clouds(sub):
        out_paths = []
        for p in sorted(glob(os.path.join(
                load_dir, sdir, "point_clouds", sub, "*"))):
            stem = os.path.splitext(os.path.basename(p))[0]
            out = os.path.join(save_dir, sub, stem + ".bin")
            if not os.path.exists(out):
                pcd_to_bin(p, out)
            out_paths.append(out)
        return out_paths

    veh_bins = convert_clouds(VEHICLE_LIDAR_DIR)
    infra_bins = convert_clouds(INFRA_LIDAR_DIR)
    reg_bins = convert_clouds(REGISTERED_LIDAR_DIR)
    labels = sorted(glob(os.path.join(
        load_dir, sdir, "labels_point_clouds", REGISTERED_LIDAR_DIR, "*")))
    imgs = {
        cam: sorted(glob(os.path.join(load_dir, sdir, "images", cam, "*")))
        for cam in ("s110_camera_basler_south1_8mm",
                    "s110_camera_basler_south2_8mm",
                    "s110_camera_basler_north_8mm",
                    "vehicle_camera_basler_16mm")
    }

    infos = []
    for i, label_path in enumerate(labels):
        props, boxes, names, num_pts = parse_openlabel_objects(label_path)
        ts = props["timestamp"]
        v2i = np.asarray(props["transforms"][
            "vehicle_lidar_robosense_to_s110_lidar_ouster_south"][
            "transform_src_to_dst"]["matrix4x4"], np.float32)
        info = dict(
            timestamp=ts,
            location=props["point_cloud_file_names"][1].split("_")[2]
            if len(props.get("point_cloud_file_names", [])) > 1 else "s110",
            vehicle_lidar_path=veh_bins[i], vehicle_sweeps=[],
            infrastructure_lidar_path=infra_bins[i],
            infrastructure_sweeps=[],
            registered_lidar_path=reg_bins[i], registered_sweeps=[],
            vehicle2infrastructure=v2i,
            lidar_anno_path=label_path,
            vehicle_cams={
                "vehicle_camera_basler_16mm": _cam_info(
                    imgs["vehicle_camera_basler_16mm"][i],
                    "vehicle_camera_basler_16mm", VEHICLE_LIDAR2IMG,
                    VEHICLE_CAM2LIDAR, VEHICLE_CAM_INTRINSICS, ts)},
            infrastructure_cams={
                "s110_camera_basler_south1_8mm": _cam_info(
                    imgs["s110_camera_basler_south1_8mm"][i],
                    "s110_camera_basler_south1_8mm", INFRA_LIDAR2S1IMG,
                    SOUTH1_2_INFRALIDAR, SOUTH1_INTRINSICS, ts),
                "s110_camera_basler_south2_8mm": _cam_info(
                    imgs["s110_camera_basler_south2_8mm"][i],
                    "s110_camera_basler_south2_8mm", INFRA_LIDAR2S2IMG,
                    SOUTH2_2_INFRALIDAR, SOUTH2_INTRINSICS, ts),
                "s110_camera_basler_north_8mm": _cam_info(
                    imgs["s110_camera_basler_north_8mm"][i],
                    "s110_camera_basler_north_16mm", INFRA_LIDAR2N1IMG,
                    NORTH_2_INFRALIDAR, NORTH_INTRINSICS, ts)},
        )
        if not test:
            info.update(
                gt_boxes=boxes,
                gt_names=np.asarray(names),
                gt_velocity=np.zeros((len(boxes), 2), np.float32),
                num_lidar_pts=np.asarray(num_pts),
                num_radar_pts=np.zeros(len(boxes), np.int64),
                valid_flag=np.ones(len(boxes), bool),
            )
        infos.append(info)
    return infos


def convert_all(load_dir: str, save_dir: str,
                splits=("training", "validation", "testing")) -> None:
    for split in splits:
        infos = convert_split(load_dir, save_dir, split)
        tag = {"training": "train", "validation": "val",
               "testing": "test"}[split]
        out = os.path.join(save_dir, f"a9_nusc_coop_infos_{tag}.pkl")
        with open(out, "wb") as f:
            pickle.dump(dict(infos=infos, metadata=dict(version="r1")), f)
        print(f"{split}: {len(infos)} samples -> {out}")


def create_gt_database(save_dir: str,
                       info_path: Optional[str] = None) -> None:
    """Build the GT-paste database from the registered clouds
    (create_gt_database.py:111-498; uses the registered cloud so pasted
    objects carry both agents' points)."""
    info_path = info_path or os.path.join(
        save_dir, "a9_nusc_coop_infos_train.pkl")
    with open(info_path, "rb") as f:
        infos = pickle.load(f)["infos"]
    db_dir = os.path.join(save_dir, "a9_nusc_coop_gt_database")
    os.makedirs(db_dir, exist_ok=True)
    db_infos: Dict[str, List[dict]] = {}
    for info in infos:
        pts = np.fromfile(
            info["registered_lidar_path"], np.float32).reshape(-1, 5)
        boxes = np.asarray(info["gt_boxes"], np.float32)
        if not len(boxes):
            continue
        bottom = boxes.copy()
        bottom[:, 2] -= bottom[:, 5] / 2.0
        inside = box_np.points_in_rbbox(pts, bottom)
        for gi, name in enumerate(info["gt_names"]):
            obj_pts = pts[inside[:, gi]].copy()
            obj_pts[:, :3] -= bottom[gi, :3]
            fname = f"{info['timestamp']}_{name}_{gi}.bin"
            obj_pts.astype(np.float32).tofile(os.path.join(db_dir, fname))
            db_infos.setdefault(str(name), []).append(dict(
                name=str(name),
                path=f"a9_nusc_coop_gt_database/{fname}",
                gt_idx=gi,
                box3d_lidar=bottom[gi],
                num_points_in_gt=int(inside[:, gi].sum()),
                difficulty=0,
                load_dim=5,
            ))
    out = os.path.join(save_dir, "a9_nusc_coop_dbinfos_train.pkl")
    with open(out, "wb") as f:
        pickle.dump(db_infos, f)
    print(f"gt database: {sum(len(v) for v in db_infos.values())} objects")


def create_gt_database_images(save_dir: str,
                              info_path: Optional[str] = None) -> None:
    """Augment the GT database with per-camera image patches for sample_2d
    pasting (gt_database_cmt-style, create_gt_database_cmt.py capability):
    project each object's 3D box into every camera, crop the patch, store as
    .npy next to the point crops, record under `cam_patches`. Images are
    read raw: a `.npy` array as stored, any other file decoded by Pillow."""
    info_path = info_path or os.path.join(
        save_dir, "a9_nusc_coop_infos_train.pkl")
    db_path = os.path.join(save_dir, "a9_nusc_coop_dbinfos_train.pkl")
    with open(info_path, "rb") as f:
        infos = {i["timestamp"]: i for i in pickle.load(f)["infos"]}
    with open(db_path, "rb") as f:
        db_infos = pickle.load(f)
    patch_dir = os.path.join(save_dir, "a9_nusc_coop_gt_database_patches")
    os.makedirs(patch_dir, exist_ok=True)

    # cache decoded images per (timestamp, cam)
    def corners3d(box):
        c = box_np.corners_bev(box[None])[0]  # (4, 2)
        z0, z1 = box[2], box[2] + box[5]
        out = []
        for z in (z0, z1):
            for k in range(4):
                out.append([c[k, 0], c[k, 1], z, 1.0])
        return np.asarray(out, np.float32)

    for cls, entries in db_infos.items():
        for e in entries:
            ts = str(e["path"]).split("/")[-1].split("_" + cls)[0]
            info = infos.get(type(list(infos)[0])(ts)) if infos else None
            if info is None:
                continue
            box = np.asarray(e["box3d_lidar"], np.float32)
            pts8 = corners3d(box)
            e["cam_patches"] = {}
            for prefix, cams in (("vehicle_", info["vehicle_cams"]),
                                 ("infrastructure_",
                                  info["infrastructure_cams"])):
                for vi, (_, cam) in enumerate(cams.items()):
                    l2i = np.vstack([np.asarray(cam["lidar2image"],
                                                np.float64)[:3],
                                     [0, 0, 0, 1]])
                    proj = pts8 @ l2i.T
                    if (proj[:, 2] <= 0.1).any():
                        continue
                    uv = proj[:, :2] / proj[:, 2:3]
                    x1, y1 = np.floor(uv.min(0)).astype(int)
                    x2, y2 = np.ceil(uv.max(0)).astype(int)
                    path = cam["data_path"]
                    try:
                        img = (np.load(path) if str(path).endswith(".npy")
                               else np.asarray(open_image(path)))
                    except (OSError, ValueError):
                        # a missing or corrupt file gives no patch; no
                        # Pillow (ImportError) is an error
                        continue
                    h, w = img.shape[:2]
                    x1, y1 = max(x1, 0), max(y1, 0)
                    x2, y2 = min(x2, w), min(y2, h)
                    if x2 - x1 < 4 or y2 - y1 < 4:
                        continue
                    patch = img[y1:y2, x1:x2].astype(np.float32)
                    fname = f"{ts}_{cls}_{e['gt_idx']}_{prefix}cam{vi}.npy"
                    np.save(os.path.join(patch_dir, fname), patch)
                    e["cam_patches"][f"{prefix}cam{vi}"] = dict(
                        path=os.path.join(patch_dir, fname),
                        bbox=(int(x1), int(y1), int(x2), int(y2)))
    with open(db_path, "wb") as f:
        pickle.dump(db_infos, f)
    print("gt database image patches written")
