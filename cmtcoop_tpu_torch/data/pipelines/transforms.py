"""Augmentation/preprocessing pipeline (host-side numpy; counterpart of
cmtcoop_tpu/data/pipelines/transforms.py, bit-equal to it except the image
resize).

Images: `load_image` reads `.npy` with `np.load` and decodes any other file
with Pillow, imported at the call; without Pillow it raises. The bilinear
resize is PyTorch's antialiased uint8 `interpolate` on the host, on any
machine, where the JAX package calls Pillow's `BILINEAR`: it meets Pillow
within one uint8 level (tests/test_torch_data_pipelines.py states the
tolerance).

Rebuild of reference datasets/pipelines/{transform_3d.py, transforms_3d_coop
.py, loading*.py, formating_coop.py} with one unified implementation: every
transform takes `prefixes` — ("",) for single-agent samples or
("vehicle_", "infrastructure_") for cooperative ones — instead of the
reference's duplicated *Coop classes.

Sample dict layout (all numpy):
  {p}points      (N, 5)
  {p}img_list    list[np.ndarray HxWx3 float32]   (variable size until pad)
  {p}lidar2cam   (V, 4, 4)   {p}cam_intrinsic (V, 4, 4)
  {p}lidar2img   (V, 4, 4)
  gt_boxes_3d    (G, 9) bottom-centered   gt_labels_3d (G,)
  vehicle2infrastructure (4, 4)

Every random transform takes an np.random.Generator — no global RNG state.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

import torch
import torch.nn.functional as F

from cmtcoop_tpu_torch.data.pipelines import box_np

SINGLE = ("",)
COOP = ("vehicle_", "infrastructure_")


# ---------------------------------------------------------------- loading

def load_points_bin(path: str, load_dim: int = 5,
                    use_dim: Sequence[int] = (0, 1, 2, 3, 4)) -> np.ndarray:
    """.bin/.npy point loader (loading_coop.py:305-445)."""
    if str(path).endswith(".npy"):
        pts = np.load(path)
    else:
        pts = np.fromfile(path, dtype=np.float32)
    pts = pts.reshape(-1, load_dim)
    return pts[:, list(use_dim)].astype(np.float32)


def load_multi_sweeps(points: np.ndarray, sweeps: List[dict],
                      rng: np.random.Generator, sweeps_num: int = 10,
                      pad_empty: bool = True,
                      test_mode: bool = False) -> np.ndarray:
    """Aggregate past sweeps into the key cloud with a relative-timestamp
    channel (LoadPointsFromMultiSweeps, loading_coop.py:105-302).

    The key frame's timestamp channel (dim 4) is zeroed; each sweep's points
    are transformed by sensor2lidar and stamped with the time delta.
    """
    points = points.copy()
    points[:, 4] = 0.0
    out = [points]
    if len(sweeps) == 0:
        return points
    if len(sweeps) <= sweeps_num:
        choices = np.arange(len(sweeps))
    elif test_mode:
        choices = np.arange(sweeps_num)
    else:
        choices = rng.choice(len(sweeps), sweeps_num, replace=False)
    ts = 0.0
    for idx in choices:
        sweep = sweeps[idx]
        pts = load_points_bin(sweep["data_path"])
        pts[:, :3] = pts[:, :3] @ np.asarray(
            sweep["sensor2lidar_rotation"], np.float32).T
        pts[:, :3] += np.asarray(sweep["sensor2lidar_translation"],
                                 np.float32)
        pts[:, 4] = ts - sweep.get("timestamp", 0.0) * 1e-6
        out.append(pts)
    return np.concatenate(out, axis=0)


def open_image(path: str):
    """`PIL.Image.open(path)`, Pillow imported here; an ImportError that
    names the file when Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {path} needs Pillow, which is not installed; an "
            "archive whose images are stored as .npy arrays needs no "
            "decoder") from e
    return Image.open(path)


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 RGB: a `.npy` array as stored, any other file
    decoded by Pillow (`open_image`) and converted to RGB."""
    if str(path).endswith(".npy"):
        return np.load(path).astype(np.float32)
    return np.asarray(open_image(path).convert("RGB"), np.float32)


# ------------------------------------------------------------ coordinates

def vehicle_points_to_infra(sample: Dict) -> Dict:
    """Rotate/translate the vehicle cloud into infrastructure coordinates by
    v2i (VehiclePointsToInfraCoords, transforms_3d_coop.py:194-211)."""
    v2i = np.asarray(sample["vehicle2infrastructure"], np.float32)
    sample["vehicle_points"] = box_np.transform_points(
        sample["vehicle_points"], v2i)
    return sample


def transform_lidar2img_to_infra(sample: Dict) -> Dict:
    """Right-multiply the vehicle cameras' lidar2img/lidar2cam by v2i^-1 so
    they consume infra-frame points (TransformLidar2ImgToInfraCoords,
    transforms_3d_coop.py:213-222)."""
    v2i_inv = np.linalg.inv(
        np.asarray(sample["vehicle2infrastructure"], np.float64)).astype(
            np.float32)
    sample["vehicle_lidar2img"] = np.asarray(
        [m @ v2i_inv for m in sample["vehicle_lidar2img"]], np.float32)
    if "vehicle_lidar2cam" in sample:
        sample["vehicle_lidar2cam"] = np.asarray(
            [m @ v2i_inv for m in sample["vehicle_lidar2cam"]], np.float32)
    return sample


# -------------------------------------------------------------- filtering

def points_range_filter(sample: Dict, pc_range,
                        prefixes: Sequence[str] = SINGLE) -> Dict:
    lo = np.asarray(pc_range[:3], np.float32)
    hi = np.asarray(pc_range[3:], np.float32)
    for p in prefixes:
        pts = sample[p + "points"]
        keep = np.all(pts[:, :3] >= lo, -1) & np.all(pts[:, :3] < hi, -1)
        sample[p + "points"] = pts[keep]
    return sample


def object_range_filter(sample: Dict, pc_range) -> Dict:
    """BEV-range filter + yaw limit (mmdet3d ObjectRangeFilter)."""
    boxes, labels = sample["gt_boxes_3d"], sample["gt_labels_3d"]
    bev_range = np.asarray(
        [pc_range[0], pc_range[1], pc_range[3], pc_range[4]], np.float32)
    keep = ((boxes[:, 0] > bev_range[0]) & (boxes[:, 1] > bev_range[1]) &
            (boxes[:, 0] < bev_range[2]) & (boxes[:, 1] < bev_range[3]))
    boxes = boxes[keep]
    boxes[:, 6] = limit_period(boxes[:, 6], 0.5, 2 * np.pi)
    sample["gt_boxes_3d"] = boxes
    sample["gt_labels_3d"] = labels[keep]
    if "gt_names" in sample:  # keep raw names aligned for the name filter
        sample["gt_names"] = [
            n for n, k in zip(sample["gt_names"], keep) if k]
    return sample


def limit_period(val, offset=0.5, period=2 * np.pi):
    return val - np.floor(val / period + offset) * period


def object_name_filter(sample: Dict, class_names: Sequence[str],
                       gt_names_key: str = "gt_names") -> Dict:
    """Keep only boxes whose label is a configured class. Labels arriving
    here are already ints into `class_names`, so this is a passthrough
    unless raw names are attached."""
    if gt_names_key in sample:
        keep = np.asarray(
            [n in class_names for n in sample[gt_names_key]], bool)
        sample["gt_boxes_3d"] = sample["gt_boxes_3d"][keep]
        sample["gt_labels_3d"] = sample["gt_labels_3d"][keep]
        sample[gt_names_key] = [
            n for n, k in zip(sample[gt_names_key], keep) if k]
    return sample


def point_shuffle(sample: Dict, rng: np.random.Generator,
                  prefixes: Sequence[str] = SINGLE) -> Dict:
    for p in prefixes:
        pts = sample[p + "points"]
        sample[p + "points"] = pts[rng.permutation(len(pts))]
    return sample


# ----------------------------------------------------- global rot/scale/t

def global_rot_scale_trans(
    sample: Dict,
    rng: np.random.Generator,
    rot_range=(-0.3925, 0.3925),
    scale_ratio_range=(0.95, 1.05),
    translation_std=(0.0, 0.0, 0.0),
    prefixes: Sequence[str] = SINGLE,
) -> Dict:
    """Joint R/S/T of all agents' clouds + boxes, with lidar2img/lidar2cam
    updated by the inverse transform (GlobalRotScaleTransAllCoop,
    transforms_3d_coop.py:968-1231; single-agent GlobalRotScaleTransAll,
    transform_3d.py:507-724). Identical noise for every agent — the
    reference asserts this (transforms_3d_coop.py:1110-1116)."""
    angle = float(rng.uniform(rot_range[0], rot_range[1]))
    scale = float(rng.uniform(scale_ratio_range[0], scale_ratio_range[1]))
    trans = rng.normal(scale=np.asarray(translation_std, np.float64),
                       size=3).astype(np.float32)

    for p in prefixes:
        pts = sample[p + "points"]
        pts = box_np.rotate_points(pts, angle)
        pts = box_np.scale_points(pts, scale)
        pts = box_np.translate_points(pts, trans)
        sample[p + "points"] = pts

    if "gt_boxes_3d" in sample and len(sample["gt_boxes_3d"]):
        b = sample["gt_boxes_3d"]
        b = box_np.rotate_boxes(b, angle)
        b = box_np.scale_boxes(b, scale)
        b = box_np.translate_boxes(b, trans)
        sample["gt_boxes_3d"] = b

    # fold the inverse world transform into every camera matrix
    rot4 = np.eye(4, dtype=np.float64)
    rot4[:3, :3] = box_np.rot_mat_z(angle)
    scale4 = np.diag([scale, scale, scale, 1.0])
    trans4 = np.eye(4, dtype=np.float64)
    trans4[:3, 3] = trans
    full_inv = np.linalg.inv(trans4 @ scale4 @ rot4).astype(np.float32)
    for p in prefixes:
        for key in (p + "lidar2img", p + "lidar2cam"):
            if key in sample:
                sample[key] = np.asarray(
                    [m @ full_inv for m in sample[key]], np.float32)

    sample["pcd_rotation"] = angle
    sample["pcd_scale_factor"] = scale
    sample["pcd_trans"] = trans
    return sample


# ------------------------------------------------------------- modal mask

def modal_mask(sample: Dict, rng: np.random.Generator,
               prefixes: Sequence[str] = SINGLE) -> Dict:
    """Training-time modality dropout (ModalMask3D, transform_3d.py:832-858):
    seed > 0.75 -> zero images, 0.5 < seed <= 0.75 -> zero points."""
    seed = rng.uniform()
    for p in prefixes:
        if seed > 0.75 and p + "img_list" in sample:
            sample[p + "img_list"] = [
                np.zeros_like(im) for im in sample[p + "img_list"]]
        elif 0.5 < seed <= 0.75 and p + "points" in sample:
            sample[p + "points"] = sample[p + "points"][:0]
    return sample


# -------------------------------------------------------------- image ida

def _sample_ida(rng: np.random.Generator, conf: Dict, training: bool):
    """(resize, resize_dims, crop, flip, rotate) — transforms_3d_coop.py:
    899-922."""
    h, w = conf["H"], conf["W"]
    fh, fw = conf["final_dim"]
    if training:
        resize = float(rng.uniform(*conf["resize_lim"]))
        new_w, new_h = int(w * resize), int(h * resize)
        crop_h = int(
            (1 - rng.uniform(*conf.get("bot_pct_lim", (0.0, 0.0)))) * new_h
        ) - fh
        crop_w = int(rng.uniform(0, max(0, new_w - fw)))
        crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
        flip = bool(conf.get("rand_flip") and rng.integers(0, 2))
        rotate = float(rng.uniform(*conf.get("rot_lim", (0.0, 0.0))))
    else:
        resize = max(fh / h, fw / w)
        new_w, new_h = int(w * resize), int(h * resize)
        crop_h = int(
            (1 - np.mean(conf.get("bot_pct_lim", (0.0, 0.0)))) * new_h) - fh
        crop_w = int(max(0, new_w - fw) / 2)
        crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
        flip, rotate = False, 0.0
    return resize, (new_w, new_h), crop, flip, rotate


def _resize_bilinear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """Resize an (H, W, 3) image to `size_wh` = (W', H'): the clipped uint8
    image, channels-last, through PyTorch's antialiased bilinear
    interpolation (Pillow's `BILINEAR` within one level)."""
    u8 = torch.from_numpy(np.clip(img, 0, 255).astype(np.uint8))
    x = u8.permute(2, 0, 1).unsqueeze(0)  # (1, 3, H, W), channels-last
    out = F.interpolate(x, size=(size_wh[1], size_wh[0]), mode="bilinear",
                        antialias=True, align_corners=False)
    return out[0].permute(1, 2, 0).numpy().astype(np.float32)


def _ida_one(img, resize, resize_dims, crop, flip):
    """Resize+crop(+flip) with zero padding outside the source
    (transforms_3d_coop.py:861-897); rotation is not applied (rot_lim is
    (0, 0) in every config)."""
    resized = _resize_bilinear(img, resize_dims)
    out = np.zeros((crop[3] - crop[1], crop[2] - crop[0], 3), np.float32)
    hsize, wsize = crop[3] - crop[1], crop[2] - crop[0]
    dh, dw, sh, sw = crop[1], crop[0], 0, 0
    if dh < 0:
        sh = -dh; hsize += dh; dh = 0
    if dh + hsize > resized.shape[0]:
        hsize = resized.shape[0] - dh
    if dw < 0:
        sw = -dw; wsize += dw; dw = 0
    if dw + wsize > resized.shape[1]:
        wsize = resized.shape[1] - dw
    if hsize > 0 and wsize > 0:
        out[sh:sh + hsize, sw:sw + wsize] = resized[dh:dh + hsize,
                                                    dw:dw + wsize]
    if flip:
        out = out[:, ::-1]
    post_rot = np.eye(2, dtype=np.float32) * resize
    post_tran = -np.asarray(crop[:2], np.float32)
    if flip:
        a = np.array([[-1, 0], [0, 1]], np.float32)
        b = np.array([crop[2] - crop[0], 0], np.float32)
        post_rot = a @ post_rot
        post_tran = a @ post_tran + b
    return out, post_rot, post_tran


def resize_crop_flip_image(sample: Dict, rng: np.random.Generator,
                           conf: Dict, training: bool,
                           prefixes: Sequence[str] = SINGLE) -> Dict:
    """BEVDet-style image-domain aug; post_rot/post_tran folded into the
    intrinsics and lidar2img recomputed as K' @ lidar2cam
    (ResizeCropFlipImageCoop, transforms_3d_coop.py:729-846). One sample per
    agent (pic_wise=False)."""
    for p in prefixes:
        if p + "img_list" not in sample:
            continue
        resize, resize_dims, crop, flip, _ = _sample_ida(rng, conf, training)
        new_imgs = []
        intr = np.asarray(sample[p + "cam_intrinsic"], np.float32).copy()
        for i, img in enumerate(sample[p + "img_list"]):
            out, post_rot, post_tran = _ida_one(
                img, resize, resize_dims, crop, flip)
            new_imgs.append(out)
            intr[i][:2, :3] = post_rot @ intr[i][:2, :3]
            intr[i][:2, 2] = post_tran + intr[i][:2, 2]
        sample[p + "img_list"] = new_imgs
        sample[p + "cam_intrinsic"] = intr
        l2c = np.asarray(sample[p + "lidar2cam"], np.float32)
        sample[p + "lidar2img"] = np.asarray(
            [intr[i] @ l2c[i] for i in range(len(l2c))], np.float32)
    return sample


def normalize_images(sample: Dict, mean, std, to_rgb: bool = False,
                     prefixes: Sequence[str] = SINGLE) -> Dict:
    """NormalizeMultiviewImage(Coop). Note the reference normalizes with
    BGR-ordered mean/std and to_rgb=False (config img_norm_cfg)."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    for p in prefixes:
        if p + "img_list" in sample:
            imgs = sample[p + "img_list"]
            if not to_rgb:
                imgs = [im[..., ::-1] for im in imgs]  # loader gives RGB
            sample[p + "img_list"] = [(im - mean) / std for im in imgs]
    return sample


def pad_images(sample: Dict, size_divisor: int = 32,
               prefixes: Sequence[str] = SINGLE) -> Dict:
    """PadMultiViewImage(Coop): zero-pad each image to /32 and stack to
    (V, H, W, 3)."""
    for p in prefixes:
        if p + "img_list" not in sample:
            continue
        padded = []
        for im in sample[p + "img_list"]:
            h, w = im.shape[:2]
            ph = -(-h // size_divisor) * size_divisor
            pw = -(-w // size_divisor) * size_divisor
            out = np.zeros((ph, pw, 3), np.float32)
            out[:h, :w] = im
            padded.append(out)
        sample[p + "imgs"] = np.stack(padded)
        sample[p + "pad_shape"] = padded[0].shape
        del sample[p + "img_list"]
    return sample


def random_flip_3d(sample: Dict, rng: np.random.Generator,
                   flip_ratio_horizontal: float = 0.5,
                   flip_ratio_vertical: float = 0.5,
                   prefixes: Sequence[str] = SINGLE) -> Dict:
    """BEV flips of clouds + boxes with camera-matrix updates
    (CustomRandomFlip3D, transform_3d.py:725-830; commented out of the coop
    config but part of the single-agent capability surface).

    Horizontal = flip y, vertical = flip x (mmdet3d convention)."""
    flip_h = rng.uniform() < flip_ratio_horizontal
    flip_v = rng.uniform() < flip_ratio_vertical

    def flip_mat():
        m = np.eye(4, dtype=np.float32)
        if flip_h:
            m[1, 1] = -1
        if flip_v:
            m[0, 0] = -1
        return m

    if not (flip_h or flip_v):
        sample["pcd_horizontal_flip"] = False
        sample["pcd_vertical_flip"] = False
        return sample
    for p in prefixes:
        if p + "points" in sample:
            pts = sample[p + "points"].copy()
            if flip_h:
                pts[:, 1] *= -1
            if flip_v:
                pts[:, 0] *= -1
            sample[p + "points"] = pts
        for key in (p + "lidar2img", p + "lidar2cam"):
            if key in sample:
                inv = np.linalg.inv(flip_mat())
                sample[key] = np.asarray(
                    [m @ inv for m in sample[key]], np.float32)
    if "gt_boxes_3d" in sample and len(sample["gt_boxes_3d"]):
        b = sample["gt_boxes_3d"].copy()
        if flip_h:
            b[:, 1] *= -1
            b[:, 6] = -b[:, 6]
            if b.shape[1] > 7:
                b[:, 8] *= -1
        if flip_v:
            b[:, 0] *= -1
            b[:, 6] = np.pi - b[:, 6]
            if b.shape[1] > 7:
                b[:, 7] *= -1
        sample["gt_boxes_3d"] = b
    sample["pcd_horizontal_flip"] = bool(flip_h)
    sample["pcd_vertical_flip"] = bool(flip_v)
    return sample


def global_rot_scale_trans_image(
    sample: Dict, rng: np.random.Generator,
    rot_range=(-0.3925, 0.3925), scale_ratio_range=(0.95, 1.05),
    prefixes: Sequence[str] = SINGLE,
) -> Dict:
    """Camera-only variant: apply the world R/S to GT boxes and fold the
    inverse into lidar2img, leaving (absent) clouds untouched
    (GlobalRotScaleTransImage, transform_3d.py:861-968)."""
    angle = float(rng.uniform(*rot_range))
    scale = float(rng.uniform(*scale_ratio_range))
    if "gt_boxes_3d" in sample and len(sample["gt_boxes_3d"]):
        b = box_np.rotate_boxes(sample["gt_boxes_3d"], angle)
        sample["gt_boxes_3d"] = box_np.scale_boxes(b, scale)
    rot4 = np.eye(4, dtype=np.float64)
    rot4[:3, :3] = box_np.rot_mat_z(angle)
    scale4 = np.diag([scale, scale, scale, 1.0])
    inv = np.linalg.inv(scale4 @ rot4).astype(np.float32)
    for p in prefixes:
        for key in (p + "lidar2img", p + "lidar2cam"):
            if key in sample:
                sample[key] = np.asarray(
                    [m @ inv for m in sample[key]], np.float32)
    sample["pcd_rotation"] = angle
    sample["pcd_scale_factor"] = scale
    return sample
