"""GT-database sampler (UnifiedDataBaseSampler rebuild; counterpart of
cmtcoop_tpu/data/pipelines/dbsampler.py, bit-equal to it).

Reference datasets/pipelines/dbsampler.py:14-268: per-class quotas minus the
classes already present, random draws from a pre-built GT database
(dbinfos pkl + per-object .bin point crops), BEV rotated-rectangle collision
rejection against existing + already-accepted boxes, then paste the sampled
object points into the scene cloud(s).

`sample_2d` (image patch pasting with mixup, UnifiedObjectSampleCoop
transforms_3d_coop.py:491-726) is supported by `paste_image_patches`.
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from cmtcoop_tpu_torch.data import native
from cmtcoop_tpu_torch.data.pipelines.transforms import load_points_bin


class DataBaseSampler:
    def __init__(
        self,
        info_path: str,
        data_root: str,
        rate: float = 1.0,
        sample_groups: Optional[Dict[str, int]] = None,
        classes: Sequence[str] = (),
        filter_by_min_points: Optional[Dict[str, int]] = None,
        filter_by_difficulty: Sequence[int] = (-1,),
    ):
        self.data_root = data_root
        self.rate = rate
        self.classes = list(classes)
        self.sample_groups = dict(sample_groups or {})
        with open(info_path, "rb") as f:
            db_infos = pickle.load(f)
        if filter_by_difficulty:
            db_infos = {
                k: [x for x in v
                    if x.get("difficulty", 0) not in filter_by_difficulty]
                for k, v in db_infos.items()}
        if filter_by_min_points:
            db_infos = {
                k: [x for x in v
                    if x.get("num_points_in_gt", 1 << 30) >=
                    filter_by_min_points.get(k, 0)]
                for k, v in db_infos.items()}
        self.db_infos = db_infos

    def sample_all(self, gt_boxes: np.ndarray, gt_names: List[str],
                   rng: np.random.Generator) -> Dict:
        """Returns dict(gt_boxes (S, 7+), gt_names, points_list, infos)."""
        sampled_boxes: List[np.ndarray] = []
        sampled_names: List[str] = []
        sampled_infos: List[dict] = []
        avoid = gt_boxes[:, :7].copy() if len(gt_boxes) else np.zeros(
            (0, 7), np.float32)

        for cls, max_num in self.sample_groups.items():
            have = sum(1 for n in gt_names if n == cls)
            need = int(self.rate * max(0, max_num - have))
            pool = self.db_infos.get(cls, [])
            if need <= 0 or not pool:
                continue
            picks = rng.choice(len(pool), size=min(need, len(pool)),
                               replace=False)
            for pi in picks:
                info = pool[int(pi)]
                box = np.asarray(info["box3d_lidar"], np.float32)[:7]
                cand = box[None]
                if len(avoid):
                    if native.box_collision_test(cand, avoid).any():
                        continue
                if sampled_boxes and native.box_collision_test(
                        cand, np.stack(sampled_boxes)).any():
                    continue
                sampled_boxes.append(box)
                sampled_names.append(cls)
                sampled_infos.append(info)

        if not sampled_boxes:
            return dict(gt_boxes=np.zeros((0, 7), np.float32),
                        gt_names=[], points_list=[], infos=[])
        points_list = []
        for info, box in zip(sampled_infos, sampled_boxes):
            pts = load_points_bin(
                f"{self.data_root}/{info['path']}",
                load_dim=info.get("load_dim", 5))
            # object crops are stored recentered at the box origin
            # (create_gt_database.py:366-498)
            pts[:, :3] += box[:3]
            points_list.append(pts)
        return dict(gt_boxes=np.stack(sampled_boxes),
                    gt_names=sampled_names, points_list=points_list,
                    infos=sampled_infos)


def paste_image_patches(
    sample: Dict,
    sampled_infos: List[dict],
    sampled_boxes: np.ndarray,
    rng: np.random.Generator,
    prefixes: Sequence[str] = ("",),
    mixup_rate: float = 0.5,
) -> Dict:
    """Paste sampled objects' image crops into every camera, far-to-near,
    blended with `mixup_rate` (UnifiedObjectSampleCoop sample_2d path,
    transforms_3d_coop.py:491-726).

    Each db info may carry `cam_patches: {cam_tag: {path, bbox}}` produced by
    the GT-database builder; objects without patches are points-only.
    """
    order = np.argsort(-np.linalg.norm(sampled_boxes[:, :2], axis=1))
    for p in prefixes:
        if p + "img_list" not in sample:
            continue
        l2i = np.asarray(sample[p + "lidar2img"], np.float32)
        for oi in order:
            info = sampled_infos[oi]
            patches = info.get("cam_patches") or {}
            box = sampled_boxes[oi]
            center = np.array(
                [box[0], box[1], box[2] + box[5] / 2, 1.0], np.float32)
            for vi, img in enumerate(sample[p + "img_list"]):
                tag = f"{p}cam{vi}"
                if tag not in patches:
                    continue
                patch = np.load(patches[tag]["path"])
                proj = l2i[vi] @ center
                if proj[2] <= 0.1:
                    continue
                u, v_ = proj[0] / proj[2], proj[1] / proj[2]
                ph, pw = patch.shape[:2]
                x1 = int(round(u - pw / 2))
                y1 = int(round(v_ - ph / 2))
                h, w = img.shape[:2]
                sx1, sy1 = max(x1, 0), max(y1, 0)
                sx2, sy2 = min(x1 + pw, w), min(y1 + ph, h)
                if sx2 <= sx1 or sy2 <= sy1:
                    continue
                crop = patch[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1]
                img[sy1:sy2, sx1:sx2] = (
                    img[sy1:sy2, sx1:sx2] * (1 - mixup_rate) +
                    crop * mixup_rate)
    return sample


def unified_object_sample(
    sample: Dict,
    sampler: DataBaseSampler,
    rng: np.random.Generator,
    class_names: Sequence[str],
    prefixes: Sequence[str] = ("",),
    remove_points_in_boxes: bool = True,
    sample_2d: bool = False,
    mixup_rate: float = 0.5,
) -> Dict:
    """Paste sampled GT objects into every agent's cloud
    (UnifiedObjectSampleCoop points path, transforms_3d_coop.py:491-726):
    drop scene points inside pasted boxes, then append object points."""
    gt_boxes = sample["gt_boxes_3d"]
    gt_names = [class_names[int(l)] for l in sample["gt_labels_3d"]]
    out = sampler.sample_all(gt_boxes[:, :7] if len(gt_boxes) else gt_boxes,
                             gt_names, rng)
    if not len(out["gt_names"]):
        return sample

    new_boxes = np.zeros((len(out["gt_boxes"]), gt_boxes.shape[1] if
                          len(gt_boxes) else 9), np.float32)
    new_boxes[:, :7] = out["gt_boxes"]
    sample["gt_boxes_3d"] = (
        np.concatenate([gt_boxes, new_boxes]) if len(gt_boxes)
        else new_boxes)
    new_labels = np.asarray(
        [class_names.index(n) for n in out["gt_names"]], np.int64)
    sample["gt_labels_3d"] = np.concatenate(
        [sample["gt_labels_3d"], new_labels])
    if "gt_names" in sample:
        # keep the raw-name list aligned with boxes/labels — the
        # downstream name filter boolean-indexes boxes by it
        sample["gt_names"] = list(sample["gt_names"]) + list(
            out["gt_names"])

    obj_points = np.concatenate(out["points_list"])
    if obj_points.shape[1] < 5:
        obj_points = np.pad(obj_points,
                            ((0, 0), (0, 5 - obj_points.shape[1])))
    for p in prefixes:
        pts = sample[p + "points"]
        if remove_points_in_boxes and len(pts):
            pts = native.remove_points_in_boxes(pts, out["gt_boxes"])
        sample[p + "points"] = np.concatenate(
            [obj_points[:, :pts.shape[1]], pts])
    if sample_2d:
        sample = paste_image_patches(
            sample, out["infos"], out["gt_boxes"], rng, prefixes,
            mixup_rate)
    return sample
