"""Dataset families: TUMTraf cooperative / intersection (counterpart of
cmtcoop_tpu/data/datasets.py; the nuScenes family is not ported yet).

Rebuild of reference datasets/{a9coop_dataset.py, a9_nusc_dataset.py}
reading the SAME pkl info format the reference's converters emit (so info
files are interchangeable between frameworks), plus the CBGS class-balanced
resampler (mmdet3d CBGSDataset, coop config:185-196).

A dataset yields fixed-shape model samples (see data/formats.py); evaluation
runs the in-repo nuScenes-protocol scorer.
"""
from __future__ import annotations

import pickle
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from cmtcoop_tpu_torch.data.eval.nusc_protocol import evaluate_detection
from cmtcoop_tpu_torch.data.pipelines import transforms as T


def _boxes_from_info(info: Dict, class_names: Sequence[str]):
    """pkl info -> bottom-centered box9 + int labels, filtered to
    num_lidar_pts > 0 (get_ann_info, a9coop_dataset.py:242-291)."""
    mask = np.asarray(info["num_lidar_pts"]) > 0
    boxes = np.asarray(info["gt_boxes"], np.float32)[mask]
    names = np.asarray(info["gt_names"])[mask]
    vel = np.asarray(info["gt_velocity"], np.float32)[mask]
    vel = np.nan_to_num(vel)
    # converter stores z at the box center (origin 0.5,0.5,0.5) -> bottom
    if len(boxes):
        boxes = np.concatenate([boxes, vel], axis=-1)
        boxes[:, 2] -= boxes[:, 5] / 2.0
    else:
        boxes = np.zeros((0, 9), np.float32)
    labels = np.asarray(
        [class_names.index(n) if n in class_names else -1 for n in names],
        np.int64)
    keep = labels >= 0
    return boxes[keep], labels[keep], [str(n) for n in names[keep]]


class A9NuscCoopDataset:
    """TUMTraf V2X cooperative dataset (a9coop_dataset.py:21-1132)."""

    PREFIXES = ("vehicle_", "infrastructure_")

    def __init__(
        self,
        ann_file: str,
        class_names: Sequence[str],
        pipeline: Optional[Callable] = None,
        test_mode: bool = False,
        use_camera: bool = True,
        use_lidar: bool = True,
        load_interval: int = 1,
    ):
        self.class_names = list(class_names)
        self.pipeline = pipeline
        self.test_mode = test_mode
        self.use_camera = use_camera
        self.use_lidar = use_lidar
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data
        infos = sorted(infos, key=lambda e: e["timestamp"])
        self.infos = infos[::load_interval]

    def __len__(self):
        return len(self.infos)

    def get_raw_sample(self, index: int, rng: np.random.Generator) -> Dict:
        """Load one sample into the pipeline dict layout."""
        info = self.infos[index]
        sample: Dict[str, Any] = dict(
            timestamp=info["timestamp"],
            vehicle2infrastructure=np.asarray(
                info["vehicle2infrastructure"], np.float32).reshape(4, 4),
        )
        if self.use_lidar:
            for p in self.PREFIXES:
                pts = T.load_points_bin(info[p + "lidar_path"])
                pts = T.load_multi_sweeps(
                    pts, info.get(p + "sweeps", []), rng,
                    test_mode=self.test_mode)
                sample[p + "points"] = pts
        if self.use_camera:
            for p, cams_key in (("vehicle_", "vehicle_cams"),
                                ("infrastructure_", "infrastructure_cams")):
                imgs, l2i, l2c, intr = [], [], [], []
                for _, cam in info[cams_key].items():
                    imgs.append(T.load_image(cam["data_path"]))
                    li = np.vstack([np.asarray(cam["lidar2image"],
                                               np.float64)[:3],
                                    [0, 0, 0, 1.0]])
                    c2l = np.vstack([np.asarray(cam["sensor2lidar"],
                                                np.float64)[:3],
                                     [0, 0, 0, 1.0]])
                    k4 = np.eye(4)
                    k4[:3, :3] = np.asarray(
                        cam["camera_intrinsics"], np.float64)[:3, :3]
                    l2i.append(li.astype(np.float32))
                    l2c.append(np.linalg.inv(c2l).astype(np.float32))
                    intr.append(k4.astype(np.float32))
                sample[p + "img_list"] = imgs
                sample[p + "lidar2img"] = np.stack(l2i)
                sample[p + "lidar2cam"] = np.stack(l2c)
                sample[p + "cam_intrinsic"] = np.stack(intr)
        if not self.test_mode:
            boxes, labels, names = _boxes_from_info(info, self.class_names)
            sample["gt_boxes_3d"] = boxes
            sample["gt_labels_3d"] = labels
            sample["gt_names"] = names
        return sample

    def set_epoch(self, epoch: int) -> None:
        """Epoch-dependent augmentation seeding (DistributedSampler
        set_epoch equivalent); also keyed into __getitem__'s rng so resumed
        runs reproduce the exact data stream."""
        self._epoch = int(epoch)

    def __getitem__(self, index):
        # stable across processes (python hash() is salted -> would break
        # deterministic resume); SplitMix64-style integer mix
        seed = (index * 0x9E3779B97F4A7C15
                + getattr(self, "_epoch", 0) * 0xBF58476D1CE4E5B9
                + (1 if self.test_mode else 0)) % (1 << 63)
        rng = np.random.default_rng(seed)
        sample = self.get_raw_sample(index, rng)
        if self.pipeline is not None:
            sample = self.pipeline(sample, rng)
        return sample

    # --------------------------- evaluation ---------------------------

    def gt_eval_boxes(self) -> Dict:
        out = {}
        for info in self.infos:
            ts = info["timestamp"]
            mask = np.asarray(info["num_lidar_pts"]) > 0
            boxes = np.asarray(info["gt_boxes"], np.float32)[mask]
            names = np.asarray(info["gt_names"])[mask]
            npts = np.asarray(info["num_lidar_pts"])[mask]
            entries = []
            for b, n, np_ in zip(boxes, names, npts):
                entries.append(dict(
                    translation=(float(b[0]), float(b[1]), float(b[2])),
                    size=(float(b[3]), float(b[4]), float(b[5])),
                    yaw=float(b[6]), velocity=(0.0, 0.0),
                    detection_name=str(n),
                    ego_dist=float(np.hypot(b[0], b[1])),
                    num_pts=int(np_), timestamp=ts))
            out[ts] = entries
        return out

    def evaluate(self, pred_boxes_by_ts: Dict,
                 output_dir: str = None) -> Dict:
        """pred_boxes_by_ts: {timestamp: [scorer box dicts]} (see
        formats.decoded_to_eval_boxes). `output_dir` writes the reference's
        metrics_summary.json / metrics_details.json artifacts."""
        gt = self.gt_eval_boxes()
        for ts in gt:
            pred_boxes_by_ts.setdefault(ts, [])
        return evaluate_detection(gt, pred_boxes_by_ts, self.class_names,
                                  output_dir=output_dir)


class A9NuscDataset(A9NuscCoopDataset):
    """Single-view TUMTraf intersection dataset (a9_nusc_dataset.py:22-1120):
    same protocol, one agent, south1/south2 cameras, no prefixes."""

    PREFIXES = ("",)

    def get_raw_sample(self, index: int, rng: np.random.Generator) -> Dict:
        info = self.infos[index]
        sample: Dict[str, Any] = dict(timestamp=info["timestamp"])
        if self.use_lidar:
            pts = T.load_points_bin(info["lidar_path"])
            pts = T.load_multi_sweeps(
                pts, info.get("sweeps", []), rng, test_mode=self.test_mode)
            sample["points"] = pts
        if self.use_camera:
            imgs, l2i, l2c, intr = [], [], [], []
            for _, cam in info["cams"].items():
                imgs.append(T.load_image(cam["data_path"]))
                li = np.vstack([np.asarray(cam["lidar2image"],
                                           np.float64)[:3], [0, 0, 0, 1.0]])
                c2l = np.vstack([np.asarray(cam["sensor2lidar"],
                                            np.float64)[:3], [0, 0, 0, 1.0]])
                k4 = np.eye(4)
                k4[:3, :3] = np.asarray(
                    cam["camera_intrinsics"], np.float64)[:3, :3]
                l2i.append(li.astype(np.float32))
                l2c.append(np.linalg.inv(c2l).astype(np.float32))
                intr.append(k4.astype(np.float32))
            sample["img_list"] = imgs
            sample["lidar2img"] = np.stack(l2i)
            sample["lidar2cam"] = np.stack(l2c)
            sample["cam_intrinsic"] = np.stack(intr)
        if not self.test_mode:
            boxes, labels, names = _boxes_from_info(info, self.class_names)
            sample["gt_boxes_3d"] = boxes
            sample["gt_labels_3d"] = labels
            sample["gt_names"] = names
        return sample


def cbgs_indices(dataset, rng: np.random.Generator) -> np.ndarray:
    """Class-balanced resampling (mmdet3d CBGSDataset semantics): duplicate
    sample indices so every class's share approaches 1/num_classes."""
    class_names = dataset.class_names
    cls_to_samples: Dict[int, List[int]] = {i: [] for i in
                                            range(len(class_names))}
    for idx, info in enumerate(dataset.infos):
        mask = np.asarray(info["num_lidar_pts"]) > 0
        names = set(np.asarray(info["gt_names"])[mask].tolist())
        for n in names:
            if n in class_names:
                cls_to_samples[class_names.index(n)].append(idx)
    total = sum(len(v) for v in cls_to_samples.values())
    if total == 0:
        return np.arange(len(dataset))
    frac = 1.0 / len(class_names)
    out: List[int] = []
    for _, idxs in cls_to_samples.items():
        if not idxs:
            continue
        ratio = frac / (len(idxs) / total)
        n_draw = int(len(idxs) * ratio)
        out.extend(rng.choice(idxs, n_draw, replace=True).tolist())
    return np.asarray(out)
