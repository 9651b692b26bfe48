"""A9/TUMTraf nuScenes-protocol detection scorer (pure numpy), a copy of
cmtcoop_tpu/data/eval/nusc_protocol.py: the port imports nothing of the JAX
package, so it keeps its own.

Exact port of the reference's in-repo re-implementation of the nuScenes
detection protocol without tokens (datasets/a9coop_dataset.py:560-1016 and the
identical copy in a9_nusc_dataset.py): greedy center-distance matching at
{0.5, 1, 2, 4} m, 101-point interpolated AP with recall/precision clipping at
0.1, TP errors (ATE/ASE/AOE/AVE) at the 2 m threshold, and
NDS = (5*mAP + sum(1 - err)) / 9. Class range filter 50 m (40 m for
pedestrians/bikes), zero-point GT filtered (a9coop_dataset.py:753-779).

Box dict fields: translation (3,), size (w, l, h), yaw, velocity (2,),
detection_name, detection_score (preds), ego_dist, num_pts.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

CLS_RANGE = {
    "CAR": 50, "TRUCK": 50, "BUS": 50, "TRAILER": 50, "VAN": 50,
    "EMERGENCY_VEHICLE": 50, "PEDESTRIAN": 40, "MOTORCYCLE": 40,
    "BICYCLE": 40,
}
DIST_THS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MEAN_AP_WEIGHT = 5
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err")
# protocol="nuscenes" additionally scores attribute errors (devkit mAAE)
TP_METRICS_NUSC = TP_METRICS + ("attr_err",)
# devkit per-class TP-metric exclusions (nuscenes-devkit
# evaluate.py::DetectionMetrics — cones have no orientation/velocity/
# attributes, barriers no velocity/attributes)
TP_EXCLUDE = {
    "traffic_cone": {"attr_err", "vel_err", "orient_err"},
    "barrier": {"attr_err", "vel_err"},
}
ERR_NAME_MAPPING = {
    "trans_err": "mATE", "scale_err": "mASE", "orient_err": "mAOE",
    "vel_err": "mAVE", "attr_err": "mAAE",
}


def center_distance(a, b) -> float:
    return float(np.linalg.norm(
        np.asarray(a["translation"][:2]) - np.asarray(b["translation"][:2])))


def velocity_l2(a, b) -> float:
    va = np.asarray(a.get("velocity", (0.0, 0.0)), float)
    vb = np.asarray(b.get("velocity", (0.0, 0.0)), float)
    if np.any(np.isnan(va)) or np.any(np.isnan(vb)):
        return np.nan
    return float(np.linalg.norm(va - vb))


def scale_iou(gt, pred) -> float:
    """Aligned 3D IoU of sizes (a9coop_dataset.py scale_iou)."""
    sa = np.maximum(np.asarray(gt["size"], float), 1e-9)
    sr = np.maximum(np.asarray(pred["size"], float), 1e-9)
    min_wlh = np.minimum(sa, sr)
    vol_a, vol_r = np.prod(sa), np.prod(sr)
    inter = np.prod(min_wlh)
    return float(inter / (vol_a + vol_r - inter))


def yaw_diff(gt, pred, period: float = 2 * np.pi) -> float:
    d = (gt["yaw"] - pred["yaw"]) % period
    if d > period / 2:
        d = period - d
    return float(abs(d))


def cummean(x: np.ndarray) -> np.ndarray:
    if np.isnan(x).sum() == len(x):
        return np.ones(len(x))
    sum_vals = np.nancumsum(x.astype(float))
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals, out=np.zeros_like(sum_vals),
                     where=count_vals != 0)


def attr_acc(gt, pred) -> float:
    """Attribute accuracy (devkit attr_acc): NaN when the GT box carries
    no attribute (the devkit excludes those pairs via cummean)."""
    a = gt.get("attribute_name", "")
    if not a:
        return np.nan
    return float(a == pred.get("attribute_name", ""))


def _no_predictions_md():
    return {
        "recall": np.linspace(0, 1, 101), "precision": np.zeros(101),
        "confidence": np.zeros(101), "trans_err": np.ones(101),
        "vel_err": np.ones(101), "scale_err": np.ones(101),
        "orient_err": np.ones(101), "attr_err": np.ones(101),
    }


def accumulate(gt_boxes: Dict, pred_boxes: Dict, class_name: str,
               dist_th: float) -> Dict[str, np.ndarray]:
    """One (class, distance threshold) accumulation
    (a9coop_dataset.py:582-751)."""
    npos = sum(1 for key in gt_boxes for box in gt_boxes[key]
               if box["detection_name"] == class_name)
    if npos == 0:
        return _no_predictions_md()

    pred_list = [box for key in pred_boxes for box in pred_boxes[key]
                 if box["detection_name"] == class_name]
    pred_confs = [box["detection_score"] for box in pred_list]
    sortind = [i for (v, i) in
               sorted((v, i) for (i, v) in enumerate(pred_confs))][::-1]

    tp, fp, conf = [], [], []
    match_data = {k: [] for k in
                  ("trans_err", "vel_err", "scale_err", "orient_err",
                   "attr_err", "conf")}
    taken = set()
    for ind in sortind:
        pred_box = pred_list[ind]
        min_dist, match_gt_idx = np.inf, None
        for gt_idx, gt_box in enumerate(gt_boxes[pred_box["timestamp"]]):
            if gt_box["detection_name"] == class_name and \
                    (pred_box["timestamp"], gt_idx) not in taken:
                d = center_distance(gt_box, pred_box)
                if d < min_dist:
                    min_dist, match_gt_idx = d, gt_idx
        if min_dist < dist_th:
            taken.add((pred_box["timestamp"], match_gt_idx))
            tp.append(1); fp.append(0)
            conf.append(pred_box["detection_score"])
            gtm = gt_boxes[pred_box["timestamp"]][match_gt_idx]
            match_data["trans_err"].append(center_distance(gtm, pred_box))
            match_data["vel_err"].append(velocity_l2(gtm, pred_box))
            match_data["scale_err"].append(1 - scale_iou(gtm, pred_box))
            period = np.pi if class_name == "barrier" else 2 * np.pi
            match_data["orient_err"].append(
                yaw_diff(gtm, pred_box, period=period))
            match_data["attr_err"].append(1.0 - attr_acc(gtm, pred_box))
            match_data["conf"].append(pred_box["detection_score"])
        else:
            tp.append(0); fp.append(1)
            conf.append(pred_box["detection_score"])

    if len(match_data["trans_err"]) == 0:
        return _no_predictions_md()

    tp = np.cumsum(tp).astype(float)
    fp = np.cumsum(fp).astype(float)
    conf = np.array(conf)
    prec = tp / (fp + tp)
    rec = tp / float(npos)
    rec_interp = np.linspace(0, 1, 101)
    prec = np.interp(rec_interp, rec, prec, right=0)
    conf = np.interp(rec_interp, rec, conf, right=0)

    out = {"recall": rec_interp, "precision": prec, "confidence": conf}
    for key in ("trans_err", "vel_err", "scale_err", "orient_err",
                "attr_err"):
        tmp = cummean(np.array(match_data[key]))
        out[key] = np.interp(
            conf[::-1], np.array(match_data["conf"])[::-1], tmp[::-1])[::-1]
    return out


def filter_eval_boxes(eval_boxes: Dict, max_dist: Dict[str, float]) -> Dict:
    """Distance + zero-point filtering (a9coop_dataset.py:753-779)."""
    for ts in eval_boxes:
        eval_boxes[ts] = [
            b for b in eval_boxes[ts]
            if b["ego_dist"] < max_dist[b["detection_name"]]]
        eval_boxes[ts] = [b for b in eval_boxes[ts]
                          if not b.get("num_pts", -1) == 0]
    return eval_boxes


def calc_ap(md, min_recall: float, min_precision: float) -> float:
    prec = np.copy(md["precision"])
    prec = prec[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md, min_recall: float, metric_name: str) -> float:
    first_ind = round(100 * min_recall) + 1
    non_zero = np.nonzero(md["confidence"])[0]
    max_recall_ind = non_zero[-1] if len(non_zero) else 0
    if max_recall_ind < first_ind:
        return 1.0
    return float(np.mean(md[metric_name][first_ind: max_recall_ind + 1]))


def evaluate_detection(gt_boxes: Dict, pred_boxes: Dict,
                       class_names: Sequence[str],
                       cls_range: Dict[str, float] = None,
                       output_dir: str = None,
                       protocol: str = "a9") -> Dict:
    """Full protocol: returns the metrics_summary dict
    (a9coop_dataset.py:830-969) plus the flat `object/...` detail keys
    (a9coop_dataset.py:1000-1016). With `output_dir`, also writes the
    reference's eval artifacts metrics_summary.json + metrics_details.json
    (a9coop_dataset.py:918-940).

    protocol="a9" (default): the reference's token-less in-repo scorer —
    4 TP metrics, NDS = (5*mAP + sum(1-err)) / 9.
    protocol="nuscenes": the official devkit's CVPR-2019 configuration —
    adds the attribute error (mAAE; boxes carry `attribute_name`), the
    devkit's per-class TP exclusions (cones: attr/vel/orient; barriers:
    attr/vel), NDS = (5*mAP + sum of 5 (1-err)) / 10. Not replicated
    from the devkit (needs the map DB): bike-rack filtering — documented
    deviation, negligible on val mAP.
    """
    tp_metrics = TP_METRICS_NUSC if protocol == "nuscenes" else TP_METRICS
    excl = TP_EXCLUDE if protocol == "nuscenes" else {}
    cls_range = dict(CLS_RANGE if cls_range is None else cls_range)
    pred_boxes = filter_eval_boxes(pred_boxes, cls_range)
    gt_boxes = filter_eval_boxes(gt_boxes, cls_range)

    mdl = {}
    for class_name in class_names:
        for dist_th in DIST_THS:
            mdl[(class_name, dist_th)] = accumulate(
                gt_boxes, pred_boxes, class_name, dist_th)

    label_aps = defaultdict(dict)
    label_tp_errors = defaultdict(dict)
    for class_name in class_names:
        for dist_th in DIST_THS:
            label_aps[class_name][dist_th] = calc_ap(
                mdl[(class_name, dist_th)], MIN_RECALL, MIN_PRECISION)
        for metric_name in tp_metrics:
            if metric_name in excl.get(class_name, ()):
                label_tp_errors[class_name][metric_name] = float("nan")
            else:
                label_tp_errors[class_name][metric_name] = calc_tp(
                    mdl[(class_name, DIST_TH_TP)], MIN_RECALL, metric_name)

    mean_dist_aps = {c: float(np.mean(list(d.values())))
                     for c, d in label_aps.items()}
    mean_ap = float(np.mean(list(mean_dist_aps.values())))
    tp_errors = {
        m: float(np.nanmean(
            [label_tp_errors[c][m] for c in class_names]))
        for m in tp_metrics}
    tp_scores = {m: max(0.0, 1.0 - e) for m, e in tp_errors.items()}
    nd_score = float(
        MEAN_AP_WEIGHT * mean_ap + np.sum(list(tp_scores.values())))
    nd_score /= float(MEAN_AP_WEIGHT + len(tp_scores))

    summary = {
        "label_aps": {c: dict(v) for c, v in label_aps.items()},
        "mean_dist_aps": mean_dist_aps,
        "mean_ap": mean_ap,
        "label_tp_errors": {c: dict(v) for c, v in label_tp_errors.items()},
        "tp_errors": tp_errors,
        "tp_scores": tp_scores,
        "nd_score": nd_score,
    }
    detail = {}
    for name in class_names:
        for k, v in summary["label_aps"][name].items():
            detail[f"object/{name}_ap_dist_{k}"] = round(float(v), 4)
        for k, v in summary["label_tp_errors"][name].items():
            detail[f"object/{name}_{k}"] = round(float(v), 4)
    for k, v in summary["tp_errors"].items():
        detail[f"object/{ERR_NAME_MAPPING[k]}"] = round(float(v), 4)
    detail["object/nds"] = summary["nd_score"]
    detail["object/map"] = summary["mean_ap"]
    summary["detail"] = detail
    if output_dir:
        write_metrics_artifacts(summary, mdl, output_dir, cls_range)
    return summary


def write_metrics_artifacts(summary: Dict, mdl: Dict, output_dir: str,
                            cls_range: Dict[str, float] = None) -> None:
    """metrics_summary.json + metrics_details.json
    (a9coop_dataset.py:918-940; details = the per-(class, dist) accumulate
    curves, keyed 'CLASS:dist')."""
    import json
    import os
    os.makedirs(output_dir, exist_ok=True)
    out = {k: v for k, v in summary.items() if k != "detail"}
    out["cfg"] = {
        "class_range": dict(CLS_RANGE if cls_range is None else cls_range),
        "dist_ths": list(DIST_THS), "dist_th_tp": DIST_TH_TP,
        "min_recall": MIN_RECALL, "min_precision": MIN_PRECISION,
        "mean_ap_weight": MEAN_AP_WEIGHT,
    }
    with open(os.path.join(output_dir, "metrics_summary.json"), "w") as f:
        json.dump(out, f, indent=2)
    details = {
        f"{cls}:{dist}": {k: np.asarray(v).tolist() for k, v in md.items()}
        for (cls, dist), md in mdl.items()}
    with open(os.path.join(output_dir, "metrics_details.json"), "w") as f:
        json.dump(details, f, indent=2)


def write_results_nusc(pred_boxes: Dict, output_dir: str,
                       meta: Dict = None) -> str:
    """results_nusc.json (a9coop_dataset.py:293-337): {meta, results:
    {timestamp: [nusc annos]}}; rotation emitted as a (w, x, y, z) yaw
    quaternion like the reference's pyquaternion boxes."""
    import json
    import os
    os.makedirs(output_dir, exist_ok=True)
    results = {}
    for ts, boxes in pred_boxes.items():
        annos = []
        for b in boxes:
            yaw = float(b.get("yaw", 0.0))
            annos.append(dict(
                timestamp=str(ts),
                translation=[float(x) for x in b["translation"]],
                size=[float(x) for x in b["size"]],
                rotation=[float(np.cos(yaw / 2)), 0.0, 0.0,
                          float(np.sin(yaw / 2))],
                velocity=[float(x) for x in b.get("velocity", (0, 0))[:2]],
                detection_name=b["detection_name"],
                detection_score=float(b.get("detection_score", 0.0)),
            ))
        results[str(ts)] = annos
    path = os.path.join(output_dir, "results_nusc.json")
    with open(path, "w") as f:
        json.dump({"meta": meta or {"use_lidar": True, "use_camera": True},
                   "results": results}, f)
    return path
