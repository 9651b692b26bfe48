"""The port's eval runner (train/eval_hook.py), its scorer
(data/eval/nusc_protocol.py) and batch formats (data/formats.py) on CPU,
float32, against the JAX package.

- `evaluate_detection` on the same seeded eval boxes returns the JAX
  summary exactly, and writes the same artifacts;
- `collate`, `sample_to_model_batch`, `decoded_to_eval_boxes` and
  `gt_to_eval_boxes` equal JAX's;
- `run_eval` of the small fusion coop detector (configs/presets.py
  `SMALL_FUSION_*`, flax init with perturbed BN, carried across by
  `from_jax_variables`) over 3 synthetic samples in batches of 2 (the tail
  padded) against JAX `run_eval`: per-timestamp boxes and scores within
  1e-4 of their max |.|, labels equal, mean_ap and nd_score within 1e-4;
- stale packs: an eval model that ran, then took the weights of another
  train step through `load_state_dict`, equals a fresh eval model loaded
  with them, bit for bit (through the plain versions).
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cmtcoop_tpu.configs.presets import tiny_preset as jtiny_preset
from cmtcoop_tpu.core.coder import DecodedBoxes as JDecoded
from cmtcoop_tpu.data import formats as jformats
from cmtcoop_tpu.data.eval import nusc_protocol as jnusc
from cmtcoop_tpu.models.build import build_detector as jbuild
from cmtcoop_tpu.train.eval_hook import run_eval as jrun_eval
from cmtcoop_tpu_torch.configs.presets import (SMALL_FUSION_EXTRACTOR,
                                               SMALL_FUSION_HEAD,
                                               SMALL_FUSION_PRESET,
                                               tiny_preset)
from cmtcoop_tpu_torch.convert import from_jax_variables
from cmtcoop_tpu_torch.core.coder import DecodedBoxes
from cmtcoop_tpu_torch.data import formats
from cmtcoop_tpu_torch.data.eval import nusc_protocol as nusc
from cmtcoop_tpu_torch.data.synthetic import (synthetic_batch_iter,
                                              synthetic_sample)
from cmtcoop_tpu_torch.models.build import build_detector
from cmtcoop_tpu_torch.train.eval_hook import run_eval, to_device
from cmtcoop_tpu_torch.train.optim import AdamW
from cmtcoop_tpu_torch.train.train_step import make_train_step
from tests.test_torch_camera import _perturbed

CLASSES = ("CAR", "TRUCK", "PEDESTRIAN", "BICYCLE")
PRESET = tiny_preset(**SMALL_FUSION_PRESET)
GT_KEYS = ("gt_boxes", "gt_labels", "gt_mask")


class SyntheticValSet:
    """A val split in memory: `synthetic_sample(preset, seed + i,
    with_gt=True)`; `ds[i]` the model inputs, the GT boxes as eval boxes
    (bottom-centred again), scored by `scorer.evaluate_detection` with
    `fmt.gt_to_eval_boxes` (the JAX package's or the port's)."""

    def __init__(self, preset, n, scorer, fmt, seed=0):
        samples = [synthetic_sample(preset, np.random.default_rng(seed + i))
                   for i in range(n)]
        self.infos = [{"timestamp": 1000 + i} for i in range(n)]
        self.samples = [{k: v for k, v in s.items() if k not in GT_KEYS}
                        for s in samples]
        self.class_names, self.scorer = preset.class_names, scorer
        self.gt = {}
        for info, s in zip(self.infos, samples):
            boxes = s["gt_boxes"][s["gt_mask"]].copy()
            boxes[:, 2] -= boxes[:, 5] / 2
            self.gt[info["timestamp"]] = fmt.gt_to_eval_boxes(
                boxes, s["gt_labels"][s["gt_mask"]], self.class_names,
                info["timestamp"])

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def evaluate(self, preds, output_dir=None):
        return self.scorer.evaluate_detection(self.gt, preds,
                                              self.class_names,
                                              output_dir=output_dir)


def eval_boxes(rng, n_ts=4, n=12, with_score=True):
    out = {}
    for ts in range(n_ts):
        boxes = []
        for _ in range(n):
            b = dict(translation=tuple(rng.uniform(-45, 45, 2).tolist()
                                       + [float(rng.uniform(-3, 1))]),
                     size=tuple(rng.uniform(0.5, 5, 3).tolist()),
                     yaw=float(rng.uniform(-np.pi, np.pi)),
                     velocity=tuple(rng.normal(size=2).tolist()),
                     detection_name=CLASSES[rng.integers(len(CLASSES))],
                     num_pts=int(rng.integers(0, 20)), timestamp=ts)
            b["ego_dist"] = float(np.hypot(*b["translation"][:2]))
            if with_score:
                b["detection_score"] = float(rng.uniform())
            boxes.append(b)
        out[ts] = boxes
    return out


def jittered(rng, gt):
    """Predictions near the GT (most within the match thresholds) plus
    false positives."""
    out = {}
    for ts, boxes in gt.items():
        preds = []
        for b in boxes:
            p = dict(b, detection_score=float(rng.uniform()))
            p["translation"] = tuple(np.asarray(b["translation"])
                                     + rng.normal(0, 0.8, 3))
            preds.append(p)
        out[ts] = preds + eval_boxes(rng, 1, 4)[0]
    return out


def test_nusc_protocol_equals_the_jax_scorer(rng, tmp_path):
    gt = eval_boxes(rng, with_score=False)
    preds = jittered(rng, gt)
    for protocol in ("a9", "nuscenes"):
        ours = nusc.evaluate_detection(gt, preds, CLASSES,
                                       output_dir=str(tmp_path / "p"),
                                       protocol=protocol)
        ref = jnusc.evaluate_detection(gt, preds, CLASSES,
                                       output_dir=str(tmp_path / "j"),
                                       protocol=protocol)
        assert json.dumps(ours, sort_keys=True) == json.dumps(
            ref, sort_keys=True)
        assert ref["mean_ap"] > 0.1
        for name in ("metrics_summary.json", "metrics_details.json"):
            assert ((tmp_path / "p" / name).read_text()
                    == (tmp_path / "j" / name).read_text())
    nusc.write_results_nusc(preds, str(tmp_path / "p"))
    jnusc.write_results_nusc(preds, str(tmp_path / "j"))
    assert ((tmp_path / "p" / "results_nusc.json").read_text()
            == (tmp_path / "j" / "results_nusc.json").read_text())


def test_formats_equal_the_jax_formats(rng):
    sample = {"vehicle_points": rng.normal(size=(50, 5)).astype(np.float32),
              "vehicle_imgs": rng.normal(size=(1, 4, 6, 3)),
              "vehicle_lidar2img": np.eye(4) + rng.normal(size=(1, 4, 4)) / 9,
              "gt_boxes_3d": rng.normal(size=(5, 9)),
              "gt_labels_3d": rng.integers(0, 3, 5)}
    for max_points, max_gt in ((64, 8), (32, 3)):
        kw = dict(max_points=max_points, max_gt=max_gt,
                  prefixes=("vehicle_",))
        ours = formats.sample_to_model_batch(sample, **kw)
        ref = jformats.sample_to_model_batch(sample, **kw)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        batch, jbatch = formats.collate([ours, ours]), jformats.collate(
            [ref, ref])
        for k in jbatch:
            np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    dec = [rng.normal(size=(20, 9)).astype(np.float32),
           rng.uniform(size=20).astype(np.float32),
           rng.integers(0, 3, 20).astype(np.int32), rng.uniform(size=20) > 0.3]
    ref = jformats.decoded_to_eval_boxes(JDecoded(*map(jnp.asarray, dec)),
                                         CLASSES, 7)
    assert formats.decoded_to_eval_boxes(
        DecodedBoxes(*map(torch.from_numpy, dec)), CLASSES, 7) == ref
    assert formats.decoded_to_eval_boxes(DecodedBoxes(*dec), CLASSES,
                                         7) == ref
    assert len(ref) == int(dec[3].sum())
    npts = rng.integers(0, 9, 20)
    for n in (None, npts):
        assert formats.gt_to_eval_boxes(dec[0], dec[2], CLASSES, 3, n) == \
            jformats.gt_to_eval_boxes(dec[0], dec[2], CLASSES, 3, n)


def eval_model(state_dict):
    model = build_detector(PRESET, extractor_kwargs=SMALL_FUSION_EXTRACTOR,
                           head_kwargs=SMALL_FUSION_HEAD)
    model.load_state_dict(state_dict, strict=True)
    return model


@pytest.fixture(scope="module")
def shared():
    """The flax init with perturbed BN statistics and affines, carried to
    the port by `from_jax_variables`."""
    jmodel = jbuild(jtiny_preset(**SMALL_FUSION_PRESET), train=False,
                    extractor_kwargs=SMALL_FUSION_EXTRACTOR,
                    head_kwargs=SMALL_FUSION_HEAD)
    batch = formats.collate([synthetic_sample(
        PRESET, np.random.default_rng(0), with_gt=False)])
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                             {k: jnp.asarray(x) for k, x in batch.items()})
    v = jax.tree.map(np.asarray, _perturbed(v, np.random.default_rng(3)))
    return from_jax_variables(v), jmodel, v


def test_run_eval_matches_the_jax_runner(shared, tmp_path):
    sd, jmodel, v = shared
    summary, preds = run_eval(
        eval_model(sd),
        SyntheticValSet(PRESET, 3, nusc, formats), PRESET, batch_size=2,
        work_dir=str(tmp_path))
    jsummary, jpreds = jrun_eval(
        jmodel, v, SyntheticValSet(PRESET, 3, jnusc, jformats), PRESET,
        batch_size=2)
    assert (tmp_path / "metrics_summary.json").exists()
    assert sorted(preds) == sorted(jpreds) == [1000, 1001, 1002]
    for ts, ref in jpreds.items():
        got = preds[ts]
        assert len(got) == len(ref) > 0
        assert [b["detection_name"] for b in got] == [
            b["detection_name"] for b in ref]
        for key in ("translation", "size", "yaw", "velocity",
                    "detection_score"):
            a = np.array([b[key] for b in got], np.float64)
            r = np.array([b[key] for b in ref], np.float64)
            err = float(np.abs(a - r).max())
            assert err <= 1e-4 * max(1.0, float(np.abs(r).max())), (ts, key,
                                                                    err)
    for key in ("mean_ap", "nd_score"):
        assert abs(summary[key] - jsummary[key]) <= 1e-4, key
    _, none = run_eval(eval_model(sd),
                       SyntheticValSet(PRESET, 1, nusc, formats), PRESET,
                       collect_preds=False)
    assert none is None


def test_reloaded_eval_model_equals_a_fresh_one(shared):
    """The eval modules' packs (models/layers.py) follow `load_state_dict`
    after another train step."""
    sd = shared[0]
    ds = SyntheticValSet(PRESET, 1, nusc, formats)
    batch = to_device(formats.collate([ds[0]]), "cpu")
    held = eval_model(sd)
    with torch.no_grad():
        before = held(batch)[0]  # builds the packs
    train = build_detector(PRESET, train=True,
                           extractor_kwargs=SMALL_FUSION_EXTRACTOR,
                           head_kwargs=SMALL_FUSION_HEAD)
    train.load_state_dict(sd)
    step = make_train_step(train, AdamW(train.named_parameters(), 10),
                           PRESET.tasks)
    step(to_device(next(synthetic_batch_iter(PRESET, 1)), "cpu"))
    held.load_state_dict(train.state_dict())
    fresh = eval_model(train.state_dict())
    with torch.no_grad():
        got, ref = held(batch)[0], fresh(batch)[0]
    for k in ref[0]:
        assert torch.equal(got[0][k], ref[0][k]), k
    assert not torch.equal(before[0]["center"], ref[0]["center"])
    assert run_eval(held, ds, PRESET)[1] == run_eval(fresh, ds, PRESET)[1]
