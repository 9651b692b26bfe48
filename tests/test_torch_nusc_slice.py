"""The single-agent, multi-task fusion detector of the nuScenes presets at a
small size, on the CPU, float32: the port against the JAX package on the
same weights, and against the benchmark's plain reference
(bench_torch/reference_single.py) on the harness's seeded weights.

The detector is the small fusion detector (configs/presets.py
`SMALL_FUSION_*`: a 2-stage pillar encoder, V-19-slim-eSE + CPFPN on
64x128 images, 2 decoder layers) as one agent (`domain="vehicle"`, the
port's `CmtDetector`) with the six nuScenes task groups over ten classes
and six views on the nuScenes camera ring's yaws, from the vehicle cloud of
`small_coop_batch()`.
"""
import functools
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bench_torch import compare, program
from bench_torch.reference_single import SingleReference
from bench_torch.weights import make_weights
from cmtcoop_tpu.configs.presets import tiny_preset as jtiny_preset
from cmtcoop_tpu.core.coder import decode_boxes as jdecode
from cmtcoop_tpu.models.build import build_detector as jbuild
from cmtcoop_tpu_torch.configs.presets import (NUSCENES_CLASSES,
                                               NUSCENES_TASKS,
                                               SMALL_FUSION_EXTRACTOR,
                                               SMALL_FUSION_HEAD,
                                               SMALL_FUSION_PRESET,
                                               post_center_range, tiny_preset)
from cmtcoop_tpu_torch.convert import from_jax_variables
from cmtcoop_tpu_torch.core.coder import decode_boxes
from cmtcoop_tpu_torch.data.formats import decoded_to_eval_boxes
from cmtcoop_tpu_torch.data.synthetic import (pinhole_lidar2img,
                                              small_coop_batch)
from cmtcoop_tpu_torch.models.build import build_detector
from cmtcoop_tpu_torch.models.detector import CmtDetector
from cmtcoop_tpu_torch.train.eval_hook import make_eval_forward, to_device
from tests.test_torch_camera import _perturbed
from tests.test_torch_slice import _check, _run

SMALL_NUSC_PRESET = dict(SMALL_FUSION_PRESET, domain="vehicle",
                         class_names=NUSCENES_CLASSES, tasks=NUSCENES_TASKS,
                         num_views=6, dataset="nuscenes")
# the benchmark's configuration of the same detector (the reference reads
# its widths)
CONFIG = (Path(__file__).resolve().parents[1] / "bench_torch" / "tests"
          / "data" / "tiny_fusion_nusc.json")
YAWS = np.deg2rad((0.0, -55.0, -110.0, 180.0, 110.0, 55.0))
CODES = ("center", "height", "dim", "rot", "vel")


def nusc_batch():
    """The vehicle cloud of `small_coop_batch()` and six 64x128 views
    (seed 3), unprefixed, as the single detector takes them."""
    h, w = 64, 128
    src = small_coop_batch()
    rng = np.random.default_rng(3)
    l2i = np.stack([pinhole_lidar2img(h, w, y) for y in YAWS])[None]
    return {"points": src["vehicle_points"],
            "points_mask": src["vehicle_points_mask"],
            "imgs": rng.normal(size=(1, 6, h, w, 3)).astype(np.float32),
            "lidar2img": l2i,
            "img2lidar": np.linalg.inv(l2i).astype(np.float32)}


def _decode_all(outs, fn):
    """Every task's last layer through one decode, top 40."""
    logits = [t["cls_logits"][-1, 0] for t in outs]
    codes = [np.concatenate([t[k][-1, 0] for k in CODES], -1) for t in outs]
    return fn(logits, codes)


@pytest.fixture(scope="module")
def jax_side():
    batch = nusc_batch()
    model = jbuild(jtiny_preset(**SMALL_NUSC_PRESET), train=False,
                   extractor_kwargs=SMALL_FUSION_EXTRACTOR,
                   head_kwargs=SMALL_FUSION_HEAD)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jb)
    variables = _perturbed(variables, np.random.default_rng(0))
    fn = jax.jit(functools.partial(model.apply, mutable=["batch_stats"]))
    (outs, _), _ = fn(variables, jb)
    return batch, variables, jax.tree.map(np.asarray, outs)


def test_single_multi_task_detector_matches_jax(jax_side):
    """Per-task logits and codes of every decoder layer within rtol = atol
    = 1e-3 (float32 through ~40 layers of sums in another order, as the
    coop detector's check), then the six tasks' joint decode at the nuScenes
    range: scores within 1e-4, the same labels, boxes within 1e-3."""
    batch, variables, ref = jax_side
    model = build_detector(tiny_preset(**SMALL_NUSC_PRESET),
                           extractor_kwargs=SMALL_FUSION_EXTRACTOR,
                           head_kwargs=SMALL_FUSION_HEAD)
    assert isinstance(model, CmtDetector)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    ours = _run(model, batch)
    assert len(ours) == len(NUSCENES_TASKS)
    assert [o["cls_logits"].shape[-1] for o in ours] == [
        len(t) for t in NUSCENES_TASKS]
    _check(ours, ref)
    centre_range = post_center_range(tiny_preset(**SMALL_NUSC_PRESET))
    od = _decode_all(ours, lambda lg, c: decode_boxes(
        [torch.from_numpy(x) for x in lg], [torch.from_numpy(x) for x in c],
        40, post_center_range=centre_range))
    rd = _decode_all(ref, lambda lg, c: jdecode(
        [jnp.asarray(x) for x in lg], [jnp.asarray(x) for x in c], 40,
        post_center_range=centre_range))
    np.testing.assert_allclose(od.scores.numpy(), np.asarray(rd.scores),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(od.labels.numpy(), np.asarray(rd.labels))
    np.testing.assert_allclose(od.boxes.numpy(), np.asarray(rd.boxes),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(od.valid.numpy(), np.asarray(rd.valid))
    # the top 40 draw on more than one task's queries
    task_of = [t for t, names in enumerate(NUSCENES_TASKS) for _ in names]
    assert len({task_of[c] for c in od.labels.tolist()}) > 1


@pytest.mark.parametrize("seed", [5, 2 ** 40 + 7])
def test_single_multi_task_detector_matches_the_plain_reference(seed):
    """The port's small detector, built and filled as the benchmark builds
    and fills it (float32 here), served through `make_eval_forward`,
    `decode_boxes` at the configuration's range and
    `decoded_to_eval_boxes`, against the plain float32 reference on the
    same seeded weights, by the benchmark's own comparison. Both sides are
    float32 and differ only in the order of their sums (the pillar layout
    against the rulebook convolution, packed against plain convolutions):
    the gaps read at most 3.8e-6 (box) and 1.2e-7 (score) over three
    seeds, so the limits, 1e-4 and 1e-5, sit well above rounding and far
    below any fault (a moved box reads metres; the same run in bf16 reads
    box gaps of 0.046-0.054 and score gaps of 0.0012-0.0018)."""
    cfg = json.loads(CONFIG.read_text())
    cpu = torch.device("cpu")
    model = program.build_eval_model(cfg, cpu)
    shapes = program.state_shapes(model)
    program.load_weights(model, make_weights(shapes, seed, cpu))
    batch = nusc_batch()
    logits, codes = make_eval_forward(model)(to_device(batch, cpu))
    dec = decode_boxes([lg[0] for lg in logits], [c[0] for c in codes],
                       cfg["head"]["max_num"],
                       post_center_range=cfg["head"]["post_center_range"])
    names = program.preset(cfg).class_names
    served = decoded_to_eval_boxes(dec, names, 0)
    ref = SingleReference(cfg, make_weights(shapes, seed, cpu)).frame(batch)
    assert len(served) == len(ref.top_scores) == min(
        cfg["head"]["max_num"], 24 * len(names))
    gaps = compare.frame_gaps(served, ref, names)
    assert gaps["box_gap"] < 1e-4, gaps
    assert gaps["score_gap"] < 1e-5, gaps
    assert gaps["query_score_gap"] < 1e-5, gaps
