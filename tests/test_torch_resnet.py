"""The port's ResNet-50 (models/resnet.py) and the single-agent fusion
detector built on it (the camera branch of `cmt_fusion_r50_nuscenes`), on
the CPU, in float32:

- ResNet-50 against the JAX package's `ResNet(50)` on one random
  mmdet-layout state_dict, which the port loads as it is and the JAX side
  takes through `convert_resnet`; against the benchmark's plain reference
  (bench_torch/reference_resnet.py) on the harness's seeded weights; its
  train path (plain convs, BN frozen, blocks checkpointed) against its
  eval path (BN folded into packed convs); its packs rebuilt when the
  weights change;
- the small single-agent detector of test_torch_nusc_slice.py with a
  ResNet-50 + CPFPN camera branch in place of VoVNet, against the JAX
  detector and against `reference_resnet` on the harness's weights.

rtol = atol = 1e-4 unless a test says why not.
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
from bench_torch.reference import full_float32
from bench_torch.reference_resnet import ResNetReference
from bench_torch.weights import make_weights
from cmtcoop_tpu.configs.presets import tiny_preset as jtiny_preset
from cmtcoop_tpu.models.build import build_detector as jbuild
from cmtcoop_tpu.models.resnet import ResNet as JResNet
from cmtcoop_tpu.train import torch_convert as tc
from cmtcoop_tpu_torch.configs.presets import (SMALL_FUSION_EXTRACTOR,
                                               SMALL_FUSION_HEAD, tiny_preset)
from cmtcoop_tpu_torch.convert import from_jax_variables
from cmtcoop_tpu_torch.core.coder import decode_boxes
from cmtcoop_tpu_torch.data.formats import decoded_to_eval_boxes
from cmtcoop_tpu_torch.models.build import build_detector
from cmtcoop_tpu_torch.models.detector import CmtDetector
from cmtcoop_tpu_torch.models.resnet import ResNet
from cmtcoop_tpu_torch.train.eval_hook import make_eval_forward, to_device
from tests.test_torch_camera import _perturbed
from tests.test_torch_nusc_slice import SMALL_NUSC_PRESET, nusc_batch
from tests.test_torch_slice import _check, _run

TOL = dict(rtol=1e-4, atol=1e-4)
FEATS = ("layer3", "layer4")
R50_EXTRACTOR = dict(SMALL_FUSION_EXTRACTOR, img_spec="r50",
                     img_out_features=FEATS)
CONFIG = (Path(__file__).resolve().parents[1] / "bench_torch" / "tests"
          / "data" / "tiny_fusion_nusc_r50.json")
CPU = torch.device("cpu")


def _state(seed: int):
    """A seeded ResNet-50 state_dict in mmdet's layout (the harness's
    rule: BN statistics and affines away from the identity)."""
    shapes = program.state_shapes(ResNet(50, FEATS))
    return make_weights(shapes, seed, CPU)


def _images(seed: int, n: int = 2, h: int = 64, w: int = 96):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, h, w, 3)).astype(np.float32))


def _port(sd):
    model = ResNet(50, FEATS)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_resnet50_matches_jax_through_convert_resnet():
    """Both stages the detector reads, at strides 16 and 32, from one
    mmdet-layout dict: the port loads it strictly, `convert_resnet` takes
    every key of it."""
    sd = _state(1)
    x = _images(2)
    with torch.inference_mode():
        ours = _port(sd)(x)
    cv = tc.Converter({f"bb.{k}": v.numpy() for k, v in sd.items()})
    tc.convert_resnet(cv, "bb", ["bb"], depth=50)
    assert sorted(cv.used) == sorted(f"bb.{k}" for k in sd)
    ref = jax.jit(JResNet(50, FEATS).apply)(
        {"params": cv.params["bb"], "batch_stats": cv.stats["bb"]},
        jnp.asarray(x.numpy()))
    for k, c, s in (("layer3", 1024, 16), ("layer4", 2048, 32)):
        r = np.asarray(ref[k])
        assert ours[k].shape == r.shape == (2, 64 // s, 96 // s, c)
        assert float(np.abs(r).max()) > 0.1
        np.testing.assert_allclose(ours[k].numpy(), r, err_msg=k, **TOL)


def test_resnet50_matches_the_plain_reference():
    """The port's eval path against `ResNetReference`'s backbone (every BN
    unfolded, float32, TF32 off) on the harness's weights."""
    sd = _state(2 ** 40 + 3)
    x = _images(4)
    cfg = json.loads(CONFIG.read_text())
    ref = ResNetReference(cfg, {f"img_backbone.{k}": v
                                for k, v in sd.items()})
    with torch.inference_mode(), full_float32():
        want = ref.vovnet(x.permute(0, 3, 1, 2), "agent.img_backbone")
        ours = _port(sd)(x)
    assert set(want) == set(FEATS)
    for k in FEATS:
        np.testing.assert_allclose(ours[k].numpy(),
                                   want[k].permute(0, 2, 3, 1).numpy(),
                                   err_msg=k, **TOL)


def test_resnet50_train_path_matches_eval_and_keeps_bn_frozen():
    """Train mode (plain convs, BN at its running statistics as
    `norm_eval`, blocks checkpointed) computes the eval function, moves no
    running statistic and gives every conv and BN affine a finite
    gradient."""
    sd = _state(5)
    model = _port(sd)
    x = _images(6)
    with torch.inference_mode():
        want = model(x)
    model.train()
    got = model(x)
    for k in FEATS:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   want[k].numpy(), err_msg=k, **TOL)
    (got["layer3"].sum() + got["layer4"].sum()).backward()
    for k, v in model.state_dict().items():
        if "running" in k:
            assert torch.equal(v, sd[k]), k
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)


def test_resnet50_repacks_when_the_weights_change():
    """The packs follow `load_state_dict`: a model that served on one
    dict and then loaded another serves what a fresh model on the second
    serves, bit for bit."""
    x = _images(7)
    model = _port(_state(8))
    with torch.inference_mode():
        model(x)
    second = _state(9)
    model.load_state_dict(second, strict=True)
    with torch.inference_mode():
        got, want = model(x), _port(second)(x)
    for k in FEATS:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def jax_side():
    batch = nusc_batch()
    model = jbuild(jtiny_preset(**SMALL_NUSC_PRESET), train=False,
                   extractor_kwargs=R50_EXTRACTOR,
                   head_kwargs=SMALL_FUSION_HEAD)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jb)
    variables = _perturbed(variables, np.random.default_rng(0))
    fn = jax.jit(functools.partial(model.apply, mutable=["batch_stats"]))
    (outs, _), _ = fn(variables, jb)
    return batch, variables, jax.tree.map(np.asarray, outs)


def test_small_resnet_detector_matches_jax(jax_side):
    """The small single-agent six-task detector with ResNet-50 + CPFPN on
    six 64x128 views (4 x 8 image tokens a view): per-task logits and codes
    of every decoder layer within rtol = atol = 1e-3, as the VoVNet
    detector's check (float32 through ~90 layers of sums in another
    order), then the joint decode's scores within 1e-4 and its labels."""
    batch, variables, ref = jax_side
    model = build_detector(tiny_preset(**SMALL_NUSC_PRESET),
                           extractor_kwargs=R50_EXTRACTOR,
                           head_kwargs=SMALL_FUSION_HEAD)
    assert isinstance(model, CmtDetector)
    assert isinstance(model.img_backbone, ResNet)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    _check(_run(model, batch), ref)


@pytest.mark.parametrize("seed", [5, 2 ** 40 + 7])
def test_small_resnet_detector_matches_the_plain_reference(seed):
    """The small detector built and filled as the benchmark builds and
    fills it (float32 here), served through `make_eval_forward`,
    `decode_boxes` at the configuration's range and
    `decoded_to_eval_boxes`, against the plain float32 `ResNetReference`
    on the same seeded weights by the benchmark's comparison, at the
    limits of test_torch_nusc_slice.py (both sides float32, differing only
    in the order of their sums)."""
    cfg = json.loads(CONFIG.read_text())
    cfg["dtype"] = "float32"
    model = program.build_eval_model(cfg, CPU)
    shapes = program.state_shapes(model)
    program.load_weights(model, make_weights(shapes, seed, CPU))
    batch = nusc_batch()
    logits, codes = make_eval_forward(model)(to_device(batch, CPU))
    dec = decode_boxes([lg[0] for lg in logits], [c[0] for c in codes],
                       cfg["head"]["max_num"],
                       post_center_range=cfg["head"]["post_center_range"])
    names = program.preset(cfg).class_names
    served = decoded_to_eval_boxes(dec, names, 0)
    ref = ResNetReference(cfg, make_weights(shapes, seed, CPU)).frame(batch)
    assert len(served) == len(ref.top_scores) == min(
        cfg["head"]["max_num"], 24 * len(names))
    gaps = compare.frame_gaps(served, ref, names)
    assert gaps["box_gap"] < 1e-4, gaps
    assert gaps["score_gap"] < 1e-5, gaps
    assert gaps["query_score_gap"] < 1e-5, gaps
