"""End-to-end parity of the port's cooperative fusion detector against the
JAX package, on CPU, float32.

The small fusion coop detector (configs/presets.py `SMALL_FUSION_*`: the
small LiDAR branch plus V-19-slim-eSE + CPFPN on 64x128 images, 1 vehicle
and 2 infrastructure views) is initialised by flax, its BN statistics and
affines perturbed, its variables carried across by `from_jax_variables`,
and both packages run `small_fusion_batch()`. The JAX side takes its flax
VoVNet and XLA convs on CPU and its Pallas pillar convs in interpret mode;
the port takes its plain versions. Per-task outputs of every decoder layer
agree within rtol = atol = 1e-3 (float32 through ~40 layers of sums in
another order), the decoded top-k scores within 1e-4.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cmtcoop_tpu.configs.presets import tiny_preset as jtiny_preset
from cmtcoop_tpu.models.build import build_detector as jbuild
from cmtcoop_tpu_torch.configs.presets import (SMALL_FUSION_EXTRACTOR,
                                               SMALL_FUSION_HEAD,
                                               SMALL_FUSION_PRESET,
                                               tiny_preset)
from cmtcoop_tpu_torch.convert import from_jax_variables
from cmtcoop_tpu_torch.data.synthetic import small_fusion_batch
from cmtcoop_tpu_torch.models.build import build_detector
from tests.test_torch_camera import _perturbed
from tests.test_torch_slice import _check, _run

CAMERA_PRESET = dict(SMALL_FUSION_PRESET, modality="camera")


def _jax_side(preset, batch, **over):
    model = jbuild(jtiny_preset(**preset), train=False,
                   extractor_kwargs=SMALL_FUSION_EXTRACTOR,
                   head_kwargs=SMALL_FUSION_HEAD, **over)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jb)
    variables = _perturbed(variables, np.random.default_rng(0))
    fn = jax.jit(functools.partial(model.apply, mutable=["batch_stats"]))
    (outs, _), _ = fn(variables, jb)
    return variables, jax.tree.map(np.asarray, outs)


def _port(preset, variables, **over):
    model = build_detector(tiny_preset(**preset),
                           extractor_kwargs=SMALL_FUSION_EXTRACTOR,
                           head_kwargs=SMALL_FUSION_HEAD, **over)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def fusion():
    batch = small_fusion_batch()
    variables, outs = _jax_side(SMALL_FUSION_PRESET, batch)
    return batch, variables, outs


def test_fusion_coop_detector_matches_jax(fusion):
    batch, variables, ref = fusion
    model = _port(SMALL_FUSION_PRESET, variables)
    _check(_run(model, batch), ref)


def test_small_batch_puts_some_queries_in_an_image(fusion):
    """The queries' in-image mask, per agent over its views, is neither
    all false nor all true, so the RV query embedding is really tested."""
    batch, variables, _ = fusion
    head = _port(SMALL_FUSION_PRESET, variables).pts_bbox_head
    ref01 = torch.sigmoid(head.reference_points.weight)[None]
    for a in ("vehicle_", "infrastructure_"):
        _, in_img = head.project_queries(
            ref01, torch.from_numpy(batch[a + "lidar2img"]),
            batch[a + "imgs"].shape[2:4])
        assert 0 < int(in_img.sum()) < in_img.numel(), a


def test_camera_only_single_agent_matches_jax():
    """modality="camera", agents=("vehicle",): no BEV tokens, no
    shared_conv; the query PE is still bev_embedding + the RV embedding."""
    batch = {k: v for k, v in small_fusion_batch().items()
             if k.startswith("vehicle_") and "points" not in k}
    variables, ref = _jax_side(CAMERA_PRESET, batch, agents=("vehicle",))
    model = _port(CAMERA_PRESET, variables, agents=("vehicle",))
    assert not hasattr(model.pts_bbox_head, "shared_conv")
    _check(_run(model, batch), ref)
