"""Module-level parity of the port's LiDAR path against the JAX package, on
CPU, float32: the pillar encoder on given pillars, SECOND + FPN on a given
BEV map, and the coop head on given BEV maps. One flax init of the small
coop detector (configs/presets.py `SMALL_COOP_*`) serves every test;
each JAX submodule runs through `apply(method=...)`. Tolerance rtol = atol =
1e-4 for the encoder and the neck, 1e-3 for the head (six layer norms and
two softmax attentions of float32 sums in another order).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cmtcoop_tpu.configs.presets import tiny_preset as jtiny_preset
from cmtcoop_tpu.models.build import build_detector as jbuild
from cmtcoop_tpu.models.cmt_head import AgentInputs as JAgentInputs
from cmtcoop_tpu_torch.configs.presets import (SMALL_COOP_EXTRACTOR,
                                               SMALL_COOP_HEAD,
                                               SMALL_COOP_PRESET)
from cmtcoop_tpu_torch.convert import from_jax_variables
from cmtcoop_tpu_torch.data.synthetic import small_coop_batch
from cmtcoop_tpu_torch.models.cmt_head import AgentInputs
from tests.test_torch_kernels import slice_model

# the JAX package's own preset for the small detector
JSLICE_PRESET = jtiny_preset(**SMALL_COOP_PRESET)


@pytest.fixture(scope="module")
def models():
    jm = jbuild(JSLICE_PRESET, train=False,
                extractor_kwargs=SMALL_COOP_EXTRACTOR,
                head_kwargs=SMALL_COOP_HEAD)
    batch = small_coop_batch()
    variables = jax.jit(jm.init)(
        jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in batch.items()})
    variables = jax.tree.map(np.asarray, variables)
    port = slice_model()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, port, batch


def _apply(jm, variables, fn, *args):
    return jax.jit(functools.partial(jm.apply, method=fn))(variables, *args)


def test_pillar_encoder_matches_jax(models):
    """Same pillars in, dense BEV (H', W', C*Z') out, both agents."""
    jm, variables, port, batch = models
    for agent in ("vehicle_", "infrastructure_"):
        ext = getattr(port, agent + "model")
        pillars = ext.pillarize(torch.from_numpy(batch[agent + "points"][0]),
                                torch.from_numpy(
                                    batch[agent + "points_mask"][0]))
        with torch.inference_mode():
            ours = ext.pts_middle_encoder(*pillars)
        prebuilt = tuple(jnp.asarray(t.numpy())[None] for t in pillars)
        ref = _apply(jm, variables, lambda m, pb, a=agent: getattr(
            m, a + "model").pts_middle_encoder(None, None, None, False,
                                               prebuilt=pb), prebuilt)
        assert ours.shape == ref.shape[1:] and float(ours.abs().max()) > 0
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref)[0],
                                   rtol=1e-4, atol=1e-4)


def test_second_fpn_matches_jax(models, rng):
    jm, variables, port, _ = models
    ext = port.vehicle_model
    c_in = ext.pts_backbone.blocks[0][0].in_channels
    bev = rng.normal(size=(1, 16, 16, c_in)).astype(np.float32)

    def neck(m, x):
        e = m.vehicle_model
        return e.pts_neck(e.pts_backbone(x, False), False)

    ref = _apply(jm, variables, neck, jnp.asarray(bev))
    with torch.inference_mode():
        ours = ext.pts_neck(ext.pts_backbone(torch.from_numpy(bev)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_coop_head_matches_jax(models, rng):
    """Two agents' BEV maps through shared_conv, the decoder, the max
    fusion and the task heads."""
    jm, variables, port, _ = models
    bevs = [rng.normal(size=(1, 16, 16, 32)).astype(np.float32)
            for _ in range(2)]
    (ref, _) = _apply(jm, variables, lambda m, a, b: m.pts_bbox_head(
        [JAgentInputs(bev_feat=a), JAgentInputs(bev_feat=b)]),
        *map(jnp.asarray, bevs))
    with torch.inference_mode():
        ours, _ = port.pts_bbox_head(
            [AgentInputs(bev_feat=torch.from_numpy(b)) for b in bevs])
    for o, r in zip(ours, ref):
        for k in r:
            np.testing.assert_allclose(o[k].numpy(), np.asarray(r[k]),
                                       rtol=1e-3, atol=1e-3, err_msg=k)
