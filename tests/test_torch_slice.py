"""End-to-end parity of the port's cooperative LiDAR detector against the
JAX package, on CPU, float32.

A small coop detector (2-stage pillar encoder, 16x16 BEV so 256 memory
tokens per agent, 2 decoder layers) is initialised by flax, its variables
are carried across by `from_jax_variables`, and both packages run the same
numpy batch. The JAX side takes its XLA paths for the cross-attention and
`shared_conv` on CPU and its Pallas fused pillar convs in interpret mode;
the port takes its plain versions. Per-task outputs of every decoder layer
agree within rtol = atol = 1e-3 (float32 through ~20 layers of sums in
another order) and the decoded top-k scores within 1e-4.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cmtcoop_tpu.configs.presets import tiny_preset as jtiny_preset
from cmtcoop_tpu.core.coder import decode_boxes as jdecode
from cmtcoop_tpu.models.build import build_detector as jbuild
from cmtcoop_tpu_torch.configs.presets import (SMALL_COOP_EXTRACTOR,
                                               SMALL_COOP_HEAD,
                                               SMALL_COOP_PRESET)
from cmtcoop_tpu_torch.convert import from_jax_variables
from cmtcoop_tpu_torch.core.coder import decode_boxes
from cmtcoop_tpu_torch.data.synthetic import small_coop_batch
from tests.test_torch_kernels import slice_model

# the JAX package's own preset for the small detector
JSLICE_PRESET = jtiny_preset(**SMALL_COOP_PRESET)

OUT_TOL = dict(rtol=1e-3, atol=1e-3)
CODES = ("center", "height", "dim", "rot", "vel")


def _jax_apply(model, variables, batch):
    fn = jax.jit(functools.partial(model.apply, mutable=["batch_stats"]))
    (outs, _), _ = fn(variables, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    return jax.tree.map(np.asarray, outs)


@pytest.fixture(scope="module")
def jax_side():
    model = jbuild(JSLICE_PRESET, train=False,
                   extractor_kwargs=SMALL_COOP_EXTRACTOR,
                   head_kwargs=SMALL_COOP_HEAD)
    batch = small_coop_batch()
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    variables = jax.tree.map(np.asarray, variables)
    return dict(variables=variables, batch=batch,
                outs=_jax_apply(model, variables, batch))


def _run(model, batch):
    with torch.inference_mode():
        outs, dn = model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert dn is None
    return [{k: v.float().cpu().numpy() for k, v in t.items()} for t in outs]


def _decode(outs, dec):
    t = outs[0]
    codes = np.concatenate([t[k][-1, 0] for k in CODES], -1)
    return dec([t["cls_logits"][-1, 0]], [codes], 20)


def _check(ours, ref):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert set(o) == set(r)
        for k in r:
            assert o[k].shape == r[k].shape, k
            np.testing.assert_allclose(o[k], r[k], err_msg=k, **OUT_TOL)
    od = _decode(ours, lambda l, c, n: decode_boxes(
        [torch.from_numpy(x) for x in l], [torch.from_numpy(x) for x in c],
        n))
    rd = _decode(ref, lambda l, c, n: jdecode(
        [jnp.asarray(x) for x in l], [jnp.asarray(x) for x in c], n))
    np.testing.assert_allclose(od.scores.numpy(), np.asarray(rd.scores),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(od.labels.numpy(), np.asarray(rd.labels))


def test_coop_detector_matches_jax(jax_side):
    model = slice_model()
    model.load_state_dict(from_jax_variables(jax_side["variables"]),
                          strict=True)
    # the clouds must give the encoder real work: occupied pillars below
    # the cap, at both agents
    for a in ("vehicle_", "infrastructure_"):
        b = jax_side["batch"]
        _, pmask, occ, _ = getattr(model, a + "model").pillarize(
            torch.from_numpy(b[a + "points"][0]),
            torch.from_numpy(b[a + "points_mask"][0]))
        assert 32 < int(pmask.sum()) and int(occ.sum()) > int(pmask.sum())
    _check(_run(model, jax_side["batch"]), jax_side["outs"])


def test_single_agent_degrade_matches_jax(jax_side):
    """agents=("vehicle",): the head runs one decoder pass, no fusion."""
    jm = jbuild(JSLICE_PRESET, train=False,
                extractor_kwargs=SMALL_COOP_EXTRACTOR,
                head_kwargs=SMALL_COOP_HEAD, agents=("vehicle",))
    variables = {
        col: {k: v for k, v in tree.items()
              if k != "infrastructure_model"}
        for col, tree in jax_side["variables"].items()}
    ref = _jax_apply(jm, variables, jax_side["batch"])
    model = slice_model(("vehicle",))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    _check(_run(model, jax_side["batch"]), ref)
