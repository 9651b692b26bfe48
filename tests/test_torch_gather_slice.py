"""End-to-end parity of the port's cooperative LiDAR detector with the gather
sparse encoder (`encoder_impl="gather"`) against the JAX package's, on CPU,
float32.

The small coop detector of test_torch_slice.py with the gather encoder
(configs/presets.py `SMALL_GATHER_EXTRACTOR`: active sets capped at 128) is
initialised by flax, its variables carried across by `from_jax_variables`,
and both packages run the same numpy batch: voxelize, HardSimpleVFE, the
sparse encoder (the JAX neighbour maps through its exact lookup on CPU, the
port's through its plain sorted lookup), SECOND/FPN, the coop head. Per-task
outputs of every decoder layer and the decoded top-k scores and boxes within
rtol = atol = 1e-4 (float32 sums in another order), the labels equal.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cmtcoop_tpu.core.coder import decode_boxes as jdecode
from cmtcoop_tpu.models.build import build_detector as jbuild
from cmtcoop_tpu_torch.configs.presets import (SMALL_COOP_HEAD,
                                               SMALL_GATHER_EXTRACTOR)
from cmtcoop_tpu_torch.convert import from_jax_variables
from cmtcoop_tpu_torch.core.coder import decode_boxes
from cmtcoop_tpu_torch.data.synthetic import small_coop_batch
from cmtcoop_tpu_torch.models.build import build_detector
from cmtcoop_tpu_torch.models.sparse_encoder import SparseEncoder
from tests.test_torch_kernels import SLICE_PRESET
from tests.test_torch_slice import JSLICE_PRESET, _decode, _jax_apply, _run

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_side():
    model = jbuild(JSLICE_PRESET, train=False,
                   extractor_kwargs=SMALL_GATHER_EXTRACTOR,
                   head_kwargs=SMALL_COOP_HEAD)
    batch = small_coop_batch()
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    variables = jax.tree.map(np.asarray, variables)
    return dict(variables=variables, batch=batch,
                outs=_jax_apply(model, variables, batch))


def test_gather_coop_detector_matches_jax(jax_side):
    model = build_detector(SLICE_PRESET,
                           extractor_kwargs=SMALL_GATHER_EXTRACTOR,
                           head_kwargs=SMALL_COOP_HEAD)
    assert isinstance(model.vehicle_model.pts_middle_encoder, SparseEncoder)
    model.load_state_dict(from_jax_variables(jax_side["variables"]),
                          strict=True)
    # the clouds give the encoder real work: voxels at the cap, and more
    # output sites than the stage cap keeps after the downsample
    b = jax_side["batch"]
    for a in ("vehicle_", "infrastructure_"):
        ext = getattr(model, a + "model")
        vox = ext.voxelize(torch.from_numpy(b[a + "points"][0]),
                           torch.from_numpy(b[a + "points_mask"][0]))
        maps = ext.pts_middle_encoder.maps(vox.coords, vox.mask)
        assert int(vox.mask.sum()) == 128
        assert int(maps.out_grid.mask.sum()) > 32
    ours, ref = _run(model, b), jax_side["outs"]
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert set(o) == set(r)
        for k in r:
            assert o[k].shape == r[k].shape, k
            np.testing.assert_allclose(o[k], r[k], err_msg=k, **TOL)
    od = _decode(ours, lambda l, c, n: decode_boxes(
        [torch.from_numpy(x) for x in l], [torch.from_numpy(x) for x in c],
        n))
    rd = _decode(ref, lambda l, c, n: jdecode(
        [jnp.asarray(x) for x in l], [jnp.asarray(x) for x in c], n))
    np.testing.assert_allclose(od.scores.numpy(), np.asarray(rd.scores),
                               **TOL)
    np.testing.assert_allclose(od.boxes.numpy(), np.asarray(rd.boxes), **TOL)
    np.testing.assert_array_equal(od.labels.numpy(), np.asarray(rd.labels))


def test_gather_encoder_refuses_train_mode():
    model = build_detector(SLICE_PRESET, train=True,
                           extractor_kwargs=SMALL_GATHER_EXTRACTOR,
                           head_kwargs=SMALL_COOP_HEAD)
    b = {k: torch.from_numpy(v) for k, v in small_coop_batch().items()}
    with pytest.raises(NotImplementedError, match="train mode"):
        model.vehicle_model.extract_pts_feat(b["vehicle_points"],
                                             b["vehicle_points_mask"])
    with pytest.raises(ValueError, match="encoder_impl"):
        build_detector(SLICE_PRESET, extractor_kwargs=dict(
            SMALL_GATHER_EXTRACTOR, encoder_impl="spconv"))
