"""Parity of cmtcoop_tpu_torch.core (boxes, position encodings, decode)
against cmtcoop_tpu.core, on CPU in float32.

Inputs are drawn with numpy and fed to both packages. Tolerance
rtol = atol = 1e-4 unless a test says otherwise.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cmtcoop_tpu.core import boxes as jb
from cmtcoop_tpu.core import coder as jc
from cmtcoop_tpu.core import pos_embed as jp
from cmtcoop_tpu_torch.core import boxes as tb
from cmtcoop_tpu_torch.core import coder as tc
from cmtcoop_tpu_torch.core import pos_embed as tp

TOL = dict(rtol=1e-4, atol=1e-4)


def _close(ours, ref, **tol):
    np.testing.assert_allclose(np.asarray(ours.detach().cpu()),
                               np.asarray(ref), **(tol or TOL))


def test_box_codec_and_centers(rng):
    code = rng.normal(size=(7, 10)).astype(np.float32)
    _close(tb.denormalize_bbox(torch.from_numpy(code)),
           jb.denormalize_bbox(jnp.asarray(code)))
    _close(tb.denormalize_bbox(torch.from_numpy(code[:, :8])),
           jb.denormalize_bbox(jnp.asarray(code[:, :8])))
    box = rng.normal(size=(5, 9)).astype(np.float32)
    _close(tb.gravity_to_bottom_center(torch.from_numpy(box)),
           jb.gravity_to_bottom_center(jnp.asarray(box)))
    xyz = rng.uniform(-80, 80, size=(4, 3)).astype(np.float32)
    pcr = (-72.0, -72.0, -8.0, 72.0, 72.0, 0.0)
    _close(tb.normalize_01(torch.from_numpy(xyz), pcr),
           jb.normalize_01(jnp.asarray(xyz), pcr))


def test_inverse_sigmoid_clamps_like_reference(rng):
    x = np.concatenate([rng.uniform(-0.2, 1.2, 50),
                        [0.0, 1.0, 1e-7, 1 - 1e-7]]).astype(np.float32)
    _close(tb.inverse_sigmoid(torch.from_numpy(x)),
           jb.inverse_sigmoid(jnp.asarray(x)))


@pytest.mark.parametrize("npf", [16, 128])
def test_pos2embed(rng, npf):
    pos = rng.uniform(0, 1, size=(2, 9, 3)).astype(np.float32)
    _close(tp.pos2embed(torch.from_numpy(pos), npf),
           jp.pos2embed(jnp.asarray(pos), npf))


@pytest.mark.parametrize("grid,ds,npf", [((32, 32), 2, 16),
                                         ((1440, 1440), 8, 128),
                                         ((24, 40), 4, 8)])
def test_bev_position_tables(grid, ds, npf):
    _close(tp.bev_grid_coords(grid, ds), jp.bev_grid_coords(grid, ds))
    _close(tp.bev_pos2embed_grid(grid, ds, npf),
           jp.bev_pos2embed_grid(grid, ds, npf))
    dense = tp.pos2embed(tp.bev_grid_coords(grid, ds), npf)
    _close(tp.bev_pos2embed_grid(grid, ds, npf), dense.numpy())


@pytest.mark.parametrize("n_cls,max_num", [((7,), 300), ((2, 1, 3), 40),
                                           ((1,), 300)])
def test_decode_boxes(rng, n_cls, max_num):
    nq = 60
    logits = [rng.normal(size=(nq, c)).astype(np.float32) * 3 for c in n_cls]
    codes = []
    for _ in n_cls:
        c = rng.normal(size=(nq, 10)).astype(np.float32)
        c[:, :3] *= 60.0
        codes.append(c)
    ours = tc.decode_boxes([torch.from_numpy(x) for x in logits],
                           [torch.from_numpy(x) for x in codes], max_num)
    ref = jc.decode_boxes([jnp.asarray(x) for x in logits],
                          [jnp.asarray(x) for x in codes], max_num)
    k = min(max_num, nq * sum(n_cls))
    assert ours.scores.shape == (k,) and ours.boxes.shape == (k, 9)
    _close(ours.scores, ref.scores)
    _close(ours.boxes, ref.boxes)
    np.testing.assert_array_equal(ours.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    assert not bool(ours.valid.all())  # the post-center range cuts some


def test_decode_boxes_score_threshold(rng):
    logits = [rng.normal(size=(20, 3)).astype(np.float32)]
    codes = [rng.normal(size=(20, 10)).astype(np.float32)]
    ours = tc.decode_boxes([torch.from_numpy(logits[0])],
                           [torch.from_numpy(codes[0])], 30,
                           score_threshold=0.5)
    ref = jc.decode_boxes([jnp.asarray(logits[0])], [jnp.asarray(codes[0])],
                          30, score_threshold=0.5)
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))


def test_decode_boxes_keeps_the_range_it_is_given():
    """A box centred 62 m out along x: the TUMTraf range (+-80 m, the
    default) keeps it, nuScenes' (+-61.2 m) drops it, in both packages; a
    preset's range comes from its dataset."""
    from cmtcoop_tpu_torch.configs.presets import (get_preset,
                                                   post_center_range)
    logits = np.array([[2.0], [1.0]], np.float32)
    codes = np.zeros((2, 10), np.float32)
    codes[0, 0], codes[1, 0] = 62.0, 30.0
    nusc = post_center_range(get_preset("cmt_fusion_nuscenes"))
    assert nusc == (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    assert post_center_range(get_preset("cmt_fusion_coop_tumtraf")) == (
        -80.0, -80.0, -10.0, 80.0, 80.0, 10.0)
    for kwargs, want in (({}, [True, True]),
                         (dict(post_center_range=nusc), [False, True])):
        ours = tc.decode_boxes([torch.from_numpy(logits)],
                               [torch.from_numpy(codes)], 2, **kwargs)
        ref = jc.decode_boxes([jnp.asarray(logits)], [jnp.asarray(codes)],
                              2, **kwargs)
        assert ours.valid.tolist() == want
        np.testing.assert_array_equal(ours.valid.numpy(),
                                      np.asarray(ref.valid))
        _close(ours.boxes[:, 0], [62.0, 30.0])
