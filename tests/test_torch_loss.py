"""Parity of the port's training losses, assignment, denoising and grid mask
against the JAX package, on CPU, float32:

- focal / L1 losses and matching costs, rtol = atol = 1e-5;
- `solve_lap` (scipy on the host) against the JAX on-device solver on
  random tie-free costs with invalid (padded) rows at the end, as the JAX
  package's own tests place them: the same column for every valid row,
  exactly. With invalid rows between valid ones the JAX solver's float32
  duals lose the valid costs against its 1e9 padding cost and it can miss
  the optimum (ROADMAP.md §3); there the port is held to a brute-force
  optimum instead;
- the full `cmt_loss` dict (every `d{i}.`, `dn_` and total term) on the
  same random head outputs and DNInfo, rtol 1e-5;
- `dn_attn_bias` exactly; `prepare_for_dn` given JAX's `jax.random.uniform`
  draws, 1e-6; `grid_mask` given the JAX function's draws, exactly.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cmtcoop_tpu.core import hungarian as jh
from cmtcoop_tpu.core import losses as jl
from cmtcoop_tpu.models import cmt_head as jhead
from cmtcoop_tpu.models.cmt_loss import cmt_loss as jcmt_loss
from cmtcoop_tpu.models.grid_mask import grid_mask as jgrid_mask
from cmtcoop_tpu_torch.core import losses as tl
from cmtcoop_tpu_torch.core.hungarian import solve_lap
from cmtcoop_tpu_torch.models import cmt_head as thead
from cmtcoop_tpu_torch.models.cmt_loss import cmt_loss
from cmtcoop_tpu_torch.models.grid_mask import GridMaskDraws, grid_mask

TOL = dict(rtol=1e-5, atol=1e-5)
TASKS = (("CAR", "TRUCK"), ("PEDESTRIAN",))
PC_RANGE = (-72.0, -72.0, -8.0, 72.0, 72.0, 0.0)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_losses_and_costs_match_jax(rng):
    n, c, g = 50, 3, 7
    logits = rng.normal(size=(n, c)).astype(np.float32) * 3
    labels = rng.integers(0, c + 1, n).astype(np.int32)
    lw = rng.uniform(size=n).astype(np.float32)
    np.testing.assert_allclose(
        float(tl.sigmoid_focal_loss(_t(logits), _t(labels), _t(lw), c, 7.5,
                                    loss_weight=2.0)),
        float(jl.sigmoid_focal_loss(logits, labels, lw, c, 7.5,
                                    loss_weight=2.0)), **TOL)
    pred, tgt, w = (rng.normal(size=(n, 10)).astype(np.float32)
                    for _ in range(3))
    np.testing.assert_allclose(
        float(tl.weighted_l1_loss(_t(pred), _t(tgt), _t(w), 3.0, 0.25)),
        float(jl.weighted_l1_loss(pred, tgt, w, 3.0, 0.25)), **TOL)
    gl = rng.integers(0, c, g).astype(np.int32)
    np.testing.assert_allclose(tl.focal_cost(_t(logits), _t(gl)).numpy(),
                               np.asarray(jl.focal_cost(logits, gl)), **TOL)
    np.testing.assert_allclose(tl.l1_cost(_t(pred), _t(tgt[:g])).numpy(),
                               np.asarray(jl.l1_cost(pred, tgt[:g])), **TOL)


@pytest.mark.parametrize("r,c,n_invalid", [(8, 30, 0), (16, 40, 5),
                                           (30, 30, 7), (128, 900, 20),
                                           (1, 5, 0)])
def test_solve_lap_equals_jax(rng, r, c, n_invalid):
    cost = rng.uniform(size=(r, c)).astype(np.float32) * 10
    valid = np.arange(r) < r - n_invalid
    ref = np.asarray(jh.solve_lap(jnp.asarray(cost), jnp.asarray(valid)))
    ours = solve_lap(cost, valid)
    np.testing.assert_array_equal(ours[valid], ref[valid])
    assert (ours[~valid] == -1).all()
    assert len(set(ours[valid])) == valid.sum()


def test_solve_lap_with_interleaved_invalid_rows_is_optimal(rng):
    """Invalid rows between valid ones: the assignment of the valid rows
    has the least total over every injective choice of columns."""
    import itertools
    for _ in range(5):
        cost = rng.uniform(size=(6, 7)) * 10
        valid = np.array([False, True, True, False, True, True])
        ours = solve_lap(cost, valid)
        rows = np.flatnonzero(valid)
        best = min(cost[rows, list(cols)].sum()
                   for cols in itertools.permutations(range(7), len(rows)))
        np.testing.assert_allclose(cost[rows, ours[rows]].sum(), best,
                                   rtol=1e-12)


@pytest.mark.parametrize("r,c,n_invalid,seed", [(30, 30, 7, 0),
                                                (128, 900, 40, 2)])
def test_solve_lap_at_or_below_jax_with_interleaved_padding(r, c, n_invalid,
                                                           seed):
    """With invalid rows among the valid ones the port's total is the
    optimum and the JAX solver's is no lower (it is higher on these draws:
    ROADMAP.md §3; `-s` prints both totals)."""
    rng = np.random.default_rng(seed)
    cost = rng.uniform(size=(r, c)).astype(np.float32) * 10
    valid = np.ones(r, bool)
    valid[rng.choice(r, n_invalid, replace=False)] = False
    rows = np.flatnonzero(valid)
    ours = cost[rows, solve_lap(cost, valid)[rows]].sum(dtype=np.float64)
    ref = np.asarray(jh.solve_lap(jnp.asarray(cost), jnp.asarray(valid)))
    theirs = cost[rows, ref[rows]].sum(dtype=np.float64)
    print(f"{r}x{c}, {n_invalid} interleaved invalid rows: port total "
          f"{ours:.6f}, JAX total {theirs:.6f}, "
          f"{int((solve_lap(cost, valid)[rows] != ref[rows]).sum())} of "
          f"{rows.size} valid rows differ")
    assert ours <= theirs + 1e-9


def _head_outputs(rng, layers, b, nq, pad):
    outs = []
    for names in TASKS:
        t = {}
        for prefix, n in (("", nq), ("dn_", pad)):
            t[prefix + "center"] = rng.uniform(-50, 50, (layers, b, n, 2))
            t[prefix + "height"] = rng.uniform(-6, -2, (layers, b, n, 1))
            t[prefix + "dim"] = rng.normal(size=(layers, b, n, 3))
            t[prefix + "rot"] = rng.normal(size=(layers, b, n, 2))
            t[prefix + "vel"] = rng.normal(size=(layers, b, n, 2))
            t[prefix + "cls_logits"] = rng.normal(
                size=(layers, b, n, len(names))) * 2
        outs.append({k: v.astype(np.float32) for k, v in t.items()})
    return outs


def _gt(rng, b, g):
    boxes = np.zeros((b, g, 9), np.float32)
    boxes[..., :2] = rng.uniform(-50, 50, (b, g, 2))
    boxes[..., 2] = rng.uniform(-6, -2, (b, g))
    boxes[..., 3:6] = rng.uniform(0.5, 4, (b, g, 3))
    boxes[..., 6] = rng.uniform(-3, 3, (b, g))
    boxes[..., 7:] = rng.normal(size=(b, g, 2))
    labels = rng.integers(0, 3, (b, g)).astype(np.int32)
    mask = rng.uniform(size=(b, g)) < 0.8
    return boxes, labels, mask


def test_cmt_loss_matches_jax(rng):
    """3 decoder layers, 2 tasks (one with one class), batch 2, 6 GT slots
    (some invalid), 2 DN groups with split-flipped labels."""
    layers, b, nq, g, groups = 3, 2, 20, 6, 2
    boxes, labels, mask = _gt(rng, b, g)
    outs = _head_outputs(rng, layers, b, nq, groups * g)
    known = np.broadcast_to(labels[:, None], (b, groups, g)).copy()
    known[rng.uniform(size=known.shape) < 0.3] = 3
    info = dict(known_labels=known,
                known_labels_raw=np.broadcast_to(labels[:, None],
                                                 (b, groups, g)).copy(),
                known_boxes=np.broadcast_to(boxes[:, None],
                                            (b, groups, g, 9)).copy(),
                valid=np.broadcast_to(mask[:, None], (b, groups, g)).copy())
    ref = jcmt_loss([{k: jnp.asarray(v) for k, v in t.items()} for t in outs],
                    jhead.DNInfo(**{k: jnp.asarray(v)
                                    for k, v in info.items()},
                                 pad_size=groups * g),
                    jnp.asarray(boxes), jnp.asarray(labels),
                    jnp.asarray(mask), TASKS)
    ours = cmt_loss([{k: _t(v) for k, v in t.items()} for t in outs],
                    thead.DNInfo(**{k: _t(v) for k, v in info.items()},
                                 pad_size=groups * g),
                    _t(boxes), _t(labels), _t(mask), TASKS)
    assert set(ours) == set(ref)
    assert {"d0.loss_cls", "d1.dn_loss_bbox", "dn_loss_cls"} <= set(ours)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("nq,gt,groups", [(900, 128, 5), (24, 4, 2),
                                          (10, 3, 1)])
def test_dn_attn_bias_equals_jax(nq, gt, groups):
    np.testing.assert_array_equal(
        thead.dn_attn_bias(nq, gt, groups).numpy(),
        np.asarray(jhead.dn_attn_bias(nq, gt, groups)))


@pytest.mark.parametrize("noise_scale", [1.0, 0.0])
def test_prepare_for_dn_matches_jax(rng, noise_scale):
    b, g, groups, nq = 2, 5, 3, 12
    boxes, labels, mask = _gt(rng, b, g)
    ref_pts = rng.uniform(size=(nq, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jm = jhead.CmtHead(num_query=nq, dn_groups=groups, max_gt=g,
                       noise_scale=noise_scale, tasks=TASKS, with_bev=False,
                       with_rv=False)
    jref, jinfo = jm.apply({"params": {"reference_points": ref_pts}}, key,
                           jnp.asarray(ref_pts), jnp.asarray(boxes),
                           jnp.asarray(labels), jnp.asarray(mask),
                           method=jhead.CmtHead.prepare_for_dn)
    rand = np.asarray(jax.random.uniform(key, (b, groups, g, 3),
                                         minval=-1.0, maxval=1.0))
    tm = thead.CmtHead(num_query=nq, dn_groups=groups, max_gt=g,
                       noise_scale=noise_scale, tasks=TASKS, with_bev=False,
                       with_rv=False, num_decoder_layers=1, hidden_dim=32,
                       feedforward_channels=32, num_heads=2)
    tref, tinfo = tm.prepare_for_dn(_t(ref_pts), _t(boxes), _t(labels),
                                    _t(mask), _t(rand))
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), rtol=1e-6,
                               atol=1e-6)
    for name in ("known_labels", "known_labels_raw", "known_boxes", "valid"):
        np.testing.assert_array_equal(getattr(tinfo, name).numpy(),
                                      np.asarray(getattr(jinfo, name)),
                                      err_msg=name)
    assert tinfo.pad_size == jinfo.pad_size == groups * g
    if noise_scale:
        assert (tinfo.known_labels.numpy() == 3).any()


def _jax_draws(key, h, w):
    """The draws `cmtcoop_tpu.models.grid_mask.grid_mask` takes from key."""
    k_apply, k_d, k_sx, k_sy, _ = jax.random.split(key, 5)
    d = int(jax.random.randint(k_d, (), 2, min(h, w)))
    return GridMaskDraws(float(jax.random.uniform(k_apply)), d,
                         int(jax.random.randint(k_sx, (), 0, 1 << 30)) % d,
                         int(jax.random.randint(k_sy, (), 0, 1 << 30)) % d)


def test_grid_mask_matches_jax(rng):
    imgs = rng.normal(size=(3, 40, 56, 3)).astype(np.float32)
    applied = 0
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, 40, 56)
        ref = np.asarray(jgrid_mask(key, jnp.asarray(imgs)))
        ours = grid_mask(_t(imgs), draws).numpy()
        np.testing.assert_array_equal(ours, ref)
        applied += draws.apply_u < 0.7
    assert 0 < applied < 6
