"""Parity of the port's sorted lookup, voxelizer and gather sparse encoder
against cmtcoop_tpu, on CPU.

Integer results (lookups, neighbour maps, output grids, voxel coords,
counts and masks, the densify's zero pattern) must be equal exactly; the
lookup's plain version also against the JAX Pallas compare-count
(`window_counts`, interpret mode). Float results within rtol = atol = 1e-4
in float32 (sums in another order): the VFE, `gather_conv`, the encoder
against the JAX `SparseEncoder` (the JAX encoder test's config), and the
port's gather encoder against its pillar encoder on one state_dict.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cmtcoop_tpu.models.sparse_encoder import SparseEncoder as JSparseEncoder
from cmtcoop_tpu.ops import sparse_utils as jsu
from cmtcoop_tpu.ops.voxelize import hard_simple_vfe as jvfe
from cmtcoop_tpu.ops.voxelize import voxelize as jvoxelize
from cmtcoop_tpu_torch import _build
from cmtcoop_tpu_torch.configs.presets import (SMALL_COOP_EXTRACTOR,
                                               SMALL_COOP_HEAD,
                                               SMALL_COOP_PRESET, tiny_preset)
from cmtcoop_tpu_torch.convert import from_jax_variables
from cmtcoop_tpu_torch.data.synthetic import small_coop_batch
from cmtcoop_tpu_torch.models.build import build_detector, random_init_
from cmtcoop_tpu_torch.models.sparse_encoder import SparseEncoder
from cmtcoop_tpu_torch.ops import sparse_utils as su
from cmtcoop_tpu_torch.ops import voxelize as tvox

TOL = dict(rtol=1e-4, atol=1e-4)
BIG = np.iinfo(np.int32).max
# the JAX encoder test's config (tests/test_pillar_encoder.py)
CFG = dict(sparse_shape=(41, 16, 16), base_channels=4,
           encoder_channels=((4, 4, 8), (8, 8, 8), (8, 8, 8), (8, 8)),
           output_channels=8)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _eq(ours, ref):
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


def _keys_queries(rng, n_keys=700, n_q=900, tail=50):
    """Sorted distinct keys with a sentinel tail; queries in random order:
    present keys, their neighbours, absent values and sentinels."""
    keys = np.sort(rng.choice(20000, n_keys, replace=False)).astype(np.int32)
    keys = np.concatenate([keys, np.full(tail, BIG, np.int32)])
    q = np.concatenate([rng.choice(keys[:n_keys], n_q // 3),
                        rng.choice(keys[:n_keys], n_q // 3) - 1,
                        rng.integers(-5, 20010, n_q - 2 * (n_q // 3))])
    q = q.astype(np.int32)
    q[rng.choice(n_q, n_q // 10, replace=False)] = BIG
    return keys, q


@pytest.mark.parametrize("run", [1, 3])
def test_sorted_lookup_matches_jax_exact(rng, run):
    """Unsorted queries with sentinels in the middle: pos equal everywhere,
    hit equal for real queries and false for sentinels (the JAX exact path
    reports a sentinel query as found in a sentinel tail; its callers mask
    it, the port's lookup never reports it)."""
    keys, q = _keys_queries(rng)
    before = dict(_build.launch_counts)
    pos, hit = su.sorted_lookup(_t(keys), _t(q), run=run)
    assert _build.launch_counts == before
    jpos, jhit = jsu.sorted_lookup(jnp.asarray(keys), jnp.asarray(q),
                                   exact=True, run=run)
    shape = (len(q),) if run == 1 else (len(q), run)
    assert pos.shape == hit.shape == shape and pos.dtype == torch.int32
    _eq(pos, jpos)
    real = (q != BIG) if run == 1 else (q != BIG)[:, None]
    _eq(hit.numpy(), np.asarray(jhit) & real)
    assert hit.any() and not hit.numpy()[q == BIG].any()


@pytest.mark.parametrize("n_keys,n_q,run", [(3000, 1000, 3), (500, 256, 1)])
def test_sorted_lookup_matches_window_counts(rng, n_keys, n_q, run):
    """Against the JAX windowed lookup through the Pallas compare-count
    (`kernel=True`, interpret mode on CPU) on sorted queries whose windows
    do not overflow: hit equal, pos equal for every real query."""
    keys = np.sort(rng.choice(100000, n_keys, replace=False)).astype(np.int32)
    q = np.sort(rng.choice(100000, n_q, replace=False)).astype(np.int32)
    q[-n_q // 8:] = BIG
    jpos, jhit, ovf = jsu.sorted_lookup(
        jnp.asarray(keys), jnp.asarray(q), run=run, exact=False,
        return_overflow=True, kernel=True)
    assert not bool(ovf)
    pos, hit = su.sorted_lookup(_t(keys), _t(q), run=run)
    _eq(hit, jhit)
    _eq(pos.numpy()[q != BIG], np.asarray(jpos)[q != BIG])
    assert hit.any()


def _grid(rng, shape=(9, 12, 10), n=150, cap=192):
    """The same random sorted voxel set for both packages."""
    d, h, w = shape
    lin = np.sort(rng.choice(d * h * w, n, replace=False))
    coords = np.full((cap, 3), -1, np.int32)
    coords[:n] = np.stack([lin // (h * w), (lin // w) % h, lin % w], -1)
    mask = np.arange(cap) < n
    return (jsu.SparseGrid(jnp.asarray(coords), jnp.asarray(mask), shape),
            su.SparseGrid(_t(coords), _t(mask), shape))


def test_neighbor_maps_and_downsample_match_jax(rng):
    jg, tg = _grid(rng)
    _eq(tg.linear_ids, jg.linear_ids)
    _eq(su.subm_neighbor_map(tg), jsu.subm_neighbor_map(jg))
    _eq(su.subm_neighbor_map(tg, (3, 1, 3)),
        jsu.subm_neighbor_map(jg, (3, 1, 3)))
    for k, s, p, cap in [((3, 3, 3), (2, 2, 2), (1, 1, 1), 256),
                         ((3, 3, 3), (2, 2, 2), (0, 1, 1), 256),
                         ((3, 3, 3), (2, 2, 2), (1, 1, 1), 64),  # truncates
                         ((3, 1, 1), (2, 1, 1), (0, 0, 0), 192)]:
        jo = jsu.downsample_output_grid(jg, k, s, p, cap)
        to, n = su.downsample_output_grid(tg, k, s, p, cap, return_n=True)
        _eq(to.coords, jo.coords)
        _eq(to.mask, jo.mask)
        assert to.shape == jo.shape
        assert int(n) >= int(to.mask.sum()) == min(int(n), cap)
        _eq(su.conv_neighbor_map(tg, to, k, s, p),
            jsu.conv_neighbor_map(jg, jo, k, s, p))
    assert int(n) > 64


@pytest.mark.parametrize("max_points,max_voxels", [
    (10, 1024),  # no cap binds
    (3, 1024),   # the per-voxel point cap binds
    (10, 40),    # the voxel cap drops voxels in sorted (z, y, x) order
])
def test_voxelize_and_vfe_match_jax(rng, max_points, max_voxels):
    centers = rng.uniform(-7.5, 7.5, (96, 3)) * [1, 1, 0.6]
    pts = np.repeat(centers, 8, axis=0) + rng.normal(0, 0.3, (768, 3))
    pts = np.concatenate([pts, rng.uniform(0, 1, (768, 2))], 1).astype(
        np.float32)
    mask = rng.uniform(size=768) < 0.9
    kw = dict(voxel_size=(0.5, 0.5, 0.5), pc_range=(-8, -8, -5, 8, 8, 3),
              grid_size=(32, 32, 16), max_points=max_points,
              max_voxels=max_voxels)
    ref = jvoxelize(jnp.asarray(pts), jnp.asarray(mask), **kw)
    ours, stats = tvox.voxelize(_t(pts), _t(mask), return_stats=True, **kw)
    for name in ("coords", "num_points", "mask"):
        _eq(getattr(ours, name), getattr(ref, name))
    np.testing.assert_allclose(ours.voxels.numpy(), np.asarray(ref.voxels),
                               **TOL)
    np.testing.assert_allclose(tvox.hard_simple_vfe(ours).numpy(),
                               np.asarray(jvfe(ref)), **TOL)
    n = int(stats["n_voxels_raw"])
    assert int(ours.mask.sum()) == min(n, max_voxels) > 0
    assert int(stats["n_voxels_dropped"]) == max(n - max_voxels, 0)


def test_gather_conv_and_dense_match_jax(rng):
    jg, tg = _grid(rng)
    nbr = su.subm_neighbor_map(tg)
    feats = rng.normal(size=(192, 6)).astype(np.float32)
    w = rng.normal(size=(27, 6, 5)).astype(np.float32)
    ours = su.gather_conv(_t(feats), nbr, _t(w))
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(jsu.gather_conv(
            jnp.asarray(feats), jnp.asarray(nbr.numpy()), jnp.asarray(w))),
        **TOL)
    dense = su.sparse_to_dense(tg, ours)
    ref = np.asarray(jsu.sparse_to_dense(jg, jnp.asarray(ours.numpy())))
    _eq(dense.numpy() != 0, ref != 0)
    _eq(dense, ref)


def _voxels(rng, v=96, n_active=60):
    d, h, w = CFG["sparse_shape"]
    lin = np.sort(rng.choice(d * h * w, n_active, replace=False))
    coords = np.full((v, 3), -1, np.int32)
    coords[:n_active] = np.stack([lin // (h * w), (lin // w) % h, lin % w],
                                 -1)
    feats = np.zeros((v, 5), np.float32)
    feats[:n_active] = rng.normal(size=(n_active, 5))
    return feats, coords, np.arange(v) < n_active


def test_sparse_encoder_matches_jax(rng):
    """The JAX encoder test's config and caps, BN statistics and affines
    perturbed so the fold is not the identity; weights carried across by
    `from_jax_variables` (an encoder's tree alone)."""
    feats, coords, mask = _voxels(rng)
    ref = JSparseEncoder(stage_caps=(512,) * 4, **CFG)
    args = [jnp.asarray(a)[None] for a in (feats, coords, mask)]
    variables = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0),
                                                  *args))
    variables = jax.tree.map(
        lambda a: (a * rng.uniform(0.5, 1.5, a.shape)
                   + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32),
        variables)
    out_ref = np.asarray(jax.jit(ref.apply)(variables, *args))[0]
    port = SparseEncoder(5, stage_caps=(512,) * 4, **CFG).eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.inference_mode():
        ours = port(_t(feats), _t(coords), _t(mask))
    assert ours.shape == out_ref.shape == (2, 2, 16)
    assert float(ours.abs().max()) > 0
    np.testing.assert_allclose(ours.numpy(), out_ref, **TOL)


def test_gather_encoder_matches_pillar_encoder():
    """One state_dict in the small detector with either encoder, caps that
    drop nothing: each cloud through voxelize + VFE + the gather encoder
    and through pillarize + the pillar encoder gives the same BEV map (the
    two compute the same function)."""
    ek = dict(SMALL_COOP_EXTRACTOR, max_voxels=1024, pillar_caps=(512, 512),
              sparse_stage_caps=(1024, 1024))
    preset = tiny_preset(**SMALL_COOP_PRESET)
    pillar = build_detector(preset, extractor_kwargs=ek,
                            head_kwargs=SMALL_COOP_HEAD)
    random_init_(pillar, torch.Generator().manual_seed(4))
    gather = build_detector(preset, extractor_kwargs=dict(
        ek, encoder_impl="gather"), head_kwargs=SMALL_COOP_HEAD)
    gather.load_state_dict(pillar.state_dict(), strict=True)
    batch = small_coop_batch()
    with torch.inference_mode():
        for a in ("vehicle_", "infrastructure_"):
            pts, m = (_t(batch[a + k][0]) for k in ("points", "points_mask"))
            ref = getattr(pillar, a + "model").encode(pts, m)
            ours = getattr(gather, a + "model").encode(pts, m)
            assert float(ref.abs().max()) > 0 and ours.shape == ref.shape
            np.testing.assert_allclose(ours.numpy(), ref.numpy(), **TOL)
