"""Parity of the port's pillar machinery and of the plain fused pillar conv
against cmtcoop_tpu (the JAX fused conv in Pallas interpret mode), on CPU.

Integer maps, coordinates, masks and occupancy must be equal exactly;
features within 1e-5 (pillarize: float32 sums in another order) or 1e-4
(convolutions: rtol = atol = 1e-4). Grids hold 256 pillars so the JAX
kernel runs its Pallas path (P_out % 128 == 0), not its XLA fallback.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cmtcoop_tpu.ops import pillars as jpu
from cmtcoop_tpu.ops.pillar_fused import fused_pillar_conv as jfused
from cmtcoop_tpu_torch.ops import pillars as tpu
from cmtcoop_tpu_torch.ops.pillar_fused import fused_pillar_conv

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _eq(ours, ref):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _grids(rng, hw=(32, 32), z=8, p_cap=256, density=0.35):
    """The same random BEV pillar set for both packages."""
    h, w = hw
    ys, xs = np.nonzero(rng.uniform(size=(h, w)) < density)
    n = min(len(ys), p_cap)
    coords = np.full((p_cap, 2), -1, np.int32)
    coords[:n, 0], coords[:n, 1] = ys[:n], xs[:n]
    mask = np.zeros((p_cap,), bool)
    mask[:n] = True
    return (jpu.PillarGrid(jnp.asarray(coords), jnp.asarray(mask), hw, z),
            tpu.PillarGrid(_t(coords), _t(mask), hw, z))


def _cloud(rng, n, spread=7.5):
    """Clustered points (many per voxel, some out of range) + padding."""
    centers = rng.uniform(-spread, spread, (n // 8, 3)) * [1, 1, 0.6]
    pts = np.repeat(centers, 8, axis=0)[:n] + rng.normal(0, 0.3, (n, 3))
    pts = np.concatenate([pts, rng.uniform(0, 1, (n, 2))], 1)
    mask = rng.uniform(size=n) < 0.9
    return pts.astype(np.float32), mask


@pytest.mark.parametrize("max_points,max_voxels,max_pillars", [
    (10, 4096, 512),   # no cap binds
    (3, 4096, 512),    # the per-voxel point cap binds
    (10, 96, 512),     # the voxel cap drops voxels in sorted order
    (10, 4096, 64),    # the pillar cap drops pillars in sorted order
])
def test_pillarize(rng, max_points, max_voxels, max_pillars):
    pts, mask = _cloud(rng, 1536)
    kw = dict(voxel_size=(0.5, 0.5, 0.5), pc_range=(-8, -8, -5, 8, 8, 3),
              grid_size=(32, 32, 16), max_points=max_points,
              max_voxels=max_voxels, max_pillars=max_pillars,
              return_stats=True)
    ref = jpu.pillarize(jnp.asarray(pts), jnp.asarray(mask), **kw)
    ours = tpu.pillarize(_t(pts), _t(mask), **kw)
    for o, r in zip(ours[:3], ref[:3]):
        _eq(o, r)
    np.testing.assert_allclose(ours[3].numpy(), np.asarray(ref[3]),
                               rtol=1e-5, atol=1e-5)
    for k, v in ref[4].items():
        assert int(ours[4][k]) == int(v), k
    assert int(ours[1].sum()) > 0


def test_neighbor_maps_and_downsample_grid(rng):
    jg, tg = _grids(rng)
    _eq(tpu.pillar_neighbor_map(tg), jpu.pillar_neighbor_map(jg))
    _eq(tpu.pillar_neighbor_map(tg, 5, 3), jpu.pillar_neighbor_map(jg, 5, 3))
    for cap in (128, 64):  # 64 truncates: the true count must still match
        jo, jn = jpu.pillar_downsample_grid(jg, cap, return_n=True)
        to, tn = tpu.pillar_downsample_grid(tg, cap, return_n=True)
        _eq(to.coords, jo.coords)
        _eq(to.mask, jo.mask)
        assert to.hw == jo.hw and int(tn) == int(jn)
        _eq(tpu.pillar_conv_neighbor_map(tg, to),
            jpu.pillar_conv_neighbor_map(jg, jo))
    _eq(tpu.identity_map(tg)[:, 0],
        np.where(np.asarray(jg.mask), np.arange(256), 256))


def test_pillar_conv_occ_and_dense(rng):
    jg, tg = _grids(rng, z=6)
    nbr = tpu.pillar_neighbor_map(tg)
    feats = rng.normal(size=(256, 6, 4)).astype(np.float32)
    w = rng.normal(size=(27, 4, 5)).astype(np.float32)
    for zs, zp in ((1, 1), (2, 1), (2, 0)):
        np.testing.assert_allclose(
            tpu.pillar_conv(_t(feats), nbr, _t(w), 3, zs, zp, chunk=96),
            jpu.pillar_conv(jnp.asarray(feats), jnp.asarray(nbr.numpy()),
                            jnp.asarray(w), 3, zs, zp), **TOL)
        occ = rng.uniform(size=(256, 6)) < 0.4
        _eq(tpu.occ_downsample(_t(occ), nbr, 3, zs, zp),
            jpu.occ_downsample(jnp.asarray(occ), jnp.asarray(nbr.numpy()),
                               3, zs, zp))
    np.testing.assert_array_equal(
        tpu.pillars_to_dense(tg, _t(feats)).numpy(),
        np.asarray(jpu.pillars_to_dense(jg, jnp.asarray(feats))))


def _conv_setup(rng, cin, cout, z=8):
    jg, tg = _grids(rng, z=z)
    occ = (rng.uniform(size=(256, z)) < 0.5) & np.asarray(jg.mask)[:, None]
    feats = (rng.normal(size=(256, z, cin)) * occ[..., None]).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32) * 0.1
    return jg, tg, occ, feats, scale, bias


def test_fused_subm_conv_with_residual(rng):
    """conv1/conv2 of a basic block: occupancy given, residual added."""
    jg, tg, occ, feats, scale, bias = _conv_setup(rng, 6, 6)
    w = (rng.normal(size=(27, 6, 6)) * 0.3).astype(np.float32)
    resid = (rng.normal(size=(256, 8, 6)) * occ[..., None]).astype(
        np.float32)
    nbr = tpu.pillar_neighbor_map(tg)
    ref = jfused(jnp.asarray(feats), jnp.asarray(nbr.numpy()),
                 jnp.asarray(w), scale=jnp.asarray(scale),
                 bias=jnp.asarray(bias), occ_out=jnp.asarray(occ),
                 residual=jnp.asarray(resid), relu=True, subm=True,
                 interpret=True)
    ours = fused_pillar_conv(_t(feats), nbr, _t(w), scale=_t(scale),
                             bias=_t(bias), occ_out=_t(occ),
                             residual=_t(resid), relu=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("z_pad", [1, 0])
def test_fused_down_conv_fold_occ(rng, z_pad):
    """Stride-2 down conv: output occupancy folded in (= occ_downsample)."""
    jg, tg, occ, feats, scale, bias = _conv_setup(rng, 4, 8, z=9)
    w = (rng.normal(size=(27, 4, 8)) * 0.3).astype(np.float32)
    jo = jpu.pillar_downsample_grid(jg, 128)
    to = tpu.pillar_downsample_grid(tg, 128)
    nbr = tpu.pillar_conv_neighbor_map(tg, to)
    ref, ref_occ = jfused(
        jnp.asarray(feats), jpu.pillar_conv_neighbor_map(jg, jo),
        jnp.asarray(w), z_stride=2, z_pad=z_pad, scale=jnp.asarray(scale),
        bias=jnp.asarray(bias), relu=True, occ_in=jnp.asarray(occ),
        fold_occ=True, interpret=True)
    ours, ours_occ = fused_pillar_conv(
        _t(feats), nbr, _t(w), z_stride=2, z_pad=z_pad, scale=_t(scale),
        bias=_t(bias), relu=True, occ_in=_t(occ), fold_occ=True)
    _eq(ours_occ, ref_occ)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_fused_conv_out_kb1(rng):
    """conv_out: kernel (3, 1, 1), stride (2, 1, 1), pad 0, identity map."""
    jg, tg, occ, feats, scale, bias = _conv_setup(rng, 8, 8, z=5)
    w = (rng.normal(size=(3, 8, 8)) * 0.3).astype(np.float32)
    ident = tpu.identity_map(tg)
    occ_out = tpu.occ_downsample(_t(occ), ident, 3, 2, 0)
    ref = jfused(jnp.asarray(feats), jnp.asarray(ident.numpy()),
                 jnp.asarray(w), kz=3, z_stride=2, z_pad=0,
                 scale=jnp.asarray(scale), bias=jnp.asarray(bias),
                 occ_out=jnp.asarray(occ_out.numpy()), relu=True,
                 interpret=True)
    ours = fused_pillar_conv(_t(feats), ident, _t(w), kz=3, z_stride=2,
                             z_pad=0, scale=_t(scale), bias=_t(bias),
                             occ_out=occ_out, relu=True)
    assert ours.shape == (256, 2, 8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
