"""Parity of the port's camera branch against the JAX package, on CPU, in
float32, rtol = atol = 1e-4:

- the plain versions of kernels 5 and 6 (`conv3x3_bn_relu` with a residual,
  `osa_aggregate` with its eSE sums) against the Pallas kernels
  `conv3x3_cf(residual=...)` and `osa_agg_cf` in interpret mode, at tiny
  shapes;
- `frustum_coords` and `depth_bins`;
- the port's `VoVNet("V-19-slim-eSE")` + `CPFPN` against the flax modules
  on one input, the weights carried across by `from_jax_variables`.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn as nn

from cmtcoop_tpu.core import pos_embed as jp
from cmtcoop_tpu.models.vovnet import CPFPN as JCPFPN
from cmtcoop_tpu.models.vovnet import VoVNet as JVoVNet
from cmtcoop_tpu.ops.conv_cf import conv3x3_cf, from_cf, osa_agg_cf, to_cf
from cmtcoop_tpu_torch.convert import from_jax_variables
from cmtcoop_tpu_torch.core import pos_embed as tp
from cmtcoop_tpu_torch.models.vovnet import CPFPN, VoVNet
from cmtcoop_tpu_torch.ops.conv_cf import (conv3x3_bn_relu_reference,
                                           osa_aggregate_reference)

TOL = dict(rtol=1e-4, atol=1e-4)


def _affine(rng, c):
    return (rng.uniform(0.5, 1.5, c).astype(np.float32),
            (rng.normal(size=c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("v,h,w,cin,cout", [(1, 11, 10, 16, 16),
                                            (2, 9, 13, 8, 12)])
def test_conv_residual_plain_matches_pallas_kernel(rng, v, h, w, cin, cout):
    """Kernel 5: acc * scale + bias, + residual, then ReLU."""
    x = rng.normal(size=(v, h, w, cin)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    scale, bias = _affine(rng, cout)
    res = rng.normal(size=(v, h, w, cout)).astype(np.float32)
    ref = from_cf(conv3x3_cf(to_cf(jnp.asarray(x)), jnp.asarray(wt), h, w,
                             scale=jnp.asarray(scale),
                             bias=jnp.asarray(bias), relu=True,
                             residual=to_cf(jnp.asarray(res)),
                             interpret=True), h, w)
    ours = conv3x3_bn_relu_reference(
        torch.from_numpy(x),
        torch.from_numpy(np.transpose(wt, (3, 2, 0, 1)).copy()),
        torch.from_numpy(scale), torch.from_numpy(bias),
        residual=torch.from_numpy(res))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("chans", [(8, 16), (16, 8, 8, 8),
                                   (12, 8, 8, 8, 8, 8)])
def test_osa_aggregate_plain_matches_pallas_kernel(rng, chans):
    """Kernel 6 over 2, 4 and 6 parts: the aggregate and its float32
    per-view sums."""
    v, h, w, cout = 2, 10, 14, 16
    parts = [rng.normal(size=(v, h, w, c)).astype(np.float32) for c in chans]
    wt = (rng.normal(size=(sum(chans), cout)) * 0.1).astype(np.float32)
    scale, bias = _affine(rng, cout)
    agg, gap = osa_agg_cf([to_cf(jnp.asarray(p)) for p in parts],
                          jnp.asarray(wt), jnp.asarray(scale),
                          jnp.asarray(bias), h, w, interpret=True)
    ours, ours_gap = osa_aggregate_reference(
        [torch.from_numpy(p) for p in parts], torch.from_numpy(wt),
        torch.from_numpy(scale), torch.from_numpy(bias))
    assert ours_gap.dtype == torch.float32 and ours_gap.shape == (v, cout)
    np.testing.assert_allclose(ours.numpy(), np.asarray(from_cf(agg, h, w)),
                               **TOL)
    np.testing.assert_allclose(ours_gap.numpy(), np.asarray(gap), **TOL)


@pytest.mark.parametrize("feat_hw,pad_hw,depth_num,max_range", [
    ((4, 8), (64, 128), 8, 16.0), ((40, 100), (640, 1600), 64, 72.0)])
def test_frustum_coords_and_depth_bins(feat_hw, pad_hw, depth_num,
                                       max_range):
    np.testing.assert_allclose(
        tp.depth_bins(depth_num, max_range).numpy(),
        np.asarray(jp.depth_bins(depth_num, max_range)), **TOL)
    ours = tp.frustum_coords(feat_hw, pad_hw, depth_num, max_range)
    ref = np.asarray(jp.frustum_coords(feat_hw, pad_hw, depth_num, max_range))
    assert ours.shape == ref.shape == (*feat_hw, depth_num, 4)
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)


def _perturbed(variables, rng):
    """Non-trivial BN statistics and affines on top of a flax init."""
    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        if name.endswith("['mean']") or name.endswith("['bias']"):
            return (rng.normal(size=x.shape) * 0.1).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, variables)


def test_vovnet_and_cpfpn_match_flax(rng):
    """V-19-slim-eSE (stages 4 and 5) + a 32-channel CPFPN on two 64x128
    views: every stage output and both neck levels."""
    feats = ("stage4", "stage5")
    x = rng.normal(size=(2, 64, 128, 3)).astype(np.float32)
    jnet = JVoVNet("V-19-slim-eSE", feats)
    jneck = JCPFPN(32)
    nv = _perturbed(jax.jit(jnet.init)(jax.random.PRNGKey(0), x), rng)
    ref_feats = jax.jit(jnet.apply)(nv, x)
    fv = _perturbed(jax.jit(jneck.init)(
        jax.random.PRNGKey(1), [ref_feats[k] for k in feats]), rng)
    ref_outs = jax.jit(jneck.apply)(fv, [ref_feats[k] for k in feats])

    port = nn.Module()
    port.img_backbone = VoVNet("V-19-slim-eSE", feats)
    port.img_neck = CPFPN([port.img_backbone.out_channels[k] for k in feats],
                          32)
    port.load_state_dict(from_jax_variables({
        "params": {"extractor": {"img_backbone": nv["params"],
                                 "img_neck": fv["params"]}},
        "batch_stats": {"extractor": {
            "img_backbone": nv["batch_stats"]}}}), strict=True)
    port.eval()
    with torch.inference_mode():
        ours = port.img_backbone(torch.from_numpy(x))
        outs = port.img_neck([ours[k] for k in feats])
    for k in feats:
        r = np.asarray(ref_feats[k])
        assert ours[k].shape == r.shape and float(np.abs(r).max()) > 0
        np.testing.assert_allclose(ours[k].numpy(), r, err_msg=k, **TOL)
    assert len(outs) == len(ref_outs) == 2
    for o, r in zip(outs, ref_outs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
