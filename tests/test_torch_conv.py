"""Parity of the port's 3x3 conv + folded BN + ReLU (plain version and the
`ConvBNReLU` module) against the JAX `conv_bn_relu_cf` Pallas kernel in
interpret mode and the flax `ConvBNReLU`, on CPU, float32,
rtol = atol = 1e-4; the CUDA kernel against the plain version on the card.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cmtcoop_tpu.models.layers import ConvBNReLU as JConvBNReLU
from cmtcoop_tpu.models.layers import conv_bn_relu_cf
from cmtcoop_tpu_torch.models.layers import ConvBNReLU
from cmtcoop_tpu_torch.ops.conv_cf import conv3x3_bn_relu_reference, fold_bn

TOL = dict(rtol=1e-4, atol=1e-4)


def _variables(rng, cin, cout):
    k = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    return {"params": {"Conv_0": {"kernel": jnp.asarray(k)},
                       "BatchNorm_0": {
                           "scale": jnp.asarray(rng.uniform(0.5, 1.5, cout),
                                                jnp.float32),
                           "bias": jnp.asarray(rng.normal(size=cout) * 0.1,
                                               jnp.float32)}},
            "batch_stats": {"BatchNorm_0": {
                "mean": jnp.asarray(rng.normal(size=cout) * 0.3, jnp.float32),
                "var": jnp.asarray(rng.uniform(0.5, 2.0, cout),
                                   jnp.float32)}}}


def _module(v):
    p, s = v["params"], v["batch_stats"]
    cin, cout = p["Conv_0"]["kernel"].shape[2:]
    mod = ConvBNReLU(cin, cout)
    mod.load_state_dict({
        "conv.weight": torch.from_numpy(np.transpose(
            np.asarray(p["Conv_0"]["kernel"]), (3, 2, 0, 1)).copy()),
        "bn.weight": torch.tensor(np.asarray(p["BatchNorm_0"]["scale"])),
        "bn.bias": torch.tensor(np.asarray(p["BatchNorm_0"]["bias"])),
        "bn.running_mean": torch.tensor(np.asarray(
            s["BatchNorm_0"]["mean"])),
        "bn.running_var": torch.tensor(np.asarray(
            s["BatchNorm_0"]["var"]))})
    return mod.eval()


@pytest.mark.parametrize("shape", [(2, 12, 18, 24, 16), (1, 9, 7, 32, 40)])
def test_conv3x3_bn_relu_matches_pallas_kernel(rng, shape):
    b, h, w, cin, cout = shape
    v = _variables(rng, cin, cout)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    ref = conv_bn_relu_cf(v, jnp.asarray(x), jnp.float32, interpret=True)
    mod = _module(v)
    ours = mod(torch.from_numpy(x))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **TOL)
    scale, bias = mod.bn.fold()
    plain = conv3x3_bn_relu_reference(torch.from_numpy(x), mod.conv.weight,
                                      scale, bias)
    np.testing.assert_allclose(plain.detach().numpy(), np.asarray(ref), **TOL)


def test_module_matches_flax_conv_bn_relu(rng):
    """Against the flax module itself (the XLA path the JAX head takes on
    CPU)."""
    v = _variables(rng, 8, 12)
    x = rng.normal(size=(1, 10, 11, 8)).astype(np.float32)
    ref = JConvBNReLU(12, (3, 3)).apply(v, jnp.asarray(x), False)
    ours = _module(v)(torch.from_numpy(x))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **TOL)


def test_fold_bn_matches_flax_batchnorm(rng):
    c = 6
    g, b, m = (rng.normal(size=c).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2, c).astype(np.float32)
    x = rng.normal(size=(4, c)).astype(np.float32)
    bn = jax.tree.map(jnp.asarray, {
        "params": {"scale": g, "bias": b},
        "batch_stats": {"mean": m, "var": var}})
    import flax.linen as nn
    ref = nn.BatchNorm(use_running_average=True, epsilon=1e-3).apply(bn, x)
    s, sb = fold_bn(*(torch.from_numpy(a) for a in (g, b, m, var)), 1e-3)
    np.testing.assert_allclose((torch.from_numpy(x) * s + sb).numpy(),
                               np.asarray(ref), **TOL)
