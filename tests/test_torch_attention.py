"""Parity of the port's packed attention (plain version) against the JAX
`flash_attention_packed` kernel in Pallas interpret mode, on CPU, float32,
rtol = atol = 1e-4; the CUDA kernel against the plain version on the card.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cmtcoop_tpu.ops import attention as ja
from cmtcoop_tpu_torch.ops import attention as ta

TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(rng, b, nq, nk, c):
    return [rng.normal(size=(b, n, c)).astype(np.float32)
            for n in (nq, nk, nk)]


@pytest.mark.parametrize("heads,dh", [(4, 32), (16, 8)])
def test_packed_attention_matches_pallas_kernel(rng, heads, dh):
    """NEG_INF-padded keys, as the JAX decoder pads its token memory."""
    b, nq, nk = 2, 128, 512
    q, k, v = _qkv(rng, b, nq, nk, heads * dh)
    kb = np.zeros((b, nk), np.float32)
    kb[0, -100:] = ta.NEG_INF
    kb[1, -7:] = ta.NEG_INF
    ref = ja.flash_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kb),
        heads, block_q=64, block_k=256, interpret=True)
    ours = ta.flash_attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), torch.from_numpy(kb),
                                     heads)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_unpadded_keys_equal_padded_ones(rng):
    """The port pads nothing: attention over the 450 real keys equals the
    JAX kernel over keys padded to 512 with NEG_INF bias."""
    heads, dh, nq, nk = 4, 32, 64, 450
    q, k, v = _qkv(rng, 1, nq, nk, heads * dh)
    pad = ((0, 0), (0, 512 - nk), (0, 0))
    kb = np.zeros((1, 512), np.float32)
    kb[:, nk:] = ta.NEG_INF
    ref = ja.flash_attention_packed(
        jnp.asarray(q), jnp.asarray(np.pad(k, pad)),
        jnp.asarray(np.pad(v, pad)), jnp.asarray(kb), heads, block_q=64,
        block_k=256, interpret=True)
    ours = ta.flash_attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), None, heads)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_mha_reference_with_bias(rng):
    q, k, v = (rng.normal(size=(2, 3, n, 8)).astype(np.float32)
               for n in (10, 12, 12))
    bias = np.where(rng.uniform(size=(2, 1, 10, 12)) < 0.2, ta.NEG_INF,
                    0.0).astype(np.float32)
    ref = ja.mha_reference(*(jnp.asarray(x) for x in (q, k, v)),
                           jnp.asarray(bias))
    ours = ta.mha_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                            torch.from_numpy(bias))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
