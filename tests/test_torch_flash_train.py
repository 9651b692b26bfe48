"""Parity of the port's training attention (the plain versions of kernels 7
and 8, `flash_attention_kvmask`, `flash_attention_bwd`, the autograd
`flash_attention_diff` and `attend`) against the JAX package's Pallas
kernels in interpret mode, on CPU, float32:

- forward output and (m, l) statistics, rtol = atol = 2e-4 (the Pallas
  kernel's online softmax sums in another order);
- gradients of q, k, v and k_bias, dropout 0, rtol = atol = 3e-4 (as
  tests/test_flash_attention.py holds the JAX kernels to mha_reference);
- dropout: the kernels' counter-based mask keeps 0.9 of the elements within
  binomial bounds, and the plain forward and backward with dropout equal
  autograd through `mha_reference` given the same mask (1e-5).
The CUDA kernels are held to these plain versions on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cmtcoop_tpu.ops import attention as ja
from cmtcoop_tpu_torch.ops import attention as ta

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)


def _inputs(rng, b, h, nq, nk, d, pad=0):
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32)
               for n in (nq, nk, nk))
    kb = np.zeros((b, nk), np.float32)
    if pad:
        kb[:, nk - pad:] = ta.NEG_INF
    return q, k, v, kb


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("pad", [0, 100])
def test_forward_and_stats_match_pallas_kernel(rng, pad):
    q, k, v, kb = _inputs(rng, 1, 2, 128, 512, 32, pad)
    out, m, l = ja.flash_attention_kvmask(
        *(jnp.asarray(x) for x in (q, k, v, kb)), block_q=64, block_k=128,
        interpret=True, with_stats=True)
    ours = ta.flash_attention_kvmask(*_t(q, k, v, kb), with_stats=True)
    for a, r, name in zip(ours, (out, m, l), ("out", "m", "l")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


def test_gradients_match_pallas_backward(rng):
    """Multiple query and key blocks on the JAX side, NEG_INF keys and a
    random per-key bias: dq, dk, dv and d(k_bias) (summed over heads)."""
    q, k, v, kb = _inputs(rng, 2, 2, 128, 512, 16, pad=64)
    kb[:, :448] = rng.normal(size=(2, 448)).astype(np.float32)
    tgt = rng.normal(size=q.shape).astype(np.float32)

    def loss(q_, k_, v_, kb_):
        o = ja.flash_attention_diff(q_, k_, v_, kb_, None, 64, 128, True)
        return jnp.sum((o - tgt) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, kb)))
    tq, tk, tv, tkb = (x.requires_grad_() for x in _t(q, k, v, kb))
    o = ta.flash_attention_diff(tq, tk, tv, tkb)
    ((o - torch.from_numpy(tgt)) ** 2).sum().backward()
    for ours, r, name in zip((tq, tk, tv, tkb), ref, ("q", "k", "v", "kb")):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(r),
                                   err_msg=name, **GRAD_TOL)
    assert float(tk.grad[:, :, 448:].abs().max()) < 1e-6


def test_dropout_keep_rate_is_binomial():
    keep = ta.dropout_keep(1234, 0.1, 8, 300, 700)
    n = keep.numel()
    rate = float(keep.float().mean())
    assert abs(rate - 0.9) < 5 * (0.9 * 0.1 / n) ** 0.5
    # a pure function of (seed, bh, i, j): the rows of bh 5 alone, and
    # another seed gives another mask
    assert torch.equal(keep[5:6], ta.dropout_keep(1234, 0.1, 1, 300, 700,
                                                  bh0=5))
    assert not torch.equal(keep, ta.dropout_keep(1235, 0.1, 8, 300, 700))


def test_dropout_forward_and_backward_equal_reference(rng):
    """Kernel 7/8's plain versions with dropout 0.1 against autograd through
    `mha_reference` with the same keep mask (no renormalisation)."""
    b, h, nq, nk, seed, rate = 2, 3, 40, 90, 77, 0.1
    q, k, v, kb = _inputs(rng, b, h, nq, nk, 8, pad=10)
    keep = ta.dropout_keep(seed, rate, b * h, nq, nk).reshape(b, h, nq, nk)
    args = [x.requires_grad_() for x in _t(q, k, v, kb)]
    ref = ta.mha_reference(*args[:3], args[3][:, None, None, :], rate, keep)
    g = torch.from_numpy(rng.normal(size=ref.shape).astype(np.float32))
    ref_grads = torch.autograd.grad((ref * g).sum(), args)
    ours = ta.flash_attention_diff(*args, seed=seed, dropout_rate=rate)
    grads = torch.autograd.grad((ours * g).sum(), args)
    torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-5)
    for a, r in zip(grads, ref_grads):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


def test_attend_dispatch(rng):
    """A 2D bias takes the plain path (as JAX `attend` on its XLA path);
    impl="flash" refuses one, and no third impl is taken; the flash path
    equals the plain one."""
    q, k, v, kb = _inputs(rng, 1, 2, 24, 40, 8, pad=5)
    bias = np.where(rng.uniform(size=(1, 1, 24, 40)) < 0.2, ta.NEG_INF,
                    0.0).astype(np.float32)
    ref = ja.attend(*(jnp.asarray(x) for x in (q, k, v)),
                    bias=jnp.asarray(bias), k_bias=jnp.asarray(kb))
    ours = ta.attend(*_t(q, k, v), bias=torch.from_numpy(bias),
                     k_bias=torch.from_numpy(kb))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="2D attention bias"):
        ta.attend(*_t(q, k, v), bias=torch.from_numpy(bias), impl="flash")
    with pytest.raises(ValueError, match="impl must be"):
        ta.attend(*_t(q, k, v), impl="auto")
    flash = ta.attend(*_t(q, k, v), k_bias=torch.from_numpy(kb),
                      impl="flash")
    plain = ta.attend(*_t(q, k, v), k_bias=torch.from_numpy(kb))
    torch.testing.assert_close(flash, plain, rtol=1e-5, atol=1e-5)
