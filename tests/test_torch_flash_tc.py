"""Kernels 3 and 8 on the tensor cores (bf16, Dh 32), around the kernels, on
the CPU:

- `split_plan`, which splits the key walk of both kernels across blocks,
  covers every key tile exactly once, with no empty split, and fills at
  least a wave of the card at every shape the paths launch;
- a plain-torch emulation of the kernels' arithmetic (bf16 operands, P and
  dS rounded to bf16 before their products, float32 accumulators, the
  online softmax in the log2 domain tile by tile, the split partials
  merged or summed in split order) against the JAX `flash_attention_packed`
  and `_flash_backward` Pallas kernels in interpret mode (dropout 0: the
  interpret path has no PRNG), within the bf16 tolerance the card holds
  the kernels to, 2e-2 of max |reference|.

The kernels themselves run only on the card (tests/test_torch_kernels.py,
chip_smoke.py).
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cmtcoop_tpu.ops import attention as ja
from cmtcoop_tpu_torch.ops import attention as ta

LOG2E = 1.4426950408889634
TOL = 2e-2  # of max |reference|, as on the card
# (queries, keys) of the decoder's cross-attentions: eval (kernel 3) at the
# LiDAR and fusion memories, train (kernel 8) at the fusion ones
EVAL_SHAPES = [(900, 32400), (900, 36400), (900, 44400)]
TRAIN_SHAPES = [(1540, 36400), (1540, 44400)]
SMS = [132, 114]  # H100 SXM, H100 PCIe


def _ranges(plan, key_tiles):
    return [range(s * plan.tiles_per_split,
                  min(key_tiles, (s + 1) * plan.tiles_per_split))
            for s in range(plan.splits)]


def _check_plan(row_blocks, key_tiles, sms):
    plan = ta.split_plan(row_blocks, key_tiles, sms)
    ranges = _ranges(plan, key_tiles)
    assert all(len(r) for r in ranges)
    assert sorted(t for r in ranges for t in r) == list(range(key_tiles))
    assert row_blocks * plan.splits >= min(sms, row_blocks * key_tiles)
    return plan


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("nq,nk", EVAL_SHAPES)
def test_packed_plan_covers_every_key_once_and_fills_a_wave(nq, nk, sms):
    bq, bk = ta.PACKED_TC_TILE
    plan = _check_plan(8 * -(-nq // bq), -(-nk // bk), sms)
    assert plan.splits > 1  # 40 blocks a split leave an H100 under a wave


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("nq,nk", TRAIN_SHAPES)
def test_dq_plan_covers_every_key_once_and_fills_a_wave(nq, nk, sms):
    bq, bk = ta.DQ_TC_TILE
    plan = _check_plan(8 * -(-nq // bq), -(-nk // bk), sms)
    assert plan.splits > 1  # 104 blocks a split leave an H100 under a wave


@pytest.mark.parametrize("row_blocks,key_tiles", [(1, 1), (2, 3), (40, 2),
                                                  (132, 300)])
def test_plan_at_the_edges(row_blocks, key_tiles):
    """One tile; fewer blocks than SMs at any split (one tile a split); a
    full wave unsplit (one split)."""
    plan = _check_plan(row_blocks, key_tiles, 132)
    if row_blocks * key_tiles <= 132:
        assert plan.splits == key_tiles
    if row_blocks == 132:
        assert plan.splits == 1


def test_tma_needs_16_byte_aligned_bases_and_strides():
    x = torch.zeros(1, 10, 256, dtype=torch.bfloat16)
    assert ta._tma_ready(x)
    shifted = torch.zeros(2561, dtype=torch.bfloat16)[1:].view(1, 10, 256)
    assert not ta._tma_ready(shifted)
    wide = torch.zeros(1, 10, 260, dtype=torch.bfloat16)
    assert not ta._tma_ready(wide[..., :256])


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _heads(x, h):
    b, n, c = x.shape
    return x.view(b, n, h, c // h).transpose(1, 2)


def emulate_packed(q, k, v, k_bias, heads, n_sms):
    """Kernel 3's tensor-core arithmetic on bf16-valued float32 (B, N, C)
    inputs: each split walks its key tiles with the online softmax in the
    log2 domain (max started at NEG_INF log2 e, keys past Nk absent), P
    rounded to bf16 for P V; the splits' (m, l, O) merged in split
    order."""
    b, nq, c = q.shape
    nk = k.shape[1]
    dh = c // heads
    bq, bk = ta.PACKED_TC_TILE
    qh, kh, vh = (_heads(x, heads) for x in (q, k, v))
    key_tiles = -(-nk // bk)
    plan = ta.split_plan(b * heads * -(-nq // bq), key_tiles, n_sms)
    scale2 = LOG2E / math.sqrt(dh)
    bias2 = (k_bias * LOG2E)[:, None, None, :]
    parts = []
    for rng in _ranges(plan, key_tiles):
        m = torch.full((b, heads, nq), ta.NEG_INF * LOG2E)
        l = torch.zeros(b, heads, nq)
        o = torch.zeros(b, heads, nq, dh)
        for t in rng:
            sl = slice(t * bk, min(nk, (t + 1) * bk))
            s = qh @ kh[:, :, sl].transpose(-1, -2) * scale2 + bias2[..., sl]
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + _bf16(p) @ vh[:, :, sl]
            m = mx
        parts.append((m, l, o))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    num = sum(o * torch.exp2(m - top)[..., None] for m, _, o in parts)
    den = sum(l * torch.exp2(m - top) for m, l, _ in parts)
    out = num / den.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).reshape(b, nq, c)


def emulate_bwd(q, k, v, k_bias, out, m, l, do, n_sms):
    """Kernel 8's tensor-core arithmetic on bf16-valued float32 (B, H, N, Dh)
    inputs, dropout 0: P = 2^(s log2e - m log2e) / max(l, 1e-30), dS = P
    (dP - delta); the dQ pass sums bf16(dS) K over each split's 64-key
    tiles and the splits' partials in split order; the dK/dV pass sums
    bf16(P)^T dO and bf16(dS)^T Q over 64-query tiles; d(k_bias) sums dS in
    float32."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    delta = (do * out).sum(-1, keepdim=True)
    s2 = (q @ k.transpose(-1, -2)) * (scale * LOG2E) + \
        (k_bias * LOG2E)[:, None, None, :]
    p = torch.exp2(s2 - (m * LOG2E)[..., None]) / l.clamp(min=1e-30)[..., None]
    ds = p * (do @ v.transpose(-1, -2) - delta)
    bq, bk = ta.DQ_TC_TILE
    key_tiles = -(-nk // bk)
    plan = ta.split_plan(b * h * -(-nq // bq), key_tiles, n_sms)
    dq = torch.zeros_like(q)
    for rng in _ranges(plan, key_tiles):
        part = torch.zeros_like(q)
        for t in rng:
            sl = slice(t * bk, min(nk, (t + 1) * bk))
            part = part + _bf16(ds[..., sl]) @ k[:, :, sl]
        dq = dq + part
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for q0 in range(0, nq, 64):
        sl = slice(q0, min(nq, q0 + 64))
        dv = dv + _bf16(p[:, :, sl]).transpose(-1, -2) @ do[:, :, sl]
        dk = dk + _bf16(ds[:, :, sl]).transpose(-1, -2) @ q[:, :, sl]
    return dq * scale, dk * scale, dv, ds.sum(dim=(1, 2))


def _assert_within(got, ref, name):
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= TOL * float(np.abs(ref).max()), (name, err)


@pytest.mark.parametrize("n_sms", [4, 132])
def test_emulated_packed_matches_pallas_kernel(rng, n_sms):
    """Ragged tiles (700 keys: five 128-key tiles, the last of 60), 4 SMs
    forcing splits of one or two tiles; a peaked softmax (logit std 4), a
    quarter of the keys masked with NEG_INF, one batch row fully masked:
    it averages V over the 700 keys, as the port's plain version does (the
    JAX kernel's zero keys padded to its block join its average, so that
    row is held to the plain version)."""
    b, nq, nk, heads = 2, 128, 700, 4
    q, k, v = (_bf16(torch.from_numpy(rng.normal(size=(b, n, heads * 32))
                                      .astype(np.float32)) * s)
               for n, s in ((nq, 4.0), (nk, 1.0), (nk, 1.0)))
    kb = np.where(rng.uniform(size=(b, nk)) < 0.25, ta.NEG_INF,
                  0.0).astype(np.float32)
    kb[1] = ta.NEG_INF
    # the JAX kernel takes whole blocks: keys padded to 768 with NEG_INF
    pad = ((0, 0), (0, 768 - nk), (0, 0))
    kbp = np.pad(kb, ((0, 0), (0, 768 - nk)), constant_values=ta.NEG_INF)
    ref = ja.flash_attention_packed(
        jnp.asarray(q.numpy()), jnp.asarray(np.pad(k.numpy(), pad)),
        jnp.asarray(np.pad(v.numpy(), pad)), jnp.asarray(kbp), heads,
        block_q=64, block_k=256, interpret=True)
    got = emulate_packed(q, k, v, torch.from_numpy(kb), heads, n_sms)
    _assert_within(got[0], np.asarray(ref)[0], "out")
    plain = ta.flash_attention_packed_reference(q, k, v, torch.from_numpy(kb),
                                                heads)
    _assert_within(got[1], plain[1].numpy(), "fully masked row")


@pytest.mark.parametrize("n_sms", [4, 132])
def test_emulated_backward_matches_pallas_backward(rng, n_sms):
    """dq, dk, dv and d(k_bias) against `_flash_backward` in interpret mode
    on its own forward's (out, m, l): 512 keys, a random per-key bias with
    NEG_INF keys, dropout 0."""
    b, h, nq, nk, dh = 1, 2, 128, 512, 32
    q, k, v, do = (_bf16(torch.from_numpy(
        rng.normal(size=(b, h, n, dh)).astype(np.float32)) * s)
        for n, s in ((nq, 4.0), (nk, 1.0), (nk, 1.0), (nq, 1.0)))
    kb = rng.normal(size=(b, nk)).astype(np.float32)
    kb[:, rng.uniform(size=nk) < 0.25] = ta.NEG_INF
    jq, jk, jv, jkb, jdo = (jnp.asarray(x) for x in (
        q.numpy(), k.numpy(), v.numpy(), kb, do.numpy()))
    out, m, l = ja.flash_attention_kvmask(jq, jk, jv, jkb, block_q=64,
                                          block_k=128, interpret=True,
                                          with_stats=True)
    ref = ja._flash_backward(jq, jk, jv, jkb, out, m, l, jdo, None, 64, 128,
                             True, 0.0)
    got = emulate_bwd(q, k, v, torch.from_numpy(kb),
                      *(torch.from_numpy(np.array(x)) for x in (out, m, l)),
                      do, n_sms)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv", "dk_bias")):
        _assert_within(g, r, name)
