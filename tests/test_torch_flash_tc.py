"""Kernels 3, 7 and 8 on the tensor cores (bf16, Dh 32), around the kernels,
on the CPU:

- `split_plan`, which splits the key walk of the kernels across blocks,
  covers every key tile exactly once, with no empty split, and fills at
  least a wave of the card at every shape the paths launch;
- a plain-torch emulation of the kernels' arithmetic (bf16 operands, P and
  dS rounded to bf16 before their products, float32 accumulators, the
  online softmax in the log2 domain tile by tile, the split partials
  merged or summed in split order) against the JAX `flash_attention_packed`,
  `flash_attention_kvmask(with_stats=True)` and `_flash_backward` Pallas
  kernels in interpret mode (dropout 0: the interpret path has no PRNG)
  and, at dropout 0.1, against the port's plain kernel 7, within the bf16
  tolerance the card holds the kernels to, 2e-2 of max |reference|.

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
    bq, bk = ta.FWD_TC_TILE
    plan = _check_plan(8 * -(-nq // bq), -(-nk // bk), sms)
    assert plan.splits > 1  # 40 blocks a split leave an H100 under a wave


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("nq,nk", TRAIN_SHAPES)
def test_dq_plan_covers_every_key_once_and_fills_a_wave(nq, nk, sms):
    bq, bk = ta.DQ_TC_TILE
    plan = _check_plan(8 * -(-nq // bq), -(-nk // bk), sms)
    assert plan.splits > 1  # 104 blocks a split leave an H100 under a wave


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("nq,nk", TRAIN_SHAPES)
def test_fwd_plan_covers_every_key_once_and_fills_a_wave(nq, nk, sms):
    bq, bk = ta.FWD_TC_TILE
    plan = _check_plan(8 * -(-nq // bq), -(-nk // bk), sms)
    assert plan.splits > 1  # 72 blocks a split leave an H100 under a wave


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


_F32_LOG2E = torch.tensor(LOG2E, dtype=torch.float32)
_F32_LN2 = torch.tensor(math.log(2.0), dtype=torch.float32)


def natural_max(m2):
    """Kernel 7's written m (csrc/flash_train.cu `fwd_tc::natural_max`): m2
    ln 2, or the float within two ulps of it whose float32 product with
    log2 e lies nearest m2 (first found on ties), so kernel 8's m log2 e
    gives the forward's m2 back."""
    best = m2 * _F32_LN2
    err = (best * _F32_LOG2E - m2).abs()
    up = dn = best
    for _ in range(2):
        up = torch.nextafter(up, torch.tensor(math.inf))
        dn = torch.nextafter(dn, torch.tensor(-math.inf))
        for cand in (up, dn):
            e = (cand * _F32_LOG2E - m2).abs()
            best = torch.where(e < err, cand, best)
            err = torch.minimum(e, err)
    return best


def emulate_fwd(q, k, v, k_bias, n_sms, rate=0.0, seed=0):
    """Kernel 7's tensor-core arithmetic on bf16-valued float32 (B, H, N, Dh)
    inputs: each split walks its key tiles with the online softmax in the
    log2 domain (s2 = s scale log2 e + bias log2 e, the max started at
    NEG_INF log2 e, keys past Nk absent), l summing every P, the dropped P
    zeroed (`dropout_keep`) and P rounded to bf16 for P V, the split's O
    scaled by 1 / (1 - rate); the splits' (m2, l, O) merged in split order,
    out rounded to bf16. Returns out, m (natural units, `natural_max`) and
    l."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    bq, bk = ta.FWD_TC_TILE
    key_tiles = -(-nk // bk)
    plan = ta.split_plan(b * h * -(-nq // bq), key_tiles, n_sms)
    scale2 = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32) * \
        _F32_LOG2E
    bias2 = (k_bias * _F32_LOG2E)[:, None, None, :]
    keep = None
    if rate > 0.0:
        keep = ta.dropout_keep(seed, rate, b * h, nq, nk).reshape(
            b, h, nq, nk)
    parts = []
    for rng in _ranges(plan, key_tiles):
        m = torch.full((b, h, nq), ta.NEG_INF) * _F32_LOG2E
        l = torch.zeros(b, h, nq)
        o = torch.zeros(b, h, nq, dh)
        for t in rng:
            sl = slice(t * bk, min(nk, (t + 1) * bk))
            s = q @ k[:, :, sl].transpose(-1, -2) * scale2 + bias2[..., sl]
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * alpha + p.sum(-1)
            if keep is not None:
                p = torch.where(keep[..., sl], p, 0.0)
            o = o * alpha[..., None] + _bf16(p) @ v[:, :, sl]
            m = mx
        parts.append((m, l, o * (1.0 / (1.0 - rate))))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    num = sum(o * torch.exp2(m - top)[..., None] for m, _, o in parts)
    den = sum(l * torch.exp2(m - top) for m, l, _ in parts)
    out = _bf16(num / den.clamp(min=1e-30)[..., None])
    return out, natural_max(top), den


def _train_inputs(rng, b, h, nq, nk, masked_row=True):
    """bf16-valued (B, H, N, 32) q (logit std 4), k, v; a per-key bias of
    0 or NEG_INF (a quarter masked) and, with `masked_row`, every key of
    the last batch row masked."""
    q, k, v = (_bf16(torch.from_numpy(
        rng.normal(size=(b, h, n, 32)).astype(np.float32)) * s)
        for n, s in ((nq, 4.0), (nk, 1.0), (nk, 1.0)))
    kb = np.where(rng.uniform(size=(b, nk)) < 0.25, ta.NEG_INF,
                  0.0).astype(np.float32)
    if masked_row:
        kb[-1] = ta.NEG_INF
    return q, k, v, kb


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
    # kernel 3 runs kernel 7's forward on (B, H, N, Dh) views, dropout 0
    got = emulate_fwd(*(_heads(x, heads) for x in (q, k, v)),
                      torch.from_numpy(kb), n_sms)[0]
    got = got.transpose(1, 2).reshape(b, nq, heads * 32)
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


def _pallas_fwd(q, k, v, kb, nq_pad, nk_pad):
    """The JAX `flash_attention_kvmask(with_stats=True)` Pallas kernel in
    interpret mode on whole blocks: queries zero-padded, keys padded with
    NEG_INF bias; the padding cropped from (out, m, l)."""
    nq, nk = q.shape[2], k.shape[2]
    pq = ((0, 0), (0, 0), (0, nq_pad - nq), (0, 0))
    pk = ((0, 0), (0, 0), (0, nk_pad - nk), (0, 0))
    kbp = np.pad(kb, ((0, 0), (0, nk_pad - nk)), constant_values=ta.NEG_INF)
    out, m, l = ja.flash_attention_kvmask(
        jnp.asarray(np.pad(q.numpy(), pq)), jnp.asarray(np.pad(k.numpy(), pk)),
        jnp.asarray(np.pad(v.numpy(), pk)), jnp.asarray(kbp), block_q=64,
        block_k=128, interpret=True, with_stats=True)
    return (np.asarray(out)[:, :, :nq], np.asarray(m)[:, :, :nq],
            np.asarray(l)[:, :, :nq])


@pytest.mark.parametrize("n_sms", [4, 132])
def test_emulated_fwd_matches_pallas_kernel(rng, n_sms):
    """Dropout 0, ragged edges (200 queries: a block's last warpgroup of 8
    real rows; 700 keys: a partial last tile), 4 SMs forcing splits of a
    few tiles: out, m and l of the first batch row against the Pallas
    kernel; the fully masked last row (m = NEG_INF, l = Nk, out the
    average of V) against the port's plain version, as the JAX kernel's
    padded keys join that row's sum."""
    b, h, nq, nk = 2, 2, 200, 700
    q, k, v, kb = _train_inputs(rng, b, h, nq, nk)
    ref = _pallas_fwd(q, k, v, kb, 256, 768)
    got = emulate_fwd(q, k, v, torch.from_numpy(kb), n_sms)
    for g, r, name in zip(got, ref, ("out", "m", "l")):
        _assert_within(g[0], r[0], name)
    plain = ta.flash_attention_kvmask_reference(q, k, v, torch.from_numpy(kb),
                                                True)
    for g, r, name in zip(got, plain, ("out", "m", "l")):
        _assert_within(g[1], r[1].numpy(), "fully masked row " + name)
    assert torch.equal(got[2][1], torch.full((h, nq), float(nk)))


@pytest.mark.parametrize("n_sms", [4, 132])
def test_emulated_fwd_with_dropout_matches_plain(rng, n_sms):
    """Dropout 0.1 against the port's plain kernel 7 (the same keep bits,
    `dropout_keep`): out, m and l, the fully masked row included."""
    b, h, nq, nk = 2, 2, 130, 333
    q, k, v, kb = _train_inputs(rng, b, h, nq, nk)
    kbt = torch.from_numpy(kb)
    got = emulate_fwd(q, k, v, kbt, n_sms, 0.1, 17)
    plain = ta.flash_attention_kvmask_reference(q, k, v, kbt, True, 0.1, 17)
    for g, r, name in zip(got, plain, ("out", "m", "l")):
        _assert_within(g, r.numpy(), name)
        _assert_within(g[1], r[1].numpy(), "fully masked row " + name)


@pytest.mark.parametrize("n_sms", [4, 132])
def test_emulated_fwd_feeds_the_emulated_backward(rng, n_sms):
    """Kernel 7's (out, m, l), emulated, through kernel 8's emulated
    arithmetic: dq, dk, dv and d(k_bias) against `_flash_backward` in
    interpret mode on the JAX forward's own statistics, dropout 0, with a
    fully masked batch row (its m must give the backward P = 1 / Nk back;
    512 keys, whole JAX blocks, so no padded key joins that row)."""
    b, h, nq, nk = 2, 2, 128, 512
    q, k, v, kb = _train_inputs(rng, b, h, nq, nk)
    do = _bf16(torch.from_numpy(rng.normal(size=(b, h, nq, 32)).astype(
        np.float32)))
    jq, jk, jv, jkb, jdo = (jnp.asarray(x) for x in (
        q.numpy(), k.numpy(), v.numpy(), kb, do.numpy()))
    out, m, l = ja.flash_attention_kvmask(jq, jk, jv, jkb, block_q=64,
                                          block_k=128, interpret=True,
                                          with_stats=True)
    ref = ja._flash_backward(jq, jk, jv, jkb, out, m, l, jdo, None, 64, 128,
                             True, 0.0)
    fwd = emulate_fwd(q, k, v, torch.from_numpy(kb), n_sms)
    got = emulate_bwd(q, k, v, torch.from_numpy(kb), *fwd, do, n_sms)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv", "dk_bias")):
        _assert_within(g, r, name)
        if name != "dk_bias":
            _assert_within(g[1], np.asarray(r)[1], "fully masked row " + name)
