"""The bf16 tensor-core route of kernels 1 and 2 (csrc/pillar_conv.cu
`pillar_tc`) on the CPU: what surrounds the kernel, which runs only on the
card.

- `pack_pillar_weight` composed with a torch gather in the kernel's K order
  ((j, dz, ci), Cin zero-padded to 8, K to the 64-element step) over the
  compacted active rows is the GEMM the kernel computes: against the JAX
  `fused_pillar_conv` Pallas kernel in interpret mode and the port's plain
  version, float32, rtol = atol = 1e-5;
- `pillar_conv_plan` at every conv shape of the pillar encoder: the
  persistent blocks cover every active row once, one block all of Cout,
  the K table (replayed from the kernel) every (tap, dz, ci) once, and the
  shared memory fits;
- the packed operands the eval modules hold (`PillarConvPack`), rebuilt
  when a weight or BN tensor changes;
- the active rows compacted once per occupancy level in the eval encoder,
  equal to those of each conv's own occupancy;
- the bf16 shape check;
- the per-checkout timing script's launch weights and trace reading.
"""
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from cmtcoop_tpu.ops import pillars as jpu
from cmtcoop_tpu.ops.pillar_fused import fused_pillar_conv as jfused
from cmtcoop_tpu_torch.models import pillar_encoder as pe
from cmtcoop_tpu_torch.models.layers import BatchNorm, PillarConvPack
from cmtcoop_tpu_torch.ops import pillar_fused as pf
from cmtcoop_tpu_torch.ops import pillars as tpu
from cmtcoop_tpu_torch.ops.pillar_fused import (CHUNK, SM_SMEM, active_rows,
                                                cin_padded,
                                                fused_pillar_conv_reference,
                                                pack_pillar_weight,
                                                pillar_conv_plan)
from tests.test_torch_pillars import _grids, _t

TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132  # the SM count of an H100 SXM, which the plans are for
# each conv of the pillar encoder at the benchmark's caps: (KB, P_in, Z_in,
# Cin, P_out, Z_out, Cout, occupied output rows of the larger cloud)
ENCODER_CONVS = [
    (9, 38400, 41, 5, 38400, 41, 16, 33129),      # conv_input
    (9, 38400, 41, 16, 38400, 41, 16, 33129),     # level 0 (x4)
    (9, 38400, 41, 16, 40960, 21, 32, 76938),     # down into level 1
    (9, 40960, 21, 32, 40960, 21, 32, 76938),     # level 1 (x4)
    (9, 40960, 21, 32, 24064, 11, 64, 44011),     # down into level 2
    (9, 24064, 11, 64, 24064, 11, 64, 44011),     # level 2 (x4)
    (9, 24064, 11, 64, 11264, 5, 128, 10740),     # down into level 3
    (9, 11264, 5, 128, 11264, 5, 128, 10740),     # level 3 (x4)
    (1, 11264, 5, 128, 11264, 2, 128, 10125),     # conv_out
]


def k_table(kb, kz, cin_pad, ksteps):
    """The kernel's K table, replayed: piece i (elements 8i .. 8i + 7) of
    the (j, dz, ci) walk -> (j, dz, ci), or None past the end of K."""
    run = kz * cin_pad
    out = []
    for i in range(ksteps * 8):
        k = 8 * i
        if k >= kb * run:
            out.append(None)
            continue
        j = k // run
        dz = (k - j * run) // cin_pad
        out.append((j, dz, k - j * run - dz * cin_pad))
    return out


def kwalk_conv(feats, nbr, packed, rows, *, z_stride, z_pad, residual=None,
               relu=True):
    """The bf16 kernel's GEMM in float32 on the CPU: for each active row
    (p, zo), the K walk's pieces gathered as the kernel's K table names
    them (feats[nbr[p, j], zo * s + dz - pad, ci .. ci + 7], zero for a
    miss, a z outside the input and the K tail), times the packed weight,
    then the epilogue; inactive rows stay zero."""
    p_in, z_in, cin = feats.shape
    p_out, kb = nbr.shape
    kz, cout = packed.kz, packed.cout
    z_out = (z_in + 2 * z_pad - kz) // z_stride + 1
    cin_pad = cin_padded(cin)
    k_pad = packed.weight.shape[1]
    table = k_table(kb, kz, cin_pad, k_pad // CHUNK)
    x = F.pad(feats, (0, cin_pad - cin)).float()
    r = rows.rows[:int(rows.count)].long()
    p, zo = r // z_out, r % z_out
    pieces = []
    for e in table:
        if e is None:
            pieces.append(torch.zeros(len(r), 8))
            continue
        j, dz, ci = e
        src = nbr[p, j].long()
        zi = zo * z_stride + dz - z_pad
        ok = (src < p_in) & (zi >= 0) & (zi < z_in)
        v = x[src.clamp(max=p_in - 1), zi.clamp(0, z_in - 1), ci:ci + 8]
        pieces.append(v * ok[:, None])
    a = torch.cat(pieces, 1)
    y = (a @ packed.weight.float().t()) * packed.scale + packed.bias
    if residual is not None:
        y = y + residual.reshape(-1, cout)[r].float()
    if relu:
        y = torch.relu(y)
    out = torch.zeros(p_out * z_out, cout)
    out[r] = y
    return out.view(p_out, z_out, cout)


def _setup(rng, cin, cout, z=8):
    jg, tg = _grids(rng, z=z)
    occ = (rng.uniform(size=(256, z)) < 0.5) & np.asarray(jg.mask)[:, None]
    feats = (rng.normal(size=(256, z, cin)) * occ[..., None]).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32) * 0.1
    return jg, tg, occ, feats, scale, bias


@pytest.mark.parametrize("cin,cout", [(6, 8), (5, 16)])
def test_kwalk_subm_matches_pallas_kernel(rng, cin, cout):
    """A submanifold conv with a residual; Cin 5 (conv_input's, padded to
    8 as the wrapper pads its features) and 6."""
    jg, tg, occ, feats, scale, bias = _setup(rng, cin, cout)
    w = (rng.normal(size=(27, cin, cout)) * 0.3).astype(np.float32)
    resid = (rng.normal(size=(256, 8, cout)) * occ[..., None]).astype(
        np.float32)
    nbr = tpu.pillar_neighbor_map(tg)
    ref = jfused(jnp.asarray(feats), jnp.asarray(nbr.numpy()),
                 jnp.asarray(w), scale=jnp.asarray(scale),
                 bias=jnp.asarray(bias), occ_out=jnp.asarray(occ),
                 residual=jnp.asarray(resid), relu=True, subm=True,
                 interpret=True)
    packed = pack_pillar_weight(_t(w), _t(scale), _t(bias), torch.float32)
    assert packed.weight.shape == (cout, -(-27 * cin_padded(cin) // CHUNK)
                                   * CHUNK)
    ours = kwalk_conv(_t(feats), nbr, packed, active_rows(_t(occ)),
                      z_stride=1, z_pad=1, residual=_t(resid))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    plain = fused_pillar_conv_reference(
        _t(feats), nbr, _t(w), scale=_t(scale), bias=_t(bias),
        occ_out=_t(occ), residual=_t(resid), relu=True)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("z_pad", [1, 0])
def test_kwalk_down_conv_matches_pallas_kernel(rng, z_pad):
    """A stride-2 down conv, its output occupancy folded (= occ_downsample)
    and its rows compacted from that."""
    jg, tg, occ, feats, scale, bias = _setup(rng, 8, 16, z=9)
    w = (rng.normal(size=(27, 8, 16)) * 0.3).astype(np.float32)
    jo = jpu.pillar_downsample_grid(jg, 128)
    nbr = tpu.pillar_conv_neighbor_map(tg, tpu.pillar_downsample_grid(tg,
                                                                      128))
    ref, ref_occ = jfused(
        jnp.asarray(feats), jpu.pillar_conv_neighbor_map(jg, jo),
        jnp.asarray(w), z_stride=2, z_pad=z_pad, scale=jnp.asarray(scale),
        bias=jnp.asarray(bias), relu=True, occ_in=jnp.asarray(occ),
        fold_occ=True, interpret=True)
    occ_out = pf.fold_occupancy(_t(occ), nbr, 3, 2, z_pad)
    np.testing.assert_array_equal(occ_out.numpy(), np.asarray(ref_occ))
    packed = pack_pillar_weight(_t(w), _t(scale), _t(bias), torch.float32)
    ours = kwalk_conv(_t(feats), nbr, packed, active_rows(occ_out),
                      z_stride=2, z_pad=z_pad)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    plain, _ = fused_pillar_conv_reference(
        _t(feats), nbr, _t(w), z_stride=2, z_pad=z_pad, scale=_t(scale),
        bias=_t(bias), relu=True, occ_in=_t(occ), fold_occ=True)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), **TOL)


def test_kwalk_conv_out_kb1_matches_pallas_kernel(rng):
    """conv_out: KB 1 (the identity map), kz 3, stride 2, pad 0."""
    jg, tg, occ, feats, scale, bias = _setup(rng, 16, 8, z=5)
    w = (rng.normal(size=(3, 16, 8)) * 0.3).astype(np.float32)
    ident = tpu.identity_map(tg)
    occ_out = tpu.occ_downsample(_t(occ), ident, 3, 2, 0)
    ref = jfused(jnp.asarray(feats), jnp.asarray(ident.numpy()),
                 jnp.asarray(w), kz=3, z_stride=2, z_pad=0,
                 scale=jnp.asarray(scale), bias=jnp.asarray(bias),
                 occ_out=jnp.asarray(occ_out.numpy()), relu=True,
                 interpret=True)
    packed = pack_pillar_weight(_t(w), _t(scale), _t(bias), torch.float32)
    assert packed.kb == 1 and packed.weight.shape == (8, 3 * 16 + 16)
    ours = kwalk_conv(_t(feats), ident, packed, active_rows(occ_out),
                      z_stride=2, z_pad=0)
    assert ours.shape == (256, 2, 8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_packed_wrapper_on_cpu_takes_the_plain_version(rng):
    jg, tg, occ, feats, scale, bias = _setup(rng, 5, 8)
    w = _t((rng.normal(size=(27, 5, 8)) * 0.3).astype(np.float32))
    nbr = tpu.pillar_neighbor_map(tg)
    packed = pack_pillar_weight(w, _t(scale), _t(bias), torch.bfloat16)
    got = pf.fused_pillar_conv_packed(_t(feats), nbr, packed,
                                      occ_out=_t(occ), relu=True)
    torch.testing.assert_close(got, pf.fused_pillar_conv(
        _t(feats), nbr, w, scale=_t(scale), bias=_t(bias), occ_out=_t(occ),
        relu=True))
    assert packed.cin == 5 and packed.cout == 8 and packed.kz == 3


@pytest.mark.parametrize("conv", ENCODER_CONVS,
                         ids=lambda c: "x".join(map(str, c[:7])))
def test_plan_covers_every_row_and_k_once(conv):
    """The persistent walk of csrc/pillar_conv.cu, replayed: block b takes
    tiles b, b + grid, ... below ceil(count / BM); every count up to the
    bound covers each active row once. One block covers all of Cout; the K
    table names every (j, dz, ci < Cin) once and the padding reads
    nothing; the block's shared memory fits the SM; tiles of 64 rows where
    those of 128 leave the card under a wave at the benchmark's count."""
    kb, p_in, z_in, cin, p_out, z_out, cout, occupied = conv
    max_rows = p_out * z_out
    plan = pillar_conv_plan(kb, 3, cin, cout, max_rows, H100_SMS)
    assert plan.bn >= cout and plan.bn in pf.TC_WIDTHS
    for count in (1, plan.bm * plan.grid + 7, occupied, max_rows):
        n_tiles = -(-count // plan.bm)
        seen = np.zeros(n_tiles * plan.bm, np.int32)
        for b in range(plan.grid):
            for t in range(b, n_tiles, plan.grid):
                seen[t * plan.bm:(t + 1) * plan.bm] += 1
        assert (seen[:count] == 1).all()
    cin_pad = cin_padded(cin)
    assert cin_pad % 8 == 0 and cin_pad - cin < 8
    table = k_table(kb, 3, cin_pad, plan.ksteps)
    assert plan.ksteps * CHUNK - kb * 3 * cin_pad in range(CHUNK)
    hits = np.zeros((kb, 3, cin_pad), np.int32)
    for e in table:
        if e is not None:
            j, dz, ci = e
            assert ci + 8 <= cin_pad  # a piece lies inside one dz
            hits[j, dz, ci:ci + 8] += 1
    assert (hits == 1).all()
    assert plan.smem + pf.BLOCK_SMEM_RESERVED <= SM_SMEM
    assert plan.per_sm >= 1 and plan.grid <= H100_SMS * plan.per_sm
    wave_of_128 = -(-occupied // 128) >= H100_SMS
    assert plan.bm == (128 if wave_of_128 else 64)


def test_pack_orders_k_as_the_kernel_walks():
    w = torch.randn(27, 5, 16)
    packed = pack_pillar_weight(w, None, None, torch.float32)
    for i, e in enumerate(k_table(9, 3, 8, packed.weight.shape[1] // CHUNK)):
        cols = packed.weight[:, 8 * i:8 * i + 8]
        if e is None:
            assert not cols.any()
            continue
        j, dz, ci = e
        want = torch.zeros(16, 8)
        n = max(0, min(8, 5 - ci))
        want[:, :n] = w[dz * 9 + j, ci:ci + n].t()
        torch.testing.assert_close(cols, want, rtol=0, atol=0)


@pytest.mark.parametrize("kb,kz,cin,cout", [
    (9, 3, 16, 12),   # Cout not a multiple of 8
    (9, 3, 16, 256),  # Cout past one block's 128 columns
    (4, 3, 16, 16),   # KB other than 1 or 9
    (9, 4, 16, 16),   # kz past 3
    (9, 3, 160, 32),  # K past 64 steps
])
def test_bf16_shape_check_raises(kb, kz, cin, cout):
    with pytest.raises(ValueError, match="bfloat16 kernel takes"):
        pillar_conv_plan(kb, kz, cin, cout, 1000, H100_SMS)


def test_pillar_conv_pack_rebuilds_when_weights_change():
    conv = pe.SparseConvWeight(8, 16, (3, 3, 3))
    bn = BatchNorm(16, pe.BN_EPS, pe.BN_MOMENTUM)
    with torch.no_grad():
        conv.weight.normal_()
        bn.running_var.fill_(2.0)
    assert isinstance(conv.pack, PillarConvPack)
    first = conv.packed(bn, torch.float32)
    assert conv.packed(bn, torch.float32) is first
    s, b = bn.fold()
    torch.testing.assert_close(first.scale, s)
    torch.testing.assert_close(first.source, conv.kernel())
    for change in (lambda: conv.weight.mul_(2.0),
                   lambda: bn.running_mean.add_(1.0),
                   lambda: bn.weight.mul_(0.5)):
        with torch.no_grad():
            change()
        new = conv.packed(bn, torch.float32)
        assert new is not first
        torch.testing.assert_close(new.source, conv.kernel())
        torch.testing.assert_close(new.bias, bn.fold()[1])
        first = new
    assert conv.packed(bn, torch.bfloat16).weight.dtype == torch.bfloat16


def test_eval_encoder_shares_rows_per_level(rng, monkeypatch):
    """The eval encoder compacts the active rows once per occupancy: 5 a
    sample (level 0, the three down convs' folded occupancies, conv_out's)
    for its 21 convs, and each conv gets the rows of its own output
    occupancy; the output is the one of packing and compacting per conv."""
    enc = pe.PillarSparseEncoder(
        in_channels=5, sparse_shape=(41, 32, 32), base_channels=8,
        encoder_channels=((8, 8, 16), (16, 16, 32), (32, 32, 64), (64, 64)),
        output_channels=32, pillar_caps=(256, 256, 128, 64)).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    jg, tg = _grids(rng, z=41)
    occ = _t(rng.uniform(size=(256, 41)) < 0.3) & tg.mask[:, None]
    feats = torch.randn(256, 41, 5, generator=gen) * occ[..., None]
    calls, compactions = [], []
    conv, compact = pe.fused_pillar_conv_packed, pe.active_rows

    def recording_conv(x, nbr, packed, **kw):
        calls.append(kw)
        return conv(x, nbr, packed, **kw)

    def counting_rows(o):
        compactions.append(o)
        return compact(o)

    monkeypatch.setattr(pe, "fused_pillar_conv_packed", recording_conv)
    monkeypatch.setattr(pe, "active_rows", counting_rows)
    with torch.no_grad():
        got = enc(tg.coords, tg.mask, occ, feats)
    assert len(calls) == 21 and len(compactions) == 5
    for kw in calls:
        rows = kw["rows"]
        assert rows.occ is kw["occ_out"]
        fresh = compact(kw["occ_out"])
        n = int(fresh.count)
        assert int(rows.count) == n
        assert torch.equal(rows.rows[:n], fresh.rows[:n])
    monkeypatch.undo()
    # the same convs through the public wrapper, packing per call
    with torch.no_grad():
        x = pf.fused_pillar_conv(
            feats, tpu.pillar_neighbor_map(tg), enc.conv_input[0].kernel(),
            scale=enc.conv_input[1].fold()[0],
            bias=enc.conv_input[1].fold()[1], occ_out=occ, relu=True)
        y = pe.eval_conv(enc.conv_input, feats, tpu.pillar_neighbor_map(tg),
                         occ, active_rows(occ))
    torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert got.shape == (4, 4, 32 * 2)


def test_time_pillar_convs_weights_the_encoders_launches(tmp_path):
    """The per-checkout timing script: its 13 convs weigh to the encoder's
    21 launches an agent, and a trace's kernel time counts the pillar-conv
    kernels of either checkout (the CUDA-core kernel's name and the wgmma
    one's), not the occupancy fold or other kernels; an empty trace
    raises."""
    from cmtcoop_tpu_torch import time_pillar_convs as tpc
    assert sum(tpc._launches(c[0]) for c in tpc.CONVS) == 21
    trace = tmp_path / "trace.json"
    events = [
        dict(ph="X", cat="kernel", dur=5.0,
             name="void pillar_tc::pillar_conv_tc_kernel<64, 9>(...)"),
        dict(ph="X", cat="kernel", dur=7.0,
             name="void pillar_conv_kernel<__nv_bfloat16, 9>(...)"),
        dict(ph="X", cat="kernel", dur=3.0, name="pillar_occ_fold_kernel"),
        dict(ph="X", cat="cuda_runtime", dur=2.0,
             name="pillar_conv_tc_kernel launch"),
    ]
    trace.write_text(json.dumps(dict(traceEvents=events)))
    assert tpc._kernel_us(trace) == 12.0
    trace.write_text(json.dumps(dict(traceEvents=events[2:])))
    with pytest.raises(SystemExit, match="no pillar-conv kernel"):
        tpc._kernel_us(trace)
