"""The bf16 tensor-core route of kernel 6 (csrc/osa_agg.cu) on the CPU: what
surrounds the kernel, which runs only on the card.

- `pack_osa_weight` put through the kernel's K walk in float32 (each part
  in 64-channel chunks, only the 16-deep slices that hold real channels)
  is the GEMM the kernel computes: against the JAX `osa_agg_cf` Pallas
  kernel in interpret mode and the port's plain version, float32,
  rtol = atol = 1e-4, with parts whose channel counts are not whole chunks;
- `osa_agg_plan` at every shape the fusion path launches: the grid covers
  every pixel of every view and every Cout column once, the K steps every
  channel of every part once, and narrower tiles are taken where 128 x 256
  tiles leave the card under a wave: the tiles a timing sweep on the card
  found fastest;
- the bf16 shape check (channel counts multiples of 8);
- the packed operands an eval OSA block holds (`AggPack`), rebuilt when
  the weights or the dtype change.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from cmtcoop_tpu.ops.conv_cf import from_cf, osa_agg_cf, to_cf
from cmtcoop_tpu_torch.models.vovnet import OSAModule
from cmtcoop_tpu_torch.ops.conv_cf import (AGG_BM, AGG_WIDTHS, CHUNK, AggPlan,
                                           agg_k_offsets, agg_plan_cost,
                                           osa_agg_plan, osa_aggregate,
                                           osa_aggregate_packed,
                                           osa_aggregate_reference,
                                           pack_osa_weight)

TOL = dict(rtol=1e-4, atol=1e-4)
H100_SMS = 132  # the SM count of an H100 SXM, which the plans are for
# kernel 6's shapes per fusion frame, (views, H, W, parts' channels, Cout):
# each OSA block's aggregate of VoVNet-99 (a stage's first block, then the
# others), for the vehicle (1 view) and infrastructure (3 views) cameras
FUSION_BLOCKS = [(160, 400, 128, 128, 256), (80, 200, 256, 160, 512),
                 (80, 200, 512, 160, 512), (40, 100, 512, 192, 768),
                 (40, 100, 768, 192, 768), (20, 50, 768, 224, 1024),
                 (20, 50, 1024, 224, 1024)]
PATH_SHAPES = [(v, h, w, (cin,) + (ch,) * 5, cout)
               for h, w, cin, ch, cout in FUSION_BLOCKS for v in (1, 3)]


def k_walk(chans):
    """The K steps of csrc/osa_agg.cu in its order, (part, c0, koff,
    slices): every part's chunks of more than 32 channels first, four
    16-deep slices each, then the tails of at most 32, two slices each."""
    steps = []
    for full in (True, False):
        koff = 0
        for i, c in enumerate(chans):
            for c0 in range(0, c, CHUNK):
                if (c - c0 > CHUNK // 2) == full:
                    steps.append((i, c0, koff, 4 if full else 2))
            koff += -(-c // CHUNK) * CHUNK
    return steps


def kernel_gemm(parts, packed):
    """The bf16 kernel's K walk in float64 on the CPU: per step, the
    chunk's issued 16-deep slices of A (zero past the part's channels),
    each times the packed weight's K columns koff + c0 + 16 kk ..; then
    bias, ReLU and the per-view sums."""
    v, h, w = parts[0].shape[:3]
    acc = torch.zeros(v, h * w, packed.cout, dtype=torch.float64)
    a = [F.pad(p.reshape(v, h * w, -1).double(), (0, CHUNK)) for p in parts]
    for i, c0, koff, slices in k_walk(packed.chans):
        for kk in range(slices):
            k = c0 + 16 * kk
            acc += a[i][..., k:k + 16] @ packed.weight[
                :, koff + k:koff + k + 16].double().t()
    y = torch.relu(acc + packed.bias.double()).float()
    return y.view(v, h, w, -1), y.sum(dim=1)


@pytest.mark.parametrize("v,h,w,chans,cout", [
    (2, 10, 14, (24, 40, 40, 40), 16), (1, 9, 7, (160, 224, 8), 24),
    (3, 5, 6, (64, 72), 40)])
def test_packed_weight_matches_pallas_kernel(rng, v, h, w, chans, cout):
    """Channel counts 24, 40, 72, 160, 224 and 8 are not whole 64-channel
    chunks: the packed weight's zero columns meet the zero-filled tails."""
    parts = [rng.normal(size=(v, h, w, c)).astype(np.float32) for c in chans]
    wt = (rng.normal(size=(sum(chans), cout)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = (rng.normal(size=cout) * 0.1).astype(np.float32)
    agg, gap = osa_agg_cf([to_cf(jnp.asarray(p)) for p in parts],
                          jnp.asarray(wt), jnp.asarray(scale),
                          jnp.asarray(bias), h, w, interpret=True)
    tparts = [torch.from_numpy(p) for p in parts]
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    packed = pack_osa_weight(torch.from_numpy(wt), s, b, chans,
                             torch.float32)
    offs = agg_k_offsets(chans)
    assert packed.weight.shape == (cout, offs[-1])
    assert packed.weight.is_contiguous() and packed.chans == chans
    for c, k0, k1 in zip(chans, offs, offs[1:]):
        assert (k1 - k0) % CHUNK == 0 and 0 <= k1 - k0 - c < CHUNK
        assert not packed.weight[:, k0 + c:k1].any()
    ours, ours_gap = kernel_gemm(tparts, packed)
    np.testing.assert_allclose(ours.numpy(), np.asarray(from_cf(agg, h, w)),
                               **TOL)
    np.testing.assert_allclose(ours_gap.numpy(), np.asarray(gap), **TOL)
    plain, plain_gap = osa_aggregate_reference(tparts, torch.from_numpy(wt),
                                               s, b)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(ours_gap.numpy(), plain_gap.numpy(), **TOL)


def test_packed_wrapper_on_cpu_takes_the_plain_version(rng):
    parts = [torch.from_numpy(rng.normal(size=(2, 4, 5, c)).astype(
        np.float32)) for c in (16, 8, 8)]
    wt = torch.from_numpy(rng.normal(size=(32, 24)).astype(np.float32))
    s, b = torch.full((24,), 0.5), torch.full((24,), 0.1)
    packed = pack_osa_weight(wt, s, b, (16, 8, 8), torch.float32)
    got = osa_aggregate_packed(parts, packed)
    for a, r in zip(got, osa_aggregate(parts, wt, s, b)):
        torch.testing.assert_close(a, r)
    assert packed.cout == 24 and not packed.tc_maps


@pytest.mark.parametrize("shape", PATH_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:3]))
                         + f"-{sum(s[3])}-{s[4]}")
def test_plan_covers_every_output_and_k_once(shape):
    """The block decode and K walk of csrc/osa_agg.cu, replayed: block bx
    is column tile bx % col_tiles, then pixel tile (bx / col_tiles) %
    tiles of view bx / (col_tiles * tiles); the K steps (`k_walk`) cover
    every channel of every part once, at koff_i + c0."""
    v, h, w, chans, cout = shape
    hw = h * w
    plan = osa_agg_plan(v, hw, chans, cout, H100_SMS)
    bm = AGG_BM
    assert plan.bn in AGG_WIDTHS
    cover = np.zeros((v, plan.tiles * bm, plan.col_tiles * plan.bn),
                     np.int32)
    for bx in range(v * plan.tiles * plan.col_tiles):
        col, rest = bx % plan.col_tiles, bx // plan.col_tiles
        tile, view = rest % plan.tiles, rest // plan.tiles
        m0, n0 = tile * bm, col * plan.bn
        assert view < v and m0 < hw and n0 < cout  # no empty block
        cover[view, m0:m0 + bm, n0:n0 + plan.bn] += 1
    assert (cover[:, :hw, :cout] == 1).all()
    assert 0 <= plan.col_tiles * plan.bn - cout < plan.bn
    rows = np.zeros(plan.kpad, np.int32)
    for i, c0, koff, slices in k_walk(chans):
        real = min(chans[i], c0 + CHUNK) - c0
        assert 16 * slices >= real  # the issued slices hold every channel
        rows[koff + c0:koff + c0 + real] += 1
    assert rows.sum() == sum(chans) and rows.max() == 1
    assert plan.kpad == agg_k_offsets(chans)[-1]
    # never a longer modelled time than 128 x 256 tiles, and where these
    # leave the card under a wave (stage 4 V1 and stage 5), a grid that
    # fills at least 95% of one (the tiles the sweep measured fastest
    # leave 4 of 132 SMs idle at stage 4 V1 and stage 5 V1)
    big = AggPlan(256, -(-hw // AGG_BM), -(-cout // 256), plan.kpad)
    assert agg_plan_cost(plan, v, H100_SMS) <= agg_plan_cost(big, v,
                                                             H100_SMS)
    if v * big.blocks < H100_SMS:
        assert v * plan.blocks >= 0.95 * H100_SMS


def test_plan_takes_the_tiles_measured_fastest():
    """The plan's tile at the fusion path's shapes: 128 x 128 at stage 2
    (K 768: two blocks an SM hide each other's epilogue), 128 x 256 at
    stage 3, 128 x 192 at stage 4 (its Cout 768 in four whole columns:
    2.9 waves of 384 blocks at V3, 128 blocks at V1, where 128 x 256 tiles
    give 96), 128 x 128 at stage 5 V3 and 128 x 64 at stage 5 V1 (192 and
    128 blocks, where 128 x 256 tiles give 96 and 32)."""
    def plan(v, hw, cin, ch, cout, n_sms=H100_SMS):
        p = osa_agg_plan(v, hw, (cin,) + (ch,) * 5, cout, n_sms)
        return p.bn, v * p.blocks
    assert plan(3, 64000, 128, 128, 256) == (128, 3000)
    assert plan(1, 64000, 128, 128, 256) == (128, 1000)
    assert plan(3, 16000, 512, 160, 512) == (256, 750)
    assert plan(1, 4000, 768, 192, 768) == (192, 128)
    assert plan(3, 4000, 768, 192, 768) == (192, 384)
    assert plan(3, 1000, 1024, 224, 1024) == (128, 192)
    assert plan(1, 1000, 1024, 224, 1024) == (64, 128)
    # on a card of 96 SMs 128 x 256 tiles fill stage 4 V3 in 3 waves
    assert plan(3, 4000, 768, 192, 768, 96) == (256, 288)
    # Cout under 256 takes no tile wider than it needs
    assert osa_agg_plan(8, 64000, (16,) * 2, 40, H100_SMS).bn == 64


@pytest.mark.parametrize("chans,cout", [((16, 12), 24), ((16, 8), 20),
                                        ((0, 8), 16)])
def test_bf16_plan_refuses_widths_tma_cannot_stride(chans, cout):
    """A part or Cout not a multiple of 8 (TMA's 16-byte strides, bf16
    pairs in the epilogue) raises before any launch."""
    with pytest.raises(ValueError, match="multiples of 8"):
        osa_agg_plan(1, 64, chans, cout, H100_SMS)


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.rand(v.shape, generator=g) + 0.5
            for k, v in module.state_dict().items()}


@pytest.mark.parametrize("change", ["load_state_dict", "in_place", "dtype"])
def test_osa_agg_pack_is_rebuilt_when_the_weights_change(rng, change):
    mod = OSAModule(8, 8, 16, 2, "OSA2_1", identity=False).eval()
    mod.load_state_dict(_randomize(mod, 0))
    x = torch.from_numpy(rng.normal(size=(1, 5, 6, 8)).astype(np.float32))
    y0 = mod(x)
    first = mod.agg_pack.packed
    assert first.chans == (8, 8, 8)
    torch.testing.assert_close(mod(x), y0)
    assert mod.agg_pack.packed is first  # held, not rebuilt
    if change == "load_state_dict":
        mod.load_state_dict(_randomize(mod, 1))
    elif change == "in_place":
        with torch.no_grad():
            mod.concat[1].running_var.mul_(2.0)
    else:
        x = x.double()
    y1 = mod(x)
    packed = mod.agg_pack.packed
    assert packed is not first and packed.weight.dtype == x.dtype
    s, b = mod.concat[1].fold()
    torch.testing.assert_close(packed.scale, s)
    torch.testing.assert_close(packed.bias, b)
    assert torch.equal(packed.source, mod.concat[0].weight[:, :, 0, 0].t())
    assert torch.allclose(y1.float(), y0) == (change == "dtype")
