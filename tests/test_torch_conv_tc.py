"""The bf16 tensor-core route of kernels 4 and 5 (csrc/conv3x3.cu) on the
CPU: what surrounds the kernel, which runs only on the card.

- `pack_conv3x3_weight` composed with a torch im2col in the kernel's K order
  ((tap, ci), channels zero-padded to the 64-channel chunk) is the GEMM the
  kernel computes: against the JAX `conv3x3_cf` Pallas kernel in interpret
  mode and the port's plain version, float32, rtol = atol = 1e-5;
- `conv3x3_plan` at every shape the fusion path launches: the grid covers
  every output pixel once, one block all of Cout, the K steps every (tap,
  channel) once, and 64-pixel tiles are taken where 128-pixel tiles leave
  the card under a wave;
- the bf16 shape check (Cin and Cout multiples of 8, Cout <= 256);
- the packed operands the eval modules hold (`ConvPack`), rebuilt when the
  weights change.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from cmtcoop_tpu.ops.conv_cf import conv3x3_cf, from_cf, to_cf
from cmtcoop_tpu_torch.models.layers import ConvBNReLU
from cmtcoop_tpu_torch.models.vovnet import OSAModule
from cmtcoop_tpu_torch.ops.conv_cf import (BOX_W, CHUNK, WIDTHS,
                                           conv3x3_bn_relu,
                                           conv3x3_bn_relu_packed,
                                           conv3x3_bn_relu_reference,
                                           conv3x3_plan, pack_conv3x3_weight)

TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132  # the SM count of an H100 SXM, which the plans are for
# kernel 4's shapes per fusion frame: (views, H, W, Cin, Cout); the VoVNet
# stages 2-5 of each agent (1 vehicle view, 3 infrastructure views) and the
# head's shared_conv
VOVNET = [(160, 400, 128, 128), (80, 200, 256, 160), (80, 200, 160, 160),
          (80, 200, 512, 160), (40, 100, 512, 192), (40, 100, 768, 192),
          (40, 100, 192, 192), (20, 50, 768, 224), (20, 50, 1024, 224),
          (20, 50, 224, 224)]
PATH_SHAPES = ([(v,) + s for s in VOVNET for v in (1, 3)]
               + [(1, 180, 180, 512, 256)])


def im2col_conv(x, packed, relu=True, residual=None):
    """The bf16 kernel's GEMM in float32 on the CPU: F.unfold's columns
    (row ci * 9 + tap) reordered to K = tap * cin_pad + ci with zero rows
    for ci >= Cin, times the packed weight, then the fused epilogue."""
    n, h, w, cin = x.shape
    cin_pad = packed.weight.shape[1] // 9
    cols = F.unfold(x.permute(0, 3, 1, 2), 3, padding=1)
    cols = cols.view(n, cin, 9, h * w).permute(0, 3, 2, 1)
    cols = F.pad(cols, (0, cin_pad - cin)).reshape(n, h * w, 9 * cin_pad)
    y = (cols @ packed.weight.t()).view(n, h, w, -1)
    y = y * packed.scale + packed.bias
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


@pytest.mark.parametrize("v,h,w,cin,cout,with_resid", [
    (1, 7, 9, 24, 40, False), (2, 5, 6, 40, 40, True),
    (1, 6, 17, 72, 16, False)])
def test_packed_im2col_matches_pallas_kernel(rng, v, h, w, cin, cout,
                                             with_resid):
    """Cin 24, 40 and 72 are not multiples of the 64-channel chunk."""
    x = rng.normal(size=(v, h, w, cin)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = (rng.normal(size=cout) * 0.1).astype(np.float32)
    res = (rng.normal(size=(v, h, w, cout)).astype(np.float32)
           if with_resid else None)
    ref = from_cf(conv3x3_cf(
        to_cf(jnp.asarray(x)), jnp.asarray(wt), h, w,
        scale=jnp.asarray(scale), bias=jnp.asarray(bias), relu=True,
        residual=None if res is None else to_cf(jnp.asarray(res)),
        interpret=True), h, w)
    weight = torch.from_numpy(np.transpose(wt, (3, 2, 0, 1)).copy())
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    r = None if res is None else torch.from_numpy(res)
    packed = pack_conv3x3_weight(weight, s, b, torch.float32)
    cin_pad = -(-cin // CHUNK) * CHUNK
    assert packed.weight.shape == (cout, 9 * cin_pad)
    assert packed.weight.is_contiguous()
    pad = packed.weight.view(cout, 9, cin_pad)[:, :, cin:]
    assert not pad.any()
    ours = im2col_conv(torch.from_numpy(x), packed, residual=r)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    plain = conv3x3_bn_relu_reference(torch.from_numpy(x), weight, s, b,
                                      residual=r)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), **TOL)


def test_packed_wrapper_on_cpu_takes_the_plain_version(rng):
    x = torch.from_numpy(rng.normal(size=(2, 5, 7, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(24, 16, 3, 3)).astype(np.float32))
    s, b = torch.full((24,), 0.5), torch.full((24,), 0.1)
    packed = pack_conv3x3_weight(w, s, b, torch.float32)
    torch.testing.assert_close(conv3x3_bn_relu_packed(x, packed),
                               conv3x3_bn_relu(x, w, s, b))
    assert packed.cin == 16 and packed.cout == 24


@pytest.mark.parametrize("shape", PATH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_output_and_k_once(shape):
    """The block decode and K order of csrc/conv3x3.cu, replayed: block bx
    is image bx / (tiles_h * tiles_w), box row (bx / tiles_w) % tiles_h, box
    column bx % tiles_w, all bn >= Cout channels; K step k is tap k /
    chunks, channels (k % chunks) * CHUNK ..."""
    n, h, w, cin, cout = shape
    plan = conv3x3_plan(n, h, w, cin, cout, H100_SMS)
    pixels = np.zeros((n, h, w), np.int32)
    for bx in range(n * plan.tiles_h * plan.tiles_w):
        img, rest = divmod(bx, plan.tiles_h * plan.tiles_w)
        ty, tx = divmod(rest, plan.tiles_w)
        box_h = 4 * plan.wg
        y0, x0 = ty * box_h, tx * BOX_W
        assert y0 < h and x0 < w  # no block without an output pixel
        pixels[img, y0:y0 + box_h, x0:x0 + BOX_W] += 1
    assert (pixels == 1).all()
    assert plan.bn in WIDTHS and cout <= plan.bn
    chunks = plan.cin_pad // CHUNK
    taps = np.zeros((9, cin), np.int32)
    for k in range(9 * chunks):
        tap, c = divmod(k, chunks)
        taps[tap, c * CHUNK:(c + 1) * CHUNK] += 1
    assert (taps == 1).all() and plan.cin_pad - cin < CHUNK
    # 128-pixel tiles only where they fill a wave of the card
    blocks = n * plan.tiles_h * plan.tiles_w
    big = n * -(-h // 8) * -(-w // BOX_W)
    assert (plan.wg == 2) == (big >= H100_SMS)
    assert blocks == (big if plan.wg == 2 else n * -(-h // 4) * -(-w // BOX_W))
    assert plan.bn - cout < 64


def test_plan_fills_stage_4_with_64_pixel_tiles():
    """Stage 4 (40x100, 192 channels): 70 and 210 blocks of 64 pixels
    where 128-pixel tiles would give 35 and 105."""
    for v, blocks in ((1, 70), (3, 210)):
        p = conv3x3_plan(v, 40, 100, 192, 192, H100_SMS)
        assert p.wg == 1 and p.bn == 192
        assert v * p.tiles_h * p.tiles_w == blocks
    p = conv3x3_plan(1, 180, 180, 512, 256, H100_SMS)
    assert (p.wg, p.bn, p.tiles_h * p.tiles_w) == (2, 256, 276)
    # a card with fewer SMs takes 128-pixel tiles sooner
    assert conv3x3_plan(3, 40, 100, 192, 192, 100).wg == 2


@pytest.mark.parametrize("cin,cout", [(12, 16), (16, 12), (512, 512)])
def test_bf16_plan_refuses_widths_tma_cannot_stride(cin, cout):
    """Cin or Cout not a multiple of 8 (TMA's 16-byte strides), or Cout
    wider than one block (256)."""
    with pytest.raises(ValueError, match="multiples of 8 and Cout <= 256"):
        conv3x3_plan(1, 8, 8, cin, cout, H100_SMS)


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.rand(v.shape, generator=g) + 0.5
            for k, v in module.state_dict().items()}


@pytest.mark.parametrize("change", ["load_state_dict", "in_place", "dtype"])
def test_conv_pack_is_rebuilt_when_the_weights_change(rng, change):
    mod = ConvBNReLU(16, 24).eval()
    mod.load_state_dict(_randomize(mod, 0))
    x = torch.from_numpy(rng.normal(size=(1, 6, 5, 16)).astype(np.float32))
    y0 = mod(x)
    first = mod.pack.packed
    torch.testing.assert_close(mod(x), y0)
    assert mod.pack.packed is first  # held, not rebuilt
    if change == "load_state_dict":
        mod.load_state_dict(_randomize(mod, 1))
    elif change == "in_place":
        with torch.no_grad():
            mod.bn.running_var.mul_(2.0)
    else:
        x = x.double()
    y1 = mod(x)
    assert mod.pack.packed is not first
    assert mod.pack.packed.weight.dtype == x.dtype
    s, b = mod.bn.fold()
    torch.testing.assert_close(y1, conv3x3_bn_relu_reference(
        x, mod.conv.weight, s, b))
    assert torch.allclose(y1.float(), y0) == (change == "dtype")


def test_osa_packs_follow_load_state_dict(rng):
    mod = OSAModule(8, 8, 16, 2, "OSA2_1", identity=False).eval()
    mod.load_state_dict(_randomize(mod, 0))
    x = torch.from_numpy(rng.normal(size=(1, 5, 6, 8)).astype(np.float32))
    mod(x)
    first = [p.packed for p in mod.packs]
    mod.load_state_dict(_randomize(mod, 1))
    mod(x)
    for p, old in zip(mod.packs, first):
        assert p.packed is not old
    layer = mod.layers[1]
    torch.testing.assert_close(mod.packs[1].packed.scale,
                               layer[1].fold()[0])
    assert torch.equal(mod.packs[1].packed.source, layer[0].weight)
