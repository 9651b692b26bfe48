"""Pillar-dense sparse voxel encoder (counterpart of `PillarSparseEncoder`
in cmtcoop_tpu/models/pillar_encoder.py).

The same function as mmdet3d's SparseEncoder (submanifold basic blocks,
strided down convs, `conv_out`), on sparse BEV pillars carrying dense z
tiles. Eval: every convolution is one `fused_pillar_conv_packed` (conv +
folded BN + residual + ReLU + occupancy, kernels 1 and 2) on operands its
module packs once (`PillarConvPack`) and on the active rows of its output
occupancy, compacted once per occupancy: level 0's serve `conv_input` and
that level's basic blocks, each down conv's folded occupancy the next
level's, and `conv_out` its own. Train, as the JAX train
path: the gather `pillar_conv` under autograd, each conv checkpointed (its
gathered (P, KB, Z, C) tiles are recomputed in the backward; keeping them
ran the JAX step out of memory), then BN with the statistics of the
occupied rows (`BatchNorm.masked`, the JAX `MaskedBatchNorm`: eps 1e-3,
flax momentum 0.99), ReLU and the occupancy mask. State keys follow the
reference
(`conv_input.0.weight` in spconv's (O, kz, ky, kx, I) layout, `conv_input.1`
BN, `encoder_layers.encoder_layer{i}.{j}.conv1/norm1/conv2/norm2`, the down
conv at index n_blocks, `conv_out.0/1`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from cmtcoop_tpu_torch.models.layers import BatchNorm, PillarConvPack
from cmtcoop_tpu_torch.ops import pillars as pu
from cmtcoop_tpu_torch.ops.pillar_fused import (active_rows, fold_occupancy,
                                                fused_pillar_conv_packed)
from cmtcoop_tpu_torch.utils.profiling import count

BN_EPS, BN_MOMENTUM = 1e-3, 0.99  # MaskedBatchNorm (flax momentum)
DOWN_ZPADS = (1, 1, 0)


class SparseConvWeight(nn.Module):
    """An spconv SubMConv3d / SparseConv3d weight, (O, kz, ky, kx, I)."""

    def __init__(self, cin: int, cout: int, k: Tuple[int, int, int]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, *k, cin))
        self.pack = PillarConvPack()

    def kernel(self) -> torch.Tensor:
        """(K = kz*ky*kx, I, O), z-major: the fused conv's layout."""
        w = self.weight
        return w.permute(1, 2, 3, 4, 0).reshape(-1, w.shape[-1], w.shape[0])

    def packed(self, bn: BatchNorm, dtype):
        """The eval operands with `bn` folded in, packed for `dtype` once."""
        return self.pack(self.weight, bn, dtype)


def eval_conv(mod: nn.Sequential, x, nbr, occ_out, rows, z_stride: int = 1,
              z_pad: int = 1):
    """conv + folded BN + ReLU on the active `rows` of occ_out (eval)."""
    return fused_pillar_conv_packed(
        x, nbr, mod[0].packed(mod[1], x.dtype), z_stride=z_stride,
        z_pad=z_pad, occ_out=occ_out, relu=True, rows=rows)


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, BN_EPS, BN_MOMENTUM)


def _conv_bn(cin: int, cout: int, k=(3, 3, 3)) -> nn.Sequential:
    return nn.Sequential(SparseConvWeight(cin, cout, k), _bn(cout))


def train_conv(x, nbr, conv: SparseConvWeight, kz: int = 3,
               z_stride: int = 1, z_pad: int = 1):
    """The gather convolution under a checkpoint (train mode)."""
    return checkpoint(pu.pillar_conv, x, nbr, conv.kernel(), kz, z_stride,
                      z_pad, use_reentrant=False)


def train_block(mod: nn.Sequential, x, nbr, occ_out, kz: int = 3,
                z_stride: int = 1, z_pad: int = 1):
    """conv + masked BN + ReLU + occupancy (the JAX `PillarConvBlock`,
    train)."""
    y = train_conv(x, nbr, mod[0], kz, z_stride, z_pad)
    return torch.relu(mod[1].masked(y, occ_out)) * occ_out[..., None]


class SparseBasicBlock(nn.Module):
    """Submanifold basic block: conv1/norm1/ReLU, conv2/norm2, +identity,
    ReLU, all on the same active sites."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = SparseConvWeight(c, c, (3, 3, 3))
        self.norm1 = _bn(c)
        self.conv2 = SparseConvWeight(c, c, (3, 3, 3))
        self.norm2 = _bn(c)

    def forward(self, x, nbr, occ, rows=None):
        """`rows`: the `active_rows` of occ (eval; compacted here if
        None)."""
        if self.training:
            m = occ[..., None]
            y = torch.relu(self.norm1.masked(train_conv(x, nbr, self.conv1),
                                             occ)) * m
            y = self.norm2.masked(train_conv(y, nbr, self.conv2), occ)
            return torch.relu(y + x) * m
        if rows is None:
            rows = active_rows(occ)
        y = fused_pillar_conv_packed(
            x, nbr, self.conv1.packed(self.norm1, x.dtype), occ_out=occ,
            relu=True, rows=rows)
        return fused_pillar_conv_packed(
            y, nbr, self.conv2.packed(self.norm2, x.dtype), occ_out=occ,
            residual=x, relu=True, rows=rows)


class EncoderWeights(nn.Module):
    """The module tree of mmdet3d's SparseEncoder that both encoders share
    (this pillar encoder and the gather `SparseEncoder` of
    models/sparse_encoder.py), so one state_dict loads into either."""

    def __init__(self, in_channels: int = 5,
                 sparse_shape: Tuple[int, int, int] = (41, 1440, 1440),
                 base_channels: int = 16,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
                 output_channels: int = 128):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.encoder_channels = tuple(tuple(c) for c in encoder_channels)
        self.conv_input = _conv_bn(in_channels, base_channels)
        self.encoder_layers = nn.Module()
        n_stages = len(self.encoder_channels)
        cin = base_channels
        for i, blocks in enumerate(self.encoder_channels):
            ch = blocks[0]
            n_sbb = len(blocks) - (0 if i == n_stages - 1 else 1)
            mods = [SparseBasicBlock(ch) for _ in range(n_sbb)]
            if i != n_stages - 1:
                mods.append(_conv_bn(ch, blocks[-1]))
            self.encoder_layers.add_module(f"encoder_layer{i + 1}",
                                           nn.Sequential(*mods))
            cin = blocks[-1]
        self.conv_out = _conv_bn(cin, output_channels, (3, 1, 1))

    def stages(self):
        """Per stage, (its basic blocks, its down conv or None for the
        last)."""
        n_stages = len(self.encoder_channels)
        for i in range(n_stages):
            mods = list(getattr(self.encoder_layers, f"encoder_layer{i + 1}"))
            yield mods, (mods.pop() if i != n_stages - 1 else None)


class PillarSparseEncoder(EncoderWeights):
    """Pillars of one sample -> dense BEV (H/8, W/8, C_out * Z_out)."""

    def __init__(self, in_channels: int = 5,
                 sparse_shape: Tuple[int, int, int] = (41, 1440, 1440),
                 base_channels: int = 16,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
                 output_channels: int = 128,
                 pillar_caps: Sequence[int] = (38400, 40960, 24064, 11264)):
        super().__init__(in_channels, sparse_shape, base_channels,
                         encoder_channels, output_channels)
        self.pillar_caps = tuple(pillar_caps)

    def forward(self, pcoords, pmask, occ, feats, dtype=torch.float32):
        """One sample's pillars (from `pillarize`) -> (H', W', C*Z') in
        `dtype`, channels in torch's `view(N, C*D, H, W)` order."""
        d, h, w = self.sparse_shape
        grid = pu.PillarGrid(pcoords, pmask, (h, w), d)
        x = feats.to(dtype)
        # each grid's sorted ids serve its subm map and the down map from it
        keys = grid.linear_ids
        nbr = pu.pillar_neighbor_map(grid, keys=keys)
        train = self.training
        rows = None if train else active_rows(occ)
        if train:
            x = train_block(self.conv_input, x, nbr, occ)
        else:
            x = eval_conv(self.conv_input, x, nbr, occ, rows)
        for i, (mods, down) in enumerate(self.stages()):
            for blk in mods:
                x = blk(x, nbr, occ, rows)
            if down is None:
                continue
            cap = self.pillar_caps[min(i + 1, len(self.pillar_caps) - 1)]
            out_grid, n_out = pu.pillar_downsample_grid(grid, cap,
                                                        return_n=True)
            count(f"pillars.l{i + 1}", n_out)  # before the cap
            nbr_dn = pu.pillar_conv_neighbor_map(grid, out_grid, keys=keys)
            zp = DOWN_ZPADS[i]
            if train:
                occ = pu.occ_downsample(occ, nbr_dn, 3, 2, zp)
                x = train_block(down, x, nbr_dn, occ, z_stride=2, z_pad=zp)
            else:
                occ = fold_occupancy(occ, nbr_dn, 3, 2, zp)
                rows = active_rows(occ)
                x = eval_conv(down, x, nbr_dn, occ, rows, z_stride=2,
                              z_pad=zp)
            grid = out_grid
            keys = grid.linear_ids
            nbr = pu.pillar_neighbor_map(grid, keys=keys)

        # conv_out: kernel (3, 1, 1), stride (2, 1, 1), pad 0 over the BEV
        # identity map
        ident = pu.identity_map(grid)
        occ_out = pu.occ_downsample(occ, ident, 3, 2, 0)
        if train:
            x = train_block(self.conv_out, x, ident, occ_out, z_stride=2,
                            z_pad=0)
        else:
            x = eval_conv(self.conv_out, x, ident, occ_out,
                          active_rows(occ_out), z_stride=2, z_pad=0)
        dense = pu.pillars_to_dense(
            pu.PillarGrid(grid.coords, grid.mask, grid.hw, x.shape[1]), x)
        hh, ww, zc = dense.shape
        zf = x.shape[1]
        return dense.reshape(hh, ww, zf, zc // zf).transpose(2, 3).reshape(
            hh, ww, zc)
