"""Sparse 3D voxel encoder with the reference's semantics, eval (counterpart
of cmtcoop_tpu/models/sparse_encoder.py, `encoder_impl="gather"`).

    conv_input: SubM(5->16, k3, p1) + BN + ReLU
    stage i:    SparseBasicBlock x n, SpConv(s2, p1; the last p(0, 1, 1))
    last stage: SparseBasicBlock x n
    conv_out:   SpConv(k(3,1,1), s(2,1,1), p0) + BN + ReLU, then .dense()

over a sorted voxel set (ops/sparse_utils.py): every neighbour map is one
`neighbor_map` (kernel 9 on the card), every conv one `gather_conv`. The
module tree and state keys are the pillar encoder's (`EncoderWeights`), so
one state_dict loads into either; the two compute the same function. BN is
folded in eval and multiplies by the voxel mask, as the JAX package's
`MaskedBatchNorm`. The train mode is not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from cmtcoop_tpu_torch.models.pillar_encoder import EncoderWeights
from cmtcoop_tpu_torch.ops import sparse_utils as su
from cmtcoop_tpu_torch.utils.profiling import span

# the padding (z, y, x) of each stride-2 down conv (encoder_paddings of the
# reference config; the basic blocks take none)
DOWN_PADS = ((1, 1, 1), (1, 1, 1), (0, 1, 1))
CONV_OUT = ((3, 1, 1), (2, 1, 1), (0, 0, 0))  # kernel, stride, padding


class SparseMaps(NamedTuple):
    """The integer work of one sample's encoder, computed before its convs:
    a submanifold map per stage and the gather map of each down conv and of
    `conv_out`, with their masks, the output grid, and the uncapped number
    of output sites of each downsample (against its stage cap)."""
    subm: Tuple[torch.Tensor, ...]    # per stage (V_i, 27)
    masks: Tuple[torch.Tensor, ...]   # per stage (V_i,), then conv_out's
    down: Tuple[torch.Tensor, ...]    # per down conv (V_i+1, 27), conv_out's
    out_grid: su.SparseGrid           # conv_out's sites
    n_sites: Tuple[torch.Tensor, ...]  # per downsample, incl. conv_out


def conv_block(mod, x, nbr, mask):
    """conv + BN + ReLU, the JAX `SparseConvBlock` (eval) on the shared
    `Sequential(SparseConvWeight, BatchNorm)`."""
    return torch.relu(mod[1].masked(su.gather_conv(x, nbr, mod[0].kernel()),
                                    mask))


def basic_block(blk, x, nbr, mask):
    """The JAX `SparseBasicBlock` (eval) on the shared `SparseBasicBlock`:
    conv1/norm1/ReLU, conv2/norm2, + identity, ReLU."""
    y = torch.relu(blk.norm1.masked(su.gather_conv(x, nbr, blk.conv1.kernel()),
                                    mask))
    y = blk.norm2.masked(su.gather_conv(y, nbr, blk.conv2.kernel()), mask)
    return torch.relu(y + x)


class SparseEncoder(EncoderWeights):
    """Voxel features (V, Cin) + coords (V, 3) + mask of one sample ->
    dense BEV (H/8, W/8, C_out * D_out); the active set after each downsample
    is capped at `stage_caps[i]`, after `conv_out` at `stage_caps[-1]`."""

    def __init__(self, in_channels: int = 5,
                 sparse_shape: Tuple[int, int, int] = (41, 1440, 1440),
                 base_channels: int = 16,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
                 output_channels: int = 128,
                 stage_caps: Sequence[int] = (60000, 60000, 60000, 60000)):
        super().__init__(in_channels, sparse_shape, base_channels,
                         encoder_channels, output_channels)
        self.stage_caps = tuple(stage_caps)

    @span("sparse maps")
    def maps(self, coords, mask) -> SparseMaps:
        """Every neighbour map and active set of one sample."""
        grid = su.SparseGrid(coords, mask, self.sparse_shape)
        subm, masks, down, n_sites = [], [], [], []
        n_stages = len(self.encoder_channels)
        for i in range(n_stages):
            keys = grid.linear_ids  # the stage's subm map and its down map
            subm.append(su.subm_neighbor_map(grid, keys=keys))
            masks.append(grid.mask)
            k, s, p, cap = ((3, 3, 3), (2, 2, 2), DOWN_PADS[i],
                            self.stage_caps[i]) if i < n_stages - 1 else (
                                *CONV_OUT, self.stage_caps[-1])
            out, n = su.downsample_output_grid(grid, k, s, p, cap,
                                               return_n=True)
            down.append(su.conv_neighbor_map(grid, out, k, s, p, keys=keys))
            n_sites.append(n)
            grid = out
        masks.append(grid.mask)
        return SparseMaps(tuple(subm), tuple(masks), tuple(down), grid,
                          tuple(n_sites))

    @span("sparse convs")
    def convs(self, x, maps: SparseMaps) -> torch.Tensor:
        """The conv chain over `maps`, then the densify: (H', W', C*D') in
        torch's `view(N, C*D, H, W)` channel order."""
        x = conv_block(self.conv_input, x, maps.subm[0], maps.masks[0])
        for i, (blocks, down) in enumerate(self.stages()):
            for blk in blocks:
                x = basic_block(blk, x, maps.subm[i], maps.masks[i])
            if down is not None:
                x = conv_block(down, x, maps.down[i], maps.masks[i + 1])
        x = conv_block(self.conv_out, x, maps.down[-1], maps.masks[-1])
        dense = su.sparse_to_dense(maps.out_grid, x)
        d, h, w, c = dense.shape
        return dense.permute(1, 2, 3, 0).reshape(h, w, c * d)

    def forward(self, feats, coords, mask, dtype=torch.float32):
        """One sample's voxels (from `voxelize` + `hard_simple_vfe`) ->
        (H', W', C*D') in `dtype`."""
        if self.training:
            raise NotImplementedError("the gather encoder's train mode is "
                                      "not ported")
        return self.convs(feats.to(dtype), self.maps(coords, mask))
