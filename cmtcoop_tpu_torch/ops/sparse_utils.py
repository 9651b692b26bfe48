"""Static-shape sparse 3D tensors: sorted voxel sets, neighbour maps, the
gather convolution and the densify (counterpart of
cmtcoop_tpu/ops/sparse_utils.py).

A sparse tensor is (coords (V, 3) int32 (z, y, x), mask (V,)) with the
active voxels first in ascending linear (z, y, x) order and padding rows
(coords -1, mask false) after them; features are (V, C). Every neighbour
map is one `neighbor_map` of the output sites in the input grid's sorted
linear ids (kernel 9 on the card, one launch a map), which is exact at any
density, so the JAX package's windows, overflow guards and exact fallbacks
have no counterpart here. Misses map to row V, the zero row `gather_conv`
appends. The integer maps equal the JAX package's exactly. The map code
passes kernel sizes, strides, pads and bounds as Python ints, so building
a map makes no host-to-device copy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

# sorted_lookup: the lookup of arbitrary queries, here as in the JAX module
from cmtcoop_tpu_torch.ops.lookup_kernel import (INT32_MAX, neighbor_map,
                                                 sorted_lookup)  # noqa: F401


class SparseGrid(NamedTuple):
    """Active voxel set over a (D, H, W) grid, sorted by linear id."""
    coords: torch.Tensor          # (V, 3) int32 (z, y, x); -1 on padding
    mask: torch.Tensor            # (V,) bool
    shape: Tuple[int, int, int]   # static (D, H, W)

    @property
    def linear_ids(self) -> torch.Tensor:
        """(V,) int32 (z*H + y)*W + x, INT32_MAX on padding rows."""
        _, h, w = self.shape
        c = self.coords.long()
        lin = (c[:, 0] * h + c[:, 1]) * w + c[:, 2]
        return torch.where(self.mask, lin, INT32_MAX).to(torch.int32)


def subm_neighbor_map(grid: SparseGrid,
                      kernel_size: Sequence[int] = (3, 3, 3),
                      keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(V, K) gather map of a submanifold conv on `grid` (output sites =
    input sites), kernel centred; misses and padding rows -> V. `keys`:
    the grid's `linear_ids`, where the caller holds them."""
    return neighbor_map(grid.linear_ids if keys is None else keys,
                        grid.coords, grid.mask, grid.shape, kernel_size, 1,
                        tuple((k - 1) // 2 for k in kernel_size))


def _out_shape(shape, kernel_size, stride, padding):
    return tuple((shape[a] + 2 * padding[a] - kernel_size[a]) // stride[a]
                 + 1 for a in range(3))


def downsample_output_grid(grid: SparseGrid, kernel_size: Sequence[int],
                           stride: Sequence[int], padding: Sequence[int],
                           max_out: int, return_n: bool = False):
    """Active output set of a strided sparse conv (spconv SparseConv3d):
    every output site whose receptive field holds an active input, sorted,
    the first `max_out` kept. Per axis an input p feeds the outputs o with
    o*s + k - pad = p, k in [0, ksize); the unique sites come from a sort
    and a scatter of the ranks (`pillar_downsample_grid`'s method, where
    the JAX package binary-searches the ranks). With `return_n`, also the
    true (uncapped) number of output sites."""
    out_shape = _out_shape(grid.shape, kernel_size, stride, padding)
    dev = grid.coords.device
    cands, valids = [], []
    for a in range(3):
        p = grid.coords[:, a].long()
        s, k, pad = stride[a], kernel_size[a], padding[a]
        lo = -torch.div(-(p + pad - k + 1), s, rounding_mode="floor")
        hi = torch.div(p + pad, s, rounding_mode="floor")
        o = lo[:, None] + torch.arange((k + s - 1) // s, device=dev)
        cands.append(o)
        valids.append((o <= hi[:, None]) & (o >= 0) & (o < out_shape[a]))
    _, oh, ow = out_shape
    lin = ((cands[0][:, :, None, None] * oh + cands[1][:, None, :, None])
           * ow + cands[2][:, None, None, :])
    ok = (valids[0][:, :, None, None] & valids[1][:, None, :, None]
          & valids[2][:, None, None, :] & grid.mask[:, None, None, None])
    slin = torch.sort(torch.where(ok, lin, INT32_MAX).reshape(-1)).values
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      slin[1:] != slin[:-1]]) & (slin != INT32_MAX)
    rank = torch.cumsum(head.long(), 0) - 1
    n_uniq = head.sum()
    uniq = torch.full((max_out + 1,), INT32_MAX, dtype=torch.long, device=dev)
    uniq.scatter_(0, torch.where(head & (rank < max_out), rank, max_out),
                  slin)
    uniq = uniq[:max_out]
    out_mask = torch.arange(max_out, device=dev) < n_uniq
    zyx = torch.stack([uniq // (oh * ow), (uniq // ow) % oh, uniq % ow], -1)
    coords = torch.where(out_mask[:, None], zyx, -1).to(torch.int32)
    out = SparseGrid(coords, out_mask, out_shape)
    return (out, n_uniq) if return_n else out


def conv_neighbor_map(in_grid: SparseGrid, out_grid: SparseGrid,
                      kernel_size: Sequence[int], stride: Sequence[int],
                      padding: Sequence[int],
                      keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(V_out, K) gather map into `in_grid` rows of a strided conv: the
    input of output o at tap k is o*s + k - pad; misses -> V_in. `keys`:
    the input grid's `linear_ids`, where the caller holds them."""
    return neighbor_map(in_grid.linear_ids if keys is None else keys,
                        out_grid.coords, out_grid.mask, in_grid.shape,
                        kernel_size, stride, padding)


def gather_conv(features: torch.Tensor, nbr_idx: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k feat[nbr_idx[i, k]] @ W[k]: features (V_in, Cin) with
    a zero row appended for the misses (index V_in), nbr_idx (V_out, K),
    weights (K, Cin, Cout) -> (V_out, Cout) in the feature dtype. One
    `index_select` and one matmul per tap; the weights are cast to the
    feature dtype and the products summed in float32, as the JAX package's
    `preferred_element_type=float32`."""
    v_out, k = nbr_idx.shape
    padded = torch.cat([features, features.new_zeros(1, features.shape[1])])
    padded = padded.float()
    w = weights.to(features.dtype).float()
    # the taps' index columns stay strided views: on the card a contiguous
    # index row takes `index_select` to a gather kernel that ran 3.3x
    # slower at the full-width gather path's shapes
    idx = nbr_idx.long()
    acc = torch.zeros(v_out, weights.shape[2], device=features.device)
    for kk in range(k):
        acc.addmm_(padded.index_select(0, idx[:, kk]), w[kk])
    return acc.to(features.dtype)


def sparse_to_dense(grid: SparseGrid, features: torch.Tensor) -> torch.Tensor:
    """(V, C) -> dense (D, H, W, C) (spconv `.dense()`), zero where no
    voxel is active; a scatter of the active rows."""
    d, h, w = grid.shape
    idx = torch.where(grid.mask, grid.linear_ids.long(), d * h * w)
    dense = features.new_zeros(d * h * w + 1, features.shape[1])
    dense[idx] = features
    return dense[:d * h * w].reshape(d, h, w, -1)
