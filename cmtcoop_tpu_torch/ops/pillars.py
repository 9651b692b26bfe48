"""Pillar-dense sparse tensors: sparse in BEV, dense along z (counterpart of
cmtcoop_tpu/ops/pillars.py).

A pillar grid is (coords (P, 2) int32 (y, x) sorted by y*W+x, mask (P,)),
with padding rows (coords -1, mask false) at the end; features are
(P, Z, C) and occupancy (P, Z) bool. Every neighbour map is one
`neighbor_map` (ops/lookup_kernel.py; kernel 9 on the card, one launch a
map) of the output sites in the input grid's sorted linear ids, which is
exact, so the JAX package's windowed lookups, overflow guards and
fallbacks have no counterpart here. The integer maps equal the JAX
package's exactly, padding rows included: a miss points at row P_in, the
zero row the convolutions append.

Everything here is device-agnostic tensor code with static shapes and no
host synchronisation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cmtcoop_tpu_torch.ops.lookup_kernel import INT32_MAX, neighbor_map
from cmtcoop_tpu_torch.utils.constants import constant
from cmtcoop_tpu_torch.utils.profiling import count, span


class PillarGrid(NamedTuple):
    coords: torch.Tensor  # (P, 2) int32 (y, x); -1 padding
    mask: torch.Tensor    # (P,) bool
    hw: Tuple[int, int]   # static BEV (H, W)
    z: int                # static dense z extent

    @property
    def linear_ids(self) -> torch.Tensor:
        """(P,) int32 y*W+x, INT32_MAX on padding rows (sorted)."""
        lin = self.coords[:, 0] * self.hw[1] + self.coords[:, 1]
        return torch.where(self.mask, lin, INT32_MAX).to(torch.int32)


@span("pillar maps")
def pillar_neighbor_map(grid: PillarGrid, ky: int = 3, kx: int = 3,
                        keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(P, ky*kx) int32 gather map of BEV neighbour pillars, taps row-major
    over (dy, dx) centred on the pillar; misses -> P. `keys`: the grid's
    `linear_ids`, where the caller holds them."""
    return neighbor_map(grid.linear_ids if keys is None else keys,
                        grid.coords, grid.mask, grid.hw, (ky, kx), 1,
                        (ky // 2, kx // 2))


def pillar_downsample_grid(grid: PillarGrid, max_out: int, stride: int = 2,
                           k: int = 3, pad: int = 1, return_n: bool = False):
    """BEV output pillar set of a strided conv: every output cell whose
    receptive field holds an input pillar, sorted, the first `max_out` kept.
    With `return_n`, also the true (uncapped) output count."""
    h, w = grid.hw
    out_h = (h + 2 * pad - k) // stride + 1
    out_w = (w + 2 * pad - k) // stride + 1
    dev = grid.coords.device
    n_cand = (k + stride - 1) // stride
    offs = torch.arange(n_cand, device=dev)
    cands, valids = [], []
    for a, bound in ((0, out_h), (1, out_w)):
        c = grid.coords[:, a].long()
        lo = -torch.div(-(c + pad - k + 1), stride, rounding_mode="floor")
        hi = torch.div(c + pad, stride, rounding_mode="floor")
        o = lo[:, None] + offs[None]
        cands.append(o)
        valids.append((o <= hi[:, None]) & (o >= 0) & (o < bound))
    ok = valids[0][:, :, None] & valids[1][:, None, :] & \
        grid.mask[:, None, None]
    lin = torch.where(ok, cands[0][:, :, None] * out_w + cands[1][:, None, :],
                      INT32_MAX).reshape(-1)
    slin = torch.sort(lin).values
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      slin[1:] != slin[:-1]]) & (slin != INT32_MAX)
    rank = torch.cumsum(head.long(), 0) - 1
    n_uniq = head.sum()
    uniq = torch.full((max_out + 1,), INT32_MAX, dtype=torch.long, device=dev)
    uniq.scatter_(0, torch.where(head & (rank < max_out), rank, max_out),
                  slin)
    uniq = uniq[:max_out]
    out_mask = torch.arange(max_out, device=dev) < n_uniq
    coords = torch.where(out_mask[:, None],
                         torch.stack([uniq // out_w, uniq % out_w], -1),
                         -1).to(torch.int32)
    out = PillarGrid(coords, out_mask, (out_h, out_w), grid.z)
    return (out, n_uniq) if return_n else out


@span("pillar maps")
def pillar_conv_neighbor_map(in_grid: PillarGrid, out_grid: PillarGrid,
                             stride: int = 2, k: int = 3, pad: int = 1,
                             keys: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """(P_out, k*k) int32 gather map into the input pillars of a strided BEV
    conv, taps row-major over (dy, dx); misses -> P_in. `keys`: the input
    grid's `linear_ids`, where the caller holds them."""
    return neighbor_map(in_grid.linear_ids if keys is None else keys,
                        out_grid.coords, out_grid.mask, in_grid.hw, k, stride,
                        pad)


def identity_map(grid: PillarGrid) -> torch.Tensor:
    """(P, 1) int32 BEV identity map (padding rows -> P), for the (3, 1, 1)
    `conv_out`."""
    p = grid.coords.shape[0]
    idx = torch.arange(p, dtype=torch.int32, device=grid.coords.device)
    return torch.where(grid.mask, idx, p).to(torch.int32)[:, None]


def pillar_conv(feats: torch.Tensor, nbr: torch.Tensor,
                weights: torch.Tensor, kz: int, z_stride: int = 1,
                z_pad: int = 1, chunk: int = 8192) -> torch.Tensor:
    """Sparse-BEV x dense-z convolution, the gather path:

        out[p, zo] = sum_{j, dz} feats[nbr[p, j], zo*s + dz - pad] @ W[dz*KB + j]

    feats (P_in, Z_in, Cin), nbr (P_out, KB) with misses -> P_in, weights
    (kz*KB, Cin, Cout) z-major. Weights are cast to the feature dtype, the
    products run in float32 and the result is cast back to the feature
    dtype, as in the JAX package. Chunks of `chunk` output pillars bound the
    gathered tiles. The rows are gathered with `index_select` from a float32
    copy, so under autograd the backward is a float32 `index_add_` (the
    backward of an advanced-indexing gather, a sort-based kernel, took most
    of the full-width train step on the card)."""
    p_in, z_in, cin = feats.shape
    p_out, kb = nbr.shape
    cout = weights.shape[2]
    z_out = (z_in + 2 * z_pad - kz) // z_stride + 1
    cdt = torch.promote_types(feats.dtype, torch.float32)
    w3 = weights.to(feats.dtype).to(cdt).reshape(kz, kb * cin, cout)
    padded = torch.cat([feats, feats.new_zeros(1, z_in, cin)], dim=0).to(cdt)
    if z_pad:
        padded = torch.nn.functional.pad(padded, (0, 0, z_pad, z_pad))
    zp = padded.shape[1]
    span = (z_out - 1) * z_stride + 1
    outs = []
    for s in range(0, p_out, chunk):
        nb = nbr[s:s + chunk].reshape(-1).long()
        x = padded.index_select(0, nb).view(-1, kb, zp, cin).permute(
            0, 2, 1, 3).reshape(-1, zp, kb * cin)
        acc = x[:, 0:span:z_stride] @ w3[0]
        for dz in range(1, kz):
            acc = acc + x[:, dz:dz + span:z_stride] @ w3[dz]
        outs.append(acc.to(feats.dtype))
    return torch.cat(outs, dim=0) if outs else feats.new_zeros(
        0, z_out, cout)


def occ_downsample(occ: torch.Tensor, nbr: torch.Tensor, kz: int,
                   z_stride: int, z_pad: int) -> torch.Tensor:
    """Output occupancy = any input voxel in the receptive field (spconv
    SparseConv3d site rule), a max-pool through the gather map."""
    p_in, z_in = occ.shape
    z_out = (z_in + 2 * z_pad - kz) // z_stride + 1
    padded = torch.cat([occ, occ.new_zeros(1, z_in)], dim=0)
    if z_pad:
        padded = torch.nn.functional.pad(padded, (z_pad, z_pad))
    any_bev = padded[nbr.long()].any(dim=1)
    span = (z_out - 1) * z_stride + 1
    cols = [any_bev[:, dz:dz + span:z_stride] for dz in range(kz)]
    return torch.stack(cols, 0).any(0)


def pillars_to_dense(grid: PillarGrid, feats: torch.Tensor) -> torch.Tensor:
    """(P, Z, C) -> dense (H, W, Z*C) BEV map (zero where no pillar)."""
    h, w = grid.hw
    p, z, c = feats.shape
    idx = torch.where(grid.mask,
                      grid.coords[:, 0].long() * w + grid.coords[:, 1], h * w)
    dense = feats.new_zeros(h * w + 1, z * c)
    dense[idx] = feats.reshape(p, z * c)
    return dense[:h * w].reshape(h, w, z * c)


def compute_voxel_coords(points, point_mask, voxel_size, pc_range,
                         grid_size):
    """Per-point integer voxel coords (z, y, x) int64 and validity."""
    vs = constant(voxel_size, points.dtype, points.device)
    lo = constant(pc_range[:3], points.dtype, points.device)
    gxyz = torch.floor((points[..., :3] - lo) / vs).long()
    gs = constant(grid_size, torch.long, points.device)
    valid = point_mask & (gxyz >= 0).all(-1) & (gxyz < gs).all(-1)
    return gxyz.flip(-1), valid


def pillarize(points: torch.Tensor, point_mask: torch.Tensor, *,
              voxel_size, pc_range, grid_size, max_points: int = 10,
              max_voxels: int = 120000, max_pillars: int = 40000,
              return_stats: bool = False):
    """Points (N, F), mask (N,) -> (pcoords (P, 2) int32 (y, x), pmask (P,),
    occ (P, Z) bool, feats (P, Z, F) float32), Z = grid_z + 1.

    One stable sort by the (y, x, z) key. As in the JAX package: the first
    `max_points` points of each voxel in original order count toward its
    mean, and voxels past `max_voxels` and pillars past `max_pillars` are
    dropped in sorted order. The means come from float32 sums
    (`index_add_`; the order of the sums changes only the last bits).

    With `return_stats`, a fifth element holds scalar int64 drop telemetry:
    n_voxels_raw / n_voxels_dropped, n_pillars_raw / n_pillars_dropped,
    n_points_in_range / n_points_dropped."""
    n, f = points.shape
    dev = points.device
    gx = grid_size[0]
    z_ext = grid_size[2] + 1
    with span("pillarize.sort"):
        zyx, valid = compute_voxel_coords(points, point_mask, voxel_size,
                                          pc_range, grid_size)
        key = (zyx[:, 1] * gx + zyx[:, 2]) * z_ext + zyx[:, 0]
        key = torch.where(valid, key, INT32_MAX)
        skey, order = torch.sort(key, stable=True)
        spts = points[order].float()
        in_range = skey != INT32_MAX

    with span("pillarize.slots"):
        first = torch.ones(1, dtype=torch.bool, device=dev)
        bound = torch.cat([first, skey[1:] != skey[:-1]])
        head = bound & in_range
        n_vox = torch.cumsum(head.long(), 0)
        # occupied voxels before `max_voxels` (a count above it loses voxels)
        count("voxels.raw", n_vox[-1])
        vrank = n_vox - 1
        idx = torch.arange(n, device=dev)
        run_start = torch.cummax(torch.where(bound, idx, -1), 0).values
        pos_in_run = idx - run_start
        valid_pt = in_range & (vrank < max_voxels)

        pil = torch.where(valid_pt,
                          torch.div(skey, z_ext, rounding_mode="floor"),
                          INT32_MAX)
        phead = torch.cat([first, pil[1:] != pil[:-1]]) & (pil != INT32_MAX)
        prank = torch.cumsum(phead.long(), 0) - 1
        # active BEV cells before the cap (a count above it loses cells)
        n_raw = torch.where(phead, prank, -1).max() + 1
        count("pillars.l0", n_raw)
        n_pillars = n_raw.clamp(0, max_pillars)
        ok = valid_pt & (pos_in_run < max_points) & (prank < max_pillars)

        slots = torch.arange(max_pillars, device=dev)
        rank_keys = torch.where(pil != INT32_MAX, prank, INT32_MAX)
        pstart = torch.searchsorted(rank_keys, slots).clamp(max=n - 1)
        pmask = slots < n_pillars
        plin = torch.where(pmask, torch.div(skey[pstart], z_ext,
                                            rounding_mode="floor"), -1)
        pcoords = torch.where(pmask[:, None],
                              torch.stack([plin // gx, plin % gx], -1),
                              -1).to(torch.int32)

    with span("pillarize.means"):
        n_slot = max_pillars * z_ext
        slot = torch.where(ok, prank * z_ext + skey % z_ext, n_slot)
        sums = torch.zeros(n_slot + 1, f, dtype=torch.float32, device=dev)
        sums.index_add_(0, slot, spts)
        counts = torch.zeros(n_slot + 1, dtype=torch.float32, device=dev)
        counts.index_add_(0, slot,
                          torch.ones_like(slot, dtype=torch.float32))
        sums = sums[:n_slot].reshape(max_pillars, z_ext, f)
        counts = counts[:n_slot].reshape(max_pillars, z_ext)
        occ = (counts > 0) & pmask[:, None]
        feats = torch.where(occ[..., None],
                            sums / counts.clamp(min=1.0)[..., None], 0.0)
    if not return_stats:
        return pcoords, pmask, occ, feats
    pil_raw = torch.where(in_range,
                          torch.div(skey, z_ext, rounding_mode="floor"),
                          INT32_MAX)
    praw_head = torch.cat([first, pil_raw[1:] != pil_raw[:-1]]) & \
        (pil_raw != INT32_MAX)
    n_voxels_raw = head.sum()
    n_pillars_raw = praw_head.sum()
    n_in = in_range.sum()
    stats = dict(
        n_voxels_raw=n_voxels_raw,
        n_voxels_dropped=(n_voxels_raw - max_voxels).clamp(min=0),
        n_pillars_raw=n_pillars_raw,
        n_pillars_dropped=(n_pillars_raw - max_pillars).clamp(min=0),
        n_points_in_range=n_in,
        n_points_dropped=n_in - ok.sum(),
    )
    return pcoords, pmask, occ, feats, stats
