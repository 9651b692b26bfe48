"""Neighbour maps over sorted keys: kernel 9 of the port (counterpart of the
compare-count `window_counts` / `_count_kernel` in
cmtcoop_tpu/ops/lookup_kernel.py, of the exact path of `sorted_lookup` in
cmtcoop_tpu/ops/sparse_utils.py and of the query formation around it in the
JAX map builders).

`neighbor_map` writes the finished (V_out, K) int32 gather map of a
convolution's output sites into the sorted linear ids of its input grid:
its plain version for a CPU tensor, the hand-written CUDA kernel
(csrc/sorted_lookup.cu) for a CUDA tensor, one launch a map. The TPU kernel
counts keys below each query inside a 128-query block's window of 512 keys
and needs an overflow guard with an exact fallback; the port's kernel
brackets each warp's tap column in the whole key array, which is exact at
any density, so neither the windows nor the guard have a counterpart here.

`sorted_lookup`, the lookup of arbitrary queries, keeps its plain version
(the CPU tests hold it against the JAX exact path and the Pallas
compare-count) and no kernel: no path calls it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple, Union

import torch

from cmtcoop_tpu_torch import _build

INT32_MAX = 2 ** 31 - 1
MAX_TAPS = 64  # the kernel stages a tile's K taps a site in shared memory
WARP = 32   # lanes of the cooperative search
TILE = 128  # output sites a block of the kernel owns
Ints = Union[int, Sequence[int]]


def sorted_lookup_reference(keys: torch.Tensor, queries: torch.Tensor,
                            run: int = 1):
    """Plain version: `torch.searchsorted` of q + d (d = 0..run, in int64,
    the sentinel kept as it is) in the int32 keys gives the counts of keys
    below each target; `pos` is the count at d, `hit` says the count grows
    from d to d + 1 (the key q + d is present) and the query is no
    sentinel."""
    q = queries.long()
    sentinel = queries == INT32_MAX
    d = torch.arange(run + 1, device=queries.device)
    targets = torch.where(sentinel[:, None], q[:, None], q[:, None] + d)
    counts = torch.searchsorted(keys.long(), targets)
    pos = counts[:, :run].to(torch.int32)
    hit = (counts[:, 1:] > counts[:, :-1]) & ~sentinel[:, None]
    return (pos[:, 0], hit[:, 0]) if run == 1 else (pos, hit)


def sorted_lookup(keys: torch.Tensor, queries: torch.Tensor, run: int = 1):
    """(pos, hit) of int32 `queries` (n,), in any order, in the sorted int32
    `keys` (a sentinel INT32_MAX tail allowed), for q + d, d in [0, run):
    `pos` (int32) is the lower bound of q + d in the whole key array and
    `hit` (bool) says the key q + d is present; both (n,) for `run` 1,
    else (n, run). A sentinel query (INT32_MAX) never hits. CPU tensors
    only: the neighbour maps, the paths' only lookups, go through
    `neighbor_map`."""
    if keys.device.type != "cpu":
        raise ValueError(f"sorted_lookup: no kernel for {keys.device}")
    return sorted_lookup_reference(keys, queries, run)


def _per_axis(v: Ints, dims: int, name: str) -> Tuple[int, ...]:
    t = (v,) * dims if isinstance(v, int) else tuple(int(a) for a in v)
    if len(t) != dims:
        raise ValueError(f"neighbor_map: {name} {v} has not {dims} axes")
    return t


def geometry(shape, kernel_size, stride, padding):
    """(shape, kernel_size, stride, padding) as tuples of Python ints, one
    per axis of the grid."""
    dims = len(shape)
    return tuple(_per_axis(v, dims, n) for v, n in (
        (shape, "shape"), (kernel_size, "kernel_size"), (stride, "stride"),
        (padding, "padding")))


def neighbor_queries(coords: torch.Tensor, mask: torch.Tensor, shape,
                     kernel_size, stride: Ints = 1,
                     padding: Ints = 0) -> torch.Tensor:
    """(V_out, K) int32 linear id of each tap's source cell src = coords *
    stride + k - pad (taps row-major over the kernel), INT32_MAX where the
    site is invalid or src out of bounds. Bounds, strides and pads stay
    Python ints: no host-to-device copy."""
    shape, ks, st, pad = geometry(shape, kernel_size, stride, padding)
    dev = coords.device
    offs = torch.meshgrid(*(torch.arange(k, device=dev) for k in ks),
                          indexing="ij")
    c = coords.long()
    ok = mask[:, None]
    lin = None
    for a in range(len(shape)):
        src = c[:, a:a + 1] * st[a] + offs[a].reshape(1, -1) - pad[a]
        ok = ok & (src >= 0) & (src < shape[a])
        lin = src if lin is None else lin * shape[a] + src
    return torch.where(ok, lin, INT32_MAX).to(torch.int32)


def neighbor_map_reference(keys: torch.Tensor, coords: torch.Tensor,
                           mask: torch.Tensor, shape, kernel_size,
                           stride: Ints = 1,
                           padding: Ints = 0) -> torch.Tensor:
    """Plain version: the queries of `neighbor_queries`, one
    `sorted_lookup_reference`, misses -> n_in = len(keys)."""
    q = neighbor_queries(coords, mask, shape, kernel_size, stride, padding)
    pos, hit = sorted_lookup_reference(keys, q.reshape(-1))
    return torch.where(hit, pos, keys.shape[0]).to(torch.int32).view(
        q.shape)


def _check(keys, coords, mask, dims):
    for name, t, dt, nd in (("keys", keys, torch.int32, 1),
                            ("coords", coords, torch.int32, 2),
                            ("mask", mask, torch.bool, 1)):
        if (t.dtype != dt or t.dim() != nd or not t.is_contiguous()
                or t.device != keys.device):
            raise ValueError(f"neighbor_map: {name} must be a contiguous "
                             f"{nd}-D {dt} tensor on the keys' device")
    if coords.shape[1] != dims or mask.shape[0] != coords.shape[0]:
        raise ValueError(f"neighbor_map: coords {tuple(coords.shape)} and "
                         f"mask {tuple(mask.shape)} do not fit a "
                         f"{dims}-D grid")


def neighbor_map(keys: torch.Tensor, coords: torch.Tensor,
                 mask: torch.Tensor, shape, kernel_size, stride: Ints = 1,
                 padding: Ints = 0) -> torch.Tensor:
    """(V_out, K) int32 gather map of a convolution over a sorted grid.

    keys: (n_in,) int32 sorted linear ids of the input grid's active cells
    ((z * H + y) * W + x, or y * W + x), INT32_MAX on padding rows; coords:
    (V_out, D) int32 output sites (z, y, x) or (y, x), D = len(shape);
    mask: (V_out,) bool. Tap k, row-major over `kernel_size`, reads the
    cell coords * stride + k - padding; map[o, k] is the row of `keys`
    holding it when the site is valid, the cell in `shape` and the key
    present, else n_in. Every geometry argument is Python ints."""
    shape, ks, st, pad = geometry(shape, kernel_size, stride, padding)
    dims = len(shape)
    if dims not in (2, 3):
        raise ValueError(f"neighbor_map: a 2-D or 3-D grid, not {shape}")
    _check(keys, coords, mask, dims)
    if keys.device.type == "cpu":
        return neighbor_map_reference(keys, coords, mask, shape, ks, st, pad)
    if keys.device.type != "cuda":
        raise ValueError(f"neighbor_map: no kernel for {keys.device}")
    n_taps, cells = math.prod(ks), math.prod(shape)
    if not 1 <= n_taps <= MAX_TAPS or cells + MAX_TAPS >= INT32_MAX:
        raise ValueError(f"neighbor_map: {n_taps} taps (at most "
                         f"{MAX_TAPS}) over {cells} cells: not a kernel "
                         "shape")
    n_out = coords.shape[0]
    out = torch.empty(n_out, n_taps, dtype=torch.int32, device=keys.device)
    if n_out:
        lead = 3 - dims  # a 2-D map is a 3-D one of depth 1
        geom = ((1,) * lead + shape + (1,) * lead + ks + (1,) * lead + st
                + (0,) * lead + pad)
        _build.check(_build.lib().cmt_neighbor_map(
            keys.data_ptr(), keys.shape[0], coords.data_ptr(),
            mask.data_ptr(), n_out, dims, (ctypes.c_int * 12)(*geom),
            out.data_ptr(), _build.stream_ptr(keys.device)),
            "cmt_neighbor_map")
        _build.count("neighbor_map", (keys.shape[0], n_out) + ks + st)
    return out


def _padded(keys: torch.Tensor) -> torch.Tensor:
    """int64 keys with one INT32_MAX after them: a probe at n_keys, which
    the walk masks, reads a sentinel and no index is out of range."""
    return torch.cat([keys.long(), keys.new_full((1,), INT32_MAX).long()])


def _warp_lower_bound(keys: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The kernel's cooperative 32-ary search, one row per warp: the lower
    bound of each target `t` (int64) in the whole of `keys`."""
    n = keys.shape[0]
    lo = torch.zeros_like(t)
    hi = torch.full_like(t, n)
    lanes = torch.arange(1, WARP + 1, device=t.device)
    k64 = _padded(keys)
    while bool((lo < hi).any()):
        live = lo < hi
        c = (hi - lo + WARP - 1) // WARP
        idx = lo[:, None] + lanes * c[:, None] - 1
        probe = live[:, None] & (idx < hi[:, None])
        below = probe & (k64[idx.clamp(0, n)] < t[:, None])
        nlo = lo + below.sum(1) * c
        hi = torch.where(live, torch.minimum(nlo + c - 1, hi), hi)
        lo = torch.where(live, nlo, lo)
    return lo


def neighbor_map_walk(keys: torch.Tensor, coords: torch.Tensor,
                      mask: torch.Tensor, shape, kernel_size,
                      stride: Ints = 1, padding: Ints = 0):
    """A plain-torch replay of the kernel's walk, for the tests and for the
    bracket widths chip_smoke.py reports: tiles of 128 consecutive sites,
    one run of kx consecutive ids per (kz_, ky_) pair, each tile's bracket
    [lower_bound(q_min), lower_bound(q_max + kx)) of a run from the 32-ary
    search, each site's binary search inside it, then a step past each key
    equal to the previous tap's id. Returns (map, widths): the map as
    `neighbor_map` gives it and the bracket width (keys) of every tile and
    run with a live site."""
    shape, ks, st, pad = geometry(shape, kernel_size, stride, padding)
    lead = 3 - len(shape)
    shape, ks, st, pad = ((1,) * lead + shape, (1,) * lead + ks,
                          (1,) * lead + st, (0,) * lead + pad)
    (d, h, w), kx = shape, ks[2]
    n_out, n_keys, dev = coords.shape[0], keys.shape[0], coords.device
    n_tiles = -(-n_out // TILE)
    site_ok = torch.zeros(n_tiles * TILE, dtype=torch.bool, device=dev)
    site_ok[:n_out] = mask
    c = torch.zeros(n_tiles * TILE, 3, dtype=torch.long, device=dev)
    c[:n_out, lead:] = coords.long()
    src = [c[:, a] * st[a] - pad[a] for a in range(3)]
    dz = torch.arange(ks[0], device=dev).repeat_interleave(ks[1])
    dy = torch.arange(ks[1], device=dev).repeat(ks[0])
    z = src[0][None] + dz[:, None]          # (runs, sites)
    y = src[1][None] + dy[:, None]
    x0 = src[2][None].expand_as(z)
    live = (site_ok[None] & (z >= 0) & (z < d) & (y >= 0) & (y < h)
            & (x0 + kx > 0) & (x0 < w))
    q0 = torch.where(live, (z * h + y) * w + x0, 0)
    runs = q0.shape[0]
    live_t = live.view(runs, n_tiles, TILE)
    q_t = q0.view(runs, n_tiles, TILE)
    q_min = torch.where(live_t, q_t, INT32_MAX).amin(-1).reshape(-1)
    q_max = torch.where(live_t, q_t, -INT32_MAX).amax(-1).reshape(-1)
    any_live = live_t.any(-1).reshape(-1)
    # a tile and run with no live site searches nothing
    lo = torch.zeros_like(q_min)
    hi = torch.zeros_like(q_min)
    sel = any_live.nonzero().squeeze(1)
    lo[sel] = _warp_lower_bound(keys, q_min[sel])
    hi[sel] = _warp_lower_bound(keys, q_max[sel] + kx)
    widths = (hi - lo)[any_live]
    lo = lo.view(runs, n_tiles, 1).expand_as(q_t).reshape(runs, -1)
    hi = hi.view(runs, n_tiles, 1).expand_as(q_t).reshape(runs, -1)
    k64 = _padded(keys)
    # each site's lower_bound(q0) in [lo, hi)
    a, b = lo.clone(), torch.where(live, hi, lo)
    while bool((a < b).any()):
        mid = (a + b) // 2
        go = a < b
        less = go & (k64[mid] < q0)
        a = torch.where(less, mid + 1, a)
        b = torch.where(go & ~less, mid, b)
    pos = torch.where(live, a, hi)
    cols = []
    for j in range(kx):
        t = q0 + j
        in_x = (x0 + j >= 0) & (x0 + j < w)
        hit = live & in_x & (pos < hi) & (k64[pos] == t)
        cols.append(torch.where(hit, pos, n_keys))
        while True:
            step = live & (pos < hi) & (k64[pos] <= t)
            if not bool(step.any()):
                break
            pos = pos + step.long()
    # (kx, runs, sites) -> (sites, runs * kx), taps row-major
    out = torch.stack(cols).permute(2, 1, 0).reshape(n_tiles * TILE,
                                                    runs * kx)
    return out[:n_out].to(torch.int32), widths
