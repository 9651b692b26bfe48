"""Kernel 9's route on the CPU: the port's neighbour-map builders through
`neighbor_map`'s plain version against the JAX package's map builders, and
a plain-torch replay of the kernel's walk (`neighbor_map_walk`) against the
plain version.

Every map is integer and must be equal exactly, padding rows included. The
grids hold sites on every edge of the grid; each builder runs on a grid
with padding rows, on a full cap with none and on an empty grid. The
strided maps take their output sites from the JAX downsample, so a map is
compared on the same sites in both packages.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from cmtcoop_tpu.ops import pillars as jpu
from cmtcoop_tpu.ops import sparse_utils as jsu
from cmtcoop_tpu_torch import _build
from cmtcoop_tpu_torch.ops import lookup_kernel as lk
from cmtcoop_tpu_torch.ops import pillars as tpu
from cmtcoop_tpu_torch.ops import sparse_utils as tsu

BIG = np.iinfo(np.int32).max


def _eq(ours, ref):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _sites(rng, shape, n, cap):
    """(coords (cap, D) int32, mask (cap,)) of up to n distinct cells in
    ascending linear order, padding rows (-1) after them: every cell on the
    grid's border in y and x (each z slab's ring, for a 3-D grid) first
    taken, then random cells."""
    grid = np.indices(shape).reshape(len(shape), -1).T
    y, x = grid[:, -2], grid[:, -1]
    ring = np.nonzero((y == 0) | (y == shape[-2] - 1) | (x == 0)
                      | (x == shape[-1] - 1))[0]
    ring = rng.permutation(ring)[:n // 2]
    rest = rng.permutation(np.setdiff1d(np.arange(len(grid)), ring))
    lin = np.sort(np.concatenate([ring, rest[:n - len(ring)]]))
    coords = np.full((cap, len(shape)), -1, np.int32)
    coords[:len(lin)] = grid[lin]
    return coords, np.arange(cap) < len(lin)


# (sites, cap) of each grid kind: padding rows after the sites, a full cap
# with none, no site at all
FILLS = {"padding": (150, 192), "full": (192, 192), "empty": (0, 64)}


def _pillar_grids(fill, hw=(12, 14)):
    coords, mask = _sites(np.random.default_rng(len(fill)), hw,
                          *FILLS[fill])
    return (jpu.PillarGrid(jnp.asarray(coords), jnp.asarray(mask), hw, 4),
            tpu.PillarGrid(torch.from_numpy(coords), torch.from_numpy(mask),
                           hw, 4))


def _voxel_grids(fill, shape=(7, 9, 8)):
    coords, mask = _sites(np.random.default_rng(len(fill) + 7), shape,
                          *FILLS[fill])
    return (jsu.SparseGrid(jnp.asarray(coords), jnp.asarray(mask), shape),
            tsu.SparseGrid(torch.from_numpy(coords), torch.from_numpy(mask),
                           shape))


def _from_jax(grid, cls, *extra):
    return cls(torch.from_numpy(np.array(grid.coords)),
               torch.from_numpy(np.array(grid.mask)), *extra)


@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("ky,kx", [(3, 3), (5, 3)])
def test_pillar_neighbor_map_matches_jax(fill, ky, kx):
    jg, tg = _pillar_grids(fill)
    before = dict(_build.launch_counts)
    got = tpu.pillar_neighbor_map(tg, ky, kx)
    assert _build.launch_counts == before
    assert got.shape == (tg.coords.shape[0], ky * kx)
    _eq(got, jpu.pillar_neighbor_map(jg, ky, kx))
    _eq(tpu.pillar_neighbor_map(tg, ky, kx, keys=tg.linear_ids), got)


@pytest.mark.parametrize("fill", list(FILLS))
def test_pillar_conv_neighbor_map_matches_jax(fill):
    jg, tg = _pillar_grids(fill)
    jo = jpu.pillar_downsample_grid(jg, 64)
    to = _from_jax(jo, tpu.PillarGrid, jo.hw, jo.z)
    got = tpu.pillar_conv_neighbor_map(tg, to)
    _eq(got, jpu.pillar_conv_neighbor_map(jg, jo))
    assert (got.numpy() < tg.coords.shape[0]).any() == (fill != "empty")


@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("ks", [(3, 3, 3), (3, 1, 3)])
def test_subm_neighbor_map_matches_jax(fill, ks):
    jg, tg = _voxel_grids(fill)
    got = tsu.subm_neighbor_map(tg, ks)
    _eq(got, jsu.subm_neighbor_map(jg, ks))
    _eq(tsu.subm_neighbor_map(tg, ks, keys=tg.linear_ids), got)


@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("ks,st,pad", [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)),   # the last down conv's padding
    ((3, 1, 1), (2, 1, 1), (0, 0, 0)),   # conv_out
])
def test_conv_neighbor_map_matches_jax(fill, ks, st, pad):
    jg, tg = _voxel_grids(fill)
    jo = jsu.downsample_output_grid(jg, ks, st, pad, 128)
    to = _from_jax(jo, tsu.SparseGrid, jo.shape)
    _eq(tsu.conv_neighbor_map(tg, to, ks, st, pad),
        jsu.conv_neighbor_map(jg, jo, ks, st, pad))


# ------------------------------ the kernel's walk --------------------------


def _walk_case(name):
    """(keys, coords, mask, shape, kernel, stride, pad) of one walk case."""
    rng = np.random.default_rng(len(name))
    if name == "wide brackets":
        # 3-D, 6 z slabs of 8 x 8: 6 sites in each of the first three, the
        # last three full. A warp's 32 sites cross y rows and z slabs, and
        # its dz = +1 column of the third slab lands in the full fourth
        shape = (6, 8, 8)
        lin = np.sort(np.concatenate(
            [z * 64 + rng.choice(64, 6, replace=False) for z in range(3)]
            + [np.arange(192, 384)]))
        c = np.full((224, 3), -1, np.int32)
        c[:len(lin)] = np.stack(np.unravel_index(lin, shape), -1)
        m = np.arange(224) < len(lin)
        return (_keys(c, m, shape), c, m, shape, (3, 3, 3), 1, 1)
    if name == "padding warps":
        # 40 sites then 5 warps of padding rows only (the walk's second tile
        # holds padding rows alone)
        shape, (c, m) = (5, 10, 10), _sites(rng, (5, 10, 10), 40, 200)
        return (_keys(c, m, shape), c, m, shape, (3, 3, 3), 1, 1)
    if name == "no keys":
        # an input grid of padding rows only: every key INT32_MAX
        shape, (c, m) = (5, 10, 10), _sites(rng, (3, 5, 5), 50, 64)
        keys = np.full(96, BIG, np.int32)
        return keys, c, m, shape, (3, 3, 3), 2, 1
    if name == "pillar strided":
        shape, (c, m) = (20, 24), _sites(rng, (20, 24), 300, 320)
        keys = _keys(c, m, shape)
        oc, om = _sites(rng, (10, 12), 90, 128)
        return keys, oc, om, shape, (3, 3), 2, 1
    if name == "pillar 5x3":
        shape, (c, m) = (20, 24), _sites(rng, (20, 24), 300, 320)
        return (_keys(c, m, shape), c, m, shape, (5, 3), 1, (2, 1))
    if name == "shuffled sites":
        # sites in random order: brackets as wide as the key array
        shape, (c, m) = (6, 8, 8), _sites(rng, (6, 8, 8), 200, 224)
        keys = _keys(c, m, shape)
        p = rng.permutation(len(m))
        return keys, c[p], m[p], shape, (3, 3, 3), 1, 1
    raise KeyError(name)


def _keys(coords, mask, shape):
    lin = np.ravel_multi_index(np.maximum(coords, 0).T, shape)
    return np.where(mask, lin, BIG).astype(np.int32)


WALK_CASES = ("wide brackets", "padding warps", "no keys", "pillar strided",
              "pillar 5x3", "shuffled sites")


@pytest.mark.parametrize("name", WALK_CASES)
def test_kernel_walk_matches_plain(name):
    """The replay of the kernel's walk (tile brackets from the 32-ary
    search, each site's search inside them, row runs) gives the plain
    version's map bit for bit; its brackets are as wide as the case
    makes them."""
    keys, coords, mask, *geom = _walk_case(name)
    keys, coords, mask = (torch.from_numpy(np.ascontiguousarray(a))
                          for a in (keys, coords, mask))
    ref = lk.neighbor_map(keys, coords, mask, *geom)
    got, widths = lk.neighbor_map_walk(keys, coords, mask, *geom)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    hits = int((ref < keys.shape[0]).sum())
    if name == "no keys":
        assert hits == 0 and int(widths.max()) == 0
    else:
        assert hits > 0
    if name == "wide brackets":
        assert int(widths.max()) > 64
    if name == "shuffled sites":
        assert int(widths.min()) > 100
    if name == "padding warps":
        # 40 sites, then only padding rows: one tile, 9 runs
        assert widths.numel() == 9


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, 65536])
def test_warp_bracket_search_matches_searchsorted(n):
    """The kernel's cooperative 32-ary search against `torch.searchsorted`
    on sorted keys with an INT32_MAX tail, targets below, inside, between,
    on and above the keys."""
    rng = np.random.default_rng(n)
    keys = np.sort(rng.choice(4 * n + 8, n, replace=False)).astype(np.int32)
    keys = torch.from_numpy(np.concatenate([keys, np.full(n // 7, BIG,
                                                          np.int32)]))
    t = torch.from_numpy(rng.integers(-3, 4 * n + 12, 500))
    t = torch.cat([t, keys[:50].long(), torch.tensor([BIG, BIG + 1])])
    assert torch.equal(lk._warp_lower_bound(keys, t),
                       torch.searchsorted(keys.long(), t))


def test_neighbor_map_wrapper_checks_its_inputs():
    """The wrapper takes the plain version for CPU tensors (no launch),
    refuses a device without a kernel, and raises on a wrong dtype, shape,
    contiguity or geometry; `sorted_lookup` has no kernel at all."""
    keys, coords, mask, *geom = _walk_case("pillar 5x3")
    keys, coords, mask = (torch.from_numpy(a) for a in (keys, coords, mask))
    before = dict(_build.launch_counts)
    lk.neighbor_map(keys, coords, mask, *geom)
    assert _build.launch_counts == before
    bad = [(keys.long(), coords, mask), (keys, coords.long(), mask),
           (keys, coords, mask.int()), (keys, coords[:, :1], mask),
           (keys, coords, mask[:-1]), (keys, coords.t().contiguous().t(),
                                       mask)]
    for args in bad:
        with pytest.raises(ValueError, match="neighbor_map"):
            lk.neighbor_map(*args, *geom)
    with pytest.raises(ValueError, match="axes"):
        lk.neighbor_map(keys, coords, mask, (20, 24), (3, 3, 3), 1, 1)
    meta = [t.to("meta") for t in (keys, coords, mask)]
    with pytest.raises(ValueError, match="no kernel"):
        lk.neighbor_map(*meta, *geom)
    with pytest.raises(ValueError, match="no kernel"):
        lk.sorted_lookup(meta[0], meta[0])


def test_neighbor_queries_keep_every_bound_on_the_host():
    """The queries of the plain version: each in-bounds tap's linear id,
    INT32_MAX for invalid sites and out-of-bounds taps, from Python-int
    geometry (the ids of a centred 3x3 around (0, 0) of a 4 x 5 grid)."""
    coords = torch.tensor([[0, 0], [-1, -1]], dtype=torch.int32)
    mask = torch.tensor([True, False])
    q = lk.neighbor_queries(coords, mask, (4, 5), (3, 3), 1, 1)
    m = BIG
    assert q.tolist() == [[m, m, m, m, 0, 1, m, 5, 6], [m] * 9]
