"""Sorted-key lookup: kernel 9 of the port (counterpart of the compare-count
`window_counts` / `_count_kernel` in cmtcoop_tpu/ops/lookup_kernel.py and of
the exact path of `sorted_lookup` in cmtcoop_tpu/ops/sparse_utils.py).

`sorted_lookup` takes the plain version for a CPU tensor and launches the
hand-written CUDA kernel (csrc/sorted_lookup.cu) for a CUDA tensor. The
TPU kernel counts keys below each query inside a 128-query block's window
of 512 keys and needs an overflow guard with an exact fallback; the port's
kernel searches the whole sorted key array, which is exact at any density,
so neither the windows nor the guard have a counterpart here.
"""
from __future__ import annotations

import torch

from cmtcoop_tpu_torch import _build

INT32_MAX = 2 ** 31 - 1


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
    else (n, run). A sentinel query (INT32_MAX) never hits."""
    if keys.device.type == "cpu":
        return sorted_lookup_reference(keys, queries, run)
    if keys.device.type != "cuda":
        raise ValueError(f"sorted_lookup: no kernel for {keys.device}")
    for name, t in (("keys", keys), ("queries", queries)):
        if (t.dim() != 1 or t.dtype != torch.int32 or not t.is_contiguous()
                or t.device != keys.device):
            raise ValueError(f"sorted_lookup: {name} must be a contiguous "
                             "1-D int32 tensor on the keys' device")
    if run < 1:
        raise ValueError(f"sorted_lookup: run must be >= 1, got {run}")
    n = queries.shape[0]
    pos = torch.empty(n, run, dtype=torch.int32, device=keys.device)
    hit = torch.empty(n, run, dtype=torch.bool, device=keys.device)
    if n:
        _build.check(_build.lib().cmt_sorted_lookup(
            keys.data_ptr(), keys.shape[0], queries.data_ptr(), n, run,
            pos.data_ptr(), hit.data_ptr(), _build.stream_ptr(keys.device)),
            "cmt_sorted_lookup")
        _build.count("sorted_lookup")
    return (pos[:, 0], hit[:, 0]) if run == 1 else (pos, hit)
