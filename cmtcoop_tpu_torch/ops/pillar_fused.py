"""Fused pillar convolution: conv (+BN eval) (+residual) (+ReLU)
(+occupancy) in one kernel (counterpart of cmtcoop_tpu/ops/pillar_fused.py).

`fused_pillar_conv` takes the plain version for a CPU tensor and launches
the hand-written CUDA kernel (csrc/pillar_conv.cu) for a CUDA tensor:
kernel 1 for 9 BEV taps (the submanifold convs and the strided down convs),
kernel 2 for 1 BEV tap (`conv_out`). The JAX package's packed rows, band
matrices, windows, retry ladder and XLA fallback have no counterpart: the
neighbour map is gathered directly, which is exact at any density.

`pin_rows` is kernel 10 (csrc/rows_copy.cu), the row-major identity copy of
the JAX package's `_pin_rows_layout`. That copy pinned XLA's layout on the
retry ladder's fallback branch, which the port does not have, so no path of
the port calls it; it is held against its plain version, `clone()`.
"""
from __future__ import annotations

from typing import Optional

import torch

from cmtcoop_tpu_torch import _build
from cmtcoop_tpu_torch.ops.pillars import occ_downsample, pillar_conv


def fused_pillar_conv_reference(feats, nbr, weights, *, kz=3, z_stride=1,
                                z_pad=1, scale=None, bias=None, occ_out=None,
                                residual=None, relu=False, occ_in=None,
                                fold_occ=False):
    """Plain PyTorch version: `pillar_conv` plus the epilogue in float32
    (the twin of the JAX package's `_xla_reference`), with
    `occ_downsample` for `fold_occ`."""
    if fold_occ:
        occ_out = occ_downsample(occ_in, nbr, kz, z_stride, z_pad)
    out = pillar_conv(feats, nbr, weights, kz, z_stride, z_pad).float()
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    if residual is not None:
        out = out + residual.float()
    if relu:
        out = torch.relu(out)
    if occ_out is not None:
        out = out * occ_out.float()[..., None]
    out = out.to(feats.dtype)
    return (out, occ_out) if fold_occ else out


def fused_pillar_conv(
    feats: torch.Tensor,                   # (P_in, Z_in, Cin)
    nbr: torch.Tensor,                     # (P_out, KB) int32, miss -> P_in
    weights: torch.Tensor,                 # (kz*KB, Cin, Cout) z-major
    *,
    kz: int = 3,
    z_stride: int = 1,
    z_pad: int = 1,
    scale: Optional[torch.Tensor] = None,     # (Cout,) BN eval scale
    bias: Optional[torch.Tensor] = None,      # (Cout,) BN eval bias
    occ_out: Optional[torch.Tensor] = None,   # (P_out, Z_out) bool
    residual: Optional[torch.Tensor] = None,  # (P_out, Z_out, Cout)
    relu: bool = False,
    occ_in: Optional[torch.Tensor] = None,    # (P_in, Z_in) bool
    fold_occ: bool = False,
):
    """Returns (P_out, Z_out, Cout) in the feature dtype; with
    `fold_occ=True` (down convs) also the output occupancy
    `occ_downsample(occ_in, nbr, ...)`, which then masks the output."""
    kw = dict(kz=kz, z_stride=z_stride, z_pad=z_pad, scale=scale, bias=bias,
              occ_out=occ_out, residual=residual, relu=relu, occ_in=occ_in,
              fold_occ=fold_occ)
    if feats.device.type == "cpu":
        return fused_pillar_conv_reference(feats, nbr, weights, **kw)
    if feats.device.type != "cuda":
        raise ValueError(f"fused_pillar_conv: no kernel for {feats.device}")
    return _fused_pillar_conv_cuda(feats, nbr, weights, **kw)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_pillar_conv: {msg}")


def _active_rows(occ: torch.Tensor):
    """Occupied (pillar, z) rows of `occ`, compacted in row order on the
    device: (rows int32 (P*Z + 1,), count int32 (1,)) with rows[:count]
    valid. No host synchronisation: the count stays on the device."""
    flat = occ.reshape(-1)
    m = flat.numel()
    pos = torch.cumsum(flat, 0, dtype=torch.int32)
    rows = torch.empty(m + 1, dtype=torch.int32, device=occ.device)
    target = torch.where(flat, pos.long() - 1, m)
    rows.scatter_(0, target, torch.arange(m, dtype=torch.int32,
                                          device=occ.device))
    return rows, pos[-1:]


def _fused_pillar_conv_cuda(feats, nbr, weights, *, kz, z_stride, z_pad,
                            scale, bias, occ_out, residual, relu, occ_in,
                            fold_occ):
    dev = feats.device
    _require(feats.dim() == 3 and feats.is_contiguous(),
             "feats must be contiguous (P_in, Z_in, Cin)")
    p_in, z_in, cin = feats.shape
    _require(nbr.dim() == 2 and nbr.dtype == torch.int32
             and nbr.is_contiguous() and nbr.device == dev,
             "nbr must be contiguous int32 (P_out, KB) on the feats device")
    p_out, kb = nbr.shape
    _require(kb in (1, 9), f"KB must be 9 or 1, got {kb}")
    _require(weights.dim() == 3 and weights.shape[0] == kz * kb
             and weights.shape[1] == cin and weights.device == dev,
             f"weights must be (kz*KB, Cin, Cout), got {tuple(weights.shape)}")
    cout = weights.shape[2]
    z_out = (z_in + 2 * z_pad - kz) // z_stride + 1
    for name, t in (("scale", scale), ("bias", bias)):
        _require(t is None or (t.shape == (cout,) and t.dtype == torch.float32
                               and t.is_contiguous() and t.device == dev),
                 f"{name} must be contiguous float32 (Cout,)")
    _require(residual is None or (
        residual.shape == (p_out, z_out, cout) and residual.dtype ==
        feats.dtype and residual.is_contiguous() and residual.device == dev),
        "residual must be contiguous (P_out, Z_out, Cout) in the feats dtype")
    lib = _build.lib()
    stream = _build.stream_ptr(dev)
    if fold_occ:
        _require(occ_out is None and occ_in is not None
                 and occ_in.shape == (p_in, z_in)
                 and occ_in.dtype == torch.bool and occ_in.is_contiguous(),
                 "fold_occ takes contiguous bool occ_in (P_in, Z_in) and no "
                 "occ_out")
        occ = torch.empty(p_out, z_out, dtype=torch.bool, device=dev)
        _build.check(lib.cmt_pillar_occ_fold(
            occ_in.data_ptr(), nbr.data_ptr(), occ.data_ptr(), p_in, z_in,
            p_out, z_out, kb, kz, z_stride, z_pad, stream),
            "cmt_pillar_occ_fold")
    else:
        _require(occ_out is not None and occ_out.shape == (p_out, z_out)
                 and occ_out.dtype == torch.bool,
                 "the kernel takes bool occ_out (P_out, Z_out)")
        occ = occ_out.contiguous()
    rows, count = _active_rows(occ)
    w = weights.to(feats.dtype).contiguous()
    # the kernel writes the occupied rows only; the rest stay zero
    out = torch.zeros(p_out, z_out, cout, dtype=feats.dtype, device=dev)
    name = "pillar_conv_kb9" if kb == 9 else "pillar_conv_kb1"
    fn = getattr(lib, "cmt_" + name)
    _build.check(fn(
        _build.dtype_code(feats.dtype), feats.data_ptr(), nbr.data_ptr(),
        w.data_ptr(), _build.ptr(scale), _build.ptr(bias),
        _build.ptr(residual), rows.data_ptr(), count.data_ptr(),
        out.data_ptr(), p_out * z_out, p_in, z_in, cin, z_out, cout, kz,
        z_stride, z_pad, int(relu), stream), "cmt_" + name)
    _build.count(name)
    return (out, occ) if fold_occ else out


def pin_rows_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 10: a row-major copy."""
    return x.clone()


def pin_rows(x: torch.Tensor) -> torch.Tensor:
    """A new row-major copy of the contiguous (P, W) tensor `x`, of any
    element type (kernel 10 on a CUDA tensor)."""
    if x.device.type == "cpu":
        return pin_rows_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"pin_rows: no kernel for {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("pin_rows: x must be a contiguous (P, W) tensor")
    out = torch.empty_like(x)
    if x.numel():
        _build.check(_build.lib().cmt_rows_copy(
            x.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1] * x.element_size(), _build.stream_ptr(x.device)),
            "cmt_rows_copy")
        _build.count("rows_copy")
    return out
