"""Eval attention on head-packed projections (counterpart of
`flash_attention_packed` in cmtcoop_tpu/ops/attention.py).

`flash_attention_packed` takes the plain version for a CPU tensor and
launches the hand-written CUDA kernel (csrc/flash_attention.cu, kernel 3)
for a CUDA tensor. The kernel masks the ragged query and key edges itself,
so callers pad nothing.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from cmtcoop_tpu_torch import _build

NEG_INF = -1e9
KERNEL_HEAD_DIMS = (4, 8, 16, 32)


def mha_reference(q, k, v, bias: Optional[torch.Tensor] = None):
    """Plain softmax attention on (B, H, N, Dh), float32 logits; `bias`
    additive, broadcastable to (B, H, Nq, Nk)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits / math.sqrt(q.shape[-1])
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float()).to(v.dtype)


def flash_attention_packed_reference(q, k, v, k_bias, num_heads: int):
    """Plain version: softmax(q.k^T / sqrt(Dh) + bias) @ v per head."""
    b, nq, c = q.shape
    dh = c // num_heads

    def split(x):
        return x.reshape(b, -1, num_heads, dh).transpose(1, 2)

    out = mha_reference(split(q), split(k), split(v),
                        k_bias[:, None, None, :])
    return out.transpose(1, 2).reshape(b, nq, c)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_bias: Optional[torch.Tensor],
                           num_heads: int) -> torch.Tensor:
    """q (B, Nq, H*Dh), k/v (B, Nk, H*Dh), k_bias (B, Nk) additive (0 or
    NEG_INF; None = no mask) -> (B, Nq, H*Dh)."""
    b, nq, c = q.shape
    nk = k.shape[1]
    if k_bias is None:
        k_bias = torch.zeros(b, nk, dtype=torch.float32, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_packed_reference(q, k, v, k_bias, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_packed: no kernel for {q.device}")
    dh = c // num_heads
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (t.is_contiguous() and t.dtype == q.dtype
                and t.device == q.device and t.dim() == 3):
            raise ValueError(f"flash_attention_packed: {name} must be a "
                             "contiguous 3-D tensor like q")
    if (c % num_heads or dh not in KERNEL_HEAD_DIMS or k.shape != (b, nk, c)
            or v.shape != (b, nk, c)):
        raise ValueError(f"flash_attention_packed: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} heads "
                         f"{num_heads} (Dh must be one of {KERNEL_HEAD_DIMS})")
    k_bias = k_bias.to(torch.float32).contiguous()
    if k_bias.shape != (b, nk):
        raise ValueError("flash_attention_packed: k_bias must be (B, Nk)")
    out = torch.empty_like(q)
    lib = _build.lib()
    _build.check(lib.cmt_flash_attention_packed(
        _build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_bias.data_ptr(), out.data_ptr(), b, nq, nk, num_heads, dh,
        1.0 / math.sqrt(dh), _build.stream_ptr(q.device)),
        "cmt_flash_attention_packed")
    _build.count("flash_attention_packed")
    return out
