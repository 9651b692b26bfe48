"""DETR-style PETR decoder, eval (counterpart of
cmtcoop_tpu/models/petr_decoder.py).

Layer order self_attn, norm, cross_attn, norm, ffn, norm (post-LN); the
shared `post_norm` is applied to every intermediate output; the position
encoding is added to queries and keys, not values; `memory + memory_pos` is
computed once outside the layer loop. LayerNorm eps 1e-6 (flax's default).
The self-attention is plain torch; the cross-attention runs kernel 3
(`flash_attention_packed`) on the head-packed projections, unpadded.
State keys follow the reference: `layers.{l}.attentions.0.attn.in_proj_*`
(torch MultiheadAttention), `attentions.1.attn.Wqkv.*` (packed flash
projection), `attentions.{0,1}.attn.out_proj.*`, `ffns.0.layers.*`,
`norms.{0,1,2}.*`, `post_norm.*`.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cmtcoop_tpu_torch.models.layers import FFN, LayerNorm, Linear
from cmtcoop_tpu_torch.ops.attention import (flash_attention_packed,
                                             mha_reference)


def _qkv(x, weight, bias, i, dt):
    c = weight.shape[1]
    return F.linear(x.to(dt), weight[i * c:(i + 1) * c].to(dt),
                    bias[i * c:(i + 1) * c].to(dt))


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (`in_proj_weight`,
    `in_proj_bias`, `out_proj`), eval forward on (B, N, C) with plain
    softmax attention."""

    def __init__(self, c: int, heads: int, compute_dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.compute_dtype = compute_dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = Linear(c, c, compute_dtype=compute_dtype)

    def forward(self, q, k, v):
        b, nq, c = q.shape
        dt, h = self.compute_dtype, self.heads

        def split(x):
            return x.reshape(b, -1, h, c // h).transpose(1, 2)

        qh, kh, vh = (split(_qkv(x, self.in_proj_weight, self.in_proj_bias,
                                 i, dt)) for i, x in enumerate((q, k, v)))
        out = mha_reference(qh, kh, vh)
        return self.out_proj(out.transpose(1, 2).reshape(b, nq, c))


class FlashMultiheadAttention(nn.Module):
    """Cross-attention with a packed `Wqkv` projection and `out_proj`; the
    attention itself is kernel 3 on (B, N, H*Dh) projections."""

    def __init__(self, c: int, heads: int, compute_dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.compute_dtype = compute_dtype
        self.Wqkv = Linear(c, 3 * c, compute_dtype=compute_dtype)
        self.out_proj = Linear(c, c, compute_dtype=compute_dtype)

    def forward(self, q, k, v):
        dt = self.compute_dtype
        w, bias = self.Wqkv.weight, self.Wqkv.bias
        out = flash_attention_packed(
            _qkv(q, w, bias, 0, dt), _qkv(k, w, bias, 1, dt),
            _qkv(v, w, bias, 2, dt), None, self.heads)
        return self.out_proj(out)


class _AttnSlot(nn.Module):
    """Holds an attention under `.attn`, as mmcv's attention wrappers do."""

    def __init__(self, attn: nn.Module):
        super().__init__()
        self.attn = attn


class PETRDecoderLayer(nn.Module):
    def __init__(self, c: int = 256, heads: int = 8, ffn: int = 1024,
                 compute_dtype=torch.float32):
        super().__init__()
        self.attentions = nn.ModuleList([
            _AttnSlot(MultiheadAttention(c, heads, compute_dtype)),
            _AttnSlot(FlashMultiheadAttention(c, heads, compute_dtype))])
        self.ffns = nn.ModuleList([FFN(c, ffn, compute_dtype)])
        self.norms = nn.ModuleList(
            [LayerNorm(c, compute_dtype=compute_dtype) for _ in range(3)])

    def forward(self, query, memory, query_pos, memory_pe):
        q = query + query_pos
        out = self.attentions[0].attn(q, q, query)
        query = self.norms[0](query + out)
        q = query + query_pos
        out = self.attentions[1].attn(q, memory_pe, memory)
        query = self.norms[1](query + out)
        return self.norms[2](self.ffns[0](query))


class PETRTransformerDecoder(nn.Module):
    """num_layers decoder layers; returns every intermediate output through
    the shared post_norm, stacked (L, B, Nq, C)."""

    def __init__(self, num_layers: int = 6, c: int = 256, heads: int = 8,
                 ffn: int = 1024, compute_dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([
            PETRDecoderLayer(c, heads, ffn, compute_dtype)
            for _ in range(num_layers)])
        self.post_norm = LayerNorm(c, compute_dtype=compute_dtype)

    def forward(self, query, memory, query_pos, memory_pos):
        memory_pe = memory + memory_pos
        inter = []
        for layer in self.layers:
            query = layer(query, memory, query_pos, memory_pe)
            inter.append(self.post_norm(query))
        return torch.stack(inter, dim=0)
