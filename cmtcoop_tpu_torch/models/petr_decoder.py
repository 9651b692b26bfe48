"""DETR-style PETR decoder (counterpart of
cmtcoop_tpu/models/petr_decoder.py).

Layer order self_attn, norm, cross_attn, norm, ffn, norm (post-LN); the
shared `post_norm` is applied to every intermediate output; the position
encoding is added to queries and keys, not values; `memory + memory_pos` is
computed once outside the layer loop. LayerNorm eps 1e-6 (flax's default).
The self-attention is plain torch (`attend` with the DN bias as a 2D bias).
The cross-attention runs kernel 3 (`flash_attention_packed`) on the
head-packed projections in eval mode, and kernels 7 and 8
(`attend(impl="flash")`) on (B, H, N, Dh) views of the same projections in
train mode; neither pads. A layer is `pre_cross` (the self-attention
block and the cross-attention's projections), the attention, `post_cross`
(its output projection, the norm and the FFN), in train and eval alike. In
eval (`eval_forward`) the decoder is the segments of a `models/graphs.Frame`
between its kernel-3 calls, which run on the host through this module's
`flash_attention_packed`. In train mode each attention drops its softmax
weights and its output at `dropout` (the FFN's dropout is 0.0, as in the
JAX decoder), and each layer is checkpointed (`remat`, the reference's
with_cp). Every dropout seed of a layer is drawn before the layer runs, so
the checkpoint's recompute draws the same masks.
State keys follow the reference: `layers.{l}.attentions.0.attn.in_proj_*`
(torch MultiheadAttention), `attentions.1.attn.Wqkv.*` (packed flash
projection), `attentions.{0,1}.attn.out_proj.*`, `ffns.0.layers.*`,
`norms.{0,1,2}.*`, `post_norm.*`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cmtcoop_tpu_torch.models.graphs import EAGER, Frame
from cmtcoop_tpu_torch.models.layers import FFN, LayerNorm, Linear
from cmtcoop_tpu_torch.ops.attention import (attend, dropout,
                                             flash_attention_packed)

SEEDS_PER_LAYER = 4  # self-attn P, its output, cross-attn P, its output


def _qkv(x, weight, bias, i, dt):
    c = weight.shape[1]
    return F.linear(x.to(dt), weight[i * c:(i + 1) * c].to(dt),
                    bias[i * c:(i + 1) * c].to(dt))


def _split(x, h):
    """(B, N, C) -> (B, H, N, C/H) view."""
    b, n, c = x.shape
    return x.view(b, n, h, c // h).transpose(1, 2)


def _merge(x):
    """(B, H, N, Dh) -> (B, N, H*Dh)."""
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (`in_proj_weight`,
    `in_proj_bias`, `out_proj`) on (B, N, C), plain softmax attention with
    an optional additive bias and softmax dropout."""

    def __init__(self, c: int, heads: int, compute_dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.compute_dtype = compute_dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = Linear(c, c, compute_dtype=compute_dtype)

    def forward(self, q, k, v, bias=None, dropout_rate: float = 0.0,
                seed: int = 0):
        dt, h = self.compute_dtype, self.heads
        qh, kh, vh = (_split(_qkv(x, self.in_proj_weight, self.in_proj_bias,
                                  i, dt), h) for i, x in enumerate((q, k, v)))
        out = attend(qh, kh, vh, bias=bias, impl="reference",
                     dropout_rate=dropout_rate, seed=seed)
        return self.out_proj(_merge(out))


class FlashMultiheadAttention(nn.Module):
    """Cross-attention with a packed `Wqkv` projection and `out_proj`:
    `project`, then `attention` (kernel 3 on the (B, N, H*Dh) projections in
    eval mode; in train mode kernels 7 and 8 on their (B, H, N, Dh) views,
    with dropout), then `out_proj`. No key is masked: the memory is not
    padded (the JAX decoder's `memory_k_bias` masks its padding)."""

    def __init__(self, c: int, heads: int, compute_dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.compute_dtype = compute_dtype
        self.Wqkv = Linear(c, 3 * c, compute_dtype=compute_dtype)
        self.out_proj = Linear(c, c, compute_dtype=compute_dtype)

    def project(self, q, k, v):
        """(qp, kp, vp): the packed projections in the compute dtype."""
        w, bias, dt = self.Wqkv.weight, self.Wqkv.bias, self.compute_dtype
        return tuple(_qkv(x, w, bias, i, dt) for i, x in enumerate((q, k, v)))

    def attention(self, qp, kp, vp, dropout_rate: float = 0.0,
                  seed: int = 0):
        """The (B, Nq, H*Dh) attention of the projections, before
        `out_proj`."""
        h = self.heads
        if not self.training:
            return flash_attention_packed(qp, kp, vp, None, h)
        return _merge(attend(_split(qp, h), _split(kp, h), _split(vp, h),
                             impl="flash", dropout_rate=dropout_rate,
                             seed=seed))

    def forward(self, q, k, v, dropout_rate: float = 0.0, seed: int = 0):
        return self.out_proj(self.attention(*self.project(q, k, v),
                                            dropout_rate, seed))


class _AttnSlot(nn.Module):
    """Holds an attention under `.attn`, as mmcv's attention wrappers do."""

    def __init__(self, attn: nn.Module):
        super().__init__()
        self.attn = attn


class PETRDecoderLayer(nn.Module):
    def __init__(self, c: int = 256, heads: int = 8, ffn: int = 1024,
                 compute_dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.attentions = nn.ModuleList([
            _AttnSlot(MultiheadAttention(c, heads, compute_dtype)),
            _AttnSlot(FlashMultiheadAttention(c, heads, compute_dtype))])
        self.ffns = nn.ModuleList([FFN(c, ffn, compute_dtype)])
        self.norms = nn.ModuleList(
            [LayerNorm(c, compute_dtype=compute_dtype) for _ in range(3)])

    def forward(self, query, memory, query_pos, memory_pe,
                self_attn_bias=None,
                seeds: Sequence[int] = (0,) * SEEDS_PER_LAYER):
        rate = self.dropout if self.training else 0.0
        query, qkv = self.pre_cross(query, memory, query_pos, memory_pe,
                                    self_attn_bias, rate, seeds)
        attn = self.attentions[1].attn.attention(*qkv, rate, seeds[2])
        return self.post_cross(query, attn, rate, seeds[3])

    def pre_cross(self, query, memory, query_pos, memory_pe,
                  self_attn_bias=None, rate: float = 0.0,
                  seeds: Sequence[int] = (0,) * SEEDS_PER_LAYER):
        """The self-attention block -> (query, the cross-attention's
        projections (qp, kp, vp))."""
        q = query + query_pos
        out = self.attentions[0].attn(q, q, query, self_attn_bias, rate,
                                      seeds[0])
        query = self.norms[0](query + dropout(out, rate, seeds[1]))
        return query, self.attentions[1].attn.project(query + query_pos,
                                                      memory_pe, memory)

    def post_cross(self, query, attn, rate: float = 0.0, seed: int = 0):
        """From the cross-attention `attn` (before `out_proj`) on."""
        out = self.attentions[1].attn.out_proj(attn)
        query = self.norms[1](query + dropout(out, rate, seed))
        return self.norms[2](self.ffns[0](query))


class PETRTransformerDecoder(nn.Module):
    """num_layers decoder layers; returns every intermediate output through
    the shared post_norm, stacked (L, B, Nq, C)."""

    def __init__(self, num_layers: int = 6, c: int = 256, heads: int = 8,
                 ffn: int = 1024, compute_dtype=torch.float32,
                 dropout: float = 0.1, remat: bool = True):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList([
            PETRDecoderLayer(c, heads, ffn, compute_dtype, dropout)
            for _ in range(num_layers)])
        self.post_norm = LayerNorm(c, compute_dtype=compute_dtype)

    def forward(self, query, memory, query_pos, memory_pos,
                self_attn_bias=None,
                generator: Optional[torch.Generator] = None):
        """`generator` (a CPU generator) gives each layer's dropout seeds in
        train mode."""
        memory_pe = memory + memory_pos
        n = len(self.layers)
        seeds = [[0] * SEEDS_PER_LAYER] * n
        if self.training:
            seeds = torch.randint(0, 2 ** 31 - 1, (n, SEEDS_PER_LAYER),
                                  generator=generator).tolist()
        inter = []
        for layer, s in zip(self.layers, seeds):
            args = (query, memory, query_pos, memory_pe, self_attn_bias, s)
            if self.training and self.remat:
                query = checkpoint(layer, *args, use_reentrant=False)
            else:
                query = layer(*args)
            inter.append(self.post_norm(query))
        return torch.stack(inter, dim=0)

    def eval_forward(self, memory, query_pos, memory_pos,
                     frame: Frame = EAGER):
        """`forward` in eval from a zero target, as segments of `frame`: the
        first ends with layer 0's cross-attention projections, each next one
        takes a kernel-3 output (made on the host) and ends with the next
        layer's projections, the last with the stacked outputs."""
        state, qkv = frame(self._eval_first, memory, query_pos, memory_pos)
        for i, layer in enumerate(self.layers):
            attn = layer.attentions[1].attn.attention(*qkv)
            state, qkv = frame(self._eval_next, i, state, attn)
        return state

    def _eval_first(self, memory, query_pos, memory_pos):
        memory_pe = memory + memory_pos
        query, qkv = self.layers[0].pre_cross(torch.zeros_like(query_pos),
                                              memory, query_pos, memory_pe)
        return (query, [], memory, memory_pe, query_pos), qkv

    def _eval_next(self, i, state, attn):
        query, inter, memory, memory_pe, query_pos = state
        query = self.layers[i].post_cross(query, attn)
        inter = inter + [self.post_norm(query)]
        if i + 1 == len(self.layers):
            return torch.stack(inter, dim=0), ()
        query, qkv = self.layers[i + 1].pre_cross(query, memory, query_pos,
                                                  memory_pe)
        return (query, inter, memory, memory_pe, query_pos), qkv
