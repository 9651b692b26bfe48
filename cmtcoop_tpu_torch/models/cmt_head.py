"""CMT detection head, eval, LiDAR BEV tokens only (counterpart of
`CmtHead` in cmtcoop_tpu/models/cmt_head.py with `with_rv=False`).

Per agent: `shared_conv` (kernel 4) on the BEV map, BEV tokens in row-major
(y, x) order with the separable BEV position table, one 6-layer decoder
pass; with several agents the per-layer decoder outputs are fused by an
element-wise max after `nan_to_num` (the coop head). Then the grouped task
heads. State keys follow the reference (`shared_conv.conv/bn`,
`reference_points.weight`, `bev_embedding.{0,2}`, `transformer.decoder.*`,
`task_heads.{t}.{name}.{0,1,3}`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from cmtcoop_tpu_torch.core.boxes import inverse_sigmoid
from cmtcoop_tpu_torch.core.pos_embed import bev_pos2embed_grid, pos2embed
from cmtcoop_tpu_torch.models.layers import MLP, ConvBNReLU
from cmtcoop_tpu_torch.models.petr_decoder import PETRTransformerDecoder

COMMON_HEADS: Tuple[Tuple[str, int], ...] = (
    ("center", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2))


class GroupedDense(nn.Module):
    """Per-decoder-layer 1x1 Conv1d with `groups = L`: weight
    (L*Cout, Cin, 1), bias (L*Cout,); applied to (L, B, Q, Cin)."""

    def __init__(self, groups: int, cin: int, cout: int, bias: bool):
        super().__init__()
        self.groups, self.cout = groups, cout
        self.weight = nn.Parameter(torch.empty(groups * cout, cin, 1))
        self.bias = nn.Parameter(torch.zeros(groups * cout)) if bias else None

    def forward(self, x):
        w = self.weight.view(self.groups, self.cout, -1).to(x.dtype)
        y = torch.einsum("lbqc,loc->lbqo", x, w)
        if self.bias is not None:
            y = y + self.bias.view(self.groups, 1, 1, self.cout).to(x.dtype)
        return y


class GroupLayerNorm(nn.Module):
    """Per-group LayerNorm over channels, eps 1e-6: weight/bias (L*C,)."""

    def __init__(self, groups: int, c: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.c, self.eps = groups, c, eps
        self.weight = nn.Parameter(torch.ones(groups * c))
        self.bias = nn.Parameter(torch.zeros(groups * c))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        shape = (self.groups, 1, 1, self.c)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class SeparateTaskHead(nn.ModuleDict):
    """One branch per output name: GroupedDense -> GroupLayerNorm -> ReLU
    -> GroupedDense, one weight group per decoder layer."""

    def __init__(self, num_cls: int, groups: int, cin: int,
                 head_conv: int = 64):
        heads = COMMON_HEADS + (("cls_logits", num_cls),)
        super().__init__({
            name: nn.Sequential(
                GroupedDense(groups, cin, head_conv, bias=False),
                GroupLayerNorm(groups, head_conv), nn.ReLU(),
                GroupedDense(groups, head_conv, out_dim, bias=True))
            for name, out_dim in heads})

    def forward(self, outs_dec) -> Dict[str, torch.Tensor]:
        return {name: branch(outs_dec) for name, branch in self.items()}


class CmtHead(nn.Module):
    """Eval CmtHead over one or more agents' BEV maps (`with_rv=False`).

    `max_gt`, `dn_groups` and `depth_num` are the JAX head's training and
    camera settings; they are accepted so presets build, and unused here."""

    def __init__(self, num_query: int = 900, hidden_dim: int = 256,
                 in_channels: int = 512, downsample_scale: int = 8,
                 pc_range: Sequence[float] = (-72.0, -72.0, -8.0,
                                              72.0, 72.0, 0.0),
                 grid_size: Tuple[int, int] = (1440, 1440),
                 tasks: Sequence[Sequence[str]] = (
                     ("CAR", "TRAILER", "TRUCK", "VAN", "PEDESTRIAN", "BUS",
                      "BICYCLE"),),
                 num_decoder_layers: int = 6, num_heads: int = 8,
                 feedforward_channels: int = 1024,
                 max_gt: int = 32, dn_groups: int = 5, depth_num: int = 64,
                 compute_dtype=torch.float32):
        super().__init__()
        del max_gt, dn_groups, depth_num
        self.hidden_dim = hidden_dim
        self.downsample_scale = downsample_scale
        self.pc_range = tuple(pc_range)
        self.grid_size = tuple(grid_size)
        self.tasks = tuple(tuple(t) for t in tasks)
        self.compute_dtype = compute_dtype
        self.shared_conv = ConvBNReLU(in_channels, hidden_dim, eps=1e-5)
        self.bev_embedding = MLP(2 * hidden_dim, hidden_dim, hidden_dim,
                                 compute_dtype)
        self.reference_points = nn.Embedding(num_query, 3)
        self.transformer = nn.Module()
        self.transformer.decoder = PETRTransformerDecoder(
            num_decoder_layers, hidden_dim, num_heads, feedforward_channels,
            compute_dtype)
        self.task_heads = nn.ModuleList([
            SeparateTaskHead(len(names), num_decoder_layers, hidden_dim)
            for names in self.tasks])

    def forward(self, bev_feats: Sequence[torch.Tensor]):
        """bev_feats: one (B, Hb, Wb, C_in) map per agent. Returns
        (task_outs, None): per task a dict of (L, B, Nq, ·) outputs (center
        and height in metres), and no denoising info (eval)."""
        batch = bev_feats[0].shape[0]
        ref = self.reference_points.weight
        padded_ref = ref[None].expand(batch, *ref.shape)
        ref01 = torch.sigmoid(inverse_sigmoid(padded_ref))
        query_pos = self.bev_embedding(
            pos2embed(ref01, self.hidden_dim).to(self.compute_dtype))
        outs_decs = [self.run_decoder(*self.build_memory(bev), query_pos)
                     for bev in bev_feats]
        if len(outs_decs) == 1:
            outs_dec = outs_decs[0]
        else:  # coop max fusion
            outs_dec = torch.stack(outs_decs, dim=0).amax(dim=0)
        return self.run_task_heads(outs_dec, padded_ref), None

    def build_memory(self, bev: torch.Tensor):
        """Token memory (B, Hb*Wb, C) in row-major (y, x) order + its PE."""
        x = self.shared_conv(bev.to(self.compute_dtype))
        b, hb, wb, c = x.shape
        tokens = x.reshape(b, hb * wb, c)
        table = bev_pos2embed_grid((self.grid_size[1], self.grid_size[0]),
                                   self.downsample_scale, self.hidden_dim,
                                   device=x.device)
        bev_pos = self.bev_embedding(table.to(self.compute_dtype))
        return tokens, bev_pos[None].expand(b, *bev_pos.shape)

    def run_decoder(self, memory, memory_pos, query_pos):
        target = torch.zeros_like(query_pos)
        outs_dec = self.transformer.decoder(target, memory, query_pos,
                                            memory_pos)
        return torch.nan_to_num(outs_dec)

    def run_task_heads(self, outs_dec, padded_ref) -> List[Dict]:
        reference = inverse_sigmoid(padded_ref)
        lo = self.pc_range
        task_outs = []
        for head in self.task_heads:
            outs = head(outs_dec)
            center = torch.sigmoid(outs["center"] + reference[None, ..., :2])
            height = torch.sigmoid(outs["height"] + reference[None, ..., 2:3])
            cx = center[..., 0:1] * (lo[3] - lo[0]) + lo[0]
            cy = center[..., 1:2] * (lo[4] - lo[1]) + lo[1]
            outs["center"] = torch.cat([cx, cy], dim=-1)
            outs["height"] = height * (lo[5] - lo[2]) + lo[2]
            task_outs.append(outs)
        return task_outs
