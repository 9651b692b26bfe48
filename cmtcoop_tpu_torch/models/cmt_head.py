"""CMT detection head (counterpart of `CmtHead` in
cmtcoop_tpu/models/cmt_head.py).

Per agent (`AgentInputs`): the token memory is the BEV tokens (`shared_conv`,
kernel 4, in row-major (y, x) order, with the separable BEV position table)
when `with_bev`, then the image tokens in (view, h, w) order with their
frustum-ray position encoding (`_rv_pe`) when `with_rv`. The query
position encoding is `bev_embedding(pos2embed(ref))`, plus the queries'
back-projected rays summed over the views they land in (`_rv_query_embed`)
when `with_rv`. One 6-layer decoder pass per agent; with several agents the
per-layer decoder outputs are fused by an element-wise max after
`nan_to_num` (the coop head). Then the grouped task heads. In train mode
with ground truth, DN-DETR denoising (static caps: `max_gt` GT slots times
`dn_groups` groups of noised queries ahead of the `num_query` matching
queries, blocked from each other by `dn_attn_bias`) and the `dn_` outputs
split off for the loss. State keys follow
the reference (`shared_conv.conv/bn`, `reference_points.weight`,
`bev_embedding.{0,2}`, `rv_embedding.{0,2}`, `transformer.decoder.*`,
`task_heads.{t}.{name}.{0,1,3}`).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from cmtcoop_tpu_torch.core.boxes import inverse_sigmoid, normalize_01
from cmtcoop_tpu_torch.core.pos_embed import (bev_pos2embed_grid, depth_bins,
                                              frustum_coords, pos2embed)
from cmtcoop_tpu_torch.models.graphs import EAGER, Frame
from cmtcoop_tpu_torch.models.layers import MLP, ConvBNReLU
from cmtcoop_tpu_torch.models.petr_decoder import PETRTransformerDecoder
from cmtcoop_tpu_torch.ops.attention import NEG_INF
from cmtcoop_tpu_torch.utils.constants import constant
from cmtcoop_tpu_torch.utils.profiling import span

COMMON_HEADS: Tuple[Tuple[str, int], ...] = (
    ("center", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2))


class AgentInputs(NamedTuple):
    """One agent's feature inputs to the head."""
    bev_feat: Optional[torch.Tensor] = None   # (B, Hb, Wb, C_in)
    img_feats: Optional[torch.Tensor] = None  # (B, V, Hf, Wf, C)
    lidar2img: Optional[torch.Tensor] = None  # (B, V, 4, 4)
    img2lidar: Optional[torch.Tensor] = None  # (B, V, 4, 4)
    pad_hw: Optional[Tuple[int, int]] = None


class DNInfo(NamedTuple):
    """Static-shape denoising metadata carried to the loss."""
    known_labels: torch.Tensor      # (B, groups, G) label after the split
    known_labels_raw: torch.Tensor  # (B, groups, G) label, no split
    known_boxes: torch.Tensor       # (B, groups, G, 9) gravity-centred box9
    valid: torch.Tensor             # (B, groups, G) slot validity
    pad_size: int


def dn_attn_bias(num_query: int, max_gt: int, groups: int,
                 device=None) -> torch.Tensor:
    """(tgt, tgt) float32 additive self-attention bias, tgt = max_gt *
    groups + num_query: the matching queries cannot see the DN slots and the
    DN groups cannot see each other (NEG_INF where blocked)."""
    pad = max_gt * groups
    idx = torch.arange(pad + num_query, device=device)
    dn_row = idx < pad
    gid = torch.where(dn_row, idx // max(max_gt, 1), groups)
    blocked = (dn_row[:, None] & dn_row[None, :]
               & (gid[:, None] != gid[None, :])) | (~dn_row[:, None]
                                                    & dn_row[None, :])
    return torch.where(blocked, NEG_INF, 0.0).to(torch.float32)


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
    """CmtHead over one or more agents: `with_bev` takes the LiDAR BEV
    tokens, `with_rv` the image tokens (CmtLidarHead / CmtImageHead when
    only one is set). `max_gt`, `dn_groups`, `noise_scale`, `noise_trans`
    and `split` set the train-mode denoising, `dropout` and `remat` the
    decoder's train mode."""

    def __init__(self, num_query: int = 900, hidden_dim: int = 256,
                 in_channels: int = 512, depth_num: int = 64,
                 downsample_scale: int = 8,
                 pc_range: Sequence[float] = (-72.0, -72.0, -8.0,
                                              72.0, 72.0, 0.0),
                 grid_size: Tuple[int, int] = (1440, 1440),
                 tasks: Sequence[Sequence[str]] = (
                     ("CAR", "TRAILER", "TRUCK", "VAN", "PEDESTRIAN", "BUS",
                      "BICYCLE"),),
                 with_bev: bool = True, with_rv: bool = True,
                 num_decoder_layers: int = 6, num_heads: int = 8,
                 feedforward_channels: int = 1024,
                 max_gt: int = 32, dn_groups: int = 5,
                 noise_scale: float = 1.0, noise_trans: float = 0.0,
                 split: float = 0.75, dropout: float = 0.1,
                 remat: bool = True, compute_dtype=torch.float32):
        super().__init__()
        self.num_query = num_query
        self.max_gt, self.dn_groups = max_gt, dn_groups
        self.noise_scale, self.noise_trans = noise_scale, noise_trans
        self.split = split
        self.hidden_dim = hidden_dim
        self.depth_num = depth_num
        self.downsample_scale = downsample_scale
        self.pc_range = tuple(pc_range)
        self.grid_size = tuple(grid_size)
        self.tasks = tuple(tuple(t) for t in tasks)
        self.with_bev, self.with_rv = with_bev, with_rv
        self.compute_dtype = compute_dtype
        if with_bev:
            self.shared_conv = ConvBNReLU(in_channels, hidden_dim, eps=1e-5)
        # the query PE always takes bev_embedding, camera-only too
        self.bev_embedding = MLP(2 * hidden_dim, hidden_dim, hidden_dim,
                                 compute_dtype)
        if with_rv:
            self.rv_embedding = MLP(depth_num * 3, hidden_dim * 4,
                                    hidden_dim, compute_dtype)
        self.reference_points = nn.Embedding(num_query, 3)
        self.transformer = nn.Module()
        self.transformer.decoder = PETRTransformerDecoder(
            num_decoder_layers, hidden_dim, num_heads, feedforward_channels,
            compute_dtype, dropout, remat)
        self.task_heads = nn.ModuleList([
            SeparateTaskHead(len(names), num_decoder_layers, hidden_dim)
            for names in self.tasks])

    @property
    def total_classes(self) -> int:
        return sum(len(t) for t in self.tasks)

    def prepare_for_dn(self, ref_points, gt_boxes, gt_labels, gt_mask,
                       rand) -> Tuple[torch.Tensor, DNInfo]:
        """Noised GT queries (reference cmt_head.py:339-415 with static
        shapes): gt_boxes (B, G, 9) gravity-centred, gt_labels (B, G),
        gt_mask (B, G), `rand` (B, groups, G, 3) uniform in [-1, 1). Returns
        the (B, groups * G + num_query, 3) reference points in [0, 1] and
        the DNInfo."""
        b, g = gt_labels.shape
        groups = self.dn_groups
        centers = gt_boxes[:, None, :, :3]
        labels_rep = gt_labels[:, None, :].expand(b, groups, g)
        if self.noise_scale > 0:
            diff = gt_boxes[:, None, :, 3:6] / 2.0 + self.noise_trans
            noisy = centers + rand * diff * self.noise_scale
            n01 = normalize_01(noisy, self.pc_range).clamp(0.0, 1.0)
            over_split = torch.linalg.vector_norm(rand, dim=-1) > self.split
            known_labels = torch.where(over_split, self.total_classes,
                                       labels_rep)
        else:
            n01 = normalize_01(centers + 0 * rand, self.pc_range).clamp(0.0,
                                                                       1.0)
            known_labels = labels_rep
        boxes_rep = gt_boxes[:, None].expand(b, groups, g, gt_boxes.shape[-1])
        valid = gt_mask[:, None, :].expand(b, groups, g)
        dn_ref = torch.where(valid[..., None], n01, 0.0).reshape(b, -1, 3)
        padded_ref = torch.cat(
            [dn_ref, ref_points[None].expand(b, *ref_points.shape)], dim=1)
        return padded_ref, DNInfo(known_labels, labels_rep, boxes_rep, valid,
                                  groups * g)

    def forward(self, agents: Sequence[AgentInputs], gt_boxes=None,
                gt_labels=None, gt_mask=None, rngs=None,
                frame: Frame = EAGER):
        """One `AgentInputs` per agent. Returns (task_outs, dn_info): per task
        a dict of (L, B, Nq, ·) outputs (center and height in metres), plus
        the `dn_` outputs and the DNInfo in train mode with ground truth.
        `rngs` (`.dn`, `.dropout`: CPU generators) gives the DN noise and
        the decoder's dropout seeds in train mode. Every stage's body is a
        segment of `frame` (models/graphs.py); between them only kernel 4's
        `shared_conv` and the decoder's kernel-3 calls run on the host."""
        first = agents[0]
        batch = (first.bev_feat if first.bev_feat is not None
                 else first.img_feats).shape[0]
        dn_info = None
        if self.training and gt_boxes is not None:
            ref = self.reference_points.weight
            b, g = gt_labels.shape
            rand = torch.rand((b, self.dn_groups, g, 3),
                              generator=rngs.dn if rngs else None)
            padded_ref, dn_info = self.prepare_for_dn(
                ref, gt_boxes.float(), gt_labels, gt_mask.bool(),
                (rand * 2.0 - 1.0).to(ref.device))
            queries = self.query_embed(padded_ref)
        else:
            queries = self.eval_queries(batch, frame)
        padded_ref, ref01, bev_query_pos = queries
        generator = rngs.dropout if rngs else None
        outs_decs = []
        for agent in agents:
            memory, memory_pos = self.build_memory(agent, frame)
            query_pos = bev_query_pos
            if self.with_rv:
                query_pos = self._rv_query_embed(
                    query_pos, ref01, agent.lidar2img, agent.img2lidar,
                    agent.pad_hw, frame)
            outs_decs.append(self.run_decoder(memory, memory_pos, query_pos,
                                              generator, frame))
        return self.run_task_heads(outs_decs, padded_ref, dn_info,
                                   frame), dn_info

    def query_embed(self, padded_ref):
        """(B, N, 3) reference points in [0, 1] -> (padded_ref, ref01, the
        queries' BEV position encoding (B, N, hidden))."""
        ref01 = torch.sigmoid(inverse_sigmoid(padded_ref))
        return padded_ref, ref01, self.bev_embedding(
            pos2embed(ref01, self.hidden_dim).to(self.compute_dtype))

    @span("head memory")
    def eval_queries(self, batch: int, frame: Frame = EAGER):
        """`query_embed` of the learned reference points (no DN queries)."""
        return frame(self._eval_queries, batch)

    def _eval_queries(self, batch: int):
        ref = self.reference_points.weight
        return self.query_embed(ref[None].expand(batch, *ref.shape))

    @span("rv pe")
    def _rv_pe(self, feat_hw, pad_hw, img2lidar):
        """(B, V, Hf, Wf, hidden) position encoding of the image tokens: the
        frustum samples of each cell back-projected by img2lidar, in
        [0, 1]^3, flattened in (depth, xyz) order, through rv_embedding."""
        coords = frustum_coords(feat_hw, pad_hw, self.depth_num,
                                self.pc_range[3], device=img2lidar.device)
        pts = torch.einsum("hwdo,bvco->bvhwdc", coords, img2lidar.float())
        pts01 = normalize_01(pts[..., :3], self.pc_range)
        flat = pts01.reshape(*pts01.shape[:-2], self.depth_num * 3)
        return self.rv_embedding(flat.to(self.compute_dtype))

    def project_queries(self, ref01, lidar2img, pad_hw):
        """Queries (B, N, 3) in [0, 1] projected into every view: (uvz,
        in_img), uvz (B, V, N, 4) with the first three components divided
        by z +- 1e-6 (by the sign of z; z taken as a constant for the
        gradient), in_img (B, V, N) true where
        0 <= u < pad_w, 0 <= v < pad_h and z > 0."""
        pad_h, pad_w = pad_hw
        lo = constant(self.pc_range[:3], ref01.dtype, ref01.device)
        hi = constant(self.pc_range[3:], ref01.dtype, ref01.device)
        pts = ref01 * (hi - lo) + lo
        pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
        proj = torch.einsum("bnd,bvcd->bvnc", pts_h, lidar2img.float())
        z = proj[..., 2:3]
        z_pos = z > 0.0
        # no gradient through the divisor, as in the JAX head
        denom = z.detach() + torch.where(z_pos, 1e-6, -1e-6)
        uvz = torch.cat([proj[..., :3] / denom, proj[..., 3:]], dim=-1)
        u, v = uvz[..., 0], uvz[..., 1]
        in_img = ((u >= 0) & (u < pad_w) & (v >= 0) & (v < pad_h)
                  & z_pos[..., 0])
        return uvz, in_img

    @span("rv pe")
    def _rv_query_embed(self, query_pos, ref01, lidar2img, img2lidar,
                        pad_hw, frame: Frame = EAGER):
        """`query_pos` plus the queries' ray embedding, a segment of
        `frame`."""
        return frame(self._rv_query_pos, query_pos, ref01, lidar2img,
                     img2lidar, pad_hw)

    def _rv_query_pos(self, query_pos, ref01, lidar2img, img2lidar, pad_hw):
        """`query_pos` plus each query projected into every view,
        back-projected along the depth bins, embedded, masked to the views
        it lands in and summed over the views: (B, N, hidden)."""
        uvz, in_img = self.project_queries(ref01, lidar2img, pad_hw)
        dbins = depth_bins(self.depth_num, self.pc_range[3], uvz.device)
        ray = uvz[..., None, :3] * dbins[:, None]
        ray = torch.cat([ray, torch.ones_like(ray[..., :1])], dim=-1)
        back = torch.einsum("bvndo,bvco->bvndc", ray, img2lidar.float())
        back01 = normalize_01(back[..., :3], self.pc_range)
        flat = back01.reshape(*back01.shape[:-2], self.depth_num * 3)
        emb = self.rv_embedding(flat.to(self.compute_dtype))
        return query_pos + (emb * in_img[..., None].to(emb.dtype)).sum(dim=1)

    @span("head memory")
    def build_memory(self, agent: AgentInputs, frame: Frame = EAGER):
        """Token memory (B, T, C) and its PE: the BEV tokens in row-major
        (y, x) order, then the image tokens in (view, h, w) order. The BEV
        tokens' `shared_conv` (kernel 4) runs on the host, where the
        benchmark reads its calls; the rest is a segment of `frame`."""
        x = None
        if self.with_bev:
            x = self.shared_conv(agent.bev_feat.to(self.compute_dtype))
        return frame(self._memory, x, agent.img_feats, agent.img2lidar,
                     agent.pad_hw)

    def _memory(self, x, img_feats, img2lidar, pad_hw):
        mem, pos = [], []
        if self.with_bev:
            b, hb, wb, c = x.shape
            mem.append(x.reshape(b, hb * wb, c))
            table = bev_pos2embed_grid((self.grid_size[1], self.grid_size[0]),
                                       self.downsample_scale, self.hidden_dim,
                                       device=x.device)
            bev_pos = self.bev_embedding(table.to(self.compute_dtype))
            pos.append(bev_pos[None].expand(b, *bev_pos.shape))
        if self.with_rv:
            b, v, hf, wf, c = img_feats.shape
            mem.append(img_feats.reshape(b, v * hf * wf, c).to(
                self.compute_dtype))
            rv_pos = self._rv_pe((hf, wf), pad_hw, img2lidar)
            pos.append(rv_pos.reshape(b, v * hf * wf, self.hidden_dim))
        return torch.cat(mem, dim=1), torch.cat(pos, dim=1)

    @span("decoder")
    def run_decoder(self, memory, memory_pos, query_pos, generator=None,
                    frame: Frame = EAGER):
        """The decoder over one agent's memory -> its (L, B, Nq, C) outputs;
        in eval as segments of `frame`. With DN queries (train) the
        self-attention takes `dn_attn_bias`, its slot count following the
        queries' (the batch's GT slots times `dn_groups`)."""
        decoder = self.transformer.decoder
        if not self.training:
            return decoder.eval_forward(memory, query_pos, memory_pos, frame)
        nq = query_pos.shape[1]
        bias = None
        if nq > self.num_query:
            single_pad = (nq - self.num_query) // self.dn_groups
            bias = dn_attn_bias(self.num_query, single_pad, self.dn_groups,
                                query_pos.device)[None, None]
        target = torch.zeros_like(query_pos)
        return decoder(target, memory, query_pos, memory_pos,
                       self_attn_bias=bias, generator=generator)

    @span("task heads")
    def run_task_heads(self, outs_decs, padded_ref,
                       dn_info: Optional[DNInfo] = None,
                       frame: Frame = EAGER) -> List[Dict]:
        """The agents' decoder outputs (`nan_to_num`, then with several
        agents their element-wise max) through the task heads; a segment of
        `frame`."""
        return frame(self._task_heads, outs_decs, padded_ref, dn_info)

    def _task_heads(self, outs_decs, padded_ref, dn_info) -> List[Dict]:
        outs_decs = [torch.nan_to_num(o) for o in outs_decs]
        if len(outs_decs) == 1:
            outs_dec = outs_decs[0]
        else:  # coop max fusion; amax splits the gradient among ties
            outs_dec = torch.stack(outs_decs, dim=0).amax(dim=0)
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
            if dn_info is not None and dn_info.pad_size > 0:
                pad = dn_info.pad_size
                for k in list(outs):
                    outs["dn_" + k] = outs[k][:, :, :pad]
                    outs[k] = outs[k][:, :, pad:]
            task_outs.append(outs)
        return task_outs
