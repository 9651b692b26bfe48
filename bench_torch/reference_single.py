"""The plain reference of the single-agent, multi-task CMT detector (the
original CMT on nuScenes, CMT_Nuscenes/fusion/
cmt_voxel0075_vov_1600x640_cbgs.py): its eval forward and its decode in
plain PyTorch, float32, TF32 off, on a configuration file's widths and a
dict of weights keyed by the single detector's state names
(`img_backbone.*`, `pts_middle_encoder.*`, ..., `pts_bbox_head.*`).

Every layer is `reference.py`'s `Reference`, which this class calls on one
agent's inputs: the rulebook sparse encoder over the active voxels, SECOND
and its FPN, VoVNet and CPFPN per view, the frustum-ray position
encodings, one 6-layer decoder pass over the BEV and image tokens, and the
last layer's task heads, one a task group. It imports nothing of the
program and no JAX.

The decode follows the reference's `MultiTaskBBoxCoder`: the sigmoid
scores of every task's classes side by side, one flat top-`max_num` over
(query x class), each class's box from its own task's codes, then the
post-centre filter (`post_center_range`). The answer is laid out for
`compare.py` as Q x T rows: row q * T + t holds task t's box for query q
and scores only in task t's class columns, 0 elsewhere; `top_scores` are
the kept top-k of the real (Q, classes) scores.

Departures from the published description: the weights are seeded, not
trained, and the images and clouds come from the benchmark's generator,
not nuScenes; the layers and the decode are as published (no score
threshold and no NMS, as the config has none). The post-centre filter
never drops a box in practice, since a decoded centre lies inside
`pc_range` (+-54 m, -5..3 m) and the range is +-61.2 m, +-10 m.

`precision="fp8"` is `Reference`'s control, one precision step below the
configuration's bfloat16.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench_torch.reference import Reference, RefOutput, denormalize

AGENT = "agent"  # the prefix under which the extractor's weights are read
HEAD = "pts_bbox_head."


class SingleReference(Reference):
    """The single-agent detector of `config` on the weights `params`
    (float32 tensors on one device, keyed by the single detector's state
    names)."""

    def __init__(self, config: dict, params: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        super().__init__(config, {
            (k if k.startswith(HEAD) else f"{AGENT}.{k}"): v
            for k, v in params.items()}, precision)

    def _frame(self, batch: Dict[str, np.ndarray]) -> RefOutput:
        cfg, hd = self.cfg, self.cfg["head"]
        dev = next(iter(self.p.values())).device
        c = hd["hidden_dim"]
        ref = self.p[HEAD + "reference_points.weight"].clamp(0.0, 1.0)
        ref_inv = torch.log(ref.clamp(min=1e-5)) - \
            torch.log((1.0 - ref).clamp(min=1e-5))
        ref01 = torch.sigmoid(ref_inv)
        qpos = self.mlp(self.pos2embed(ref01, c), HEAD + "bev_embedding")
        get = {k: torch.as_tensor(v[0]).to(dev) for k, v in batch.items()}
        mem, pos = [], []
        bev = self.bev_tokens(get["points"].float(), get["points_mask"],
                              AGENT)
        x = self.conv2d(bev.permute(0, 3, 1, 2),
                        self.p[HEAD + "shared_conv.conv.weight"], None, 1, 1)
        x = torch.relu(self.bn(x, HEAD + "shared_conv.bn", hd["bn_eps"]))
        mem.append(x[0].permute(1, 2, 0).reshape(-1, c))
        gy = cfg["lidar"]["grid_size"][1] // hd["downsample_scale"]
        gx = cfg["lidar"]["grid_size"][0] // hd["downsample_scale"]
        ys = (torch.arange(gy, device=dev) + 0.5) / gy
        xs = (torch.arange(gx, device=dev) + 0.5) / gx
        grid = torch.stack([xs[None, :].expand(gy, gx),
                            ys[:, None].expand(gy, gx)], -1)
        pos.append(self.mlp(self.pos2embed(grid.reshape(-1, 2), c),
                            HEAD + "bev_embedding"))
        if cfg.get("camera"):
            imgs = get["imgs"].float()
            feats = self.image_tokens(imgs, AGENT)
            _, hf, wf, _ = feats.shape
            pad_hw = tuple(imgs.shape[1:3])
            mem.append(feats.reshape(-1, c))
            i2l = get["img2lidar"].float()
            pos.append(self.rv_pe((hf, wf), pad_hw, i2l).reshape(-1, c))
            qpos = qpos + self.rv_query_embed(
                ref01, get["lidar2img"].float(), i2l, pad_hw)
        dec = self.decoder(torch.cat(mem), torch.cat(pos), qpos)
        logits, codes = zip(*[self.task_head(dec, ref_inv, t)
                              for t in range(len(hd["tasks"]))])
        return decode_tasks(list(logits), list(codes), hd)


def decode_tasks(task_logits: List[torch.Tensor],
                 task_codes: List[torch.Tensor], head: dict) -> RefOutput:
    """The multi-task decode (module docstring): Q x T rows of boxes and
    scores, and the top-`max_num` scores over (query x class) whose boxes
    lie inside `post_center_range`, highest first."""
    scores = [torch.sigmoid(lg.float()) for lg in task_logits]
    n_q, n_t = scores[0].shape[0], len(scores)
    flat = torch.cat(scores, -1)
    n_cls = flat.shape[1]
    task_of = torch.cat([torch.full((s.shape[1],), t, dtype=torch.long)
                         for t, s in enumerate(scores)]).to(flat.device)
    boxes = torch.stack([denormalize(c.float()) for c in task_codes], 1)
    rows = torch.zeros(n_q, n_t, n_cls, device=flat.device)
    at = 0
    for t, s in enumerate(scores):
        rows[:, t, at:at + s.shape[1]] = s
        at += s.shape[1]
    k = min(head["max_num"], flat.numel())
    top, idx = torch.topk(flat.reshape(-1), k)
    q, cls = idx // n_cls, idx % n_cls
    centre = boxes[q, task_of[cls], :3]
    r = torch.tensor(head["post_center_range"], device=flat.device)
    keep = ((centre >= r[:3]) & (centre <= r[3:])).all(-1)
    return RefOutput(
        boxes.reshape(n_q * n_t, -1).cpu().numpy().astype(np.float64),
        rows.reshape(n_q * n_t, n_cls).cpu().numpy().astype(np.float64),
        top[keep].cpu().numpy().astype(np.float64))
