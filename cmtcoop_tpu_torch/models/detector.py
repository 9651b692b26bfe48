"""CMT detectors (counterpart of cmtcoop_tpu/models/detector.py).

Batch dicts as in the JAX package: `points` (B, N, 5) float32 zero-padded,
`points_mask` (B, N) bool, `imgs` (B, V, H, W, 3) float32, `lidar2img` and
`img2lidar` (B, V, 4, 4); cooperative batches carry `vehicle_` and
`infrastructure_` prefixes; for training `gt_boxes` (B, G, 9)
gravity-centred, `gt_labels` (B, G) int, `gt_mask` (B, G) bool, shared by
the agents. In train mode (`model.train()`) the images are grid-masked
before the backbone and the ground truth goes to the head (DN); `rngs`
(CPU generators `.dn`, `.dropout`, `.gridmask`; see train/train_step.py)
gives the step's random draws. In eval mode on the card with autograd off,
each forward runs its LiDAR branches and its head as segments that CUDA
graphs capture and replay (models/graphs.py; `graphable` says when), and
a ResNet camera branch too; a VoVNet camera branch, the head's kernel-4
calls and the decoder's kernel-3 calls stay on the host.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from cmtcoop_tpu_torch.models.cmt_head import AgentInputs, CmtHead
from cmtcoop_tpu_torch.models.graphs import EAGER, Frame, FrameGraphs
from cmtcoop_tpu_torch.models.grid_mask import grid_mask, grid_mask_draws
from cmtcoop_tpu_torch.models.pillar_encoder import PillarSparseEncoder
from cmtcoop_tpu_torch.models.resnet import ResNet
from cmtcoop_tpu_torch.models.second import SECOND, SECONDFPN
from cmtcoop_tpu_torch.models.sparse_encoder import SparseEncoder
from cmtcoop_tpu_torch.models.vovnet import CPFPN, VoVNet
from cmtcoop_tpu_torch.ops.pillars import pillarize
from cmtcoop_tpu_torch.ops.voxelize import hard_simple_vfe, voxelize
from cmtcoop_tpu_torch.utils.profiling import span

# FeatureExtractor settings that select nothing here: the JAX package's TPU
# image-layout switch. Presets carry it, so it is accepted and has no effect.
NOT_PORTED_KEYS = ("img_impl",)


class FeatureExtractor(nn.Module):
    """Per-agent feature extractor. LiDAR (`use_lidar`): pillarize ->
    PillarSparseEncoder (`encoder_impl="pillar"`), or voxelize ->
    HardSimpleVFE -> the gather SparseEncoder (`"gather"`, the reference's
    semantics, active sets capped at `sparse_stage_caps`), then SECOND ->
    SECONDFPN, giving the (B, H/8, W/8, 512) BEV map (state
    `pts_middle_encoder.*`, the same keys for both encoders, `pts_backbone.*`,
    `pts_neck.*`).
    Camera (`use_camera`): VoVNet (`img_spec` "V-*") or ResNet ("r50")
    -> CPFPN, level 0 (stride 16) per view (state `img_backbone.*`,
    `img_neck.*`)."""

    def __init__(self, use_lidar: bool = True, use_camera: bool = False,
                 voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.2),
                 pc_range: Sequence[float] = (-72.0, -72.0, -8.0,
                                              72.0, 72.0, 0.0),
                 grid_size: Tuple[int, int, int] = (1440, 1440, 40),
                 max_points_per_voxel: int = 10, max_voxels: int = 120000,
                 sparse_base_channels: int = 16,
                 sparse_channels: Sequence[Sequence[int]] = (
                     (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
                 sparse_out_channels: int = 128,
                 sparse_stage_caps: Sequence[int] = (60000, 60000, 60000,
                                                     60000),
                 encoder_impl: str = "pillar",
                 pillar_caps: Sequence[int] = (38400, 40960, 24064, 11264),
                 second_channels: Sequence[int] = (128, 256),
                 second_layers: Sequence[int] = (5, 5),
                 fpn_channels: Sequence[int] = (256, 256),
                 img_spec: str = "V-99-eSE",
                 img_out_features: Sequence[str] = ("stage4", "stage5"),
                 neck_out_channels: int = 256, use_grid_mask: bool = True,
                 compute_dtype=torch.float32, **not_ported):
        super().__init__()
        unknown = set(not_ported) - set(NOT_PORTED_KEYS)
        if unknown:
            raise TypeError(f"unexpected extractor settings {sorted(unknown)}")
        if not (use_lidar or use_camera):
            raise ValueError("an extractor needs the LiDAR or the camera "
                             "branch")
        self.use_lidar, self.use_camera = use_lidar, use_camera
        self.use_grid_mask = use_grid_mask
        self.compute_dtype = compute_dtype
        if use_camera:
            self.img_out_features = tuple(img_out_features)
            self.img_backbone = (
                ResNet(int(img_spec[1:]), self.img_out_features)
                if img_spec.startswith("r")
                else VoVNet(img_spec, self.img_out_features))
            # ResNet's camera runs as graph segments. VoVNet's stays on the
            # host: the benchmark reads kernels 4 and 6 from their host
            # calls, which a replay never makes; ResNet launches neither
            self.camera_segments = isinstance(self.img_backbone, ResNet)
            self.img_neck = CPFPN(
                [self.img_backbone.out_channels[k]
                 for k in self.img_out_features], neck_out_channels,
                num_outs=2)
        if use_lidar:
            if encoder_impl not in ("pillar", "gather"):
                raise ValueError(f"unknown encoder_impl {encoder_impl!r}")
            self.encoder_impl = encoder_impl
            self.voxel_size = tuple(voxel_size)
            self.pc_range = tuple(pc_range)
            self.grid_size = tuple(grid_size)
            self.max_points_per_voxel = max_points_per_voxel
            self.max_voxels = max_voxels
            self.pillar_caps = tuple(pillar_caps)
            z = grid_size[2] + 1
            shape = (z, grid_size[1], grid_size[0])
            if encoder_impl == "pillar":
                self.pts_middle_encoder = PillarSparseEncoder(
                    5, shape, sparse_base_channels, sparse_channels,
                    sparse_out_channels, pillar_caps)
            else:
                self.pts_middle_encoder = SparseEncoder(
                    5, shape, sparse_base_channels, sparse_channels,
                    sparse_out_channels, sparse_stage_caps)
            levels = len(sparse_channels)
            z_out = z
            for zp in (1, 1, 0)[:levels - 1]:
                z_out = (z_out + 2 * zp - 3) // 2 + 1
            z_out = (z_out - 3) // 2 + 1
            self.pts_backbone = SECOND(sparse_out_channels * z_out,
                                       second_channels, second_layers)
            self.pts_neck = SECONDFPN(second_channels, fpn_channels)

    @span("pillarize")
    def pillarize(self, points, points_mask, return_stats: bool = False,
                  frame: Frame = EAGER):
        """One sample's cloud -> pillars, with this extractor's settings."""
        return frame(self._pillarize, points, points_mask, return_stats)

    def _pillarize(self, points, points_mask, return_stats):
        return pillarize(points, points_mask, voxel_size=self.voxel_size,
                         pc_range=self.pc_range, grid_size=self.grid_size,
                         max_points=self.max_points_per_voxel,
                         max_voxels=self.max_voxels,
                         max_pillars=self.pillar_caps[0],
                         return_stats=return_stats)

    def voxelize(self, points, points_mask, return_stats: bool = False):
        """One sample's cloud -> voxels, with this extractor's settings."""
        return voxelize(points, points_mask, voxel_size=self.voxel_size,
                        pc_range=self.pc_range, grid_size=self.grid_size,
                        max_points=self.max_points_per_voxel,
                        max_voxels=self.max_voxels, return_stats=return_stats)

    @span("voxelize")
    def voxel_features(self, points, points_mask):
        """One sample's cloud -> (voxel means (V, F), the voxels):
        voxelize, then HardSimpleVFE."""
        vox = self.voxelize(points, points_mask)
        return hard_simple_vfe(vox), vox

    def encode(self, points, points_mask,
               frame: Frame = EAGER) -> torch.Tensor:
        """One sample's cloud -> its dense BEV map, through the encoder."""
        if self.encoder_impl == "pillar":
            args = self.pillarize(points, points_mask, frame=frame)
        else:
            feats, vox = self.voxel_features(points, points_mask)
            args = (feats, vox.coords, vox.mask)
        with span("pillar encoder"):
            return frame(self.pts_middle_encoder, *args,
                         dtype=self.compute_dtype)

    def extract_pts_feat(self, points, points_mask,
                         frame: Frame = EAGER) -> torch.Tensor:
        """(B, N, 5) clouds -> the (B, H/8, W/8, 512) BEV map: per sample
        pillarize and encode, then SECOND (the samples stacked in its
        segment) and SECONDFPN, each a segment of `frame`."""
        bevs = [self.encode(p, m, frame) for p, m in zip(points, points_mask)]
        with span("SECOND"):
            x = frame(self._second, bevs)
        with span("FPN"):
            return frame(self.pts_neck, x)

    def _second(self, bevs):
        return self.pts_backbone(torch.stack(bevs))

    def extract_img_feat(self, imgs, rngs=None,
                         frame: Frame = EAGER) -> torch.Tensor:
        """(B, V, H, W, 3) images -> (B, V, H/16, W/16, C) CPFPN level 0;
        grid-masked first in train mode; the backbone and the neck each a
        segment of `frame`."""
        b, v, h, w, c = imgs.shape
        x = imgs.reshape(b * v, h, w, c).to(self.compute_dtype).contiguous()
        if self.training and self.use_grid_mask:
            x = grid_mask(x, grid_mask_draws(
                rngs.gridmask if rngs else None, h, w))
        with span("image backbone"):
            feats = frame(self.img_backbone, x)
        with span("image neck"):
            f0 = frame(self._neck, feats)
        return f0.reshape(b, v, *f0.shape[1:])

    def _neck(self, feats):
        return self.img_neck([feats[k] for k in self.img_out_features])[0]

    def extract(self, batch: Dict[str, torch.Tensor], prefix: str = "",
                rngs=None, frame: Frame = EAGER) -> AgentInputs:
        """One agent's head inputs; the LiDAR branch as `frame`'s segments,
        the camera branch too where `camera_segments`, else on the
        host."""
        bev_feat = img_feats = pad_hw = None
        if self.use_lidar:
            bev_feat = self.extract_pts_feat(batch[prefix + "points"],
                                             batch[prefix + "points_mask"],
                                             frame)
        if self.use_camera:
            imgs = batch[prefix + "imgs"]
            pad_hw = (imgs.shape[2], imgs.shape[3])
            img_feats = self.extract_img_feat(
                imgs, rngs, frame if self.camera_segments else EAGER)
        return AgentInputs(bev_feat, img_feats,
                           batch.get(prefix + "lidar2img"),
                           batch.get(prefix + "img2lidar"), pad_hw)

    def forward(self, batch, prefix: str = "", rngs=None):
        return self.extract(batch, prefix, rngs)


def graphable(model: nn.Module,
              extractors: Sequence[FeatureExtractor]) -> bool:
    """Whether a forward of `model` may run its segments as CUDA graphs, as
    far as the model tells: eval mode, autograd off and every LiDAR branch
    on the pillar encoder (the batch must also be on the card)."""
    return (not model.training and not torch.is_grad_enabled()
            and all(isinstance(e.pts_middle_encoder, PillarSparseEncoder)
                    for e in extractors if e.use_lidar))


def _frame(model: nn.Module, extractors: Sequence[FeatureExtractor],
           head: CmtHead, batch: Dict[str, torch.Tensor]) -> Frame:
    """The segment runner of one forward of `model`: CUDA graphs of the
    LiDAR branches and the head where `graphable` and the batch is on the
    card; else eager."""
    tensors = [v for v in batch.values() if isinstance(v, torch.Tensor)]
    on_card = bool(tensors) and all(t.is_cuda for t in tensors)
    modules = [m for e in extractors if e.use_lidar
               for m in (e.pts_middle_encoder, e.pts_backbone, e.pts_neck)]
    modules += [m for e in extractors
                if e.use_camera and e.camera_segments
                for m in (e.img_backbone, e.img_neck)]
    return model.graphs.frame(batch, modules + [head],
                              on_card and graphable(model, extractors))


def _gt(batch):
    return dict(gt_boxes=batch.get("gt_boxes"),
                gt_labels=batch.get("gt_labels"),
                gt_mask=batch.get("gt_mask"))


def _head(use_lidar: bool, use_camera: bool, ek: Dict, hk: Dict,
          compute_dtype) -> CmtHead:
    hk = dict(hk)
    hk.setdefault("in_channels", 512)
    return CmtHead(pc_range=ek.get("pc_range", (-72.0, -72.0, -8.0,
                                                72.0, 72.0, 0.0)),
                   grid_size=tuple(ek.get("grid_size", (1440, 1440))[:2]),
                   with_bev=use_lidar, with_rv=use_camera,
                   compute_dtype=compute_dtype, **hk)


class CmtDetector(FeatureExtractor):
    """Single-agent detector: the extractor's modules at the top level (as
    in the reference) + `pts_bbox_head`."""

    def __init__(self, use_lidar: bool = True, use_camera: bool = False,
                 extractor_kwargs=None, head_kwargs=None,
                 compute_dtype=torch.float32):
        ek = dict(extractor_kwargs or {})
        super().__init__(use_lidar, use_camera, compute_dtype=compute_dtype,
                         **ek)
        self.pts_bbox_head = _head(use_lidar, use_camera, ek,
                                   head_kwargs or {}, compute_dtype)
        self.graphs = FrameGraphs()

    def forward(self, batch, rngs=None):
        frame = _frame(self, [self], self.pts_bbox_head, batch)
        return frame.finish(self.pts_bbox_head(
            [self.extract(batch, "", rngs, frame)], rngs=rngs, frame=frame,
            **_gt(batch)))


class CmtCoopDetector(nn.Module):
    """Cooperative detector: per-agent extractors (`vehicle_model`,
    `infrastructure_model`) + the shared head with decoder-output max
    fusion. `agents` selects the live agents; with one the head degrades to
    the single-agent path."""

    def __init__(self, use_lidar: bool = True, use_camera: bool = False,
                 agents: Tuple[str, ...] = ("vehicle", "infrastructure"),
                 extractor_kwargs=None, head_kwargs=None,
                 compute_dtype=torch.float32):
        super().__init__()
        ek = dict(extractor_kwargs or {})
        self.agents = tuple(agents)
        for a in self.agents:
            if a not in ("vehicle", "infrastructure"):
                raise ValueError(f"unknown agent {a!r}")
            self.add_module(f"{a}_model", FeatureExtractor(
                use_lidar, use_camera, compute_dtype=compute_dtype, **ek))
        self.pts_bbox_head = _head(use_lidar, use_camera, ek,
                                   head_kwargs or {}, compute_dtype)
        self.graphs = FrameGraphs()

    def forward(self, batch, rngs=None):
        exts = [getattr(self, f"{a}_model") for a in self.agents]
        frame = _frame(self, exts, self.pts_bbox_head, batch)
        return frame.finish(self.pts_bbox_head([
            e.extract(batch, f"{a}_", rngs, frame)
            for a, e in zip(self.agents, exts)], rngs=rngs, frame=frame,
            **_gt(batch)))
