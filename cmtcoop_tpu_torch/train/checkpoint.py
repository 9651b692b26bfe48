"""Checkpoints: save / restore with keep-N, and cross-topology key surgery
(counterpart of cmtcoop_tpu/train/checkpoint.py).

Replaces the mmcv CheckpointHook (interval=1, max_keep_ckpts=5, coop
config:391-394) and the checkpoint converter
(tools/model_converters/convert_cmtcoop_checkpoints.py:156-372). A
checkpoint is one `torch.save` file, `<ckpt_dir>/<step>.pt`, of a dict of
state_dicts: the model's (reference-layout mmdet3d keys, coop agents under
`vehicle_model.` / `infrastructure_model.`) and the optimizer's. It is
written under a temporary name and renamed, so a run killed mid-save leaves
no half checkpoint (orbax also writes atomically). The JAX package's orbax
checkpoints are not read here: that needs orbax.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{step}.pt")


def all_steps(ckpt_dir: str) -> List[int]:
    """The steps of the finished checkpoints in `ckpt_dir`, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(ckpt_dir)) if m)


def save_checkpoint(ckpt_dir: str, step: int, state: Mapping,
                    max_keep: int = 5) -> str:
    """Write `state` (tensors anywhere, dicts, lists, numbers) as the
    checkpoint of `step`, then delete all but the newest `max_keep`.
    Returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, step)
    tmp = path + ".tmp"
    torch.save(dict(state), tmp)
    os.replace(tmp, path)
    for old in all_steps(ckpt_dir)[:-max_keep]:
        os.remove(_path(ckpt_dir, old))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, target: Optional[Mapping] = None,
                       step: Optional[int] = None, device=None) -> Dict:
    """Load the checkpoint of `step` (default the newest) onto `device`
    (`weights_only`: tensors and plain containers, nothing executed). With
    `target`, a mapping of names to objects with `load_state_dict` (the
    model, the optimizer), each loads its entry in place. Returns the
    loaded dict."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    state = torch.load(_path(ckpt_dir, step), map_location=device,
                       weights_only=True)
    for key, obj in (target or {}).items():
        obj.load_state_dict(state[key])
    return state


# ------------------------ cross-topology surgery -------------------------

def _modules(sd: Mapping, prefix: str = "") -> set:
    """The first key component after `prefix` of `sd`'s keys under it."""
    return {k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)}


def _replace_modules(dst: Mapping, src: Mapping, modules,
                     prefix: str = "") -> Dict[str, torch.Tensor]:
    """`dst` with each module of `modules` (its `prefix + m + "."` keys)
    replaced whole by `src`'s."""
    heads = tuple(prefix + m + "." for m in modules)
    out = {k: v for k, v in dst.items() if not k.startswith(heads)}
    out.update({k: v for k, v in src.items() if k.startswith(heads)})
    return out


def graft_single_agent_params(
    coop_sd: Mapping[str, torch.Tensor],
    agent_sd: Mapping[str, torch.Tensor],
    agent: str,
    include_head: bool = False,
    include_head_tasks: bool = False,
) -> Dict[str, torch.Tensor]:
    """Insert a single-agent CmtDetector's state_dict into a coop one.

    Mirrors update_ckpt_vehicle/update_ckpt_infrastructure
    (convert_cmtcoop_checkpoints.py:156-288): the single agent's extractor
    (every key outside `pts_bbox_head.`) replaces the coop `<agent>_model.`
    keys; its head's modules are optionally copied over the coop head's
    (task heads dropped by default, as the reference does when assembling
    the coop warm start)."""
    if agent not in ("vehicle", "infrastructure"):
        raise ValueError(f"agent {agent!r} is not vehicle or infrastructure")
    prefix = f"{agent}_model."
    out = {k: v for k, v in coop_sd.items() if not k.startswith(prefix)}
    out.update({prefix + k: v for k, v in agent_sd.items()
                if not k.startswith("pts_bbox_head.")})
    if include_head:
        head = _modules(agent_sd, "pts_bbox_head.")
        if not include_head_tasks:
            head = {m for m in head if not m.startswith("task_heads")}
        out = _replace_modules(out, agent_sd, head, "pts_bbox_head.")
    return out


def merge_modalities(fusion_sd: Mapping[str, torch.Tensor],
                     lidar_sd: Mapping[str, torch.Tensor],
                     camera_sd: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Merge separate LiDAR-only and camera-only single-agent state_dicts
    into a fusion one (the reference merges lidar and camera checkpoints the
    same way, convert_cmtcoop_checkpoints.py:291-372): each LiDAR module
    (`pts_middle_encoder`, `pts_backbone`, `pts_neck`) present in
    `lidar_sd` replaces the fusion one whole, and each camera module
    (`img_backbone`, `img_neck`) present in `camera_sd` likewise."""
    lidar = _modules(lidar_sd) & {"pts_middle_encoder", "pts_backbone",
                                  "pts_neck"}
    camera = _modules(camera_sd) & {"img_backbone", "img_neck"}
    out = _replace_modules(fusion_sd, lidar_sd, lidar)
    return _replace_modules(out, camera_sd, camera)
