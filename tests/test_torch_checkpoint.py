"""The port's checkpoints (train/checkpoint.py) on CPU.

- save / latest / restore round trip of a model's and an optimizer's
  state_dicts, loaded in place through `target`;
- keep-N, and a half-written temporary file never taken as a checkpoint;
- `graft_single_agent_params` and `merge_modalities` on reference-layout
  state_dicts: after the JAX package's `convert_state_dict`, they equal the
  JAX functions applied to the converted trees (the counterpart of
  tests/test_checkpoint.py), exactly.
"""
import os

import numpy as np
import pytest

import jax
import torch

from cmtcoop_tpu.train import checkpoint as jckpt
from cmtcoop_tpu.train.torch_convert import convert_state_dict
from cmtcoop_tpu_torch.configs.presets import (SMALL_COOP_EXTRACTOR,
                                               SMALL_COOP_HEAD,
                                               SMALL_COOP_PRESET,
                                               SMALL_FUSION_EXTRACTOR,
                                               SMALL_FUSION_HEAD,
                                               SMALL_FUSION_PRESET,
                                               get_preset, tiny_preset)
from cmtcoop_tpu_torch.models.build import build_detector, random_init_
from cmtcoop_tpu_torch.train import checkpoint as ckpt
from cmtcoop_tpu_torch.train.optim import AdamW

COOP_SPEC = dict(encoder_channels=((8, 16), (16,)), second_layers=(1, 1),
                 num_decoder_layers=2)
FUSION_SPEC = dict(COOP_SPEC, block_per_stage=(1, 1, 1, 1),
                   layer_per_block=3)


def state_dict_of(preset, extractor, head, seed):
    model = build_detector(preset, extractor_kwargs=extractor,
                           head_kwargs=head)
    random_init_(model, torch.Generator().manual_seed(seed))
    return model.state_dict()


def converted(sd, spec):
    params, stats, unused = convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, spec)
    assert not unused
    return params, stats


def assert_trees_equal(a, b):
    assert (jax.tree_util.tree_structure(a)
            == jax.tree_util.tree_structure(b))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def tiny_model_and_optimizer(seed):
    model = build_detector(get_preset("cmt_lidar_vehicle_tiny"), train=True)
    random_init_(model, torch.Generator().manual_seed(seed))
    return model, AdamW(model.named_parameters(), 10)


def test_save_latest_restore_round_trip(tmp_path):
    model, opt = tiny_model_and_optimizer(0)
    for p in opt.params:
        p.grad = torch.ones_like(p)
    opt.step()
    d = str(tmp_path / "ckpts")
    assert ckpt.latest_step(d) is None
    path = ckpt.save_checkpoint(d, 7, {"step": 7,
                                       "model": model.state_dict(),
                                       "optimizer": opt.state_dict()})
    assert path == os.path.join(d, "7.pt") and ckpt.latest_step(d) == 7
    other, other_opt = tiny_model_and_optimizer(1)
    state = ckpt.restore_checkpoint(d, {"model": other,
                                        "optimizer": other_opt})
    assert state["step"] == 7 and other_opt.count == 1
    for (n, a), b in zip(model.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(opt.mu + opt.nu, other_opt.mu + other_opt.nu):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"))


def test_keep_limit_and_half_written_files(tmp_path):
    d = str(tmp_path / "ck")
    for step in range(1, 8):
        ckpt.save_checkpoint(d, step, {"w": torch.full((2,), step)},
                             max_keep=5)
    assert ckpt.all_steps(d) == [3, 4, 5, 6, 7]
    # a save killed before its rename leaves only a temporary file
    with open(os.path.join(d, "8.pt.tmp"), "wb") as f:
        f.write(b"\x80half")
    assert ckpt.latest_step(d) == 7
    assert torch.equal(ckpt.restore_checkpoint(d)["w"], torch.full((2,), 7))
    ckpt.save_checkpoint(d, 9, {"w": torch.zeros(2)}, max_keep=1)
    assert ckpt.all_steps(d) == [9]
    assert sorted(os.listdir(d)) == ["8.pt.tmp", "9.pt"]


@pytest.mark.parametrize("agent,include_head,include_head_tasks", [
    ("vehicle", False, False), ("infrastructure", True, False),
    ("vehicle", True, True)])
def test_graft_equals_the_jax_graft(agent, include_head,
                                    include_head_tasks):
    coop = state_dict_of(tiny_preset(**SMALL_COOP_PRESET),
                         SMALL_COOP_EXTRACTOR, SMALL_COOP_HEAD, 0)
    single = state_dict_of(tiny_preset(**dict(SMALL_COOP_PRESET,
                                              domain="vehicle")),
                           SMALL_COOP_EXTRACTOR, SMALL_COOP_HEAD, 1)
    out = ckpt.graft_single_agent_params(coop, single, agent, include_head,
                                         include_head_tasks)
    assert set(out) == set(coop)
    (cp, cs), (sp, ss) = (converted(coop, COOP_SPEC),
                          converted(single, COOP_SPEC))
    ref = jckpt.graft_single_agent_params(cp, sp, agent, include_head,
                                          include_head_tasks)
    params, stats = converted(out, COOP_SPEC)
    assert_trees_equal(params, ref)
    # the agent's running statistics come with its extractor
    assert_trees_equal(stats[f"{agent}_model"], ss["extractor"])
    other = "infrastructure" if agent == "vehicle" else "vehicle"
    assert_trees_equal(stats[f"{other}_model"], cs[f"{other}_model"])
    with pytest.raises(ValueError):
        ckpt.graft_single_agent_params(coop, single, "roadside")


def test_merge_equals_the_jax_merge():
    def single(modality, seed):
        return state_dict_of(tiny_preset(**dict(
            SMALL_FUSION_PRESET, domain="vehicle", modality=modality)),
            SMALL_FUSION_EXTRACTOR, SMALL_FUSION_HEAD, seed)

    fusion, lidar, camera = (single("fusion", 0), single("lidar", 1),
                             single("camera", 2))
    out = ckpt.merge_modalities(fusion, lidar, camera)
    assert set(out) == set(fusion)
    ref = jckpt.merge_modalities(*(converted(sd, FUSION_SPEC)[0]
                                   for sd in (fusion, lidar, camera)))
    assert_trees_equal(converted(out, FUSION_SPEC)[0], ref)
    assert torch.equal(out["pts_backbone.blocks.0.0.weight"],
                       lidar["pts_backbone.blocks.0.0.weight"])
    cam_key = next(k for k in camera if k.startswith("img_backbone."))
    assert torch.equal(out[cam_key], camera[cam_key])
