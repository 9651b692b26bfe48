"""Compose preset-driven train/test pipelines (the config train_pipeline /
test_pipeline lists, coop config:33-181) into single callables; counterpart
of cmtcoop_tpu/data/pipeline_builder.py.

Where the JAX package returns a closure, `build_pipeline` here returns a
`Pipeline` object: the loader's process-mode workers are spawned and get the
dataset, its pipeline with it, by pickling, and a closure does not pickle.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from cmtcoop_tpu_torch.configs.presets import Preset
from cmtcoop_tpu_torch.data import formats
from cmtcoop_tpu_torch.data.pipelines import transforms as T
from cmtcoop_tpu_torch.data.pipelines.dbsampler import (DataBaseSampler,
                                                        unified_object_sample)


def ida_conf(preset: Preset, src_hw=(900, 1600)) -> Dict:
    return {
        "resize_lim": preset.ida_resize_lim,
        "final_dim": preset.ida_final_dim,
        "bot_pct_lim": (0.0, 0.0),
        "rot_lim": (0.0, 0.0),
        "H": src_hw[0], "W": src_hw[1],
        "rand_flip": False,
    }


class Pipeline:
    """pipeline(sample, rng) -> fixed-shape model sample dict."""

    def __init__(self, preset: Preset, training: bool,
                 prefixes: Sequence[str],
                 db_sampler: Optional[DataBaseSampler] = None,
                 modal_mask: bool = False):
        self.preset = preset
        self.training = training
        self.prefixes = tuple(prefixes)
        self.db_sampler = db_sampler
        self.modal_mask = modal_mask
        self.conf = ida_conf(preset)

    def __call__(self, sample: Dict, rng: np.random.Generator) -> Dict:
        preset, training, prefixes = self.preset, self.training, self.prefixes
        coop = len(prefixes) > 1
        if coop and preset.use_lidar:
            sample = T.vehicle_points_to_infra(sample)
        if coop and preset.use_camera:
            sample = T.transform_lidar2img_to_infra(sample)
        if training:
            if self.db_sampler is not None and preset.use_lidar:
                sample = unified_object_sample(
                    sample, self.db_sampler, rng, preset.class_names,
                    prefixes=prefixes)
            if self.modal_mask:
                sample = T.modal_mask(sample, rng, prefixes=prefixes)
            sample = T.global_rot_scale_trans(
                sample, rng, rot_range=(-0.3925, 0.3925),
                scale_ratio_range=(0.95, 1.05), prefixes=prefixes)
        if preset.use_lidar:
            sample = T.points_range_filter(
                sample, preset.pc_range, prefixes=prefixes)
        if training and "gt_boxes_3d" in sample:
            sample = T.object_range_filter(sample, preset.pc_range)
            sample = T.object_name_filter(sample, preset.class_names)
        if training and preset.use_lidar:
            sample = T.point_shuffle(sample, rng, prefixes=prefixes)
        if preset.use_camera:
            sample = T.resize_crop_flip_image(
                sample, rng, self.conf, training, prefixes=prefixes)
            sample = T.normalize_images(
                sample, preset.img_norm_mean, preset.img_norm_std,
                prefixes=prefixes)
            sample = T.pad_images(sample, 32, prefixes=prefixes)
        return formats.sample_to_model_batch(
            sample, max_points=preset.max_points, max_gt=preset.max_gt,
            prefixes=prefixes, with_gt=training)


def build_pipeline(
    preset: Preset,
    training: bool,
    prefixes: Sequence[str],
    db_sampler: Optional[DataBaseSampler] = None,
    modal_mask: bool = False,
) -> Pipeline:
    """Returns pipeline(sample, rng) -> fixed-shape model sample dict."""
    return Pipeline(preset, training, prefixes, db_sampler, modal_mask)
