"""Weights carried across packages, and guards on the port's boundaries.

- `from_jax_variables` is the exact inverse of the JAX package's
  `convert_state_dict` on the LiDAR and fusion detectors (zero unused
  keys), and its state_dict loads strictly into the port's detectors;
- the port's presets equal the JAX package's, field by field;
- no `cmtcoop_tpu_torch` module imports jax, flax or the JAX package;
- the port's synthetic batch equals the JAX benchmark batch for one seed.
"""
import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import cmtcoop_tpu_torch
from cmtcoop_tpu.configs import presets as jpresets
from cmtcoop_tpu.models.build import build_detector as jbuild
from cmtcoop_tpu.train.torch_convert import convert_state_dict
from cmtcoop_tpu_torch.configs import presets
from cmtcoop_tpu_torch.convert import from_jax_variables
from cmtcoop_tpu_torch.data.synthetic import coop_batch
from cmtcoop_tpu_torch.models.build import build_detector

REPO = Path(__file__).resolve().parents[1]

# (tiny_preset overrides, extractor overrides, head overrides,
#  torch_convert spec)
CONFIGS = {
    "coop_2stage": (
        presets.SMALL_COOP_PRESET, presets.SMALL_COOP_EXTRACTOR,
        presets.SMALL_COOP_HEAD,
        dict(encoder_channels=((8, 16), (16,)), second_layers=(1, 1),
             num_decoder_layers=2)),
    "vehicle_4stage_2tasks": (
        dict(tasks=(("CAR", "TRUCK"), ("PEDESTRIAN",))),
        {}, dict(downsample_scale=8),
        dict(encoder_channels=((8, 8, 8), (8, 8, 16), (16, 16, 16),
                               (16, 16)),
             second_layers=(1, 1), num_decoder_layers=2)),
    "coop_fusion": (
        presets.SMALL_FUSION_PRESET, presets.SMALL_FUSION_EXTRACTOR,
        presets.SMALL_FUSION_HEAD,
        dict(encoder_channels=((8, 16), (16,)), second_layers=(1, 1),
             num_decoder_layers=2, block_per_stage=(1, 1, 1, 1),
             layer_per_block=3)),
}


def _random_variables(model, batch, rng):
    """Every leaf of the flax tree from numpy (shapes by eval_shape)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch)
    return jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def _inputs(rng, prefixes, preset):
    """Points, and with the camera branch one view of images and cameras,
    per agent prefix."""
    out = {}
    for p in prefixes:
        out[p + "points"] = rng.uniform(-7, 7, (1, 256, 5)).astype(np.float32)
        out[p + "points_mask"] = np.ones((1, 256), bool)
        if preset.use_camera:
            out[p + "imgs"] = rng.normal(
                size=(1, 1, *preset.img_size, 3)).astype(np.float32)
            out[p + "lidar2img"] = np.tile(np.eye(4, dtype=np.float32),
                                           (1, 1, 1, 1))
            out[p + "img2lidar"] = out[p + "lidar2img"]
    return {k: jnp.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weights_round_trip_exactly(rng, name):
    over, ek, hk, spec = CONFIGS[name]
    preset = presets.tiny_preset(**over)
    jm = jbuild(jpresets.tiny_preset(**over), train=False,
                extractor_kwargs=ek, head_kwargs=hk)
    prefixes = (("vehicle_", "infrastructure_") if preset.domain == "coop"
                else ("",))
    variables = _random_variables(jm, _inputs(rng, prefixes, preset), rng)
    sd = from_jax_variables(variables)
    params, stats, unused = convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, dict(spec, tasks=preset.tasks))
    assert unused == []
    for ours, ref in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        assert (jax.tree_util.tree_structure(ours)
                == jax.tree_util.tree_structure(ref))
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)
    model = build_detector(preset, extractor_kwargs=ek, head_kwargs=hk)
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name", sorted(presets.PRESETS) + sorted(CONFIGS))
def test_presets_equal_the_jax_packages(name):
    if name in CONFIGS:
        ours = presets.tiny_preset(**CONFIGS[name][0])
        ref = jpresets.tiny_preset(**CONFIGS[name][0])
    else:
        ours, ref = presets.get_preset(name), jpresets.get_preset(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ([f.name for f in dataclasses.fields(ours)]
            == [f.name for f in dataclasses.fields(ref)])
    for train in (False, True):
        assert ours.extractor_kwargs(train) == ref.extractor_kwargs(train)
    assert ours.head_kwargs() == ref.head_kwargs()
    assert (ours.agents, ours.use_lidar, ours.use_camera) == (
        ref.agents, ref.use_lidar, ref.use_camera)


def test_port_never_imports_jax():
    """Every module of the port, the subpackages too, imported in a fresh
    process loads no `jax*` or `flax*` module and no module of the JAX
    package (`cmtcoop_tpu`, `cmtcoop_tpu.*`), not even a numpy-only one;
    nor Pillow, which the data path imports only to decode an image."""
    names = [m.name for m in pkgutil.walk_packages(
        cmtcoop_tpu_torch.__path__, "cmtcoop_tpu_torch.")]
    assert {"cmtcoop_tpu_torch.models.detector",
            "cmtcoop_tpu_torch.tools.train",
            "cmtcoop_tpu_torch.tools.create_data",
            "cmtcoop_tpu_torch.tools.test",
            "cmtcoop_tpu_torch.data.eval.nusc_protocol",
            "cmtcoop_tpu_torch.data.loader",
            "cmtcoop_tpu_torch.data.native",
            "cmtcoop_tpu_torch.data.datasets",
            "cmtcoop_tpu_torch.data.pipeline_builder",
            "cmtcoop_tpu_torch.data.synthetic_archive",
            "cmtcoop_tpu_torch.data.pipelines.box_np",
            "cmtcoop_tpu_torch.data.pipelines.loading_utils",
            "cmtcoop_tpu_torch.data.pipelines.transforms",
            "cmtcoop_tpu_torch.data.pipelines.dbsampler",
            "cmtcoop_tpu_torch.data.converters.pcd",
            "cmtcoop_tpu_torch.data.converters.a9coop",
            "cmtcoop_tpu_torch.data.converters.a9_nusc",
            "cmtcoop_tpu_torch.train.trainer",
            "cmtcoop_tpu_torch.train.checkpoint",
            "cmtcoop_tpu_torch.train.eval_hook"} <= set(names)
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
            "                                    'cmtcoop_tpu')\n"
            "             or m.startswith(('jax', 'flax', 'PIL')))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_coop_batch_matches_benchmark_batch():
    # importing the entry module points jax's compile cache elsewhere; keep
    # this test process's settings
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        from __graft_entry__ import _coop_batch
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    ref = _coop_batch(batch_size=2, n_points=4096, veh_views=1,
                      infra_views=2, img_hw=(8, 16), max_gt=4, seed=3)
    ours = coop_batch(2, 4096, 1, 2, (8, 16), max_gt=4, seed=3)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)
