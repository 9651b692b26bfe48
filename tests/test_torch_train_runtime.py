"""The port's training runtime (train/trainer.py, train/optim.py's state,
tools/train.py) on CPU, float32, at small sizes.

- (a) the port's Trainer against the JAX Trainer: the small fusion coop
  detector (configs/presets.py `SMALL_FUSION_*`, dropout 0, grid mask off,
  DN noise 0, as tests/test_torch_train_step.py sets them), the JAX
  `init_state` parameters carried across by `from_jax_variables`, 2 steps on
  the same 2 batches of `synthetic_batch_iter`: every loss term and
  `grad_norm` of the two `metrics.jsonl` within 2e-3 relative (the train
  step's tolerance) plus 1e-6. The JAX Trainer's eager init and two step
  compiles take ~2.5 min on the CPU, so this one is marked `slow`; in the
  default run the port's Trainer is held to the JAX Trainer's step body
  (`make_optimizer` + `make_train_step`, jitted once) over 2 steps of the
  tiny LiDAR preset, its weights carried to JAX by `convert_state_dict`;
- (b) the Trainer adds no numerics: its `metrics.jsonl` equals a hand loop
  of `make_train_step` on the same model and batches, bit for bit;
- (c) exact resume: 6 steps against a resume from their step-3 checkpoint
  and 3 more on the stream from its fourth batch, bit for bit (dropout,
  DN noise and the grid mask on);
- (d) AdamW's state_dict round trip; (e) `load_params` warm start;
- (f) the CLI: a run as a subprocess, `--resume` and `--load-from`
  through `main`; the runs it refuses.
"""
import io
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from cmtcoop_tpu.configs.presets import tiny_preset as jtiny_preset
from cmtcoop_tpu.data.synthetic import \
    synthetic_batch_iter as jsynthetic_batch_iter
from cmtcoop_tpu.configs.presets import get_preset as jget_preset
from cmtcoop_tpu.models.build import build_detector as jbuild
from cmtcoop_tpu.parallel.mesh import make_mesh
from cmtcoop_tpu.parallel.train_step import TrainState
from cmtcoop_tpu.parallel.train_step import \
    make_train_step as jmake_train_step
from cmtcoop_tpu.train.optim import make_optimizer
from cmtcoop_tpu.train.torch_convert import convert_state_dict
from cmtcoop_tpu.train.trainer import Trainer as JTrainer
from cmtcoop_tpu_torch.configs.presets import (SMALL_FUSION_EXTRACTOR,
                                               SMALL_FUSION_HEAD,
                                               SMALL_FUSION_PRESET,
                                               get_preset, tiny_preset)
from cmtcoop_tpu_torch.convert import from_jax_variables
from cmtcoop_tpu_torch.data.synthetic import synthetic_batch_iter
from cmtcoop_tpu_torch.models.build import build_detector
from cmtcoop_tpu_torch.tools import train as train_cli
from cmtcoop_tpu_torch.train import checkpoint as ckpt
from cmtcoop_tpu_torch.train.eval_hook import to_device
from cmtcoop_tpu_torch.train.optim import AdamW
from cmtcoop_tpu_torch.train.train_step import make_train_step
from cmtcoop_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
EXTRACTOR = dict(SMALL_FUSION_EXTRACTOR, use_grid_mask=False)
HEAD = dict(SMALL_FUSION_HEAD, dropout=0.0, noise_scale=0.0)
TRAIN_TOL = 2e-3
PRESET = tiny_preset(**SMALL_FUSION_PRESET)


def rows_of(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f) if "eval" not in r}


def losses(row):
    return {k: v for k, v in row.items() if k not in ("step",
                                                       "sec_per_step")}


def port_trainer(work_dir, total_steps, preset=PRESET, ckpt_every=3, **kw):
    model = build_detector(preset, train=True, **kw)
    trainer = Trainer(model, preset.tasks, total_steps=total_steps,
                      work_dir=str(work_dir), log_interval=1,
                      ckpt_interval_steps=ckpt_every, seed=0, device="cpu")
    trainer.init_state()
    return trainer


def stream(start=0):
    return itertools.islice(synthetic_batch_iter(PRESET, 1, seed=0), start,
                            None)


def assert_rows_match(ref, got, steps):
    assert set(ref) == set(got) == set(steps)
    for step in steps:
        r, g = losses(ref[step]), losses(got[step])
        assert set(r) == set(g) and {"loss", "grad_norm", "dn_loss_cls",
                                     "d0.loss_bbox"} <= set(r)
        for k, v in r.items():
            assert abs(g[k] - v) <= TRAIN_TOL * abs(v) + 1e-6, (step, k,
                                                                g[k], v)


def test_trainer_matches_the_jax_train_step(tmp_path):
    name = "cmt_lidar_vehicle_tiny"
    ek, hk = dict(use_grid_mask=False), dict(dropout=0.0, noise_scale=0.0)
    pt = port_trainer(tmp_path, 2, get_preset(name), extractor_kwargs=ek,
                      head_kwargs=hk)
    params, stats, unused = convert_state_dict(
        {k: v.numpy() for k, v in pt.model.state_dict().items()},
        dict(encoder_channels=((8, 8, 8), (8, 8, 16), (16, 16, 16),
                               (16, 16)),
             second_layers=(1, 1), num_decoder_layers=2))
    assert not unused
    jpreset = jget_preset(name)
    tx, _ = make_optimizer(params, total_steps=2)
    state = TrainState(jax.numpy.zeros((), jax.numpy.int32), params, stats,
                       tx.init(params))
    step = jmake_train_step(jbuild(jpreset, train=True, extractor_kwargs=ek,
                                   head_kwargs=hk),
                            tx, jpreset.tasks, donate=False)
    batches = list(itertools.islice(
        jsynthetic_batch_iter(jpreset, 1, seed=0), 2))
    ref = {}
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        ref[i + 1] = {k: float(v) for k, v in m.items()}
    pt.run(iter(batches))
    pt.close()
    assert_rows_match(ref, rows_of(tmp_path), (1, 2))


@pytest.mark.slow
def test_trainer_matches_the_jax_trainer(tmp_path):
    jpreset = jtiny_preset(**SMALL_FUSION_PRESET)
    batches = list(itertools.islice(jsynthetic_batch_iter(jpreset, 1), 2))
    jt = JTrainer(jbuild(jpreset, train=True, extractor_kwargs=EXTRACTOR,
                         head_kwargs=HEAD),
                  jpreset.tasks, total_steps=2, work_dir=str(tmp_path / "j"),
                  log_interval=1, mesh=make_mesh(num_dp=1), seed=0)
    state = jt.init_state(batches[0])
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    jt.run(iter(batches))

    pt = port_trainer(tmp_path / "p", 2, extractor_kwargs=EXTRACTOR,
                      head_kwargs=HEAD)
    pt.model.load_state_dict(from_jax_variables(variables), strict=True)
    pt.run(iter(batches))
    pt.close()
    assert_rows_match(rows_of(tmp_path / "j"), rows_of(tmp_path / "p"),
                      (1, 2))


def test_trainer_adds_no_numerics(tmp_path):
    trainer = port_trainer(tmp_path, 2)
    hand = build_detector(PRESET, train=True)
    hand.load_state_dict(trainer.model.state_dict())
    opt = AdamW(hand.named_parameters(), 2)
    step = make_train_step(hand, opt, PRESET.tasks, base_seed=0)
    trainer.run(stream())
    trainer.close()
    rows = rows_of(tmp_path)
    for i, batch in enumerate(itertools.islice(stream(), 2)):
        m = {k: float(v) for k, v in step(to_device(batch, "cpu")).items()}
        assert m == losses(rows[i + 1]), i
    for (n, p), q in zip(trainer.model.named_parameters(), hand.parameters()):
        assert torch.equal(p, q), n


def test_resume_replays_the_uninterrupted_run(tmp_path):
    """The uninterrupted run's step-3 checkpoint stands for the cut run's
    (the first 3 steps are the same code on the same inputs), as in
    tests/test_schedule_resume.py."""
    full = port_trainer(tmp_path / "full", 6)
    full.run(stream())
    full.close()
    assert ckpt.all_steps(tmp_path / "full" / "ckpts") == [3, 6]
    resumed = port_trainer(tmp_path / "resumed", 6)
    assert resumed.resume(str(tmp_path / "full" / "ckpts"), step=3)
    assert resumed.step == 3
    resumed.run(stream(3))
    resumed.close()
    ref, got = rows_of(tmp_path / "full"), rows_of(tmp_path / "resumed")
    assert sorted(ref) == [1, 2, 3, 4, 5, 6] and sorted(got) == [4, 5, 6]
    for s in (4, 5, 6):
        assert losses(got[s]) == losses(ref[s]), s
    for (n, p), q in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(p, q), n


def test_adamw_state_dict_round_trip(rng):
    def params():
        return [(n, torch.nn.Parameter(torch.from_numpy(
            rng.normal(size=s).astype(np.float32))))
            for n, s in (("img_backbone.w", (3, 4)), ("head.b", (5,)))]

    a_named = params()
    b_named = [(n, torch.nn.Parameter(p.detach().clone()))
               for n, p in a_named]
    a, b = AdamW(a_named, 10), AdamW(b_named, 10)
    grads = [[torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
              for _, p in a_named] for _ in range(4)]
    for g in grads[:2]:
        for (_, p), gi in zip(a_named, g):
            p.grad = gi
        a.step()
    buf = io.BytesIO()
    torch.save({"opt": a.state_dict(),
                "params": {n: p.detach() for n, p in a_named}}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    b.load_state_dict(saved["opt"])
    with torch.no_grad():
        for n, p in b_named:
            p.copy_(saved["params"][n])
    assert b.count == 2
    for g in grads[2:]:
        for named, opt in ((a_named, a), (b_named, b)):
            for (_, p), gi in zip(named, g):
                p.grad = gi.clone()
            opt.step()
    for (n, p), (_, q) in zip(a_named, b_named):
        assert torch.equal(p, q), n
    bad = a.state_dict()
    bad["mu"] = {"other": bad["mu"]["head.b"]}
    with pytest.raises(KeyError):
        b.load_state_dict(bad)


def test_load_params_warm_starts_the_parameters_alone(tmp_path):
    src = port_trainer(tmp_path / "src", 2, ckpt_every=1)
    src.run(stream())
    src.close()
    state = ckpt.restore_checkpoint(str(tmp_path / "src" / "ckpts"),
                                    step=None)
    assert state["step"] == 2
    dst = Trainer(build_detector(PRESET, train=True), PRESET.tasks,
                  total_steps=2, work_dir=str(tmp_path / "dst"), seed=1,
                  device="cpu")
    dst.init_state()
    buffers = {n: b.clone() for n, b in dst.model.named_buffers()}
    dst.load_params(state["model"])
    dst.close()
    for n, p in dst.model.named_parameters():
        assert torch.equal(p, state["model"][n]), n
    for n, b in dst.model.named_buffers():
        assert torch.equal(b, buffers[n]), n
    assert dst.step == 0
    with pytest.raises(KeyError):
        dst.load_params({})


CLI_ARGS = ("cmt_lidar_vehicle_tiny", "--device", "cpu", "--log-interval",
            "1", "--synthetic", "--epochs", "2", "--cfg-options", "max_gt=4",
            "dn_groups=1")


def test_cli_trains_resumes_and_warm_starts(tmp_path):
    """The first run as `python -m` in a subprocess; the resume and the
    warm start through `main(argv)` in this process."""
    wd = str(tmp_path / "run")
    res = subprocess.run(
        [sys.executable, "-m", "cmtcoop_tpu_torch.tools.train", *CLI_ARGS,
         "--steps", "2", "--work-dir", wd],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-2000:]
    assert sorted(rows_of(wd)) == [1, 2]
    assert ckpt.all_steps(os.path.join(wd, "ckpts")) == [1, 2]
    assert os.listdir(os.path.join(wd, "tf_logs"))
    state = ckpt.restore_checkpoint(os.path.join(wd, "ckpts"))
    assert state["step"] == state["optimizer"]["count"] == 2

    resumed = train_cli.main([*CLI_ARGS, "--steps", "4", "--work-dir", wd,
                              "--resume"])
    assert resumed.step == 4
    assert sorted(rows_of(wd)) == [1, 2, 3, 4]
    assert ckpt.all_steps(os.path.join(wd, "ckpts")) == [1, 2, 4]

    warm = str(tmp_path / "warm")
    started = train_cli.main([*CLI_ARGS, "--steps", "1", "--work-dir", warm,
                              "--load-from", os.path.join(wd, "ckpts")])
    assert started.step == 1 and sorted(rows_of(warm)) == [1]
    # the first step of the warm start runs on the step-4 parameters
    assert rows_of(warm)[1]["loss"] != rows_of(wd)[1]["loss"]


def test_cli_refuses_runs_it_cannot_make(capsys):
    with pytest.raises(SystemExit) as exc:
        train_cli.parse_args(["cmt_lidar_vehicle_tiny", "--device", "cpu"])
    assert exc.value.code != 0
    assert "ROADMAP.md" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as exc:
            train_cli.parse_args(["cmt_lidar_vehicle_tiny", "--synthetic"])
        assert exc.value.code != 0
        assert "no CUDA device" in capsys.readouterr().err
