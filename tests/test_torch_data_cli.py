"""The port's on-disk CLIs end to end on the CPU, as tests/test_e2e_cli.py
runs the JAX package's: a raw archive from the port's `build_raw_archive`
-> `create_data a9coop_nusc` (infos, GT database) -> `train --data-root`
(the tiny fusion detector, 2 steps, the eval hook at step 2; then resumed
to step 3) -> `test` over val at batch 2 (one full batch and a padded
tail) -> `metrics_summary.json` with a finite mAP. Also `make_eval_hook`
against `run_eval` on the same dataset and weights, and the CLIs' refusals.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from cmtcoop_tpu_torch.configs.presets import get_preset
from cmtcoop_tpu_torch.data.loader import build_test_loader
from cmtcoop_tpu_torch.data.synthetic_archive import build_raw_archive
from cmtcoop_tpu_torch.models.build import build_detector, random_init_
from cmtcoop_tpu_torch.tools import create_data
from cmtcoop_tpu_torch.tools import test as test_cli
from cmtcoop_tpu_torch.tools import train as train_cli
from cmtcoop_tpu_torch.train import checkpoint as ckpt
from cmtcoop_tpu_torch.train import eval_hook
from cmtcoop_tpu_torch.utils.config import apply_overrides

PRESET = "cmt_fusion_coop_tumtraf"
# the flagship preset cut to the tiny detector (tiny=True: a 4-stage pillar
# encoder of 8-16 channels, V-19-slim-eSE, a 32-wide head of 24 queries) on
# a 0.6 m grid, with 64x128 camera crops
CFG = ["tiny=True", "voxel_size=(0.6,0.6,0.2)", "grid_size=(240,240,40)",
       "img_size=(64,128)", "ida_final_dim=(64,128)",
       "ida_resize_lim=(0.25,0.25)", "max_points=20000",
       "max_voxels_train=4096", "max_voxels_eval=4096", "max_gt=8",
       "dn_groups=2"]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """PyTorch on one intra-op thread here: the suite runs several test
    processes side by side on the host's cores, and the loader's worker
    threads call into PyTorch too, so more threads only oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    raw, data = str(root / "raw"), str(root / "data")
    build_raw_archive(raw, "train", n_frames=3, seed=0, img_hw=(32, 64))
    build_raw_archive(raw, "val", n_frames=3, seed=1, img_hw=(32, 64))
    create_data.main(["a9coop_nusc", "--root-path", raw, "--out-dir", data])
    return data


def rows_of(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_create_train_test_round_trip(data_root, tmp_path):
    with open(os.path.join(data_root, "a9_nusc_coop_infos_train.pkl"),
              "rb") as f:
        infos = pickle.load(f)["infos"]
    assert len(infos) == 3
    for info in infos:
        pts = np.fromfile(info["registered_lidar_path"],
                          np.float32).reshape(-1, 5)
        assert len(pts) > 1000 and np.isfinite(pts).all()
        assert info["gt_boxes"].shape == (4, 7)
        cam = info["vehicle_cams"]["vehicle_camera_basler_16mm"]
        assert cam["data_path"].endswith(".npy")
    with open(os.path.join(data_root, "a9_nusc_coop_dbinfos_train.pkl"),
              "rb") as f:
        assert sum(len(v) for v in pickle.load(f).values()) == 12

    work, evald = str(tmp_path / "work"), str(tmp_path / "eval")
    args = [PRESET, "--data-root", data_root, "--work-dir", work,
            "--device", "cpu", "--epochs", "1", "--num-workers", "2",
            "--log-interval", "1", "--eval-interval-steps", "2",
            "--eval-max-samples", "2", "--cfg-options", *CFG]
    trainer = train_cli.main([*args, "--steps", "2"])
    assert trainer.step == 2
    assert ckpt.all_steps(os.path.join(work, "ckpts")) == [2]
    rows = rows_of(work)
    assert [r["step"] for r in rows if "eval" not in r] == [1, 2]
    evals = [r for r in rows if "eval" in r]
    assert len(evals) == 1 and evals[0]["step"] == 2
    assert np.isfinite(evals[0]["eval"]["object/map"])
    assert np.isfinite(evals[0]["eval"]["object/nds"])
    assert all(np.isfinite(v) for r in rows if "eval" not in r
               for v in r.values())

    # resumed: the data stream continues at the checkpointed step
    resumed = train_cli.main([*args, "--steps", "3", "--resume"])
    assert resumed.step == 3
    assert [r["step"] for r in rows_of(work) if "eval" not in r] == [1, 2, 3]

    summary = test_cli.main([
        PRESET, os.path.join(work, "ckpts"), "--data-root", data_root,
        "--split", "val", "--eval", "bbox", "--work-dir", evald,
        "--out", str(tmp_path / "dets.json"), "--dtype", "float32",
        "--batch-size", "2", "--device", "cpu", "--cfg-options", *CFG])
    with open(os.path.join(evald, "metrics_summary.json")) as f:
        written = json.load(f)
    assert np.isfinite(written["mean_ap"])
    assert written["mean_ap"] == summary["mean_ap"]
    assert os.path.exists(os.path.join(evald, "results_nusc.json"))
    with open(tmp_path / "dets.json") as f:
        assert len(json.load(f)) == 3  # every val frame, the tail's too


def test_eval_hook_equals_run_eval(data_root, monkeypatch):
    """`make_eval_hook`'s metrics and boxes equal `run_eval` over the same
    dataset with a fresh eval model loaded from the same state_dict, for
    two different states (the hook reloads its model on each call)."""
    preset = apply_overrides(get_preset(PRESET), CFG)
    seen = []
    run_eval = eval_hook.run_eval

    def spy(*args, **kwargs):
        summary, preds = run_eval(*args, **dict(kwargs, collect_preds=True))
        seen.append(preds)
        return summary, preds

    monkeypatch.setattr(eval_hook, "run_eval", spy)
    hook = eval_hook.make_eval_hook(preset, data_root, split="val",
                                    batch_size=2, device="cpu")
    ds, _ = build_test_loader(preset, data_root, split="val")
    for seed in (0, 1):
        train_model = build_detector(preset, train=True)
        random_init_(train_model, torch.Generator().manual_seed(seed))
        state = {"step": seed, "model": train_model.state_dict()}
        out = hook(state, seed)
        ref_model = build_detector(preset)
        ref_model.load_state_dict(state["model"])
        summary, preds = run_eval(ref_model, ds, preset, batch_size=2)
        assert seen[-1] == preds
        assert out["object/map"] == summary["mean_ap"]
        assert out["object/nds"] == summary["nd_score"]
        assert out == {**{k: v for k, v in summary["detail"].items()
                          if isinstance(v, (int, float))},
                       "object/map": summary["mean_ap"],
                       "object/nds": summary["nd_score"]}
    assert seen[0] != seen[1]


def test_clis_refuse_what_is_not_ported(tmp_path, capsys):
    for dataset in ("a9_kitti", "nuscenes"):
        with pytest.raises(SystemExit) as exc:
            create_data.main([dataset, "--root-path", str(tmp_path),
                              "--out-dir", str(tmp_path / "out")])
        assert exc.value.code == 2
        assert "ROADMAP.md" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as exc:
            test_cli.parse_args([PRESET, "--data-root", str(tmp_path)])
        assert exc.value.code == 2
        assert "no CUDA device" in capsys.readouterr().err
