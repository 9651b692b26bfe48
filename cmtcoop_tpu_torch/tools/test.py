"""Evaluation CLI of the port (counterpart of the root tools/test.py;
reference tools/test.py:130-286).

    python -m cmtcoop_tpu_torch.tools.test cmt_fusion_coop_tumtraf \\
        WORK/ckpts --data-root DATA --split val --eval bbox --work-dir EVAL

Restores the newest checkpoint in CHECKPOINT (a `ckpts` directory the train
CLI wrote; without one the weights are random, seeded with 0), runs the
`--split` infos under `--data-root` through an eval-mode detector
(`run_eval`, the code the train CLI's eval hook runs) and scores them with
the nusc protocol. `--work-dir` receives `metrics_summary.json`,
`metrics_details.json` and `results_nusc.json`; `--out` the detections as
JSON. Runs on the card; `--device cpu` (for tests) runs the plain versions
of the kernels on the CPU.
"""
from __future__ import annotations

import argparse
import json
import logging
from typing import Dict, Optional, Sequence

import torch

from cmtcoop_tpu_torch.configs.presets import get_preset
from cmtcoop_tpu_torch.data.eval.nusc_protocol import write_results_nusc
from cmtcoop_tpu_torch.data.loader import build_test_loader
from cmtcoop_tpu_torch.models.build import build_detector, random_init_
from cmtcoop_tpu_torch.train.checkpoint import restore_checkpoint
from cmtcoop_tpu_torch.train.eval_hook import run_eval
from cmtcoop_tpu_torch.utils.config import apply_overrides


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m cmtcoop_tpu_torch.tools.test")
    ap.add_argument("preset")
    ap.add_argument("checkpoint", nargs="?", default=None,
                    help="checkpoint directory of this package (optional: "
                         "random weights)")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--eval", default="bbox")
    ap.add_argument("--out", default=None, help="write detections json")
    ap.add_argument("--work-dir", default=None,
                    help="write results_nusc.json + metrics_summary.json + "
                         "metrics_details.json here (reference eval "
                         "artifacts, a9coop_dataset.py:293-337, 918-940)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--batch-size", type=int, default=1,
                    help="eval batch size (the tail batch is padded by "
                         "repeating the last sample)")
    ap.add_argument("--max-samples", type=int, default=None)
    ap.add_argument("--cfg-options", nargs="*", default=None,
                    help="preset field overrides, key=value")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (tests: the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error(f"--device {args.device}: no CUDA device is available "
                 "(pass --device cpu to run on the CPU, for tests)")
    return args


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns the scorer's summary."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    preset = get_preset(args.preset)
    if args.cfg_options:
        preset = apply_overrides(preset, args.cfg_options)
    dtype = dict(float32=torch.float32, bfloat16=torch.bfloat16)[args.dtype]
    model = build_detector(preset, train=False, dtype=dtype)
    if args.checkpoint:
        model.load_state_dict(
            restore_checkpoint(args.checkpoint, device="cpu")["model"])
    else:
        random_init_(model, torch.Generator().manual_seed(0))
    model.to(args.device)
    ds, _ = build_test_loader(preset, args.data_root, split=args.split)

    summary, preds = run_eval(
        model, ds, preset, batch_size=args.batch_size,
        max_samples=args.max_samples,
        work_dir=args.work_dir if "bbox" in args.eval else None)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({str(k): v for k, v in preds.items()}, f)
    if args.work_dir:
        write_results_nusc(
            preds, args.work_dir,
            meta={"use_lidar": preset.use_lidar,
                  "use_camera": preset.use_camera})
    if "bbox" in args.eval:
        print(json.dumps(summary["detail"], indent=2))
        print(f"mAP: {summary['mean_ap']:.4f}  NDS: "
              f"{summary['nd_score']:.4f}")
    return summary


if __name__ == "__main__":
    main()
