"""Training CLI of the port (counterpart of the root tools/train.py, on one
process and one card; reference tools/train.py:116-289).

    python -m cmtcoop_tpu_torch.tools.train cmt_fusion_coop_tumtraf \\
        --synthetic --steps 100 --dtype bfloat16 --work-dir runs/fusion

`--synthetic` trains on the generated stream of data/synthetic.py and is
required: the on-disk data path (datasets, pipelines, loaders) is not
ported yet (ROADMAP.md). `--resume` continues from the newest checkpoint in
`<work-dir>/ckpts`; `--load-from DIR` warm-starts the parameters from the
newest checkpoint in DIR. As the JAX CLI does, a resumed `--synthetic` run
restarts the synthetic stream from its start, less the batch taken as the
example. Runs on the card; `--device cpu` (for tests) runs the plain
versions of the kernels on the CPU.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

import torch

from cmtcoop_tpu_torch.configs.presets import get_preset
from cmtcoop_tpu_torch.data.synthetic import synthetic_batch_iter
from cmtcoop_tpu_torch.models.build import build_detector
from cmtcoop_tpu_torch.train.checkpoint import restore_checkpoint
from cmtcoop_tpu_torch.train.trainer import Trainer
from cmtcoop_tpu_torch.utils.config import apply_overrides


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m cmtcoop_tpu_torch.tools.train")
    ap.add_argument("preset", help="preset name, see "
                    "cmtcoop_tpu_torch.configs.presets")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--epochs", type=int, default=20,
                    help="the run is cut into this many checkpoint intervals")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic", action="store_true",
                    help="train on synthetic data (required: the on-disk "
                         "data path is not ported yet)")
    ap.add_argument("--steps", type=int, default=None,
                    help="total steps (default 100)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--load-from", default=None,
                    help="checkpoint directory of this package for a "
                         "weights-only warm start")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--log-interval", type=int, default=50)
    ap.add_argument("--cfg-options", nargs="*", default=None,
                    help="preset field overrides, key=value")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (tests: the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if not args.synthetic:
        ap.error("only --synthetic runs are ported: the on-disk data path "
                 "(datasets, pipelines, build_train_loader) is the next "
                 "slice of the port, queued in ROADMAP.md")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error(f"--device {args.device}: no CUDA device is available "
                 "(pass --device cpu to run on the CPU, for tests)")
    return args


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    preset = get_preset(args.preset)
    if args.cfg_options:
        preset = apply_overrides(preset, args.cfg_options)
    work_dir = args.work_dir or f"runs/{preset.name}"
    dtype = dict(float32=torch.float32, bfloat16=torch.bfloat16)[args.dtype]
    model = build_detector(preset, train=True, dtype=dtype)

    total_steps = args.steps or 100
    batches = synthetic_batch_iter(preset, args.batch_size, args.seed)
    example = next(batches)

    trainer = Trainer(
        model, preset.tasks, total_steps=total_steps, work_dir=work_dir,
        base_lr=args.lr, log_interval=args.log_interval,
        ckpt_interval_steps=max(total_steps // args.epochs, 1),
        seed=args.seed, device=args.device)
    trainer.init_state(example)
    if args.resume:
        trainer.resume()
    elif args.load_from:
        trainer.load_params(restore_checkpoint(
            args.load_from, device=trainer.device)["model"])

    if trainer.step == 0:
        def chain(first=example, rest=batches):
            yield first
            yield from rest
        batches = chain()
    try:
        trainer.run(batches)
    finally:
        trainer.close()
    logging.info("training done: %d steps", trainer.step)
    return trainer


if __name__ == "__main__":
    main()
