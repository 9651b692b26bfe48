"""Training loop: the mmcv EpochBasedRunner equivalent (counterpart of
cmtcoop_tpu/train/trainer.py).

Per iteration: the host batch copied to the device -> the train step
(forward + DN + Hungarian loss + backward + clip-35 AdamW with cyclic
schedules, train/train_step.py) -> on log steps the per-decoder-layer loss
dict to `metrics.jsonl` and TensorBoard (TextLoggerHook every 50 iters,
coop config:395-398; the device scalars are read on log steps only) ->
checkpoints every `ckpt_interval_steps` (keep 5) and the optional eval
hook. The step index is the optimizer's `count`, as the JAX loop's is
`state.step`: a restored checkpoint restores it, and with it the schedules
and the step's random draws.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from cmtcoop_tpu_torch.models.build import random_init_
from cmtcoop_tpu_torch.train import checkpoint as ckpt
from cmtcoop_tpu_torch.train.eval_hook import to_device
from cmtcoop_tpu_torch.train.optim import AdamW
from cmtcoop_tpu_torch.train.train_step import make_train_step
from cmtcoop_tpu_torch.utils.tb_writer import TensorBoardWriter

log = logging.getLogger("cmtcoop")


class Trainer:
    def __init__(
        self,
        model: torch.nn.Module,
        tasks,
        total_steps: int,
        work_dir: str,
        base_lr: float = 1e-4,
        log_interval: int = 50,
        ckpt_interval_steps: Optional[int] = None,
        max_keep_ckpts: int = 5,
        seed: int = 0,
        device="cuda",
    ):
        self.model = model
        self.tasks = tasks
        self.total_steps = total_steps
        self.work_dir = work_dir
        self.log_interval = log_interval
        self.ckpt_interval_steps = ckpt_interval_steps
        self.max_keep_ckpts = max_keep_ckpts
        self.seed = seed
        self.base_lr = base_lr
        self.device = torch.device(device)
        self.optimizer: Optional[AdamW] = None
        self.step_fn = None
        os.makedirs(work_dir, exist_ok=True)
        self._metrics_file = open(
            os.path.join(work_dir, "metrics.jsonl"), "a")
        # TensorboardLoggerHook equivalent (config log_config:395-398)
        self._tb = TensorBoardWriter(os.path.join(work_dir, "tf_logs"))

    def init_state(self, example_batch: Optional[Dict] = None
                   ) -> Dict[str, Any]:
        """Seeded weights (`random_init_` from `seed`, where the JAX
        package's `model.init` draws from `PRNGKey(seed)`), the model on the
        device in train mode, the optimizer and the step. The port's
        modules have their shapes from the preset, so `example_batch` (the
        JAX signature's) is not read. Returns `state`."""
        random_init_(self.model, torch.Generator().manual_seed(self.seed))
        self.model.to(self.device).train()
        self.optimizer = AdamW(self.model.named_parameters(),
                               self.total_steps, base_lr=self.base_lr)
        self.step_fn = make_train_step(self.model, self.optimizer,
                                       self.tasks, base_seed=self.seed)
        return self.state

    @property
    def step(self) -> int:
        return self.optimizer.count

    @property
    def state(self) -> Dict[str, Any]:
        """What a checkpoint holds: the step, the model's and the
        optimizer's state_dicts (references to the live tensors)."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def resume(self, ckpt_dir: Optional[str] = None,
               step: Optional[int] = None) -> bool:
        """Full resume (`resume_from`): parameters, running statistics and
        the optimizer (its count: the step) from the checkpoint of `step`
        (default the newest) in `ckpt_dir` (default `work_dir/ckpts`).
        False when there is none."""
        ckpt_dir = ckpt_dir or os.path.join(self.work_dir, "ckpts")
        if step is None:
            step = ckpt.latest_step(ckpt_dir)
        if step is None:
            return False
        ckpt.restore_checkpoint(
            ckpt_dir, {"model": self.model, "optimizer": self.optimizer},
            step, device=self.device)
        log.info("resumed from step %d", step)
        return True

    def load_params(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Weights-only warm start (`load_from`, coop config:402): the
        parameters of `state_dict` (every parameter of the model, strictly
        by name), as the JAX loop replaces `state.params` alone; running
        statistics, the step and the optimizer stay."""
        names = {n for n, _ in self.model.named_parameters()}
        missing = sorted(names - set(state_dict))
        if missing:
            raise KeyError(f"warm start lacks parameters {missing[:5]} "
                           f"({len(missing)})")
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(state_dict[n])

    def run(self, batch_iter: Iterable[Dict[str, Any]],
            eval_hook: Optional[Callable[[Dict, int], Dict]] = None,
            eval_interval_steps: Optional[int] = None) -> Dict[str, Any]:
        if self.optimizer is None:
            raise RuntimeError("call init_state first")
        t_last = time.time()
        for batch in batch_iter:
            step_idx = self.step
            if step_idx >= self.total_steps:
                break
            metrics = self.step_fn(to_device(batch, self.device))
            step_idx += 1
            if step_idx % self.log_interval == 0 or step_idx == 1:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = (time.time() - t_last) / (
                    self.log_interval if step_idx > 1 else 1)
                t_last = time.time()
                metrics.update(step=step_idx, sec_per_step=round(dt, 3))
                log.info("step %d: loss=%.4f (%.2fs/it)", step_idx,
                         metrics["loss"], dt)
                self._metrics_file.write(json.dumps(metrics) + "\n")
                self._metrics_file.flush()
                self._tb.add_scalars(
                    step_idx, {f"train/{k}": v for k, v in metrics.items()
                               if k != "step"})
                self._tb.flush()
            if (self.ckpt_interval_steps and
                    step_idx % self.ckpt_interval_steps == 0):
                ckpt.save_checkpoint(
                    os.path.join(self.work_dir, "ckpts"), step_idx,
                    self.state, max_keep=self.max_keep_ckpts)
            if (eval_hook is not None and eval_interval_steps and
                    step_idx % eval_interval_steps == 0):
                results = eval_hook(self.state, step_idx)
                log.info("eval @%d: map=%s nds=%s", step_idx,
                         results.get("object/map"),
                         results.get("object/nds"))
                num = {k: v for k, v in results.items()
                       if isinstance(v, (int, float))}
                self._metrics_file.write(json.dumps(
                    {"step": step_idx, "eval": num}) + "\n")
                self._metrics_file.flush()
                self._tb.add_scalars(
                    step_idx, {f"val/{k}": v for k, v in num.items()})
                self._tb.flush()
        return self.state

    def close(self) -> None:
        """Close the metrics file and the TensorBoard writer."""
        self._metrics_file.close()
        self._tb.close()
