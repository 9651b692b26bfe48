"""Prefetching data loader and the on-disk train / test loaders
(counterpart of cmtcoop_tpu/data/loader.py; the reference's
workers_per_gpu=6 DataLoader).

Worker pools run the numpy pipeline; a bounded queue keeps batches ready so
the step never waits on the host. Two worker modes:

- threads (default): the heavy per-sample work (point decode, image resize,
  GT paste geometry) runs in numpy, which releases the GIL;
- processes (`use_processes=True`): for pipelines whose residual Python time
  would serialise threads. Unlike the JAX package's, the pool does not
  fork: a process that has initialised CUDA (or runs threads) cannot be
  forked safely. It uses the `spawn` start method, and ships the dataset to
  each worker once, through the pool's initializer, after `set_epoch`; only
  a batch's indices cross the pipe per task. The dataset must therefore
  pickle (the on-disk datasets' pipelines are `Pipeline` objects,
  data/pipeline_builder.py), and each worker imports its module afresh
  (this package builds no kernel and touches no card at import). A worker
  runs PyTorch on one thread (the image resize), so that the workers do not
  oversubscribe the host's cores.

Determinism is kept in both modes: a sample is a pure function of (epoch,
index), so the worker that makes it cannot change the stream.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from cmtcoop_tpu_torch.configs.presets import Preset
from cmtcoop_tpu_torch.data import formats
from cmtcoop_tpu_torch.data.datasets import (A9NuscCoopDataset, A9NuscDataset,
                                             cbgs_indices)
from cmtcoop_tpu_torch.data.pipeline_builder import build_pipeline
from cmtcoop_tpu_torch.data.pipelines.dbsampler import DataBaseSampler

# the dataset of a process-mode worker, set once by the pool's initializer
# in the worker process
_WORKER_DATASET = None


def _init_worker(dataset) -> None:
    global _WORKER_DATASET
    torch.set_num_threads(1)
    _WORKER_DATASET = dataset


def _worker_batch(idxs) -> Dict[str, np.ndarray]:
    return formats.collate([_WORKER_DATASET[int(i)] for i in idxs])


class PrefetchLoader:
    """Iterate batches assembled by workers, in a deterministic order,
    `prefetch` batches ahead.

    Epoch-aware and resumable: with `shuffle_seed` set, the (fixed) index
    set is reshuffled per epoch with a per-epoch seed
    (= DistributedSampler.set_epoch), the dataset's augmentation rng is
    re-keyed per epoch (`set_epoch`, where it has one), and
    `iter_steps(start_step)` resumes mid-epoch at the exact batch a restored
    checkpoint stopped at: the data stream of a resumed run is identical to
    an uninterrupted one."""

    def __init__(self, dataset, indices: np.ndarray, batch_size: int,
                 num_workers: int = 6, prefetch: int = 4,
                 shuffle_seed: Optional[int] = None,
                 process_id: int = 0, num_processes: int = 1,
                 use_processes: bool = False):
        """`batch_size` is GLOBAL. With num_processes > 1 each process
        yields its own batch_size/num_processes slice of every global batch,
        so the global data stream is identical for any process count."""
        if batch_size % num_processes:
            raise ValueError(f"batch size {batch_size} does not split over "
                             f"{num_processes} processes")
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shuffle_seed = shuffle_seed
        self.process_id = process_id
        self.num_processes = num_processes
        self.use_processes = use_processes

    def __len__(self):
        return len(self.indices) // self.batch_size

    def epoch_indices(self, epoch: int) -> np.ndarray:
        if self.shuffle_seed is None:
            return self.indices
        idx = self.indices.copy()
        np.random.default_rng(self.shuffle_seed + epoch).shuffle(idx)
        return idx

    def _batch_indices(self, indices, b: int) -> np.ndarray:
        local = self.batch_size // self.num_processes
        start = b * self.batch_size + self.process_id * local
        return indices[start:start + local]

    def _make_batch(self, indices, b: int) -> Dict[str, np.ndarray]:
        return formats.collate([self.dataset[int(i)]
                                for i in self._batch_indices(indices, b)])

    def iter_epoch(self, epoch: int = 0,
                   start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        indices = self.epoch_indices(epoch)
        n_batches = len(self)
        inflight = self.prefetch + self.num_workers
        if self.use_processes:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            with ctx.Pool(self.num_workers, initializer=_init_worker,
                          initargs=(self.dataset,)) as pool:
                futures: deque = deque()
                b = start_batch
                while b < n_batches or futures:
                    while b < n_batches and len(futures) < inflight:
                        futures.append(pool.apply_async(
                            _worker_batch,
                            (self._batch_indices(indices, b),)))
                        b += 1
                    yield futures.popleft().get()
            return
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(self.num_workers) as ex:
            futures = deque()
            b = start_batch
            while b < n_batches or futures:
                while b < n_batches and len(futures) < inflight:
                    futures.append(ex.submit(self._make_batch, indices, b))
                    b += 1
                yield futures.popleft().result()

    def iter_steps(self, start_step: int = 0,
                   max_epochs: Optional[int] = None
                   ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite (or max_epochs-bounded) multi-epoch stream starting at
        global batch `start_step`: the resume entry point."""
        spe = len(self)
        epoch = start_step // spe
        start = start_step % spe
        while max_epochs is None or epoch < max_epochs:
            yield from self.iter_epoch(epoch, start)
            epoch += 1
            start = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_epoch(0)


DEFAULT_SAMPLE_GROUPS = dict(  # coop config:70-78
    CAR=2, TRAILER=5, TRUCK=3, VAN=3, PEDESTRIAN=7, BUS=5, BICYCLE=7)


def _prefixes(preset: Preset):
    return (("vehicle_", "infrastructure_") if preset.domain == "coop"
            else ("",))


def build_train_loader(preset: Preset, data_root: str, batch_size: int,
                       num_workers: int = 6, seed: int = 0,
                       use_cbgs: bool = True,
                       db_sampler_cfg: Optional[dict] = None,
                       modal_mask: bool = False,
                       process_id: int = 0, num_processes: int = 1):
    """The training loader over `<data_root>/<ann_prefix>_train.pkl`:
    CBGS-resampled indices drawn once from `seed`, reshuffled per epoch,
    the GT-paste database wired in when `*_dbinfos_train.pkl` is there.
    Returns (loader, steps per epoch)."""
    db_sampler = None
    if db_sampler_cfg:
        db_sampler = DataBaseSampler(**db_sampler_cfg)
    else:
        # auto-wire the GT-paste database when present (dbinfos built by
        # tools/create_data.py, coop config:49-84)
        dbinfos = os.path.join(
            data_root, preset.ann_prefix.replace("infos", "dbinfos")
            + "_train.pkl")
        if os.path.exists(dbinfos):
            db_sampler = DataBaseSampler(
                info_path=dbinfos, data_root=data_root,
                sample_groups={k: v for k, v in
                               DEFAULT_SAMPLE_GROUPS.items()
                               if k in preset.class_names},
                classes=preset.class_names,
                filter_by_min_points={c: 5 for c in preset.class_names})
    pipeline = build_pipeline(preset, training=True,
                              prefixes=_prefixes(preset),
                              db_sampler=db_sampler, modal_mask=modal_mask)
    cls = A9NuscCoopDataset if preset.domain == "coop" else A9NuscDataset
    ds = cls(
        ann_file=f"{data_root}/{preset.ann_prefix}_train.pkl",
        class_names=preset.class_names, pipeline=pipeline,
        use_camera=preset.use_camera, use_lidar=preset.use_lidar)
    rng = np.random.default_rng(seed)
    # CBGS index set drawn once (mmdet3d CBGSDataset semantics); the
    # per-epoch ORDER comes from PrefetchLoader.epoch_indices
    indices = cbgs_indices(ds, rng) if use_cbgs else np.arange(len(ds))
    loader = PrefetchLoader(ds, indices, batch_size, num_workers,
                            shuffle_seed=seed, process_id=process_id,
                            num_processes=num_processes)
    return loader, len(loader)


def build_test_loader(preset: Preset, data_root: str, split: str = "val",
                      batch_size: int = 1, num_workers: int = 6):
    """The test dataset over `<data_root>/<ann_prefix>_<split>.pkl` (test
    mode: no GT in the samples) and its loader in index order. Returns
    (dataset, loader)."""
    pipeline = build_pipeline(preset, training=False,
                              prefixes=_prefixes(preset))
    cls = A9NuscCoopDataset if preset.domain == "coop" else A9NuscDataset
    ds = cls(
        ann_file=f"{data_root}/{preset.ann_prefix}_{split}.pkl",
        class_names=preset.class_names, pipeline=pipeline, test_mode=True,
        use_camera=preset.use_camera, use_lidar=preset.use_lidar)
    loader = PrefetchLoader(ds, np.arange(len(ds)), batch_size, num_workers)
    return ds, loader
