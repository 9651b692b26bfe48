"""Prefetching data loader (counterpart of `PrefetchLoader` in
cmtcoop_tpu/data/loader.py; the reference's workers_per_gpu=6 DataLoader).

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
  pickle, and each worker imports its module afresh (this package builds
  no kernel and touches no card at import). The on-disk pipelines must be
  made picklable when they are ported.

Determinism is kept in both modes: a sample is a pure function of (epoch,
index), so the worker that makes it cannot change the stream.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterator, Optional

import numpy as np

from cmtcoop_tpu_torch.data import formats

# the dataset of a process-mode worker, set once by the pool's initializer
# in the worker process
_WORKER_DATASET = None


def _init_worker(dataset) -> None:
    global _WORKER_DATASET
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
