"""A picklable stand-in dataset for the loader tests (numpy only, so a
spawned worker that unpickles it imports neither jax nor the JAX package).
"""
import numpy as np


class StubDataset:
    """Returns (index, epoch) so batch contents encode the data stream."""

    def __init__(self, n):
        self.n = n
        self._epoch = 0

    def set_epoch(self, epoch):
        self._epoch = int(epoch)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.array([i], np.int64),
                "epoch": np.array([self._epoch], np.int64)}
