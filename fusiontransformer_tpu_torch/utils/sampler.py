"""Iteration-based batch sampler (port of
``fusiontransformer_tpu/utils/sampler.py``, itself the reference's
``common/utils/sampler.py``).

Yields exactly ``num_iterations - start_iter`` batches of dataset indices,
shuffling each epoch's order with ``np.random.RandomState(seed + epoch)``
and moving to the next epoch when one runs out.  Pure numpy; no trainer of
either package uses it, and it is kept for the component's parity.
"""

from __future__ import annotations

import numpy as np


class IterationBasedBatchSampler:
    def __init__(self, dataset_size, batch_size, num_iterations,
                 start_iter=0, shuffle=True, seed=0, drop_last=True):
        self.dataset_size = dataset_size
        self.batch_size = batch_size
        self.num_iterations = num_iterations
        self.start_iter = start_iter
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _epoch_batches(self, epoch):
        order = np.arange(self.dataset_size)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        for i in range(0, self.dataset_size, self.batch_size):
            b = order[i:i + self.batch_size]
            if self.drop_last and len(b) < self.batch_size:
                return
            yield b

    def __iter__(self):
        iteration = self.start_iter
        epoch = self.epoch
        while iteration < self.num_iterations:
            for batch in self._epoch_batches(epoch):
                if iteration >= self.num_iterations:
                    return
                iteration += 1
                yield batch
            epoch += 1

    def __len__(self):
        return self.num_iterations - self.start_iter
