"""Batching loader with one prefetch thread (the ``NUM_WORKERS: 0`` path
of ``fusiontransformer_tpu/data/loader.py``).

Batch order: the scan indices, shuffled per epoch with
``RandomState(seed + epoch)`` when ``shuffle``.  Each batch's augmentation
draws are seeded from (loader seed, epoch, batch ordinal) exactly as the JAX
package's workers seed them, so a run is reproducible whatever produces the
batches: numpy's global generator is seeded before each batch is made (the
synthetic dataset draws from its own per-item generator instead).  A
thread keeps the next collated batch ready while the device step runs, as
the JAX loader's one prefetch thread does; an error there is re-raised in
the consumer.  The worker
pool (``NUM_WORKERS > 0``) is not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


def batch_seed(seed: int, epoch: int, ordinal: int) -> int:
    return ((seed + epoch) * 100003 + ordinal) % (2 ** 31 - 1)


class DataLoader:
    def __init__(self, dataset, batch_size, collate_fn, shuffle=False,
                 seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _index_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return [order[i:i + self.batch_size]
                for i in range(0, len(order), self.batch_size)]

    def _produce(self, ordinal, idx):
        np.random.seed(batch_seed(self.seed, self.epoch, ordinal))
        return self.collate_fn([self.dataset[int(i)] for i in idx])

    def __iter__(self):
        batches = list(enumerate(self._index_batches()))
        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = object()
        failure = []

        def worker():
            try:
                for ordinal, idx in batches:
                    q.put(self._produce(ordinal, idx))
            except BaseException as e:  # handed to the consumer, re-raised
                failure.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]
