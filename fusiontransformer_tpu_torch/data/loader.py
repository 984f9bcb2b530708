"""Batching loader: a prefetch thread, or a pool of worker processes (port
of ``fusiontransformer_tpu/data/loader.py``).

Batch order: the scan indices, shuffled per epoch with
``RandomState(seed + epoch)`` when ``shuffle``.  Each batch's augmentation
draws are seeded from (loader seed, epoch, batch ordinal) exactly as the JAX
package's workers seed them, so a run is reproducible whatever produces the
batches and however many workers there are: numpy's global generator is
seeded before each batch is made (the synthetic dataset draws from its own
per-item generator instead).

A thread keeps up to ``prefetch`` collated batches ready while the device
step runs; an error there is re-raised in the consumer.

* ``num_workers == 0``: that thread makes the batches.
* ``num_workers > 0``: it fetches them from a persistent ``forkserver``
  pool, whose workers make whole batches (items, augmentation, quantize,
  collate and slot maps) in parallel.  At most workers + max(2, prefetch)
  batches are in flight, and they come back in the order they were
  submitted; the epoch's seed travels with each task, so one pool serves
  every epoch.  A worker hands a batch's arrays over in one shared-memory
  block, which the thread copies out and unlinks: through the pool's
  result pipe, 64 KiB at a time, a flagship batch (~100 MB, most of it the
  images) took longer to arrive than to make.  A worker's error is
  re-raised in the consumer.  Workers descend from a clean helper process,
  not from the trainer (which holds CUDA state and threads), run numpy only
  and never initialise CUDA; the dataset and the collate are pickled once
  per worker.  ``close`` stops the pool.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from collections import deque
from multiprocessing import shared_memory

import numpy as np

# A worker process's dataset and collate, installed once by _worker_init.
_G = {}


def batch_seed(seed: int, epoch: int, ordinal: int) -> int:
    return ((seed + epoch) * 100003 + ordinal) % (2 ** 31 - 1)


def _produce(dataset, collate_fn, seed, epoch, ordinal, idx):
    np.random.seed(batch_seed(seed, epoch, ordinal))
    return collate_fn([dataset[int(i)] for i in idx])


def _worker_init(dataset, collate_fn):
    _G["dataset"] = dataset
    _G["collate"] = collate_fn


def _worker_produce(seed, epoch, ordinal, idx):
    return _share(_produce(_G["dataset"], _G["collate"], seed, epoch,
                           ordinal, idx))


def _share(batch):
    """``(name, layout, rest)``: a dict batch's top-level arrays copied
    into one new shared-memory block ``name`` at ``layout[key] = (shape,
    dtype, offset)``; ``rest`` holds its other values (another batch is
    ``rest`` whole, and ``name`` None)."""
    if not isinstance(batch, dict):
        return None, {}, batch
    rest = dict(batch)
    layout, size = {}, 0
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            layout[k] = (v.shape, v.dtype, size)
            size += -(-v.nbytes // 64) * 64
            del rest[k]
    shm = shared_memory.SharedMemory(create=True, size=max(size, 1))
    try:
        for k, (shape, dtype, offset) in layout.items():
            view = np.ndarray(shape, dtype, buffer=shm.buf, offset=offset)
            view[...] = batch[k]
            del view
    except BaseException:
        shm.close()
        shm.unlink()
        raise
    shm.close()
    return shm.name, layout, rest


def _unshare(shared):
    """The batch of ``_share``, its arrays copied out of the block, which
    is then unlinked."""
    name, layout, rest = shared
    if name is None:
        return rest
    shm = shared_memory.SharedMemory(name=name)
    try:
        batch = dict(rest)
        for k, (shape, dtype, offset) in layout.items():
            batch[k] = np.ndarray(shape, dtype, buffer=shm.buf,
                                  offset=offset).copy()
    finally:
        shm.close()
        shm.unlink()
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size, collate_fn, shuffle=False,
                 seed=0, prefetch=1, num_workers=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.prefetch = max(1, int(prefetch))
        self.num_workers = int(num_workers)
        self._pool = None

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
        return _produce(self.dataset, self.collate_fn, self.seed, self.epoch,
                        ordinal, idx)

    def _get_pool(self):
        if self._pool is None:
            ctx = multiprocessing.get_context("forkserver")
            self._pool = ctx.Pool(self.num_workers, initializer=_worker_init,
                                  initargs=(self.dataset, self.collate_fn))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __iter__(self):
        batches = list(enumerate(self._index_batches()))
        if self.num_workers > 0:
            return self._ahead(self._from_pool(batches))
        return self._ahead(self._produce(ordinal, idx)
                           for ordinal, idx in batches)

    def _from_pool(self, batches):
        """Batches from the pool in submission order, with at most
        workers + max(2, prefetch) in flight."""
        pool = self._get_pool()
        window = self.num_workers + max(2, self.prefetch)
        pending = deque()
        todo = iter(batches)

        def submit():
            for ordinal, idx in todo:
                pending.append(pool.apply_async(
                    _worker_produce,
                    (self.seed, self.epoch, ordinal, np.asarray(idx))))
                return

        for _ in range(window):
            submit()
        try:
            while pending:
                batch = _unshare(pending.popleft().get())
                submit()
                yield batch
        finally:
            # An epoch left early: unlink the blocks of the batches that
            # have arrived (the pool's resource tracker unlinks the others
            # when the program ends).
            for result in pending:
                if result.ready() and result.successful():
                    _unshare(result.get())

    def _ahead(self, produced):
        """The batches of ``produced``, made (or fetched from the pool and
        copied out of shared memory) by a thread that keeps up to
        ``prefetch`` of them ready while the device step runs."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        failure = []

        def worker():
            try:
                for batch in produced:
                    q.put(batch)
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
