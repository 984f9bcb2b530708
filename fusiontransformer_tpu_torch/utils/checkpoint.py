"""Checkpointer with a last-checkpoint manifest and max-to-keep GC (torch).

Port of ``CheckpointerV2`` of ``fusiontransformer_tpu/utils/checkpoint.py``:
``save`` writes one ``torch.save`` file per checkpoint (the model's
``state_dict`` — parameters and BN running statistics — the optimizer's
state dict, step, epoch, best metrics, the dropout generator's state,
``grad_accum_steps`` and, with ``TRAIN.GRAD_ACCUM_STEPS`` > 1, the
gradients accumulated so far in ``grad_accum`` and the open window's
micro-step count in ``grad_accum_window``: the JAX package keeps both in
its optimizer state), appends it to the ``last_checkpoint`` manifest in
the save directory and deletes the oldest beyond ``max_to_keep``.  ``load``
restores the newest one when resuming and logs the file's MD5.

With ``async_save`` (``TRAIN.ASYNC_CHECKPOINT``) only the file write runs
on a background thread.  The snapshot of every tensor into host memory of
the checkpoint's own happens before ``save`` returns: the trainer's
parameters, optimizer state and gradients are static tensors that the
next CUDA-graph replay (or eager step) overwrites in place, so a thread
that read them later would save a later step.  Saves run one at a time: a
save joins the previous write first, and so do ``wait`` and ``load``; a
failed write raises at the next ``wait`` or ``save``.
"""

from __future__ import annotations

import hashlib
import logging
import os
import os.path as osp
import threading
import time

import torch


def host_snapshot(obj):
    """``obj`` with every tensor in it copied into host memory of its own
    (nested dicts, lists and tuples followed; other values kept)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_snapshot(v) for v in obj)
    return obj


def checkpoint_md5(path, chunk=1 << 20):
    """MD5 of a checkpoint file, for the load log line (the JAX package's
    ``checkpoint_md5``)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


class Checkpointer:
    _LAST = "last_checkpoint"

    def __init__(self, save_dir="", logger=None, max_to_keep=100,
                 async_save=False):
        self.save_dir = osp.abspath(save_dir) if save_dir else save_dir
        self.logger = logger or logging.getLogger(__name__)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._pending = None            # the background write
        self._write_error = None        # what the last background write raised
        self.last_write_s = None        # seconds the last write took
        self._saved = []
        if self.save_dir and osp.exists(self._manifest_path()):
            with open(self._manifest_path()) as f:
                self._saved = [ln.strip() for ln in f if ln.strip()]

    def _manifest_path(self):
        return osp.join(self.save_dir, self._LAST)

    def wait(self):
        """Join the write in flight, if any; re-raise a write that failed,
        so that no caller takes a failed save for a checkpoint."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise RuntimeError(f"checkpoint write failed: {err}") from err

    def save(self, name, **payload):
        """Write ``payload`` (tensors, state dicts, numbers) to
        ``<save_dir>/<name>.pth``; the manifest is rewritten after the file
        is complete, so it never names a half-written checkpoint.  Returns
        the path (the write may still be running with ``async_save``)."""
        if not self.save_dir:
            return None
        payload = host_snapshot(payload)
        self.wait()
        os.makedirs(self.save_dir, exist_ok=True)
        path = osp.join(self.save_dir, name + ".pth")
        if self.async_save:
            self._pending = threading.Thread(
                target=self._write, args=(path, payload), daemon=True,
                name="checkpoint-write")
            self._pending.start()
        else:
            self._write(path, payload)
            self.wait()         # re-raises a failed write
        return path

    def _write(self, path, payload):
        t0 = time.perf_counter()
        try:
            tmp = path + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
            if path in self._saved:
                self._saved.remove(path)
            self._saved.append(path)
            while len(self._saved) > self.max_to_keep:
                victim = self._saved.pop(0)
                if osp.exists(victim):
                    os.remove(victim)
            with open(self._manifest_path(), "w") as f:
                f.write("\n".join(self._saved))
            self.last_write_s = time.perf_counter() - t0
            self.logger.info("Saved checkpoint to %s in %.2f s", path,
                             self.last_write_s)
        except Exception as e:      # noqa: BLE001 - raised again at wait()
            self.logger.exception("Checkpoint write failed: %s", path)
            self._write_error = e

    def load(self, path=None, resume=True, resume_states=True):
        """The restored payload (``{}`` when there is nothing to restore).

        Joins a write in flight first.  With no ``path`` and ``resume``,
        the manifest's newest checkpoint.  ``resume_states=False`` drops the
        optimizer state (with the accumulated gradients and their window's
        count) and the epoch.  Tensors load onto the CPU; the caller moves
        them.
        """
        self.wait()
        if not path and resume and self._saved:
            path = self._saved[-1]
        if not path:
            self.logger.info("No checkpoint found; training from scratch.")
            return {}
        self.logger.info("Loading checkpoint from %s, MD5: %s", path,
                         checkpoint_md5(path))
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if not resume_states:
            payload = {k: v for k, v in payload.items()
                       if k not in ("optimizer", "grad_accum",
                                    "grad_accum_window", "epoch")}
        return payload
