"""Checkpointer with a last-checkpoint manifest and max-to-keep GC (torch).

Port of ``CheckpointerV2`` of ``fusiontransformer_tpu/utils/checkpoint.py``,
synchronous: ``save`` writes one ``torch.save`` file per checkpoint (the
model's ``state_dict`` — parameters and BN running statistics — the
optimizer's state dict, step, epoch, best metrics, the dropout generator's
state, ``grad_accum_steps`` and, with ``TRAIN.GRAD_ACCUM_STEPS`` > 1, the
gradients accumulated so far in ``grad_accum`` and the open window's
micro-step count in ``grad_accum_window``: the JAX package keeps both in
its optimizer state), appends it to the ``last_checkpoint`` manifest in
the save directory and deletes the oldest beyond ``max_to_keep``.  ``load``
restores the newest one when resuming.
The JAX package's asynchronous writer is not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import logging
import os
import os.path as osp

import torch


class Checkpointer:
    _LAST = "last_checkpoint"

    def __init__(self, save_dir="", logger=None, max_to_keep=100):
        self.save_dir = osp.abspath(save_dir) if save_dir else save_dir
        self.logger = logger or logging.getLogger(__name__)
        self.max_to_keep = max_to_keep
        self._saved = []
        if self.save_dir and osp.exists(self._manifest_path()):
            with open(self._manifest_path()) as f:
                self._saved = [ln.strip() for ln in f if ln.strip()]

    def _manifest_path(self):
        return osp.join(self.save_dir, self._LAST)

    def save(self, name, **payload):
        """Write ``payload`` (tensors, state dicts, numbers) to
        ``<save_dir>/<name>.pth``; the manifest is rewritten after the file
        is complete, so it never names a half-written checkpoint."""
        if not self.save_dir:
            return None
        os.makedirs(self.save_dir, exist_ok=True)
        path = osp.join(self.save_dir, name + ".pth")
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
        self.logger.info("Saved checkpoint to %s", path)
        return path

    def load(self, path=None, resume=True, resume_states=True):
        """The restored payload (``{}`` when there is nothing to restore).

        With no ``path`` and ``resume``, the manifest's newest checkpoint.
        ``resume_states=False`` drops the optimizer state (with the
        accumulated gradients and their window's count) and the epoch.  Tensors load onto the CPU;
        the caller moves them.
        """
        if not path and resume and self._saved:
            path = self._saved[-1]
        if not path:
            self.logger.info("No checkpoint found; training from scratch.")
            return {}
        self.logger.info("Loading checkpoint from %s", path)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if not resume_states:
            payload = {k: v for k, v in payload.items()
                       if k not in ("optimizer", "grad_accum",
                                    "grad_accum_window", "epoch")}
        return payload
