"""Distributed entry points with the reference's API (port of
``fusiontransformer_tpu/modules/TorchpackInterface.py``): ``main(cfg,
output_dir, run_name)`` trains and ``test(...)`` scores the test split,
both through ``DistributedTrainer`` in this process's rank of the process
group (torchrun's, or the caller's).  ``device`` as the trainer's (the
card by default; ``"cpu"`` for the plain path over gloo)."""

from __future__ import annotations

from fusiontransformer_tpu_torch.modules.DistributedTrainer import (
    DistributedTrainer)


def main(cfg, output_dir, run_name, device=None):
    trainer = DistributedTrainer(cfg, output_dir, run_name, device=device)
    trainer.train()
    return trainer


def test(cfg, output_dir, run_name, device=None):
    trainer = DistributedTrainer(cfg, output_dir, run_name, device=device)
    return trainer.test()
