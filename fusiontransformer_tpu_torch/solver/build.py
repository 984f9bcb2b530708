"""Optimizer and learning-rate schedule (torch).

Port of ``fusiontransformer_tpu/solver/build.py``:

* Adam with torch's coupled L2 (the decay is added to the gradient before
  the moment updates) is ``torch.optim.Adam(weight_decay=wd, eps=1e-8)``:
  the same update as the JAX package's ``add_decayed_weights(wd)`` +
  ``scale_by_adam(eps=1e-8)`` + ``scale_by_learning_rate``;
* SGD: momentum with dampening 0 (``optax.trace``), coupled L2 likewise;
* schedules are per-epoch factors (StepLR / MultiStepLR /
  WarmupMultiStepLR) floored by ClipLR; the trainer applies one per epoch
  by setting the param groups' ``lr`` (``set_learning_rate``).

``TRAIN.GRAD_ACCUM_STEPS > 1`` is not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from bisect import bisect_right

import torch


def make_lr_schedule(cfg, steps_per_epoch: int):
    """``schedule(step) -> lr`` of the epoch that global ``step`` is in."""
    base_lr = cfg.OPTIMIZER.BASE_LR
    name = cfg.SCHEDULER.TYPE
    clip = cfg.SCHEDULER.CLIP_LR

    def factor(epoch: int) -> float:
        if name == "StepLR":
            p = cfg.SCHEDULER.StepLR
            if p.step_size <= 0:
                return 1.0
            return p.gamma ** (epoch // p.step_size)
        if name == "MultiStepLR":
            p = cfg.SCHEDULER.MultiStepLR
            return p.gamma ** bisect_right(sorted(p.milestones), epoch)
        if name == "WarmupMultiStepLR":
            p = cfg.SCHEDULER.WarmupMultiStepLR
            warm = 1.0
            if epoch < p.warmup_steps:
                alpha = epoch / p.warmup_steps
                warm = p.warmup_factor * (1 - alpha) + alpha
            return warm * p.gamma ** bisect_right(sorted(p.milestones), epoch)
        return 1.0

    def schedule(step):
        epoch = int(step) // max(1, steps_per_epoch)
        lr = base_lr * factor(epoch)
        if clip > 0:
            lr = max(lr, clip)
        return lr

    return schedule


def build_optimizer(cfg, params, steps_per_epoch: int = 1):
    """``(optimizer, schedule)`` for ``params`` (an iterable of tensors)."""
    if int(cfg.TRAIN.GRAD_ACCUM_STEPS) > 1:
        raise NotImplementedError(
            "TRAIN.GRAD_ACCUM_STEPS > 1 is not ported yet (ROADMAP.md, "
            "Queue 1: gradient accumulation)")
    name = cfg.OPTIMIZER.TYPE
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    wd = cfg.OPTIMIZER.WEIGHT_DECAY
    if name == "Adam":
        b1, b2 = cfg.OPTIMIZER.Adam.betas
        opt = torch.optim.Adam(params, lr=schedule(0), betas=(b1, b2),
                               eps=1e-8, weight_decay=wd)
    elif name == "SGD":
        opt = torch.optim.SGD(params, lr=schedule(0),
                              momentum=cfg.OPTIMIZER.SGD.momentum,
                              dampening=0.0, weight_decay=wd)
    else:
        raise ValueError(f"Unsupported type of optimizer: {name!r}")
    return opt, schedule


def set_learning_rate(optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
