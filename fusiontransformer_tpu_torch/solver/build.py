"""Optimizer and learning-rate schedule (torch).

Port of ``fusiontransformer_tpu/solver/build.py``:

* Adam with torch's coupled L2 (the decay is added to the gradient before
  the moment updates) is ``torch.optim.Adam(weight_decay=wd, eps=1e-8)``:
  the same update as the JAX package's ``add_decayed_weights(wd)`` +
  ``scale_by_adam(eps=1e-8)`` + ``scale_by_learning_rate``;
* SGD: momentum with dampening 0 (``optax.trace``), coupled L2 likewise;
* schedules are per-epoch factors (StepLR / MultiStepLR /
  WarmupMultiStepLR) floored by ClipLR; the trainer applies one per epoch
  with ``set_learning_rate``.

The learning rate is a one-element tensor on the parameters' device,
shared by every param group and filled in place by ``set_learning_rate``:
a train step captured in a CUDA graph reads it at every replay, as the JAX
package's optimizer reads its injected hyperparameter, so a new rate never
needs a new capture.  On the card Adam is ``capturable`` (its step count
lives on the device too).  ``load_optimizer_state`` keeps that tensor
across a state-dict load.

``TRAIN.GRAD_ACCUM_STEPS`` = k > 1 (``optax.MultiSteps`` in the JAX
package) is applied by the train step (``modules/steps.py::TrainStep``): the
micro-batches' gradients add up in the parameters' ``.grad``, and every
k-th micro-step divides them by k and runs the optimizer once.
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
    """``(optimizer, schedule)`` for ``params`` (an iterable of tensors on
    one device)."""
    if int(cfg.TRAIN.GRAD_ACCUM_STEPS) < 1:
        raise ValueError(f"TRAIN.GRAD_ACCUM_STEPS must be >= 1, got "
                         f"{cfg.TRAIN.GRAD_ACCUM_STEPS}")
    params = list(params)
    name = cfg.OPTIMIZER.TYPE
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    wd = cfg.OPTIMIZER.WEIGHT_DECAY
    device = params[0].device
    lr = torch.tensor(schedule(0), dtype=torch.float32, device=device)
    on_card = device.type == "cuda"
    if name == "Adam":
        b1, b2 = cfg.OPTIMIZER.Adam.betas
        opt = torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8,
                               weight_decay=wd, capturable=on_card)
    elif name == "SGD":
        if on_card:
            raise NotImplementedError(
                "SGD on the card is not ported: torch's SGD reads a tensor "
                "learning rate back to the host, which the train step's CUDA "
                "graph refuses (ROADMAP.md, Queue 1)")
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=cfg.OPTIMIZER.SGD.momentum,
                              dampening=0.0, weight_decay=wd)
    else:
        raise ValueError(f"Unsupported type of optimizer: {name!r}")
    return opt, schedule


def set_learning_rate(optimizer, lr: float):
    """Fill the optimizer's learning-rate tensor in place (stream-ordered on
    the card: the next step, eager or replayed, reads the new rate)."""
    optimizer.param_groups[0]["lr"].fill_(lr)


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def load_optimizer_state(optimizer, state):
    """``optimizer.load_state_dict(state)``, keeping the optimizer's own
    learning-rate tensor (the load would put the saved one in its place)
    with the saved rate in it.  The moments and step counts are new tensors
    after a load: a CUDA graph captured before it would keep updating the
    old ones, so the trainer loads before its first capture."""
    lr = optimizer.param_groups[0]["lr"]
    optimizer.load_state_dict(state)
    lr.fill_(float(optimizer.param_groups[0]["lr"]))
    for group in optimizer.param_groups:
        group["lr"] = lr
