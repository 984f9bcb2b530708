"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU by name.
With no CUDA device and no explicit ``"cpu"`` they raise: nothing falls back
to the CPU quietly.  Under ``torch.distributed.run`` (torchrun), which sets
``LOCAL_RANK`` in each process it starts, the card is the process's own,
``cuda:LOCAL_RANK``.  ``device_constant`` keeps the steps' constant index
tables on the device.
"""

from __future__ import annotations

import os

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device must exist.  A ``"cuda"``
    with no index is ``cuda:LOCAL_RANK`` where the environment names a
    local rank (torchrun), made the current device, so that the tables,
    generators and graph pools made without an index land on the
    process's own card; without a local rank it stays ``"cuda"`` (the
    current device).  ``"cpu"`` stays the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    local_rank = os.environ.get("LOCAL_RANK")
    if dev.index is None and local_rank is not None:
        dev = torch.device("cuda", int(local_rank))
        torch.cuda.set_device(dev)
    return dev


_constants = {}


def device_constant(name: str, values, device) -> torch.Tensor:
    """The constant table ``values`` (named ``name``, unique per table) as a
    tensor on ``device``, copied there once.  A step reads its tables from
    here: a copy from host memory inside the step would wait for the
    device, which a CUDA-graph capture of the step refuses, and the step's
    first (eager) run makes the copy before any capture."""
    key = (name, str(device))
    t = _constants.get(key)
    if t is None:
        # Made outside any fake mode: under ``torch.export``'s tracing the
        # table is a real constant of the program, and the cache never
        # holds a fake tensor.
        with unset_fake_temporarily():
            t = _constants[key] = torch.as_tensor(values, device=device)
    return t
