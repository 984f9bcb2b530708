"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU by name.
With no CUDA device and no explicit ``"cpu"`` they raise: nothing falls back
to the CPU quietly.  ``device_constant`` keeps the steps' constant index
tables on the device.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
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
        t = _constants[key] = torch.as_tensor(values, device=device)
    return t
