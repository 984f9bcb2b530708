"""Capacity rules and hierarchy construction shared by the port's steps.

The inference part of ``fusiontransformer_tpu/modules/steps.py``:
``level_caps_for_n`` sizes the voxel levels from the batch's point buffer
exactly as the JAX step does, ``hier_from_cfg`` builds the hierarchy (with
the batch's group-pooled slot maps attached when it carries them), and
``device_batch`` moves the array part of a collated batch to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from fusiontransformer_tpu_torch.ops.hierarchy import (attach_grouped_slots,
                                                       build_hierarchy)
from fusiontransformer_tpu_torch.ops.host_slots import caps_from_fractions


def level_caps_for_n(cfg, n_total: int):
    """Voxel capacities per level for a batch whose point buffer holds
    ``n_total`` rows (L0 a fraction of the buffer, L1+ chained fractions,
    all 128-multiples; the host slot maps use the same rule)."""
    return caps_from_fractions(n_total, cfg.TPU.L0_CAPACITY_FRACTION,
                               cfg.TPU.LEVEL_CAPACITY_FRACTIONS)


def hier_from_cfg(cfg, batch):
    """Hierarchy sized from the batch's point buffer, with the batch's
    group-pooled slot maps (``gslot_src_{l}`` / ``gslot_bin_{l}``) attached;
    levels without maps run the dense ks3 path."""
    caps = level_caps_for_n(cfg, batch["coords"].shape[0])
    hier = build_hierarchy(batch["coords"], batch["pt_batch"],
                           batch["pt_valid"], caps)
    return attach_grouped_slots(hier, batch)


_ARRAY_KEYS = ("coords", "feats", "seg_label", "pt_batch", "pt_valid", "img",
               "img_indices")


def device_batch(batch, device):
    """Array-only view of a collated batch on ``device`` (host lists
    stripped; group-pooled slot maps ride along)."""
    out = {}
    for k, v in batch.items():
        if k in _ARRAY_KEYS or k.startswith(("gslot_src_", "gslot_bin_")):
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
                device, non_blocking=True)
    return out
