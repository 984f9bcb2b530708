"""Carry the JAX package's variables into the port.

``load_jax_variables(module, params, batch_stats)`` takes the flax
``params`` / ``batch_stats`` trees as nested dicts of numpy arrays and fills
the module's ``state_dict``.  The port names its submodules, parameters and
buffers after the flax names and keeps the JAX layouts (x-slowest ks3 tap
order, ``[in, out]`` linear kernels), so each flax path joined with dots is
a ``state_dict`` key and every array copies across unpermuted.  A missing or
extra key, or a shape that differs, raises.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def load_jax_variables(module: torch.nn.Module, params, batch_stats=None):
    flat = _flatten(params)
    stats = _flatten(batch_stats or {})
    overlap = flat.keys() & stats.keys()
    if overlap:
        raise ValueError(f"keys in both params and batch_stats: "
                         f"{sorted(overlap)[:5]}")
    flat.update(stats)
    state = module.state_dict()
    missing = sorted(state.keys() - flat.keys())
    extra = sorted(flat.keys() - state.keys())
    if missing or extra:
        raise KeyError(f"JAX variables do not match the module: "
                       f"missing {missing[:8]} ({len(missing)}), "
                       f"extra {extra[:8]} ({len(extra)})")
    new_state = {}
    for k, t in state.items():
        a = flat[k]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{k}: JAX shape {a.shape}, port shape "
                             f"{tuple(t.shape)}")
        new_state[k] = torch.from_numpy(np.array(a, dtype=np.float32))
    module.load_state_dict(new_state)
    return module
