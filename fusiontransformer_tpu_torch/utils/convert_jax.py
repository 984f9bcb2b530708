"""Carry the JAX package's variables into the port.

``load_jax_variables(module, params, batch_stats)`` takes the flax
``params`` / ``batch_stats`` trees as nested dicts of numpy arrays and fills
the module's ``state_dict``.  The port names its submodules, parameters and
buffers after the flax names and keeps the JAX layouts (x-slowest ks3 tap
order, ``[in, out]`` linear kernels), so each flax path joined with dots is
a ``state_dict`` key and every array copies across unpermuted: the STN's
flax convs keep their ``[kh, kw, Cin, Cout]`` kernels as the parameter
(``models/image_models_stn.py::FlaxConv`` permutes in ``forward``) and its
raw ``fc2_kernel`` / ``fc2_bias`` params are parameters of those names.  A
missing or extra key, or a shape that differs, raises.

With ``tp`` > 1 the module is one rank's tensor-parallel model
(``parallel/tensor_parallel.py``): each ViT-block leaf the split rules
address is cut to rank ``tp_rank``'s shard of JAX's canonical (tp=1)
array before the copy, so the rank loads its part of the same weights.

``jax_leaf_paths(module)`` is the map the other way: each parameter and
buffer name of the port to its collection (``params`` / ``batch_stats``) and
its flax leaf path, so gradients and updated values can be compared leaf by
leaf.
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


def load_jax_variables(module: torch.nn.Module, params, batch_stats=None,
                       tp: int = 1, tp_rank: int = 0, num_heads=None):
    flat = _flatten(params)
    stats = _flatten(batch_stats or {})
    overlap = flat.keys() & stats.keys()
    if overlap:
        raise ValueError(f"keys in both params and batch_stats: "
                         f"{sorted(overlap)[:5]}")
    flat.update(stats)
    if tp > 1:
        from fusiontransformer_tpu_torch.parallel.tensor_parallel import (
            shard_state)
        flat = {k: np.asarray(v) for k, v in shard_state(
            {k: torch.from_numpy(np.array(v)) for k, v in flat.items()},
            tp, tp_rank, num_heads).items()}
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


def jax_leaf_path(name: str) -> tuple:
    """The flax leaf path of a port parameter or buffer name
    (``"a.b.kernel"`` -> ``("a", "b", "kernel")``)."""
    return tuple(name.split("."))


def jax_leaf_paths(module: torch.nn.Module) -> dict:
    """``{port name: (collection, flax leaf path)}`` for every parameter
    (``params``) and buffer (``batch_stats``) of ``module``."""
    out = {n: ("params", jax_leaf_path(n))
           for n, _ in module.named_parameters()}
    out.update({n: ("batch_stats", jax_leaf_path(n))
                for n, _ in module.named_buffers()})
    return out
