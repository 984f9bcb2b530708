"""Tensor parallelism of the ViT stream (Megatron head / hidden sharding).

Port of ``fusiontransformer_tpu/parallel/tensor_parallel.py``.  The JAX
package shards the DeiT attention heads and MLP hidden width over a
``model`` mesh axis under ``shard_map``; here each process of a model group
holds its own shard of every ViT block and the collectives are
``torch.distributed`` all-reduces over that group (NCCL on the card, gloo on
the CPU).

Layout per transformer block (embed d, heads h, tp ranks):

* ``attn.qkv``  column-parallel: each rank holds h/tp heads' q, k, v
  columns; its input is replicated, so no collective;
* ``attn.proj`` row-parallel: each rank contracts its heads' slice, one
  all-reduce rebuilds the output, the bias added once after it;
* ``mlp.fc1``   column-parallel over the 4d hidden width;
* ``mlp.fc2``   row-parallel, all-reduce, bias.

The Megatron pair (``replicate_fwd_psum_bwd``, ``psum_fwd_identity_bwd``)
are ``torch.autograd.Function``\\ s with an explicit process group: the f at
each column-parallel input sums the ranks' partial cotangents in the
backward, so every replicated parameter's gradient (patch embedding, layer
norms, the 3D stream) is the full one and bit for bit the same on every
model rank, while a sharded parameter's gradient is its own.  The
optimizer then runs rank-local with no collective of its own.

Parameters keep the flax names and ``[in, out]`` layouts
(``utils/convert_jax.py``), so ``tp_rule_for_path`` addresses the same
leaves as JAX's.  ``shard_leaf`` / ``shard_state`` give this rank's shard
(JAX's ``split_params_for_tp`` stacks every rank's); ``merge_state``
gathers the shards over the model group (a collective: every rank of the
group calls it) and rebuilds the canonical tp=1 tensors, which checkpoints
and evaluation use.

``Mesh2D`` is the 2-D layout of ``make_mesh_2d``: rank = d * model + m, a
model group of consecutive ranks (the Megatron placement: within a host),
a data group of the ranks with the same m; every rank makes every group in
the same order, as ``dist.new_group`` requires.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.profiler import record_function


def _psum(x, group):
    """The sum of ``x`` over ``group``, a new tensor (in a
    ``tensor_parallel.psum`` range, which a profile reads)."""
    with record_function("tensor_parallel.psum"):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
    return out


class _ReplicateFwdPsumBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dout):
        return _psum(dout, ctx.group), None


class _PsumFwdIdentityBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _psum(x, group)

    @staticmethod
    def backward(ctx, dout):
        return dout, None


def replicate_fwd_psum_bwd(x, group):
    """Megatron ``f``: the identity forward, an all-reduce of the
    cotangent over ``group`` backward.  At the input of every
    column-parallel region whose input is replicated over the group."""
    return _ReplicateFwdPsumBwd.apply(x, group)


def psum_fwd_identity_bwd(x, group):
    """Megatron ``g``: an all-reduce over ``group`` forward, the identity
    backward.  At the output of every row-parallel matmul."""
    return _PsumFwdIdentityBwd.apply(x, group)


def tp_input(x, tp: int, group):
    """``f`` at a column-parallel region's replicated input (identity at
    tp = 1)."""
    return x if tp <= 1 else replicate_fwd_psum_bwd(x, group)


def tp_rule_for_path(path) -> str | None:
    """The split rule of a parameter path (a tuple of names, or a dotted
    name), or None for a replicated leaf: ``qkv_kernel``, ``qkv_bias``,
    ``row_kernel`` (proj / fc2 kernels), ``col_kernel`` (fc1), ``col_bias``
    (fc1).  The proj / fc2 biases are replicated (added after the
    all-reduce).  Optimizer moments have their parameter's path."""
    segs = path.split(".") if isinstance(path, str) else [str(s)
                                                           for s in path]
    for i, s in enumerate(segs):
        if not s.startswith("block"):
            continue
        rest = segs[i + 1:]
        if rest[:2] == ["attn", "qkv"]:
            return "qkv_kernel" if rest[-1] == "kernel" else "qkv_bias"
        if rest[:2] == ["attn", "proj"]:
            return "row_kernel" if rest[-1] == "kernel" else None
        if rest[:2] == ["mlp", "fc1"]:
            return "col_kernel" if rest[-1] == "kernel" else "col_bias"
        if rest[:2] == ["mlp", "fc2"]:
            return "row_kernel" if rest[-1] == "kernel" else None
    return None


def shard_leaf(rule: str, x, tp: int, rank: int, num_heads: int):
    """Rank ``rank``'s shard of a full (tp=1) leaf, contiguous."""
    if rule == "qkv_kernel":
        d = x.shape[0]
        hd, hl = d // num_heads, num_heads // tp
        # Columns ordered (3, h, hd): each rank takes its heads' slice.
        k = x.reshape(d, 3, num_heads, hd)
        return k[:, :, rank * hl:(rank + 1) * hl, :].reshape(
            d, 3 * hl * hd).contiguous()
    if rule == "qkv_bias":
        d = x.shape[0] // 3
        hd, hl = d // num_heads, num_heads // tp
        b = x.reshape(3, num_heads, hd)
        return b[:, rank * hl:(rank + 1) * hl, :].reshape(
            3 * hl * hd).contiguous()
    if rule == "row_kernel":
        # Rows ordered (h, hd) for proj, plain for fc2: a contiguous split
        # once the qkv columns are head-sliced the same way.
        n = x.shape[0] // tp
        return x[rank * n:(rank + 1) * n].contiguous()
    if rule == "col_kernel":
        n = x.shape[1] // tp
        return x[:, rank * n:(rank + 1) * n].contiguous()
    if rule == "col_bias":
        n = x.shape[0] // tp
        return x[rank * n:(rank + 1) * n].contiguous()
    raise ValueError(rule)


def merge_leaf(rule: str, shards, num_heads: int):
    """Inverse of ``shard_leaf``: the full leaf from every rank's shard, in
    rank order."""
    tp = len(shards)
    if rule == "qkv_kernel":
        d = shards[0].shape[0]
        hd, hl = d // num_heads, num_heads // tp
        return torch.cat([s.reshape(d, 3, hl, hd) for s in shards],
                         dim=2).reshape(d, 3 * num_heads * hd)
    if rule == "qkv_bias":
        hl = num_heads // tp
        hd = shards[0].shape[0] // 3 // hl
        return torch.cat([s.reshape(3, hl, hd) for s in shards],
                         dim=1).reshape(3 * num_heads * hd)
    if rule in ("row_kernel", "col_bias"):
        return torch.cat(list(shards), dim=0)
    if rule == "col_kernel":
        return torch.cat(list(shards), dim=1)
    raise ValueError(rule)


def shard_state(state, tp: int, rank: int, num_heads: int):
    """A ``{name: tensor}`` state (a ``state_dict``, gradients) with every
    ViT-block leaf cut to rank ``rank``'s shard; the rest as it is."""
    out = {}
    for name, x in state.items():
        rule = tp_rule_for_path(name)
        out[name] = x if rule is None else shard_leaf(rule, x, tp, rank,
                                                      num_heads)
    return out


def gather_shards(tensors, group):
    """Every rank's version of ``tensors`` (same shapes on every rank of
    ``group``), one coalesced ``all_gather`` a dtype: a list, per tensor,
    of the ranks' tensors in rank order.  A collective: every rank of the
    group calls it with the same shapes."""
    tensors = list(tensors)
    n = dist.get_world_size(group)
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(parts, flat, group=group)
        sizes = [tensors[i].numel() for i in idx]
        split = [p.split(sizes) for p in parts]
        for j, i in enumerate(idx):
            out[i] = [s[j].view(tensors[i].shape) for s in split]
    return out


def merge_state(state, group, num_heads: int):
    """The canonical tp=1 ``{name: tensor}`` of a model-parallel state:
    every sharded leaf gathered over ``group`` and merged, the rest as it
    is.  A collective over the model group."""
    names = [n for n in state if tp_rule_for_path(n) is not None]
    gathered = gather_shards([state[n] for n in names], group)
    out = dict(state)
    for n, shards in zip(names, gathered):
        out[n] = merge_leaf(tp_rule_for_path(n), shards, num_heads)
    return out


def _sharded_entries(opt_state, names):
    """``(index, key, rule)`` of every optimizer state tensor that has its
    parameter's shape and a split rule (``names``: the parameter names in
    the optimizer's index order)."""
    out = []
    for i, s in sorted(opt_state["state"].items()):
        rule = tp_rule_for_path(names[i])
        for k, v in sorted(s.items()):
            if rule is not None and torch.is_tensor(v) and v.dim() >= 1:
                out.append((i, k, rule))
    return out


def shard_opt_state(opt_state, names, tp: int, rank: int, num_heads: int):
    """A canonical ``torch.optim`` ``state_dict`` -> rank ``rank``'s: each
    moment of a sharded parameter cut as the parameter is."""
    state = {i: dict(s) for i, s in opt_state["state"].items()}
    for i, k, rule in _sharded_entries(opt_state, names):
        state[i][k] = shard_leaf(rule, state[i][k], tp, rank, num_heads)
    return {"state": state, "param_groups": opt_state["param_groups"]}


def merge_opt_state(opt_state, names, group, num_heads: int):
    """The canonical ``state_dict`` of a model-parallel optimizer: each
    sharded moment gathered over ``group`` and merged.  A collective."""
    entries = _sharded_entries(opt_state, names)
    gathered = gather_shards([opt_state["state"][i][k]
                              for i, k, _ in entries], group)
    state = {i: dict(s) for i, s in opt_state["state"].items()}
    for (i, k, rule), shards in zip(entries, gathered):
        state[i][k] = merge_leaf(rule, shards, num_heads)
    return {"state": state, "param_groups": opt_state["param_groups"]}


class Mesh2D:
    """The (data, model) layout of ``world`` ranks with ``model`` ranks a
    model group: rank = d * model + m.  ``data_index`` / ``model_index``
    are this rank's d and m; ``model_group`` holds the ranks d * model ..
    d * model + model - 1, ``data_group`` the ranks with this rank's m.
    Every rank makes every group, model groups first, in rank order."""

    def __init__(self, model: int, world=None, rank=None):
        world = dist.get_world_size() if world is None else world
        rank = dist.get_rank() if rank is None else rank
        if model < 1 or world % model:
            raise ValueError(f"{world} ranks do not divide into model groups "
                             f"of {model}")
        self.model, self.data = model, world // model
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model)
        self.model_ranks = [self.data_index * model + m for m in range(model)]
        self.data_ranks = [d * model + self.model_index
                           for d in range(self.data)]
        self.model_group = self.data_group = None
        for d in range(self.data):
            ranks = [d * model + m for m in range(model)]
            g = dist.new_group(ranks)
            if d == self.data_index:
                self.model_group = g
        for m in range(model):
            ranks = [d * model + m for d in range(self.data)]
            g = dist.new_group(ranks)
            if m == self.model_index:
                self.data_group = g
