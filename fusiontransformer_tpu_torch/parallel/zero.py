"""ZeRO-1: the optimizer's moments kept 1/n per data rank.

Port of ``fusiontransformer_tpu/parallel/zero.py``.  Each of the n ranks of
the data group stores ``1/n`` of every optimizer state tensor (Adam's
``exp_avg`` / ``exp_avg_sq``, SGD's ``momentum_buffer``); the scalars
(Adam's ``step``) and the learning-rate tensor stay replicated, so
``solver/build.py::set_learning_rate`` reaches the optimizer as before.

Chunking is per leaf, as JAX's is: a tensor is flattened and zero-padded to
n * c elements, c = ceil(size / n), and row r of the [n, c] layout is rank
r's (``chunk``, ``split_opt_state`` / ``merge_opt_state``).  ``Zero1`` runs
the port's own optimizer on this rank's chunks.  Each update:

1. the gradients are averaged over the data group beforehand (the train
   step's ``Reducer.mean_``, outside the CUDA graph);
2. this rank's chunk of each gradient and parameter is sliced: a view of
   the parameter and of its static ``.grad`` where the chunk lies inside
   the tensor, a zero-padded copy where it runs past the end;
3. the inner optimizer steps on the chunks;
4. one coalesced ``all_gather`` over the data group brings every rank's
   new chunks back into the full parameters.

JAX gathers the chunk updates and adds them to the parameters; this gathers
the parameters themselves.  The inner optimizer's math is elementwise, so
each chunk's new values are bit for bit those of the replicated optimizer
on the whole tensor, and so is every gathered parameter
(``tests/test_torch_port_zero.py`` holds a ZeRO trainer bitwise against the
replicated one).  Adding gathered updates would round once more.

``state_dict`` gives the canonical layout, ``torch.optim``'s own over the
full parameters (a collective: every rank of the group calls it);
``load_state_dict`` takes that layout and keeps this rank's chunks, so a
checkpoint loads across ZeRO degrees and into a replicated run.

Memory: the state drops from 2x the parameters to 2x / n a rank; the
update adds a parameters-sized gather buffer while it runs (the gradient
all-reduce is unchanged: fusing it into a reduce-scatter is ZeRO-2, not
done here).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fusiontransformer_tpu_torch.parallel.tensor_parallel import gather_shards


def chunk_size(size: int, n: int) -> int:
    return -(-size // n)


def chunk(x, n: int, r: int):
    """Row ``r`` of ``x`` flattened and zero-padded to ``[n, c]``."""
    flat = x.reshape(-1)
    c = chunk_size(flat.numel(), n)
    part = flat[r * c:(r + 1) * c]
    if part.numel() == c:
        return part.clone()
    out = torch.zeros(c, dtype=x.dtype, device=x.device)
    out[:part.numel()] = part
    return out


def unchunk(rows, shape):
    """The tensor of ``shape`` from its ``[n, c]`` rows (a tensor or a list
    of the n rows), the padding dropped."""
    flat = rows.reshape(-1) if torch.is_tensor(rows) else torch.cat(
        [r.reshape(-1) for r in rows])
    size = 1
    for s in shape:
        size *= s
    return flat[:size].reshape(shape)


def is_sharded(value) -> bool:
    """A state entry kept 1/n a rank: a tensor of rank >= 1 (JAX's
    ``shard_flags``); scalars (Adam's step) stay replicated."""
    return torch.is_tensor(value) and value.dim() >= 1


def split_opt_state(canonical, n: int, r: int):
    """A canonical ``torch.optim`` ``state_dict`` -> rank ``r``'s: every
    sharded entry cut to its chunk, the rest as it is."""
    state = {i: {k: chunk(v, n, r) if is_sharded(v) else v
                 for k, v in s.items()}
             for i, s in canonical["state"].items()}
    return {"state": state, "param_groups": canonical["param_groups"]}


def merge_opt_state(per_rank, shapes):
    """The canonical ``state_dict`` from every rank's (a list in rank
    order); ``shapes`` maps a state index to its parameter's shape."""
    first = per_rank[0]
    state = {}
    for i, s in first["state"].items():
        state[i] = {k: unchunk([p["state"][i][k] for p in per_rank],
                               shapes[i]) if is_sharded(v) else v
                    for k, v in s.items()}
    return {"state": state, "param_groups": first["param_groups"]}


class _Chunk:
    """Rank r's chunk of one parameter: ``param`` (the tensor the inner
    optimizer updates) and its ``.grad``, views of the parameter and its
    static gradient where the chunk lies inside the tensor, else a padded
    buffer that ``load`` fills."""

    def __init__(self, p, n, r):
        self.p = p
        self.numel = p.numel()
        self.c = chunk_size(self.numel, n)
        self.lo = r * self.c
        self.hi = min(self.lo + self.c, self.numel)
        self.view = self.hi - self.lo == self.c
        if self.view:
            self.param = p.detach().view(-1)[self.lo:self.hi]
        else:
            self.param = torch.zeros(self.c, dtype=p.dtype, device=p.device)
            self.param.grad = torch.zeros_like(self.param)

    def load(self):
        """Bring the parameter and its gradient into the chunk."""
        if self.view:
            self.param.grad = self.p.grad.view(-1)[self.lo:self.hi]
            return
        k = max(0, self.hi - self.lo)
        with torch.no_grad():
            self.param[:k].copy_(self.p.detach().view(-1)[self.lo:self.hi])
            self.param.grad[:k].copy_(self.p.grad.view(-1)[self.lo:self.hi])


class Zero1:
    """``build(chunks)`` (the port's optimizer over a list of tensors) run
    on this rank's chunks of ``params``, the chunks gathered back into the
    parameters over ``group`` (None: the default group) after each step.

    Stands in for the optimizer: ``param_groups`` (the shared
    learning-rate tensor), ``state``, ``step``, ``state_dict`` and
    ``load_state_dict`` in the canonical layout."""

    def __init__(self, build, params, group=None):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.params = list(params)
        self.chunks = [_Chunk(p, self.n, self.rank) for p in self.params]
        self.inner = build([c.param for c in self.chunks])

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    @torch.no_grad()
    def step(self):
        for c in self.chunks:
            c.load()
        self.inner.step()
        self.gather()

    @torch.no_grad()
    def gather(self):
        """Every rank's chunks into the full parameters: one
        ``all_gather`` a dtype over the group."""
        by_dtype = {}
        for c in self.chunks:
            by_dtype.setdefault(c.param.dtype, []).append(c)
        for group in by_dtype.values():
            flat = torch.cat([c.param.reshape(-1) for c in group])
            parts = [torch.empty_like(flat) for _ in range(self.n)]
            dist.all_gather(parts, flat, group=self.group)
            at = 0
            for c in group:
                dst = c.p.detach().view(-1)
                for q, part in enumerate(parts):
                    lo, hi = q * c.c, min((q + 1) * c.c, c.numel)
                    if hi > lo:
                        dst[lo:hi].copy_(part[at:at + hi - lo])
                at += c.c

    def state_dict(self):
        """The canonical layout: ``torch.optim``'s ``state_dict`` over the
        full parameters (every sharded entry gathered over the group)."""
        mine = self.inner.state_dict()
        keys = [(i, k) for i, s in sorted(mine["state"].items())
                for k, v in sorted(s.items()) if is_sharded(v)]
        gathered = gather_shards([mine["state"][i][k] for i, k in keys],
                                 self.group)
        state = {i: dict(s) for i, s in mine["state"].items()}
        for (i, k), rows in zip(keys, gathered):
            state[i][k] = unchunk(rows, self.params[i].shape)
        return {"state": state, "param_groups": mine["param_groups"]}

    def load_state_dict(self, canonical):
        self.inner.load_state_dict(split_opt_state(canonical, self.n,
                                                   self.rank))
