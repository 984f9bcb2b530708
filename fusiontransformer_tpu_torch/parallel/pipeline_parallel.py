"""Pipeline parallelism of the ViT stream: the GPipe schedule over a group.

Port of ``fusiontransformer_tpu/parallel/pipeline_parallel.py``.  The DeiT
blocks are cut into contiguous stages, one a rank of the pipe group; a
batch is split into microbatches that flow through the stages in the GPipe
schedule: at tick t stage s runs microbatch t - s and hands its activation
to stage s + 1.  Every rank runs the same program: bubble ticks compute on
don't-care data, and their writes are masked (``torch.where`` on a flag)
rather than skipped, so that every rank builds the same autograd graph.

JAX gets the backward by transposing ``scan`` + ``ppermute``; here the
hand-off is an ``autograd.Function`` whose forward sends to s + 1 and
receives from s - 1 and whose backward sends the cotangent to s - 1 and
receives from s + 1.  Its backward runs only where its output reaches the
loss, so each tick's stage output is written (masked) into every tap
buffer on every rank: then every rank runs the same hand-offs' backwards,
in the same (reverse tick) order, and no exchange waits for a peer that
skipped it.  The last tick's hand-off, whose result no stage reads, is not
made.

The hand-off is point to point (``dist.batch_isend_irecv``) where the
group's backend sends the tensor's device: NCCL, and gloo on the CPU.
gloo sends no CUDA tensor, so a gloo group on the card hands off through
an ``all_gather`` over the pipe group (which gloo runs on CUDA tensors):
each rank keeps its neighbour's part.  ``handoff_mode`` picks the way; a
caller may name it.

The two Megatron collectives of ``parallel/tensor_parallel.py`` sit where
JAX puts them: ``replicate_fwd_psum_bwd`` at the (replicated) embedding,
consumed by stage 0 only, so that the embedding's gradients are full sums,
the same on every rank; ``psum_fwd_identity_bwd`` broadcasts each tap's
buffer (one writer, zeros elsewhere) to every rank.  Stage parameters are
local: an optimizer runs rank-local on the stage's block tensors.

No trainer key drives this module, in JAX either (``docs/PARALLELISM.md``:
library level); ``tests/test_torch_port_pipeline_parallel.py`` holds it
against JAX's ``make_pp_forward`` and the sequential backbone.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from fusiontransformer_tpu_torch.models.vit import Block
from fusiontransformer_tpu_torch.ops.sparse_conv import cdt_matmul
from fusiontransformer_tpu_torch.parallel.tensor_parallel import (
    psum_fwd_identity_bwd, replicate_fwd_psum_bwd)


def _block_names(params):
    return sorted({k.split(".")[0] for k in params if k.startswith("block")},
                  key=lambda k: int(k[len("block"):]))


def stack_vit_blocks(params, n_stages: int):
    """A ViT's ``{name: tensor}`` (``state_dict``, named parameters) ->
    ``(staged, rest)``: ``staged`` maps each block-relative name
    (``attn.qkv.kernel``, ...) to the blocks' tensors stacked
    ``[n_stages, blocks_per_stage, ...]`` (stage s is ``staged[k][s]``);
    ``rest`` (patch embedding, tokens, position embedding) stays whole."""
    names = _block_names(params)
    depth = len(names)
    if depth % n_stages:
        raise ValueError(f"{depth} blocks do not divide into {n_stages} "
                         f"stages")
    leaves = [k[len(names[0]) + 1:] for k in params
              if k.startswith(names[0] + ".")]
    staged = {}
    for leaf in leaves:
        x = torch.stack([params[f"{b}.{leaf}"] for b in names])
        staged[leaf] = x.reshape(n_stages, depth // n_stages, *x.shape[1:])
    rest = {k: v for k, v in params.items() if not k.startswith("block")}
    return staged, rest


def unstack_vit_blocks(staged, rest):
    """Inverse of ``stack_vit_blocks``."""
    first = next(iter(staged.values()))
    n_stages, per_stage = first.shape[:2]
    params = dict(rest)
    for s in range(n_stages):
        for j in range(per_stage):
            for leaf, x in staged.items():
                params[f"block{s * per_stage + j}.{leaf}"] = x[s, j]
    return params


def _embed(vit, rest, images):
    """Patch embedding, prefix tokens and position embedding of ``vit``
    (a ``models/vit.py::VisionTransformer2D``) with the parameters of
    ``rest``: its forward up to the first block."""
    b = images.shape[0]
    p = vit.patch_size
    g = vit.img_size // p
    x = images.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = cdt_matmul(x.reshape(b, g * g, p * p * 3), rest["patch_embed.kernel"],
                   vit.compute_dtype) + rest["patch_embed.bias"]
    return torch.cat([rest["cls_token"].expand(b, -1, -1),
                      rest["dist_token"].expand(b, -1, -1), x],
                     dim=1) + rest["pos_embed"]


def handoff_mode(group, device) -> str:
    """``"p2p"`` where the group's backend sends tensors on ``device``
    (NCCL; gloo on the CPU), else ``"gather"`` (gloo on the card)."""
    backend = dist.get_backend(group)
    return "p2p" if backend == "nccl" or torch.device(device).type == "cpu" \
        else "gather"


def _exchange(x, group, step: int, mode: str):
    """Send ``x`` to rank s + step of ``group`` and return what rank s -
    step sent (zeros where that rank does not exist)."""
    n, s = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    dst, src = s + step, s - step
    if mode == "gather":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return parts[src] if 0 <= src < n else torch.zeros_like(x)
    out = torch.zeros_like(x)
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst)
                              if group is not None else dst, group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src)
                              if group is not None else src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Handoff(torch.autograd.Function):
    """Forward: to s + 1, from s - 1.  Backward: the cotangent to s - 1,
    from s + 1."""

    @staticmethod
    def forward(ctx, y, group, mode):
        ctx.group, ctx.mode = group, mode
        return _exchange(y, group, 1, mode)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, -1, ctx.mode), None, None


def pp_vit_apply(vit, staged_local, rest, images, group, n_micro: int,
                 tap_blocks: Sequence[int], mode=None
                 ) -> Dict[str, torch.Tensor]:
    """GPipe forward of ``vit``'s blocks over the pipe ``group`` (None: the
    default group), called by every rank of it.

    ``staged_local``: this rank's stage, ``{leaf: [L, ...]}`` (stage s of
    ``stack_vit_blocks``); ``rest``: the embedding's parameters;
    ``images``: ``[B, H, W, 3]``, the same on every rank, ``B % n_micro ==
    0``.  Returns ``{str(k): tokens}`` for each tap block and the last
    block, prefix tokens stripped, on every rank: the sequential
    backbone's outputs.  ``mode``: the hand-off's way (``handoff_mode``
    by default)."""
    n_stages = dist.get_world_size(group)
    s = dist.get_rank(group)
    depth = vit.depth
    if depth % n_stages:
        raise ValueError(f"{depth} blocks do not divide into {n_stages} "
                         f"stages")
    per_stage = depth // n_stages
    b = images.shape[0]
    if b % n_micro:
        raise ValueError(f"a batch of {b} does not divide into {n_micro} "
                         f"microbatches")
    mb = b // n_micro
    mode = mode or handoff_mode(group, images.device)
    taps = tuple(sorted({int(k) for k in tap_blocks} | {depth - 1}))

    with torch.device("meta"):
        block = Block(vit.embed_dim, vit.num_heads, vit.compute_dtype)
    local = [{k: v[j] for k, v in staged_local.items()}
             for j in range(per_stage)]

    def apply(params, x):
        return functional_call(block, params, (x,))

    def run_stage(x):
        ys = []
        for params in local:
            x = (checkpoint(apply, params, x, use_reentrant=False,
                            preserve_rng_state=False)
                 if vit.remat and vit.training else apply(params, x))
            ys.append(x)
        return ys

    x_embed = _embed(vit, rest, images)
    n_tok, d = x_embed.shape[1:]
    # Megatron f: stage 0 alone consumes the embedding; the backward's
    # all-reduce gives every rank the full embedding gradients.
    x_embed = replicate_fwd_psum_bwd(x_embed, group).reshape(
        n_micro, mb, n_tok, d)
    dev = images.device
    first = torch.tensor(s == 0, device=dev)
    zeros = torch.zeros(mb, n_tok, d, dtype=x_embed.dtype, device=dev)
    bufs = {k: [zeros] * n_micro for k in taps}
    recv = zeros
    n_ticks = n_stages + n_micro - 1
    for t in range(n_ticks):
        m = t - s                               # this rank's microbatch
        active = 0 <= m < n_micro
        mc = min(max(m, 0), n_micro - 1)
        ys = run_stage(torch.where(first, x_embed[mc], recv))
        for k in taps:
            owner = k // per_stage == s
            # Every tick's output enters every buffer's graph (masked), so
            # that each rank runs every hand-off's backward.
            src = ys[k - s * per_stage] if owner else ys[-1]
            keep = torch.tensor(owner and active, device=dev)
            bufs[k][mc] = torch.where(keep, src, bufs[k][mc])
        if t < n_ticks - 1:
            recv = _Handoff.apply(ys[-1], group, mode)

    # Megatron g: one writer a buffer, zeros elsewhere; the all-reduce
    # broadcasts it, the backward hands the cotangent through.
    out = {}
    for k in taps:
        full = psum_fwd_identity_bwd(torch.stack(bufs[k]), group)
        out[str(k)] = full.reshape(b, n_tok, d)[:, vit.n_prefix:, :]
    return out
