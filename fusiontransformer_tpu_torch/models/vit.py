"""Vision transformer (DeiT-Base distilled @384) with per-block feature taps.

Port of ``fusiontransformer_tpu/models/vit.py``: patch embedding as one
GEMM over HWC-flattened patches, cls + distillation tokens, pre-norm blocks
(LayerNorm eps 1e-6, exact GELU), attention scores and values in the
compute dtype with an f32 softmax.  ``forward`` returns every block's
output with the prefix tokens stripped, keyed by block index.  With
``remat`` (``TPU.REMAT_VIT``) each block of a module in train mode runs
under ``torch.utils.checkpoint.checkpoint``, as JAX's ``nn.remat(Block)``:
its activations are recomputed in the backward instead of kept, with the
same values (the ViT draws no random numbers, so no generator state is
kept); under tensor parallelism the recomputed forward runs its
all-reduces again, as JAX's does.

``tp`` > 1 with ``tp_group`` builds the blocks tensor-parallel
(``parallel/tensor_parallel.py``): each rank holds ``num_heads / tp``
heads of ``attn.qkv`` / ``attn.proj`` and ``hidden / tp`` of
``mlp.fc1`` / ``mlp.fc2``, with the Megatron f at each column-parallel
input and the all-reduce in each row-parallel layer.  Everything outside
the blocks is replicated.  At tp = 1 the modules are the single-device
ones.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint
from torch import nn

from fusiontransformer_tpu_torch.models.layers import (LayerNorm, TorchLinear,
                                                       trunc_normal_)
from fusiontransformer_tpu_torch.ops.sparse_conv import cdt_matmul
from fusiontransformer_tpu_torch.parallel.tensor_parallel import tp_input


def _check_tp(n, tp, what):
    if n % tp:
        raise ValueError(f"{what} = {n} does not divide over {tp} "
                         f"tensor-parallel ranks")


class Mlp(nn.Module):
    def __init__(self, dim, hidden, compute_dtype=torch.bfloat16, tp=1,
                 tp_group=None):
        super().__init__()
        _check_tp(hidden, tp, "the MLP's hidden width")
        self.tp, self.tp_group = tp, tp_group
        self.fc1 = TorchLinear(dim, hidden // tp, compute_dtype=compute_dtype)
        self.fc2 = TorchLinear(hidden // tp, dim, compute_dtype=compute_dtype,
                               reduce_group=tp_group if tp > 1 else None)

    def forward(self, x):
        x = tp_input(x, self.tp, self.tp_group)
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Attention(nn.Module):
    def __init__(self, dim, num_heads, compute_dtype=torch.bfloat16, tp=1,
                 tp_group=None):
        super().__init__()
        _check_tp(num_heads, tp, "the heads")
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.tp, self.tp_group = tp, tp_group
        width = dim // num_heads * (num_heads // tp)    # this rank's heads
        self.qkv = TorchLinear(dim, 3 * width, compute_dtype=compute_dtype)
        self.proj = TorchLinear(width, dim, compute_dtype=compute_dtype,
                                reduce_group=tp_group if tp > 1 else None)

    def forward(self, x):
        b, n, d = x.shape
        h = self.num_heads // self.tp                   # heads on this rank
        hd = d // self.num_heads
        x = tp_input(x, self.tp, self.tp_group)
        qkv = self.qkv(x).reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                  # [b, h, n, hd]
        cdt = self.compute_dtype
        attn = cdt_matmul(q, k.transpose(-1, -2), cdt) * hd ** -0.5
        attn = torch.softmax(attn, dim=-1)
        out = cdt_matmul(attn, v, cdt)
        return self.proj(out.transpose(1, 2).reshape(b, n, h * hd))


class Block(nn.Module):
    def __init__(self, dim, num_heads, compute_dtype=torch.bfloat16, tp=1,
                 tp_group=None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, compute_dtype, tp, tp_group)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim, compute_dtype, tp, tp_group)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer2D(nn.Module):
    """DeiT backbone exposing per-block outputs (the cls and distillation
    prefix tokens stripped)."""

    n_prefix = 2

    def __init__(self, img_size=384, patch_size=16, embed_dim=768, depth=12,
                 num_heads=12, compute_dtype=torch.bfloat16, remat=False,
                 tp=1, tp_group=None):
        super().__init__()
        self.remat = remat
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.compute_dtype = compute_dtype
        self.img_size = img_size
        self.patch_size = patch_size
        self.depth = depth
        n_patches = (img_size // patch_size) ** 2
        self.patch_embed = TorchLinear(patch_size * patch_size * 3, embed_dim,
                                       compute_dtype=compute_dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.n_prefix + n_patches, embed_dim))
        for i in range(depth):
            self.add_module(f"block{i}", Block(embed_dim, num_heads,
                                               compute_dtype, tp, tp_group))

    def reset_parameters_(self, gen):
        for p in (self.cls_token, self.dist_token, self.pos_embed):
            trunc_normal_(p, 0.02, gen)

    def forward(self, images) -> Dict[str, torch.Tensor]:
        # images: [B, H, W, 3] float32 NHWC, H == W == img_size.
        b = images.shape[0]
        p = self.patch_size
        g = self.img_size // p
        x = images.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embed(x.reshape(b, g * g, p * p * 3))
        x = torch.cat([self.cls_token.expand(b, -1, -1),
                       self.dist_token.expand(b, -1, -1), x],
                      dim=1) + self.pos_embed
        outputs = {}
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if self.remat and self.training:
                x = checkpoint(block, x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x)
            outputs[str(i)] = x[:, self.n_prefix:, :]
        return outputs
