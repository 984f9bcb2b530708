"""Vision transformer (DeiT-Base distilled @384) with per-block feature taps.

Port of ``fusiontransformer_tpu/models/vit.py`` at one rank (no tensor
parallelism): patch embedding as one GEMM over HWC-flattened
patches, cls + distillation tokens, pre-norm blocks (LayerNorm eps 1e-6,
exact GELU), attention scores and values in the compute dtype with an f32
softmax.  ``forward`` returns every block's output with the prefix tokens
stripped, keyed by block index.  With ``remat`` (``TPU.REMAT_VIT``) each
block of a module in train mode runs under
``torch.utils.checkpoint.checkpoint``, as JAX's ``nn.remat(Block)``: its
activations are recomputed in the backward instead of kept, with the same
values (the ViT draws no random numbers, so no generator state is kept).
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


class Mlp(nn.Module):
    def __init__(self, dim, hidden, compute_dtype=torch.bfloat16):
        super().__init__()
        self.fc1 = TorchLinear(dim, hidden, compute_dtype=compute_dtype)
        self.fc2 = TorchLinear(hidden, dim, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Attention(nn.Module):
    def __init__(self, dim, num_heads, compute_dtype=torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.qkv = TorchLinear(dim, 3 * dim, compute_dtype=compute_dtype)
        self.proj = TorchLinear(dim, dim, compute_dtype=compute_dtype)

    def forward(self, x):
        b, n, d = x.shape
        h = self.num_heads
        hd = d // h
        qkv = self.qkv(x).reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                  # [b, h, n, hd]
        cdt = self.compute_dtype
        attn = cdt_matmul(q, k.transpose(-1, -2), cdt) * hd ** -0.5
        attn = torch.softmax(attn, dim=-1)
        out = cdt_matmul(attn, v, cdt)
        return self.proj(out.transpose(1, 2).reshape(b, n, d))


class Block(nn.Module):
    def __init__(self, dim, num_heads, compute_dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, compute_dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim, compute_dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer2D(nn.Module):
    """DeiT backbone exposing per-block outputs (the cls and distillation
    prefix tokens stripped)."""

    n_prefix = 2

    def __init__(self, img_size=384, patch_size=16, embed_dim=768, depth=12,
                 num_heads=12, compute_dtype=torch.bfloat16, remat=False):
        super().__init__()
        self.remat = remat
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
                                               compute_dtype=compute_dtype))

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
