"""Shared building blocks: torch-style init, masked batch norm, linear.

Port of ``fusiontransformer_tpu/models/layers.py``.  Parameter and buffer
names are the flax leaf names (``kernel``, ``bias``, ``scale``, ``mean``,
``var``) so JAX variables map onto ``state_dict`` keys one to one
(``utils/convert_jax.py``).  Modules are created with their input widths and
zero/one placeholders; ``init_weights`` fills them from a seeded
``torch.Generator`` in registration order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fusiontransformer_tpu_torch.ops.sparse_conv import cdt_matmul
from fusiontransformer_tpu_torch.parallel.tensor_parallel import (
    psum_fwd_identity_bwd)


def torch_uniform_(t, fan_in: int, gen: torch.Generator):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) — torch's default conv/linear init."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def trunc_normal_(t, std: float, gen: torch.Generator):
    """Normal(0, std) truncated at two standard deviations (flax's
    ``truncated_normal``), by resampling."""
    with torch.no_grad():
        x = torch.randn(t.shape, generator=gen)
        bad = x.abs() > 2.0
        while bad.any():
            x[bad] = torch.randn(int(bad.sum()), generator=gen)
            bad = x.abs() > 2.0
        t.copy_(x * std)


def init_weights(model: nn.Module, seed: int = 0):
    """Fill every parameter from one seeded CPU generator (modules in
    registration order).  Call before moving the model to the card."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if hasattr(m, "reset_parameters_"):
            m.reset_parameters_(gen)
    return model


class TorchLinear(nn.Module):
    """nn.Linear with torch default init and an [in, out] ``kernel``.

    ``reduce_group`` makes the layer the row-parallel half of a Megatron
    pair (``parallel/tensor_parallel.py``): the matmul contracts this
    rank's input shard, an all-reduce over the group rebuilds the full
    product, and the (replicated) bias is added after it, once."""

    def __init__(self, in_features: int, features: int,
                 compute_dtype=torch.float32, reduce_group=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.reduce_group = reduce_group
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters_(self, gen):
        fan_in = self.kernel.shape[0]
        torch_uniform_(self.kernel, fan_in, gen)
        torch_uniform_(self.bias, fan_in, gen)

    def forward(self, x):
        y = cdt_matmul(x, self.kernel, self.compute_dtype)
        if self.reduce_group is not None:
            y = psum_fwd_identity_bwd(y, self.reduce_group)
        return y + self.bias


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's ``scale``/``bias`` names."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid rows of a padded [V, C] buffer.

    Eps 1e-5, momentum 0.1; the biased batch variance is used for the
    normalization and the running update alike (``nn.BatchNorm1d`` differs
    on both counts).  Statistics are always f32.
    """

    def __init__(self, c: int, momentum: float = 0.1, eps: float = 1e-5,
                 out_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.out_dtype = out_dtype
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, mask):
        xf = x.float()
        if self.training:
            m = mask.float()[:, None]
            n = m.sum().clamp(min=1.0)
            mean = (xf * m).sum(0) / n
            var = ((xf * m) ** 2).sum(0) / n - mean ** 2
            var = var.clamp(min=0.0)
            with torch.no_grad():
                self.mean.copy_((1 - self.momentum) * self.mean
                                + self.momentum * mean)
                self.var.copy_((1 - self.momentum) * self.var
                               + self.momentum * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) / torch.sqrt(var + self.eps)
        y = y * self.scale + self.bias
        return y.to(self.out_dtype) if self.out_dtype is not None else y


class MaskedBatchNorm2d(nn.Module):
    """BatchNorm2d over [B, H, W, C] (NHWC)."""

    def __init__(self, c: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 1, 2))
            var = ((x ** 2).mean(dim=(0, 1, 2)) - mean ** 2).clamp(min=0.0)
            with torch.no_grad():
                self.mean.copy_((1 - self.momentum) * self.mean
                                + self.momentum * mean)
                self.var.copy_((1 - self.momentum) * self.var
                               + self.momentum * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * self.scale + self.bias
