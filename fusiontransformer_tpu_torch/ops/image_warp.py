"""Affine grid generation and bilinear grid sampling, NHWC (torch).

Port of ``fusiontransformer_tpu/ops/image_warp.py``: torch's
``F.affine_grid`` / ``F.grid_sample`` semantics (bilinear, zeros padding,
``align_corners=False``) as the JAX package computes them, the grid from
normalised pixel centres and the sample as four gathered taps and their
lerps.  The taps go through ``ops/sparse_conv.py::index_rows``, whose
gradient sums in a fixed order; ``F.grid_sample``'s gradient adds into the
image with float atomics on the card, which a CUDA-graph replay could not
repeat bit for bit.
"""

from __future__ import annotations

import torch

from fusiontransformer_tpu_torch.ops.sparse_conv import index_rows


def affine_grid(theta, out_h: int, out_w: int):
    """``[B, 2, 3]`` affine matrices -> ``[B, out_h, out_w, 2]`` normalised
    (x, y) sample coordinates in [-1, 1] (``align_corners=False``)."""
    dev = theta.device
    ys = (2.0 * torch.arange(out_h, device=dev) + 1.0) / out_h - 1.0
    xs = (2.0 * torch.arange(out_w, device=dev) + 1.0) / out_w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # [H, W, 3]
    return torch.einsum("bij,hwj->bhwi", theta, base.to(theta.dtype))


def grid_sample_bilinear(img, grid):
    """``F.grid_sample`` (bilinear, zeros padding, ``align_corners=False``)
    of an NHWC ``img`` [B, H, W, C] at ``grid`` [B, Ho, Wo, 2]; returns
    [B, Ho, Wo, C]."""
    b, h, w, c = img.shape
    gx = (grid[..., 0] + 1.0) * w / 2.0 - 0.5
    gy = (grid[..., 1] + 1.0) * h / 2.0 - 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    fx = (gx - x0)[..., None].to(img.dtype)
    fy = (gy - y0)[..., None].to(img.dtype)
    x0, y0 = x0.long(), y0.long()
    first = (torch.arange(b, device=img.device) * (h * w)).view(b, 1, 1)
    idx, inb = [], []
    for yi, xi in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
        inb.append((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))
        idx.append(first + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
    taps = index_rows(img.reshape(b * h * w, c), torch.stack(idx))
    v00, v01, v10, v11 = taps * torch.stack(inb)[..., None].to(img.dtype)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy
