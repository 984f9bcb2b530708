"""The STN image variant, ``ImageSeg`` (torch).

Port of ``fusiontransformer_tpu/models/image_models_stn.py``:

* ``SpatialTransformer`` — a localisation CNN (7x7 conv to 8, 2x2 max pool,
  ReLU, 5x5 conv to 90, pool, ReLU, global mean), ``fc1`` to 32 + ReLU and
  an affine regressor ``fc2_kernel`` / ``fc2_bias`` that starts at the
  identity warp, then ``affine_grid`` / ``grid_sample_bilinear``
  (``ops/image_warp.py``) to the output size;
* ``ScaleUpModule`` — a per-token linear to ``out_features * 16 * 16`` and a
  pixel shuffle to the 16x token grid (the reference's stride-16
  ConvTranspose2d), then an STN to the camera's full resolution;
* ``Net2DSegSTN`` — STN down to 384x384, the DeiT-B/384 ViT with its
  defaults (the config's ViT and middle-block settings are not read, as in
  the JAX package), ``ScaleUpModule`` of the late block, and a per-pixel
  lift of each point;
* ``ImageSegSTN`` — the model around it; it returns ``img_seg_logit``
  only, with a dual head too.

The convolutions keep flax's ``kernel`` layout ``[kh, kw, Cin, Cout]`` as the
parameter and permute it in ``forward``, so that ``utils/convert_jax.py``
carries them unpermuted.  Only ``up_conv`` and the ViT take the compute
dtype; the localisation nets and the heads run in float32, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fusiontransformer_tpu_torch.models.image_models import FEAT_CHANNELS
from fusiontransformer_tpu_torch.models.layers import (TorchLinear,
                                                       trunc_normal_)
from fusiontransformer_tpu_torch.models.vit import VisionTransformer2D
from fusiontransformer_tpu_torch.ops.image_warp import (affine_grid,
                                                        grid_sample_bilinear)
from fusiontransformer_tpu_torch.ops.sparse_conv import index_rows

# flax's truncated_normal(stddev) draws from [-2, 2] and rescales by this
# factor so that the truncated draw has the requested standard deviation.
_TRUNC_STD = 0.87962566103423978


class _Conv2dFixedOrder(torch.autograd.Function):
    """``F.conv2d`` (stride 1, no padding) whose backward runs cuDNN's
    deterministic algorithms, so that a CUDA-graph replay repeats the eager
    step bit for bit."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[0]], [1, 1], [0, 0], [1, 1], False,
                [0, 0], 1, [ctx.needs_input_grad[0], True, True])
        finally:
            torch.backends.cudnn.deterministic = was
        return dx, dw, db


class FlaxConv(nn.Module):
    """flax ``nn.Conv`` with VALID padding: ``kernel`` [kh, kw, Cin, Cout]
    (lecun-normal init), ``bias`` [Cout] (zeros); NCHW in and out."""

    def __init__(self, cin: int, cout: int, size: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(size, size, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters_(self, gen):
        fan_in = self.kernel.shape[0] * self.kernel.shape[1] \
            * self.kernel.shape[2]
        trunc_normal_(self.kernel, math.sqrt(1.0 / fan_in) / _TRUNC_STD, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return _Conv2dFixedOrder.apply(x, self.kernel.permute(3, 2, 0, 1),
                                       self.bias)


class SpatialTransformer(nn.Module):
    """Localisation net + affine regressor + resample of [B, H, W, C]."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc_conv1 = FlaxConv(channels, 8, 7)
        self.loc_conv2 = FlaxConv(8, 90, 5)
        self.fc1 = TorchLinear(90, 32)
        # The identity warp, which ``init_weights`` leaves as it is: a zero
        # regressor and the bias [1 0 0; 0 1 0].
        self.fc2_kernel = nn.Parameter(torch.zeros(32, 6))
        self.fc2_bias = nn.Parameter(
            torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0]))

    def forward(self, x, out_h: int, out_w: int):
        h = self.loc_conv1(x.permute(0, 3, 1, 2))
        h = F.relu(F.max_pool2d(h, 2, 2))
        h = F.relu(F.max_pool2d(self.loc_conv2(h), 2, 2))
        h = F.relu(self.fc1(h.mean(dim=(2, 3))))
        theta = (h @ self.fc2_kernel + self.fc2_bias).reshape(-1, 2, 3)
        return grid_sample_bilinear(x, affine_grid(theta, out_h, out_w))


class ScaleUpModule(nn.Module):
    """Per-token linear to ``out_features * 16 * 16``, pixel shuffle to the
    16x grid, STN to (out_h, out_w)."""

    def __init__(self, cin: int, out_features: int,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.out_features = out_features
        self.up_conv = TorchLinear(cin, out_features * 16 * 16,
                                   compute_dtype=compute_dtype)
        self.up_stn = SpatialTransformer(out_features)

    def forward(self, tokens, out_h: int, out_w: int):
        b, t, _ = tokens.shape
        g = int(round(t ** 0.5))
        if g * g != t:
            raise ValueError(f"token count {t} is not a square grid")
        c = self.out_features
        h = self.up_conv(tokens).reshape(b, g, g, 16, 16, c)
        h = h.permute(0, 1, 3, 2, 4, 5).reshape(b, g * 16, g * 16, c)
        return self.up_stn(h, out_h, out_w)


class Net2DSegSTN(nn.Module):
    def __init__(self, num_classes: int, dual_head: bool,
                 middle_feat_block: Optional[int] = None,
                 late_feat_block: int = 11, image_height: int = 370,
                 image_width: int = 1226, compute_dtype=torch.bfloat16):
        super().__init__()
        cdt = compute_dtype
        self.image_height = image_height
        self.image_width = image_width
        self.late_feat_block = late_feat_block
        self.middle_feat_block = middle_feat_block
        self.stn_down = SpatialTransformer(3)
        self.backbone = VisionTransformer2D(compute_dtype=cdt)
        width = 768     # VisionTransformer2D's default embed_dim
        self.add_module(f"up_{late_feat_block}",
                        ScaleUpModule(width, FEAT_CHANNELS, cdt))
        self.linear = TorchLinear(FEAT_CHANNELS, num_classes)
        if dual_head:
            self.linear2 = TorchLinear(FEAT_CHANNELS, num_classes)
        if middle_feat_block is not None:
            self.add_module(f"up_{middle_feat_block}",
                            ScaleUpModule(width, FEAT_CHANNELS, cdt))

    def _lift(self, fmap, img_indices, pt_batch):
        """[B, H, W, C] map at the camera's resolution -> [N, C]."""
        b, h, w, c = fmap.shape
        r = img_indices[:, 0].long().clamp(0, h - 1)
        col = img_indices[:, 1].long().clamp(0, w - 1)
        idx = (pt_batch.long().clamp(0, b - 1) * h + r) * w + col
        return index_rows(fmap.reshape(b * h * w, c), idx)

    def forward(self, img, img_indices, pt_batch):
        taps = self.backbone(self.stn_down(img, 384, 384))

        def up(block):
            fmap = getattr(self, f"up_{block}")(
                taps[str(block)], self.image_height, self.image_width)
            return self._lift(fmap, img_indices, pt_batch)

        late_feats = up(self.late_feat_block)
        preds = {"img_feats": late_feats,
                 "img_seg_logit": self.linear(late_feats)}
        if hasattr(self, "linear2"):
            preds["img_seg_logit2"] = self.linear2(late_feats)
        if self.middle_feat_block is not None:
            preds["img_middle_feats"] = up(self.middle_feat_block)
        return preds


class ImageSegSTN(nn.Module):
    """The ``ImageSeg`` model: a ``Net2DSegSTN`` named ``image_backbone``."""

    def __init__(self, num_classes: int, dual_head: bool,
                 image_height: int = 370, image_width: int = 1226,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.image_backbone = Net2DSegSTN(
            num_classes=num_classes, dual_head=dual_head,
            image_height=image_height, image_width=image_width,
            compute_dtype=compute_dtype)

    def forward(self, batch, hier=None, generator=None):
        preds = self.image_backbone(batch["img"], batch["img_indices"],
                                    batch["pt_batch"])
        return {"img_seg_logit": preds["img_seg_logit"]}
