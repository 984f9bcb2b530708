"""Fusion models: late / middle / early (torch).

Port of ``fusiontransformer_tpu/models/fusion.py``.  All three pair a
``Net2DBilinear`` image stream with an SPVCNN lidar stream:

* late   — independent streams;
* middle — ViT block features lifted to points, Linear(96->256)+BN+ReLU,
  added at the UNet bottleneck z1;
* early  — ViT block features, Linear(96->32)+BN+ReLU, added to z0.

Image features are detached before they enter the lidar stream, so the
lidar losses send no gradient into the image stream (the JAX package's
``stop_gradient``).  ``vit_tp`` / ``vit_tp_group`` shard the ViT over a
model group (``parallel/tensor_parallel.py``); the 3D stream is
replicated.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fusiontransformer_tpu_torch.models.image_models import Net2DBilinear
from fusiontransformer_tpu_torch.models.layers import TorchLinear
from fusiontransformer_tpu_torch.models.spvcnn import SPVCNN


class Net3DSeg(nn.Module):
    """SPVCNN + head(s), with optional fusion injection."""

    def __init__(self, num_classes: int, dual_head: bool,
                 fusion: Optional[str] = None, cr: float = 1.0,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.backbone = SPVCNN(cr=cr, fusion=fusion,
                               compute_dtype=compute_dtype)
        width = self.backbone.cs[8]
        self.linear = TorchLinear(width, num_classes,
                                  compute_dtype=compute_dtype)
        if dual_head:
            self.linear2 = TorchLinear(width, num_classes,
                                       compute_dtype=compute_dtype)

    def forward(self, pt_feats, hier, fusion_feats=None, generator=None):
        feats = self.backbone(pt_feats, hier, fusion_feats=fusion_feats,
                              generator=generator)
        preds = {"lidar_feats": feats,
                 "lidar_seg_logit": self.linear(feats)}
        if hasattr(self, "linear2"):
            preds["lidar_seg_logit2"] = self.linear2(feats)
        return preds


class FusionTransformerBase(nn.Module):
    def __init__(self, num_classes: int, dual_head: bool,
                 fusion: Optional[str] = None,
                 middle_feat_block: Optional[int] = None,
                 late_feat_block: int = 11, cr: float = 1.0,
                 image_height: int = 370, image_width: int = 1226,
                 vit_img_size: int = 384, vit_patch: int = 16,
                 vit_embed_dim: int = 768, vit_depth: int = 12,
                 vit_heads: int = 12, compute_dtype=torch.bfloat16,
                 remat_vit: bool = False, vit_tp: int = 1, vit_tp_group=None):
        super().__init__()
        self.fusion = fusion
        self.dual_head = dual_head
        self.image_backbone = Net2DBilinear(
            num_classes=num_classes, dual_head=dual_head,
            middle_feat_block=middle_feat_block,
            late_feat_block=late_feat_block,
            image_height=image_height, image_width=image_width,
            vit_img_size=vit_img_size, vit_patch=vit_patch,
            vit_embed_dim=vit_embed_dim, vit_depth=vit_depth,
            vit_heads=vit_heads, compute_dtype=compute_dtype,
            remat_vit=remat_vit, vit_tp=vit_tp, vit_tp_group=vit_tp_group)
        self.lidar_backbone = Net3DSeg(
            num_classes=num_classes, dual_head=dual_head, fusion=fusion,
            cr=cr, compute_dtype=compute_dtype)

    def forward(self, batch, hier, generator=None):
        """``generator``: the ``torch.Generator`` (on the batch's device)
        that training-mode dropout draws from."""
        preds_image = self.image_backbone(batch["img"], batch["img_indices"],
                                          batch["pt_batch"])
        fusion_feats = None
        if self.fusion in ("early", "middle"):
            fusion_feats = preds_image["img_middle_feats"].detach()
        preds_lidar = self.lidar_backbone(batch["feats"], hier,
                                          fusion_feats=fusion_feats,
                                          generator=generator)
        out = {"lidar_seg_logit": preds_lidar["lidar_seg_logit"],
               "img_seg_logit": preds_image["img_seg_logit"]}
        if self.dual_head:
            out["lidar_seg_logit2"] = preds_lidar["lidar_seg_logit2"]
            out["img_seg_logit2"] = preds_image["img_seg_logit2"]
        return out


def LateFusionTransformer(**kw):
    return FusionTransformerBase(fusion=None, **kw)


def MiddleFusionTransformer(**kw):
    return FusionTransformerBase(fusion="middle", **kw)


def EarlyFusionTransformer(**kw):
    return FusionTransformerBase(fusion="early", **kw)
