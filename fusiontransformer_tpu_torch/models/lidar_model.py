"""LiDAR-only segmentation model (torch).

Port of ``fusiontransformer_tpu/models/lidar_model.py``: an SPVCNN backbone
(cr 1.0, dropout 0.3 on the decoder inputs in training) named ``backbone``
and one linear head named ``linear``, the flax names, so that the JAX tree
``backbone/...``, ``linear/...`` loads unpermuted.
"""

from __future__ import annotations

import torch
from torch import nn

from fusiontransformer_tpu_torch.models.layers import TorchLinear
from fusiontransformer_tpu_torch.models.spvcnn import SPVCNN


class LidarSeg(nn.Module):
    """SPVCNN backbone + single linear segmentation head."""

    def __init__(self, num_classes: int, cr: float = 1.0,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.backbone = SPVCNN(cr=cr, compute_dtype=compute_dtype)
        self.linear = TorchLinear(self.backbone.cs[8], num_classes,
                                  compute_dtype=compute_dtype)

    def forward(self, batch, hier, generator=None):
        """``generator``: the ``torch.Generator`` (on the batch's device)
        that training-mode dropout draws from."""
        feats = self.backbone(batch["feats"], hier, generator=generator)
        return {"lidar_seg_logit": self.linear(feats), "lidar_feats": feats}
