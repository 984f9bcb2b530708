"""Model factory: the ``MODEL.USE_FUSION`` branch of
``fusiontransformer_tpu/models/build.py``.

``build_model(cfg, device=None, seed=0)`` returns a ``FusionTransformerBase``
filled with random weights from a seeded ``torch.Generator``, on the card
unless the caller passes ``device="cpu"``.  Parameters are float32; the
compute dtype (``TPU.COMPUTE_DTYPE``) only sets the operand type of the
matmuls and sparse ops.
"""

from __future__ import annotations

import torch

from fusiontransformer_tpu_torch.models.fusion import (EarlyFusionTransformer,
                                                       LateFusionTransformer,
                                                       MiddleFusionTransformer)
from fusiontransformer_tpu_torch.models.layers import init_weights
from fusiontransformer_tpu_torch.utils.device import resolve_device

_BUILDERS = {
    "LateFusionTransformer": LateFusionTransformer,
    "MiddleFusionTransformer": MiddleFusionTransformer,
    "EarlyFusionTransformer": EarlyFusionTransformer,
}


def compute_dtype(cfg):
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[cfg.TPU.COMPUTE_DTYPE]


def build_model(cfg, device=None, seed: int = 0):
    dev = resolve_device(device)
    if not cfg.MODEL.USE_FUSION or cfg.MODEL.TYPE not in _BUILDERS:
        raise NotImplementedError(
            f"only the fusion models are ported, got {cfg.MODEL.TYPE} "
            f"(USE_FUSION={cfg.MODEL.USE_FUSION})")
    ds = cfg.DATASET.get(cfg.DATASET.TYPE, {})
    late = cfg.MODEL.late_feat_block_number
    model = _BUILDERS[cfg.MODEL.TYPE](
        num_classes=cfg.MODEL.NUM_CLASSES,
        dual_head=cfg.MODEL.DUAL_HEAD,
        middle_feat_block=cfg.MODEL.middle_feat_block_number,
        late_feat_block=late if late is not None else 11,
        image_height=ds.get("image_height", 370),
        image_width=ds.get("image_width", 1226),
        vit_img_size=cfg.MODEL.VIT_IMG_SIZE,
        vit_patch=cfg.MODEL.VIT_PATCH,
        vit_embed_dim=cfg.MODEL.VIT_EMBED_DIM,
        vit_depth=cfg.MODEL.VIT_DEPTH,
        vit_heads=cfg.MODEL.VIT_HEADS,
        compute_dtype=compute_dtype(cfg))
    init_weights(model, seed)
    return model.to(dev).eval()
