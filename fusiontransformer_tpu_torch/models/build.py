"""Model factory: the ``USE_FUSION``, ``USE_LIDAR`` and ``USE_IMAGE``
branches of ``fusiontransformer_tpu/models/build.py``.

``build_model(cfg, device=None, seed=0)`` returns the model of
``MODEL.TYPE`` (a fusion model, ``LidarSeg``, ``ImageSegBilinear`` or the
STN ``ImageSeg``) filled with random weights from a seeded
``torch.Generator``, on the card unless the caller passes ``device="cpu"``.
Parameters are float32; the compute dtype (``TPU.COMPUTE_DTYPE``) only sets
the operand type of the matmuls and sparse ops.  The legacy families of the
``legacy_*.yaml`` configs raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from fusiontransformer_tpu_torch.models.fusion import (EarlyFusionTransformer,
                                                       LateFusionTransformer,
                                                       MiddleFusionTransformer)
from fusiontransformer_tpu_torch.models.image_models import ImageSegBilinear
from fusiontransformer_tpu_torch.models.image_models_stn import ImageSegSTN
from fusiontransformer_tpu_torch.models.layers import init_weights
from fusiontransformer_tpu_torch.models.lidar_model import LidarSeg
from fusiontransformer_tpu_torch.utils.device import resolve_device

_FUSION = {
    "LateFusionTransformer": LateFusionTransformer,
    "MiddleFusionTransformer": MiddleFusionTransformer,
    "EarlyFusionTransformer": EarlyFusionTransformer,
}
LEGACY = ("XMUDAFusion", "LidarSegSCN", "ImageSegResNet")


def compute_dtype(cfg):
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[cfg.TPU.COMPUTE_DTYPE]


def _construct(cfg):
    cdt = compute_dtype(cfg)
    m = cfg.MODEL
    ds = cfg.DATASET.get(cfg.DATASET.TYPE, {})
    dims = dict(image_height=ds.get("image_height", 370),
                image_width=ds.get("image_width", 1226))
    if m.TYPE in LEGACY:
        raise NotImplementedError(
            f"{m.TYPE} (the legacy_*.yaml families) is not ported yet "
            f"(ROADMAP.md, Queue 1 item 5)")
    late = m.late_feat_block_number
    vit = dict(num_classes=m.NUM_CLASSES, dual_head=m.DUAL_HEAD,
               middle_feat_block=m.middle_feat_block_number,
               late_feat_block=late if late is not None else 11,
               vit_img_size=m.VIT_IMG_SIZE, vit_patch=m.VIT_PATCH,
               vit_embed_dim=m.VIT_EMBED_DIM, vit_depth=m.VIT_DEPTH,
               vit_heads=m.VIT_HEADS, compute_dtype=cdt, **dims)
    if m.USE_FUSION:
        if m.TYPE not in _FUSION:
            raise KeyError(f"{m.TYPE} is not a fusion model")
        return _FUSION[m.TYPE](**vit)
    if m.USE_LIDAR:
        assert m.TYPE == "LidarSeg", m.TYPE
        return LidarSeg(num_classes=m.NUM_CLASSES, compute_dtype=cdt)
    if m.USE_IMAGE:
        assert m.TYPE in ("ImageSegBilinear", "ImageSeg"), m.TYPE
        if m.TYPE == "ImageSeg":
            return ImageSegSTN(num_classes=m.NUM_CLASSES,
                               dual_head=m.DUAL_HEAD, compute_dtype=cdt,
                               **dims)
        return ImageSegBilinear(**vit)
    raise ValueError(f"Unsupported model config: {m.TYPE}")


def build_model(cfg, device=None, seed: int = 0):
    dev = resolve_device(device)
    model = _construct(cfg)
    init_weights(model, seed)
    return model.to(dev).eval()
