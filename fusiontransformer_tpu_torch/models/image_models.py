"""2D image stream: DeiT segmentation with per-point lifting (torch).

Port of ``fusiontransformer_tpu/models/image_models.py``:

* ``SampleDown`` — full-resolution 1x1 conv + ReLU + BN, then a nearest
  resize to the ViT's input size (index maps ``(i * src) // dst``);
* ``TokenBilinearModule`` — 1x1 conv + ReLU + BN on the token grid; the
  reference's nearest upsample to (H, W) is folded into ``_lift``;
* ``Net2DBilinear`` — backbone, late-block lifting + linear head(s), and the
  middle-block lifting that feeds the lidar stream.  ``_lift`` maps a
  point's full-resolution (row, col) to its token with integer
  ``(r * g) // H``, ``(c * g) // W``: the nearest-upsample-then-gather of
  the reference, with no upsampled map in memory;
* ``ImageSegBilinear`` — the image-only model around it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fusiontransformer_tpu_torch.models.layers import (MaskedBatchNorm,
                                                       MaskedBatchNorm2d,
                                                       TorchLinear)
from fusiontransformer_tpu_torch.models.vit import VisionTransformer2D
from fusiontransformer_tpu_torch.ops.sparse_conv import index_rows


FEAT_CHANNELS = 96      # width of the lifted per-point image features


def nearest_resize_idx(src: int, dst: int, device=None):
    """torch nn.Upsample(mode='nearest') index map: src_i = floor(i*src/dst)."""
    return (torch.arange(dst, device=device) * src) // dst


class TokenBilinearModule(nn.Module):
    """conv1x1 + ReLU + BN on [B, T, C] tokens."""

    def __init__(self, cin, features, compute_dtype=torch.bfloat16):
        super().__init__()
        self.conv = TorchLinear(cin, features, compute_dtype=compute_dtype)
        self.bn = MaskedBatchNorm(features)

    def forward(self, tokens):
        b, t, _ = tokens.shape
        h = F.relu(self.conv(tokens))
        flat = h.reshape(b * t, -1)
        mask = torch.ones(b * t, dtype=torch.bool, device=tokens.device)
        return self.bn(flat, mask).reshape(b, t, -1)


class SampleDown(nn.Module):
    """Full-res conv1x1 + ReLU + BN, then nearest resize to (out, out)."""

    def __init__(self, out_size=384, compute_dtype=torch.bfloat16):
        super().__init__()
        self.out_size = out_size
        self.conv = TorchLinear(3, 3, compute_dtype=compute_dtype)
        self.bn = MaskedBatchNorm2d(3)

    def forward(self, img):
        h, w = img.shape[1], img.shape[2]
        x = self.bn(F.relu(self.conv(img)))
        ri = nearest_resize_idx(h, self.out_size, img.device)
        ci = nearest_resize_idx(w, self.out_size, img.device)
        # Rows and columns through index_rows: the height is upsampled, and
        # index_select's gradient would add the repeated rows with atomics.
        x = index_rows(x.movedim(1, 0), ri).movedim(0, 1)
        return index_rows(x.movedim(2, 0), ci).movedim(0, 2).contiguous()


class Net2DBilinear(nn.Module):
    """DeiT backbone + per-block taps + per-point lifting + linear head(s)."""

    def __init__(self, num_classes: int, dual_head: bool,
                 middle_feat_block: Optional[int] = None,
                 late_feat_block: int = 11,
                 image_height: int = 370, image_width: int = 1226,
                 vit_img_size: int = 384, vit_patch: int = 16,
                 vit_embed_dim: int = 768, vit_depth: int = 12,
                 vit_heads: int = 12, compute_dtype=torch.bfloat16):
        super().__init__()
        cdt = compute_dtype
        self.image_height = image_height
        self.image_width = image_width
        self.grid = vit_img_size // vit_patch
        self.late_feat_block = late_feat_block
        self.middle_feat_block = middle_feat_block
        self.sample_down = SampleDown(vit_img_size, cdt)
        self.backbone = VisionTransformer2D(
            img_size=vit_img_size, patch_size=vit_patch,
            embed_dim=vit_embed_dim, depth=vit_depth, num_heads=vit_heads,
            compute_dtype=cdt)
        self.add_module(f"up_{late_feat_block}",
                        TokenBilinearModule(vit_embed_dim, FEAT_CHANNELS, cdt))
        self.linear = TorchLinear(FEAT_CHANNELS, num_classes,
                                  compute_dtype=cdt)
        if dual_head:
            self.linear2 = TorchLinear(FEAT_CHANNELS, num_classes,
                                       compute_dtype=cdt)
        if middle_feat_block is not None:
            self.add_module(f"up_{middle_feat_block}",
                            TokenBilinearModule(vit_embed_dim, FEAT_CHANNELS,
                                                cdt))

    def _lift(self, tok_feats, img_indices, pt_batch):
        """[B, T, C] token features -> [N, C] per-point features."""
        b, t, c = tok_feats.shape
        g = self.grid
        r, col = img_indices[:, 0].long(), img_indices[:, 1].long()
        tok = (r * g) // self.image_height * g + (col * g) // self.image_width
        idx = (pt_batch.long().clamp(0, b - 1) * t + tok.clamp(0, t - 1))
        return index_rows(tok_feats.reshape(b * t, c), idx)

    def forward(self, img, img_indices, pt_batch):
        taps = self.backbone(self.sample_down(img))
        late = getattr(self, f"up_{self.late_feat_block}")(
            taps[str(self.late_feat_block)])
        late_feats = self._lift(late, img_indices, pt_batch)
        preds = {"img_feats": late_feats,
                 "img_seg_logit": self.linear(late_feats)}
        if hasattr(self, "linear2"):
            preds["img_seg_logit2"] = self.linear2(late_feats)
        if self.middle_feat_block is not None:
            mid = getattr(self, f"up_{self.middle_feat_block}")(
                taps[str(self.middle_feat_block)])
            preds["img_middle_feats"] = self._lift(mid, img_indices, pt_batch)
        return preds


class ImageSegBilinear(nn.Module):
    """Image-only model: a ``Net2DBilinear`` named ``image_backbone``;
    returns ``img_seg_logit`` (and ``img_seg_logit2`` with a dual head)."""

    def __init__(self, num_classes: int, dual_head: bool, **kw):
        super().__init__()
        self.dual_head = dual_head
        self.image_backbone = Net2DBilinear(num_classes=num_classes,
                                            dual_head=dual_head, **kw)

    def forward(self, batch, hier=None, generator=None):
        preds = self.image_backbone(batch["img"], batch["img_indices"],
                                    batch["pt_batch"])
        keys = ("img_seg_logit", "img_seg_logit2") if self.dual_head \
            else ("img_seg_logit",)
        return {k: preds[k] for k in keys}
