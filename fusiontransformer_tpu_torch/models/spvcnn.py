"""SPVCNN — sparse point-voxel UNet (torch).

Port of ``fusiontransformer_tpu/models/spvcnn.py``: channel plan
``cs = [32,32,64,128,256,256,128,96,96] * cr``; a two-conv stem at level 0,
four (ks2-stride2 + 2 residual blocks) down stages, four (transposed ks2 +
skip concat + 2 residual blocks) up stages, three point-transform MLPs with
additive point-stream skips, dropout 0.3 on the decoder inputs in training,
and the early/middle fusion injection (Linear+BN+ReLU of the lifted image
features).  The forward consumes a precomputed ``ops.hierarchy.Hierarchy``.
Submodule names are the flax names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fusiontransformer_tpu_torch.models.layers import (MaskedBatchNorm,
                                                       TorchLinear,
                                                       torch_uniform_)
from fusiontransformer_tpu_torch.ops import sparse_conv as sc

IN_CHANNELS = 4     # point features: x, y, z, reflectance
FUSION_IN = 96      # lifted image feature width (image_models.FEAT_CHANNELS)
DROPOUT = 0.3       # on the decoder inputs, in training only


class _ConvKernel(nn.Module):
    """A sparse conv's ``kernel`` [taps, Cin, Cout] (torch-uniform init)."""

    def __init__(self, taps, cin, cout, compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        shape = (cin, cout) if taps == 1 else (taps, cin, cout)
        self.kernel = nn.Parameter(torch.zeros(shape))
        self.fan_in = cin * taps

    def reset_parameters_(self, gen):
        torch_uniform_(self.kernel, self.fan_in, gen)


class SubMConv3(_ConvKernel):
    """ks=3 stride=1 sparse conv (no bias)."""

    def __init__(self, cin, cout, compute_dtype=torch.bfloat16):
        super().__init__(27, cin, cout, compute_dtype)

    def forward(self, x, nbr_idx, slot_idx=None):
        return sc.subm_conv3(x, self.kernel, nbr_idx, self.compute_dtype,
                             slot_idx=slot_idx)


class DownConv2(_ConvKernel):
    def __init__(self, cin, cout, compute_dtype=torch.bfloat16):
        super().__init__(8, cin, cout, compute_dtype)

    def forward(self, x, child_idx):
        return sc.down_conv2(x, self.kernel, child_idx, self.compute_dtype)


class UpConv2(_ConvKernel):
    def __init__(self, cin, cout, compute_dtype=torch.bfloat16):
        super().__init__(8, cin, cout, compute_dtype)

    def forward(self, x, parent_idx, child_kidx):
        return sc.up_conv2(x, self.kernel, parent_idx, child_kidx,
                           self.compute_dtype)


class Conv1x1(_ConvKernel):
    def __init__(self, cin, cout, compute_dtype=torch.bfloat16):
        super().__init__(1, cin, cout, compute_dtype)

    def forward(self, x):
        return sc.conv1x1(x, self.kernel, self.compute_dtype)


class ResidualBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN + (1x1-BN shortcut) -> ReLU."""

    def __init__(self, cin, features, compute_dtype=torch.bfloat16):
        super().__init__()
        cdt = compute_dtype
        self.SubMConv3_0 = SubMConv3(cin, features, cdt)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, out_dtype=cdt)
        self.SubMConv3_1 = SubMConv3(features, features, cdt)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(features, out_dtype=cdt)
        if cin != features:
            self.Conv1x1_0 = Conv1x1(cin, features, cdt)
            self.MaskedBatchNorm_2 = MaskedBatchNorm(features, out_dtype=cdt)

    def forward(self, x, nbr_idx, mask, slot_idx=None):
        h = self.SubMConv3_0(x, nbr_idx, slot_idx)
        h = F.relu(self.MaskedBatchNorm_0(h, mask))
        h = self.SubMConv3_1(h, nbr_idx, slot_idx)
        h = self.MaskedBatchNorm_1(h, mask)
        if hasattr(self, "Conv1x1_0"):
            shortcut = self.MaskedBatchNorm_2(self.Conv1x1_0(x), mask)
        else:
            shortcut = x
        return F.relu(h + shortcut)


class PointTransform(nn.Module):
    """Linear + BN1d + ReLU on the point stream."""

    def __init__(self, cin, features, compute_dtype=torch.bfloat16):
        super().__init__()
        self.TorchLinear_0 = TorchLinear(cin, features,
                                         compute_dtype=compute_dtype)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features,
                                                 out_dtype=compute_dtype)

    def forward(self, x, mask):
        return F.relu(self.MaskedBatchNorm_0(self.TorchLinear_0(x), mask))


class SPVCNN(nn.Module):
    """The sparse UNet backbone; returns per-point features [N, cs[8]].

    ``fusion``: None | 'early' | 'middle' — which injection transform to
    create; the lifted image features ([N, FUSION_IN], gradient-stopped)
    arrive as ``fusion_feats``.
    """

    def __init__(self, cr: float = 1.0, fusion: Optional[str] = None,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        cs = [int(cr * c) for c in (32, 32, 64, 128, 256, 256, 128, 96, 96)]
        self.cs = cs
        self.fusion = fusion
        cdt = compute_dtype
        self.stem0 = SubMConv3(IN_CHANNELS, cs[0], cdt)
        self.stem0_bn = MaskedBatchNorm(cs[0], out_dtype=cdt)
        self.stem1 = SubMConv3(cs[0], cs[0], cdt)
        self.stem1_bn = MaskedBatchNorm(cs[0], out_dtype=cdt)
        # stage{i+1}: ks2 down cs[i] -> cs[i], residual blocks to cs[i+1].
        for i in range(4):
            self.add_module(f"stage{i+1}_down",
                            DownConv2(cs[i], cs[i], cdt))
            self.add_module(f"stage{i+1}_down_bn",
                            MaskedBatchNorm(cs[i], out_dtype=cdt))
            self.add_module(f"stage{i+1}_res1",
                            ResidualBlock(cs[i], cs[i + 1], cdt))
            self.add_module(f"stage{i+1}_res2",
                            ResidualBlock(cs[i + 1], cs[i + 1], cdt))
        # up{k}: deconv from the previous width, concat the encoder skip.
        up_in = [cs[4], cs[5], cs[6], cs[7]]
        skips = [cs[3], cs[2], cs[1], cs[0]]
        for k in range(4):
            f = cs[5 + k]
            self.add_module(f"up{k+1}_deconv", UpConv2(up_in[k], f, cdt))
            self.add_module(f"up{k+1}_deconv_bn",
                            MaskedBatchNorm(f, out_dtype=cdt))
            self.add_module(f"up{k+1}_res1",
                            ResidualBlock(f + skips[k], f, cdt))
            self.add_module(f"up{k+1}_res2", ResidualBlock(f, f, cdt))
        self.point_transform0 = PointTransform(cs[0], cs[4], cdt)
        self.point_transform1 = PointTransform(cs[4], cs[6], cdt)
        self.point_transform2 = PointTransform(cs[6], cs[8], cdt)
        if fusion in ("early", "middle"):
            out_dim = cs[0] if fusion == "early" else cs[4]
            self.fusion_linear = TorchLinear(FUSION_IN, out_dim,
                                             compute_dtype=cdt)
            self.fusion_bn = MaskedBatchNorm(out_dim, out_dtype=cdt)

    def _fusion_transform(self, fusion_feats, pt_valid):
        if fusion_feats is None:
            raise ValueError("fusion model called without image features")
        h = self.fusion_linear(fusion_feats)
        return F.relu(self.fusion_bn(h, pt_valid))

    def _drop(self, x):
        return F.dropout(x, DROPOUT, training=self.training)

    def _up(self, k, y, fine, skip, hier):
        """Up stage k (1..4): level ``fine + 1`` -> level ``fine``."""
        L = hier.levels
        y = getattr(self, f"up{k}_deconv")(y, L[fine].parent_idx,
                                           L[fine].child_kidx)
        y = F.relu(getattr(self, f"up{k}_deconv_bn")(y, L[fine].valid))
        y = torch.cat([y, skip], dim=-1)
        for name in ("res1", "res2"):
            y = getattr(self, f"up{k}_{name}")(y, L[fine].nbr_idx,
                                               L[fine].valid,
                                               L[fine].slot_idx)
        return y

    def forward(self, pt_feats, hier, fusion_feats=None):
        L = hier.levels
        masks = [l.valid for l in L]

        # Initial voxelize: points are 1:1 with L0 voxels.
        x0 = sc.gather_rows(pt_feats, hier.vox0_point_idx)
        x0 = self.stem0(x0, L[0].nbr_idx, L[0].slot_idx)
        x0 = F.relu(self.stem0_bn(x0, masks[0]))
        x0 = self.stem1(x0, L[0].nbr_idx, L[0].slot_idx)
        x0 = F.relu(self.stem1_bn(x0, masks[0]))

        z0 = sc.gather_rows(x0, hier.pt_sorted_pos)
        if self.fusion == "early":
            z0 = z0 + self._fusion_transform(fusion_feats, hier.pt_valid)
            feats_in = sc.gather_rows(z0, hier.vox0_point_idx)
        else:
            feats_in = x0
        skips = [x0]
        for i in range(4):
            lvl = L[i + 1]
            h = getattr(self, f"stage{i+1}_down")(feats_in, lvl.child_idx)
            h = F.relu(getattr(self, f"stage{i+1}_down_bn")(h, masks[i + 1]))
            h = getattr(self, f"stage{i+1}_res1")(h, lvl.nbr_idx,
                                                  masks[i + 1], lvl.slot_idx)
            h = getattr(self, f"stage{i+1}_res2")(h, lvl.nbr_idx,
                                                  masks[i + 1], lvl.slot_idx)
            skips.append(h)
            feats_in = h

        # z1 = v2p(x4) + PT0(z0) (+ middle fusion injection)
        z1 = sc.devoxelize_trilinear(feats_in, hier.pt_corner_idx[4],
                                     hier.pt_corner_w[4])
        z1 = z1 + self.point_transform0(z0, hier.pt_valid)
        if self.fusion == "middle":
            z1 = z1 + self._fusion_transform(fusion_feats, hier.pt_valid)

        # Decoder stages 1+2 (L4 -> L3 -> L2).
        cdt = self.stem0.compute_dtype
        y = sc.voxelize_mean(z1, hier.pt_voxel_idx[4], hier.pt_valid,
                             L[4].valid.shape[0],
                             plan=sc.devox_plan(hier, 4), compute_dtype=cdt)
        y = self._up(1, self._drop(y), 3, skips[3], hier)
        y = self._up(2, y, 2, skips[2], hier)

        # z2 = v2p(y2) + PT1(z1)
        z2 = sc.devoxelize_trilinear(y, hier.pt_corner_idx[2],
                                     hier.pt_corner_w[2])
        z2 = z2 + self.point_transform1(z1, hier.pt_valid)

        # Decoder stages 3+4 (L2 -> L1 -> L0).
        y = sc.voxelize_mean(z2, hier.pt_voxel_idx[2], hier.pt_valid,
                             L[2].valid.shape[0],
                             plan=sc.devox_plan(hier, 2), compute_dtype=cdt)
        y = self._up(3, self._drop(y), 1, skips[1], hier)
        y = self._up(4, y, 0, skips[0], hier)

        # z3 = v2p(y4) + PT2(z2) — identity gather at stride 1.
        z3 = sc.gather_rows(y, hier.pt_sorted_pos)
        return z3 + self.point_transform2(z2, hier.pt_valid)
