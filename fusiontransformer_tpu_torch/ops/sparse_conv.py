"""Sparse convolution and point<->voxel ops, forward (torch).

Port of ``fusiontransformer_tpu/ops/sparse_conv.py``.  Every op reads
through a zero pad row at index ``V``, so sentinel indices contribute zeros.

* ``subm_conv3`` — ks=3 stride=1.  At a level that carries group-pooled slot
  maps it runs the hand-written kernel ``binned_conv_grouped_fwd`` (K1);
  otherwise the dense 27-tap gather + one GEMM.
* ``down_conv2`` / ``up_conv2`` / ``conv1x1`` — gather + GEMM.
* ``voxelize_mean`` — with a ``DevoxPlan`` the sums and counts come from the
  hand-written kernel ``sorted_segment_weighted_sum`` (K3); without one, an
  ``index_add``.
* ``devoxelize_trilinear`` — 8-corner gather + weighted sum.

Routing differs from the JAX package on purpose.  There a grouped-map conv
takes the Pallas kernel only for ``16 <= Cin`` and ``max(Cin, Cout) <= 128``
(``_PALLAS_MIN_CIN`` / ``_PALLAS_MAX_CH``, TPU VMEM limits) and the dense path
otherwise.  Here every ks=3 conv at a level with grouped maps (L0-L3 of the
flagship) runs K1, whatever its widths, and L4, which has no maps, runs the
dense path.  Both paths compute the same function (the maps are lossless);
only the arithmetic that runs differs.

Precision: ``compute_dtype`` float32 means true f32 (TF32 stays off).  With
bfloat16 the operands are rounded to bf16 and every product is accumulated
and returned in f32, as the JAX package's ``preferred_element_type`` does:
no GEMM output is rounded to bf16.  The kernels' outputs are f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
    binned_conv_grouped_fwd)
from fusiontransformer_tpu_torch.ops.kernels.segment_sum import (
    sorted_segment_weighted_sum)


def cdt_matmul(a, b, cdt):
    """a @ b with operands rounded to ``cdt``, accumulated and returned in
    float32.  ``b`` is [K, N] or has ``a``'s batch dims.

    On a CUDA tensor a bf16 product runs on the tensor cores with an f32
    output (``out_dtype``); elsewhere the rounded operands are multiplied
    in f32, which gives the same products."""
    a, b = a.to(cdt), b.to(cdt)
    if cdt == torch.float32 or a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    f32 = torch.float32
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=f32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                    b.reshape(-1, *b.shape[-2:]), out_dtype=f32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def pad_row(feats):
    """Append one zero row so sentinel index V gathers zeros."""
    return torch.cat([feats, feats.new_zeros((1,) + tuple(feats.shape[1:]))])


def _subm3_dense(feats, w, nbr_idx, cdt):
    # Column 13 of nbr_idx is the voxel itself where it is valid and the
    # sentinel at padded rows, so the center tap's term is masked by the
    # same gather (the JAX package's ``_self_mask``).
    v, cin = feats.shape
    g = pad_row(feats.to(cdt))[nbr_idx.long()]                  # [V, 27, Cin]
    return cdt_matmul(g.reshape(v, 27 * cin), w.reshape(27 * cin, -1), cdt)


def subm_conv3(feats, w, nbr_idx, compute_dtype=torch.bfloat16,
               slot_idx=None):
    """ks=3 stride=1 sparse conv.

    Args:
      feats: [V, Cin].
      w: [27, Cin, Cout] kernel (x-slowest tap order).
      nbr_idx: [V, 27] int32 ks3 map (sentinel V).
      slot_idx: optional group-pooled maps (src_pack [V/8, S],
        bin_pack [V/8, S]); when given, the conv runs K1.
    Returns:
      [V, Cout] float32.
    """
    if slot_idx is None:
        return _subm3_dense(feats, w, nbr_idx, compute_dtype)
    src, binp = slot_idx
    if src.shape[0] == feats.shape[0]:
        raise NotImplementedError(
            "per-voxel K-slot maps are not ported; use group-pooled maps "
            "(TPU.CONV_SLOT_POOL) or none")
    return binned_conv_grouped_fwd(feats.to(compute_dtype).contiguous(), src,
                                   binp, w.to(compute_dtype).contiguous())


def down_conv2(feats_fine, w, child_idx, compute_dtype=torch.bfloat16):
    """ks=2 stride=2 conv: [Vf, Cin] at level l -> [Vc, Cout] at level l+1
    through ``child_idx`` [Vc, 8] (sentinel Vf)."""
    vc = child_idx.shape[0]
    cin = feats_fine.shape[1]
    g = pad_row(feats_fine.to(compute_dtype))[child_idx.long()]  # [Vc, 8, Cin]
    return cdt_matmul(g.reshape(vc, 8 * cin), w.reshape(8 * cin, -1),
                      compute_dtype)


def up_conv2(feats_coarse, w, parent_idx, child_kidx,
             compute_dtype=torch.bfloat16):
    """ks=2 stride=2 transposed conv: out[v] = fc[parent(v)] @ w[kidx(v)].

    All 8 offset products are taken at the coarse level (one GEMM) and each
    fine voxel picks its (parent, offset) row; sentinel parents read the
    zero pad row.
    """
    cin, cout = w.shape[1], w.shape[2]
    wcat = w.permute(1, 0, 2).reshape(cin, 8 * cout)
    y = cdt_matmul(pad_row(feats_coarse), wcat, compute_dtype)
    y = y.reshape(-1, 8, cout)
    return y[parent_idx.long(), child_kidx.long()]


def conv1x1(feats, w, compute_dtype=torch.bfloat16):
    """ks=1 sparse conv = per-voxel linear map."""
    return cdt_matmul(feats, w, compute_dtype)


class DevoxPlan(NamedTuple):
    """Index maps of a level over the Morton-sorted point stream."""

    sort_perm: torch.Tensor   # [cap0] point index per sorted slot (sentinel N)
    ids_sorted: torch.Tensor  # [cap0] level voxel id per sorted slot (sentinel V)
    nbr_neg: torch.Tensor     # [V, 8] ks3-map columns at taps -e (sentinel V)


# ks3 tap index of offset -e for corner e = (bx, by, bz), x-slowest order.
_NEG_CORNER_TAPS = [(1 - bx) * 9 + (1 - by) * 3 + (1 - bz)
                    for bx in (0, 1) for by in (0, 1) for bz in (0, 1)]


def devox_plan(hier, level):
    """The DevoxPlan of ``hier.levels[level]``."""
    lvl = hier.levels[level]
    cap = lvl.valid.shape[0]
    ids = hier.pt_voxel_idx[level]
    ids_sorted = torch.cat([ids, ids.new_full((1,), cap)])[
        hier.vox0_point_idx.long()]
    return DevoxPlan(hier.vox0_point_idx, ids_sorted,
                     lvl.nbr_idx[:, _NEG_CORNER_TAPS])


def voxelize_mean(pt_feats, pt_voxel_idx, pt_valid, num_voxels, plan=None,
                  compute_dtype=torch.bfloat16):
    """Average-pool point features into their containing voxels.

    With a DevoxPlan the sums, and the point counts as a trailing ones
    column, come from one K3 launch over the sorted point stream;
    ``compute_dtype`` float32 keeps its per-point products un-rounded.
    Voxels no point reaches come back 0.
    """
    if plan is None:
        valid_f = pt_valid.float()
        ids = torch.where(pt_valid, pt_voxel_idx, num_voxels).long()
        counts = valid_f.new_zeros(num_voxels + 1).index_add_(
            0, ids, valid_f)[:num_voxels]
        sums = pt_feats.new_zeros((num_voxels + 1, pt_feats.shape[1]))
        sums = sums.index_add_(0, ids, pt_feats * valid_f[:, None].to(
            pt_feats.dtype))[:num_voxels]
        return sums * (1.0 / counts.clamp(min=1.0))[:, None]
    out = sorted_segment_weighted_sum(*voxmean_stream(pt_feats, pt_valid, plan),
                                      num_voxels,
                                      precise=compute_dtype == torch.float32)
    sums, counts = out[:, :-1], out[:, -1]
    return sums * (1.0 / counts.clamp(min=1.0))[:, None]


def voxmean_stream(pt_feats, pt_valid, plan):
    """K3's inputs for ``voxelize_mean``: the values ``[feats, 1]`` and the
    validity weights in Morton-sorted point order, and the sorted ids."""
    valid_f = pt_valid.float()
    ones = valid_f.new_ones((pt_feats.shape[0], 1))
    perm = plan.sort_perm.long()
    g_s = pad_row(torch.cat([pt_feats.float(), ones], 1))[perm].contiguous()
    w_s = pad_row(valid_f[:, None])[perm].contiguous()
    return g_s, w_s, plan.ids_sorted.contiguous()


def devoxelize_trilinear(vox_feats, corner_idx, corner_w):
    """Trilinear voxel->point interpolation: [V, C] -> [N, C] float32.

    ``corner_w`` takes the dtype of ``vox_feats`` (as in the JAX package);
    products and the 8-corner sum are f32.
    """
    g = pad_row(vox_feats)[corner_idx.long()]                   # [N, 8, C]
    wk = corner_w.to(vox_feats.dtype).float().unsqueeze(1)      # [N, 1, 8]
    return torch.bmm(wk, g.float()).squeeze(1)


def gather_rows(feats, idx):
    """Gather with a zero pad row (sentinel index = len(feats))."""
    return pad_row(feats)[idx.long()]
