"""Sparse convolution and point<->voxel ops, forward and backward (torch).

Port of ``fusiontransformer_tpu/ops/sparse_conv.py``.  Every op reads
through a zero pad row at index ``V``, so sentinel indices contribute zeros.

* ``subm_conv3`` — ks=3 stride=1.  At a level that carries slot maps it
  runs hand-written kernels: ``binned_conv_slots_fwd`` (K1') and, for its
  gradient, ``binned_conv_slots_bwd`` (K2') on the device-built per-voxel
  K-slot maps; ``binned_conv_grouped_fwd`` (K1) and
  ``binned_conv_grouped_bwd`` (K2) on host-built group-pooled maps.  A level
  without maps runs the dense 27-tap gather + one GEMM.
* ``down_conv2`` / ``up_conv2`` / ``conv1x1`` — gather + GEMM.
* ``voxelize_mean`` — the sums and counts come from the hand-written kernel
  ``sorted_segment_weighted_sum`` (K3) over the level's ``DevoxPlan``.
* ``devoxelize_trilinear`` — 8-corner gather + weighted sum; its gradient
  runs K3 with E=8 over the plan's sorted point stream.

Gradients follow the JAX package's custom VJPs: each is a
``torch.autograd.Function`` whose backward is a gather (through the mirror
ks3 map, the adjoint ks2 map, or the sorted point stream), never autograd's
``index_put_(accumulate=True)`` scatter, whose float atomics are neither
deterministic nor fast.

Routing differs from the JAX package's TPU routing on purpose.  There a
slot-map conv takes the Pallas kernel only for ``16 <= Cin`` and
``max(Cin, Cout) <= 128`` (``_PALLAS_MIN_CIN`` / ``_PALLAS_MAX_CH``, TPU VMEM
limits), per-voxel maps also only for ``8K % 128 == 0`` (TPU lanes), and the
dense path otherwise; ``TPU.CONV_PALLAS`` switches the per-voxel maps
between the Pallas kernel and the XLA formulation.  Here every ks=3 conv at
a level with maps (L0-L3 of the flagship) runs its kernel pair, whatever its
widths and K, and L4, which has no maps, runs the dense path;
``TPU.CONV_PALLAS`` has no meaning.  With lossless maps every route
computes the same function; only the arithmetic differs.  With per-voxel
maps that drop live taps (``tap_overflow`` > 0) the route decides the
function: the port computes what the JAX package computes on the CPU
(``_subm3s``, K taps per voxel, and its mirrored backward), where the TPU
route would run dense, lossless, convs at the wide levels.

Precision: ``compute_dtype`` float32 means true f32 (TF32 stays off).  With
bfloat16 the operands are rounded to bf16 and every product is accumulated
and returned in f32, as the JAX package's ``preferred_element_type`` does:
no GEMM output is rounded to bf16.  The kernels' outputs are f32.  As in the
JAX VJPs, each backward rounds the incoming gradient to the compute dtype,
returns the input's gradient in the input's dtype and the weight's in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
    binned_conv_grouped_bwd, binned_conv_grouped_fwd, binned_conv_slots_bwd,
    binned_conv_slots_fwd)
from fusiontransformer_tpu_torch.ops.kernels.segment_sum import (
    sorted_segment_weighted_sum)
from fusiontransformer_tpu_torch.utils.device import device_constant


def cdt_matmul(a, b, cdt):
    """a @ b with operands rounded to ``cdt``, accumulated and returned in
    float32.  ``b`` is [K, N] or has ``a``'s batch dims.

    On a CUDA tensor a bf16 product runs on the tensor cores with an f32
    output (``out_dtype``); elsewhere the rounded operands are multiplied
    in f32, which gives the same products."""
    a, b = a.to(cdt), b.to(cdt)
    if cdt == torch.float32 or a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    return _MatmulF32Out.apply(a, b)


def _mm_f32(a, b):
    """a @ b of low-precision operands with an f32 output (tensor cores)."""
    f32 = torch.float32
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=f32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                    b.reshape(-1, *b.shape[-2:]), out_dtype=f32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _MatmulF32Out(torch.autograd.Function):
    """The card's bf16 GEMM with an f32 output, which autograd cannot
    differentiate (``out_dtype``).  The gradient of each operand is the
    GEMM of the incoming gradient, rounded to the operands' dtype, with the
    other operand, returned in the operand's dtype: the rounding a TPU's
    default-precision dot applies."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = _mm_f32(g, b.transpose(-1, -2)).to(a.dtype)
        if b.dim() == 2:
            gb = _mm_f32(a.reshape(-1, a.shape[-1]).t(),
                         g.reshape(-1, g.shape[-1]))
        else:
            gb = _mm_f32(a.transpose(-1, -2), g).reshape(b.shape)
        return ga, gb.to(b.dtype)


def pad_row(feats):
    """Append one zero row so sentinel index V gathers zeros."""
    return torch.cat([feats, feats.new_zeros((1,) + tuple(feats.shape[1:]))])


def _tap_weight_grad(x, g, cdt):
    """dW[k] = x^T @ g[:, k] for x [V, Cin], g [V, K, Cout] -> [K, Cin, Cout]
    f32 (one GEMM over the flattened tap axis)."""
    v, k, cout = g.shape
    return cdt_matmul(x.t(), g.reshape(v, k * cout), cdt).reshape(
        x.shape[1], k, cout).transpose(0, 1)


class _Subm3Dense(torch.autograd.Function):
    """Dense ks3: out[u] = sum_t x[nbr(u, t)] @ W[t].

    Column 13 of nbr_idx is the voxel itself where it is valid and the
    sentinel at padded rows, so the center tap's term is masked by the same
    gather (the JAX package splits it off with ``_self_mask``; same
    function).  Backward (``_subm3_bwd``): by mirror symmetry the one gather
    gd[u, t] = dout[nbr(u, t)] serves dX[u] = sum_t gd[u, t] @ W[26-t]^T and
    dW[26-t] = x^T @ gd[:, t]."""

    @staticmethod
    def forward(ctx, feats, w, nbr_idx, cdt):
        v, cin = feats.shape
        g = pad_row(feats.to(cdt))[nbr_idx.long()]              # [V, 27, Cin]
        ctx.save_for_backward(feats, w, nbr_idx)
        ctx.cdt = cdt
        return cdt_matmul(g.reshape(v, 27 * cin), w.reshape(27 * cin, -1),
                          cdt)

    @staticmethod
    def backward(ctx, dout):
        feats, w, nbr_idx = ctx.saved_tensors
        cdt = ctx.cdt
        v, cin = feats.shape
        cout = w.shape[2]
        gd = pad_row(dout.to(cdt))[nbr_idx.long()]              # [V, 27, Cout]
        wrev = w.flip(0).transpose(1, 2).reshape(27 * cout, cin)
        dx = cdt_matmul(gd.reshape(v, 27 * cout), wrev, cdt)
        dw = _tap_weight_grad(feats.to(cdt), gd, cdt).flip(0)
        return dx.to(feats.dtype), dw.to(w.dtype), None, None


def _binned_fwd(ctx, kernel, feats, w, src, codes, cdt):
    """A slot-map ks3 forward kernel on ``cdt`` operands, kept for the
    backward."""
    fc = feats.to(cdt).contiguous()
    wc = w.to(cdt).contiguous()
    ctx.save_for_backward(fc, wc, src, codes)
    ctx.dtypes = (feats.dtype, w.dtype)
    return kernel(fc, src, codes, wc)


def _binned_bwd(ctx, kernel, dout):
    fc, wc, src, codes = ctx.saved_tensors
    dx, dw = kernel(dout.to(fc.dtype).contiguous(), fc, src, codes, wc)
    return dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1]), None, None, None


class _Subm3Grouped(torch.autograd.Function):
    """Group-pooled-map ks3: K1 forward, K2 backward (``_subm3gp``)."""

    @staticmethod
    def forward(ctx, feats, w, src, binp, cdt):
        return _binned_fwd(ctx, binned_conv_grouped_fwd, feats, w, src, binp,
                           cdt)

    @staticmethod
    def backward(ctx, dout):
        return _binned_bwd(ctx, binned_conv_grouped_bwd, dout)


class _Subm3Slots(torch.autograd.Function):
    """Per-voxel K-slot-map ks3: K1' forward, K2' backward (``_subm3p``;
    under tap overflow the backward is JAX's, see
    ``binned_conv_slots_bwd_ref``)."""

    @staticmethod
    def forward(ctx, feats, w, src, tap, cdt):
        return _binned_fwd(ctx, binned_conv_slots_fwd, feats, w, src, tap, cdt)

    @staticmethod
    def backward(ctx, dout):
        return _binned_bwd(ctx, binned_conv_slots_bwd, dout)


def subm_conv3(feats, w, nbr_idx, compute_dtype=torch.bfloat16,
               slot_idx=None):
    """ks=3 stride=1 sparse conv.

    Args:
      feats: [V, Cin].
      w: [27, Cin, Cout] kernel (x-slowest tap order).
      nbr_idx: [V, 27] int32 ks3 map (sentinel V).
      slot_idx: optional slot maps, routed on their shape: per-voxel
        (src [V, K], tap [V, K]) run K1' and, for the gradient, K2';
        group-pooled (src_pack [V/8, S], bin_pack [V/8, S]) run K1 and K2.
    Returns:
      [V, Cout] float32.
    """
    if slot_idx is None:
        return _Subm3Dense.apply(feats, w, nbr_idx, compute_dtype)
    src, codes = slot_idx
    fn = _Subm3Slots if src.shape[0] == feats.shape[0] else _Subm3Grouped
    return fn.apply(feats, w, src, codes, compute_dtype)


class _Down2(torch.autograd.Function):
    """ks2 stride-2 down conv; its adjoint is the up conv's gather pattern
    (``_down2_bwd``): dX[u] = dout[parent(u)] @ W[kidx(u)]^T,
    dW[k] = sum_{u: kidx(u) = k} x[u] (x) dout[parent(u)]."""

    @staticmethod
    def forward(ctx, feats_fine, w, child_idx, parent_idx, child_kidx, cdt):
        ctx.save_for_backward(feats_fine, w, parent_idx, child_kidx)
        ctx.cdt = cdt
        vc, cin = child_idx.shape[0], feats_fine.shape[1]
        g = pad_row(feats_fine.to(cdt))[child_idx.long()]       # [Vc, 8, Cin]
        return cdt_matmul(g.reshape(vc, 8 * cin), w.reshape(8 * cin, -1),
                          cdt)

    @staticmethod
    def backward(ctx, dout):
        feats_fine, w, parent_idx, child_kidx = ctx.saved_tensors
        cdt = ctx.cdt
        vf, cin = feats_fine.shape
        cout = w.shape[2]
        p = pad_row(dout.to(cdt))[parent_idx.long()]             # [Vf, Cout]
        kidx = child_kidx.long()
        # All 8 offsets' products, then each fine voxel picks its own.
        y = cdt_matmul(p, w.permute(2, 0, 1).reshape(cout, 8 * cin), cdt)
        dx = y.reshape(vf, 8, cin)[torch.arange(vf, device=y.device), kidx]
        p8 = p.new_zeros((vf, 8, cout))
        p8[torch.arange(vf, device=p.device), kidx] = p
        dw = _tap_weight_grad(feats_fine.to(cdt), p8, cdt)
        return (dx.to(feats_fine.dtype), dw.to(w.dtype), None, None, None,
                None)


class _Up2(torch.autograd.Function):
    """ks2 stride-2 transposed conv, out[v] = x[parent(v)] @ W[kidx(v)];
    its adjoint is the down conv's gather pattern (``_up2_bwd``):
    dX[p] = sum_k dout[child(p, k)] @ W[k]^T, dW[k] = x^T @ dout[child(:, k)].
    """

    @staticmethod
    def forward(ctx, feats_coarse, w, parent_idx, child_kidx, child_idx,
                cdt):
        ctx.save_for_backward(feats_coarse, w, child_idx)
        ctx.cdt = cdt
        # All 8 offset products at the coarse level (one GEMM); each fine
        # voxel picks its (parent, offset) row; sentinel parents read the
        # zero pad row.
        cin, cout = w.shape[1], w.shape[2]
        wcat = w.permute(1, 0, 2).reshape(cin, 8 * cout)
        y = cdt_matmul(pad_row(feats_coarse), wcat, cdt).reshape(-1, 8, cout)
        return y[parent_idx.long(), child_kidx.long()]

    @staticmethod
    def backward(ctx, dout):
        feats_coarse, w, child_idx = ctx.saved_tensors
        cdt = ctx.cdt
        vc, cin = feats_coarse.shape
        cout = w.shape[2]
        gd = pad_row(dout.to(cdt))[child_idx.long()]            # [Vc, 8, Cout]
        dx = cdt_matmul(gd.reshape(vc, 8 * cout),
                        w.transpose(1, 2).reshape(8 * cout, cin), cdt)
        dw = _tap_weight_grad(feats_coarse.to(cdt), gd, cdt)
        return (dx.to(feats_coarse.dtype), dw.to(w.dtype), None, None, None,
                None)


def down_conv2(feats_fine, w, child_idx, parent_idx, child_kidx,
               compute_dtype=torch.bfloat16):
    """ks=2 stride=2 conv: [Vf, Cin] at level l -> [Vc, Cout] at level l+1
    through ``child_idx`` [Vc, 8] (sentinel Vf); level l's ``parent_idx`` /
    ``child_kidx`` give the scatter-free adjoint gather of its gradient."""
    return _Down2.apply(feats_fine, w, child_idx, parent_idx, child_kidx,
                        compute_dtype)


def up_conv2(feats_coarse, w, parent_idx, child_kidx, child_idx,
             compute_dtype=torch.bfloat16):
    """ks=2 stride=2 transposed conv: out[v] = fc[parent(v)] @ w[kidx(v)];
    level l+1's ``child_idx`` [Vc, 8] gives the scatter-free adjoint gather
    of its gradient."""
    return _Up2.apply(feats_coarse, w, parent_idx, child_kidx, child_idx,
                      compute_dtype)


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
                     lvl.nbr_idx[:, device_constant(
                         "sparse_conv.neg_corner_taps", _NEG_CORNER_TAPS,
                         lvl.nbr_idx.device)])


class _VoxMeanSum(torch.autograd.Function):
    """[V, C+1]: K3's sums of the valid points' features per voxel plus a
    trailing count column (``_voxmean_sum``).  The gradient of a masked
    segment sum is a gather in original point order:
    d pt_feats[n] = valid[n] * dout[vox(n)]; the count column is constant."""

    @staticmethod
    def forward(ctx, pt_feats, pt_valid, ids_orig, plan, num_voxels,
                precise):
        ctx.save_for_backward(pt_valid, ids_orig)
        ctx.num_voxels = num_voxels
        ctx.feats_dtype = pt_feats.dtype
        return sorted_segment_weighted_sum(
            *voxmean_stream(pt_feats, pt_valid, plan), num_voxels,
            precise=precise)

    @staticmethod
    def backward(ctx, dout):
        pt_valid, ids_orig = ctx.saved_tensors
        ids = ids_orig.long().clamp(max=ctx.num_voxels)
        dpt = pad_row(dout[:, :-1])[ids] * pt_valid[:, None].to(dout.dtype)
        return dpt.to(ctx.feats_dtype), None, None, None, None, None


def voxelize_mean(pt_feats, pt_voxel_idx, pt_valid, num_voxels, plan,
                  compute_dtype=torch.bfloat16):
    """Average-pool point features into their containing voxels.

    The sums, and the point counts as a trailing ones column, come from one
    K3 launch over the ``DevoxPlan``'s sorted point stream;
    ``compute_dtype`` float32 keeps its per-point products un-rounded.
    Voxels no point reaches come back 0.  The counts carry no gradient.
    """
    ids_orig = torch.where(pt_valid, pt_voxel_idx, num_voxels)
    out = _VoxMeanSum.apply(pt_feats, pt_valid, ids_orig, plan, num_voxels,
                            compute_dtype == torch.float32)
    sums, counts = out[:, :-1], out[:, -1].detach()
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


def devox_adjoint_stream(dout, corner_w, plan):
    """K3's inputs for the devoxelize adjoint: dout [N, C] and the corner
    weights [N, 8] in Morton-sorted point order, and the sorted ids."""
    perm = plan.sort_perm.long()
    g_s = pad_row(dout.float())[perm].contiguous()
    w_s = pad_row(corner_w.float())[perm].contiguous()
    return g_s, w_s, plan.ids_sorted.contiguous()


class _Devox3(torch.autograd.Function):
    """Trilinear devoxelize whose gradient is scatter-free (``_devox3``):
    the adjoint scatter dvox[corner(n, e)] += w[n, e] * dout[n] becomes K3
    with E=8 over the sorted point stream, T[u, e] = sum_{n in u} w[n, e] *
    dout[n], then 8 mirror gathers dvox[u] = sum_e T[nbr(u, -e), e] (the
    voxel whose corner e is u is u's neighbor at offset -e).  The corner
    weights come from integer coords: their gradient is dead (None)."""

    @staticmethod
    def forward(ctx, vox_feats, corner_idx, corner_w, plan, precise):
        ctx.save_for_backward(corner_w, plan.sort_perm, plan.ids_sorted,
                              plan.nbr_neg)
        ctx.precise = precise
        ctx.vox_shape = tuple(vox_feats.shape)
        ctx.vox_dtype = vox_feats.dtype
        g = pad_row(vox_feats)[corner_idx.long()]               # [N, 8, C]
        wk = corner_w.to(vox_feats.dtype).float().unsqueeze(1)  # [N, 1, 8]
        return torch.bmm(wk, g.float()).squeeze(1)

    @staticmethod
    def backward(ctx, dout):
        corner_w, sort_perm, ids_sorted, nbr_neg = ctx.saved_tensors
        v, c = ctx.vox_shape
        plan = DevoxPlan(sort_perm, ids_sorted, nbr_neg)
        t = sorted_segment_weighted_sum(
            *devox_adjoint_stream(dout, corner_w, plan), v,
            precise=ctx.precise)                                  # [V, 8C]
        # Sentinel neighbours read the zero pad row.
        flat = torch.where(
            nbr_neg < v, nbr_neg.long() * 8 + torch.arange(8, device=t.device),
            v * 8)
        g8 = pad_row(t.reshape(v * 8, c))[flat]                  # [V, 8, C]
        return g8.sum(1).to(ctx.vox_dtype), None, None, None, None


def devoxelize_trilinear(vox_feats, corner_idx, corner_w, plan,
                         compute_dtype=torch.bfloat16):
    """Trilinear voxel->point interpolation: [V, C] -> [N, C] float32.

    ``corner_w`` takes the dtype of ``vox_feats`` (as in the JAX package);
    products and the 8-corner sum are f32.  The gradient runs K3 with E=8
    over the ``DevoxPlan``'s sorted stream (``compute_dtype`` float32 keeps
    its products un-rounded).
    """
    return _Devox3.apply(vox_feats, corner_idx, corner_w, plan,
                         compute_dtype == torch.float32)


def gather_rows(feats, idx):
    """Gather with a zero pad row (sentinel index = len(feats)); see
    ``index_rows``."""
    return index_rows(pad_row(feats), idx)


class _IndexRows(torch.autograd.Function):
    """``table.index_select(0, idx)`` with a gradient that is bitwise
    repeatable on the card too.  ``index_select``'s own gradient
    (``index_add_``) adds the rows that meet at one index with float atomics
    there, in whatever order they land, and ``index_put_`` with
    ``accumulate`` adds each index's rows one after another in one warp
    (slow where thousands of rows meet at one index, as at the image lift).
    Here the indices are sorted (stably) and each row's gradient is the sum
    of its segment (``torch.segment_reduce``), in f32, in index order: on
    the CPU the same bits as ``index_add_``."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        order = torch.sort(idx, stable=True)[1]
        lengths = torch.zeros(ctx.rows, dtype=torch.int64,
                              device=idx.device).index_add_(
                                  0, idx, torch.ones_like(idx))
        dtable = torch.segment_reduce(
            g.float().index_select(0, order), "sum", lengths=lengths,
            axis=0, unsafe=True, initial=0.0)
        return dtable.to(g.dtype), None


def index_rows(table, idx):
    """``table[idx]`` for an integer ``idx`` of any shape (``_IndexRows``)."""
    out = _IndexRows.apply(table, idx.reshape(-1).long())
    return out.reshape(*idx.shape, *table.shape[1:])
