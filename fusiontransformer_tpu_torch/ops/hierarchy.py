"""Static-shape voxel hierarchy and kernel maps (torch).

Port of ``fusiontransformer_tpu/ops/hierarchy.py``; every index map is
bit-exact with it.  One stable sort of the input voxels orders every level
(Morton ``key >> 3`` is the parent and keeps the order), each coarser level
is an adjacent-compare cumsum of the previous one, the ks=3 map is searched
only at the top level and derived for every finer level by the parent-brick
descent, and the trilinear corner maps are column picks of the ks=3 maps.

The JAX package does the descent's two selects as one-hot float32 matmuls,
because a TPU element gather is slow; here they are plain ``torch.gather``s
through static per-octant index tables (each select column has exactly one
source column, so the two are the same map).

Everything is fixed-capacity: each level has a static ``cap``; overflow
voxels are dropped and counted in ``nvalid_raw``.  Index maps use the target
level's ``cap`` as the "missing" sentinel, so gathers read a zero pad row.

Kernel offset conventions (x-slowest, as in the JAX package):
* ks=3: k = (dx+1)*9 + (dy+1)*3 + (dz+1), offsets in {-1,0,1};
* ks=2: k = bx*4 + by*2 + bz, where (bx,by,bz) = child coord & 1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fusiontransformer_tpu_torch.ops import keys as K


class Level(NamedTuple):
    """One resolution level (fields as in the JAX package's ``Level``)."""

    key_hi: torch.Tensor          # [V] int32 sorted unique keys
    key_lo: torch.Tensor          # [V] int32
    coords: torch.Tensor          # [V, 3] int32 coords in level units
    batch: torch.Tensor           # [V] int32 scan index
    valid: torch.Tensor           # [V] bool
    nvalid: torch.Tensor          # [] int32 live voxels (<= cap)
    nvalid_raw: torch.Tensor      # [] int32 unique count before the clamp
    nbr_idx: torch.Tensor         # [V, 27] int32 ks3 stride-1 kernel map
    child_idx: Optional[torch.Tensor]   # [V, 8] int32 into level l-1
    parent_idx: Optional[torch.Tensor]  # [V] int32 into level l+1
    child_kidx: Optional[torch.Tensor]  # [V] int32 in [0, 8)
    # Group-pooled slot maps (src_pack [V/8, S], bin_pack [V/8, S]) attached
    # by ``attach_grouped_slots``, or None (dense ks3 path).
    slot_idx: Optional[tuple] = None


class Hierarchy(NamedTuple):
    levels: Tuple[Level, ...]
    pt_sorted_pos: torch.Tensor   # [N] int32 position of each point in level 0
    vox0_point_idx: torch.Tensor  # [cap0] int32 point per level-0 slot (sentinel N)
    pt_valid: torch.Tensor        # [N] bool
    pt_corner_idx: Tuple[Optional[torch.Tensor], ...]  # each [N, 8] int32
    pt_corner_w: Tuple[Optional[torch.Tensor], ...]    # each [N, 8] float32
    pt_voxel_idx: Tuple[Optional[torch.Tensor], ...]   # each [N] int32


_KS3_OFFSETS = [(dx, dy, dz)
                for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
_KS2_OFFSETS = [(bx, by, bz)
                for bx in (0, 1) for by in (0, 1) for bz in (0, 1)]


def _nbr_descent_tables():
    """Per-octant gather tables for the ks3 descent.

    ``colsel[o, j]``: column of the parent's 27-entry row that holds
    reachable parent brick j (j in {0,1}^3 around ``(c >> 1) + s - 1``).
    ``sel64[o, k]``: position (brick j3 * 8 + child slot t3) of tap k's
    neighbour in the [8 bricks x 8 children] block.
    """
    colsel = np.zeros((8, 8), np.int64)
    sel64 = np.zeros((8, 27), np.int64)
    for o in range(8):
        s = ((o >> 2) & 1, (o >> 1) & 1, o & 1)
        for j in range(8):
            jb = ((j >> 2) & 1, (j >> 1) & 1, j & 1)
            e = [s[i] - 1 + jb[i] for i in range(3)]
            colsel[o, j] = (e[0] + 1) * 9 + (e[1] + 1) * 3 + (e[2] + 1)
        for k, (dx, dy, dz) in enumerate(_KS3_OFFSETS):
            j3 = t3 = 0
            for i, d in enumerate((dx, dy, dz)):
                e = (s[i] + d) >> 1
                t = (s[i] + d) & 1
                j3 = j3 * 2 + (e - (s[i] - 1))
                t3 = t3 * 2 + t
            sel64[o, k] = j3 * 8 + t3
    return colsel, sel64


_NBR_COLSEL, _NBR_SEL64 = _nbr_descent_tables()
# Per-level corners: ks3 columns for the per-dim offsets {0, +1}.
_CORNER_TOP_COLS = [(bx + 1) * 9 + (by + 1) * 3 + (bz + 1)
                    for (bx, by, bz) in _KS2_OFFSETS]


def _select(rows, table, which):
    """out[v, j] = rows[v, table[which[v], j]] (exact integer select)."""
    idx = torch.as_tensor(table, device=rows.device)[which.long()]
    return torch.gather(rows, 1, idx)


def _pad_rows(arr, fill):
    """Append one row filled with ``fill`` (sentinel target for gathers)."""
    return torch.cat([arr, arr.new_full((1,) + tuple(arr.shape[1:]), fill)])


def _nbr_queries(level: Level, coord_limit: int):
    """Query keys for the 26 non-center ks=3 offsets: ([V, 26], [V, 26])."""
    q_hi, q_lo = [], []
    for (dx, dy, dz) in _KS3_OFFSETS:
        if (dx, dy, dz) == (0, 0, 0):
            continue
        qc = level.coords + torch.tensor([dx, dy, dz], dtype=torch.int32,
                                         device=level.coords.device)
        in_bounds = ((qc >= 0) & (qc < coord_limit)).all(dim=-1)
        hi, lo = K.pack_keys(level.batch, qc, level.valid & in_bounds)
        q_hi.append(hi)
        q_lo.append(lo)
    return torch.stack(q_hi, 1), torch.stack(q_lo, 1)


def _nbr_from_26(level: Level, nbr26):
    v = level.key_hi.shape[0]
    ar = torch.arange(v, dtype=torch.int32, device=nbr26.device)
    self_idx = torch.where(level.valid, ar, torch.full_like(ar, v))[:, None]
    return torch.cat([nbr26[:, :13], self_idx, nbr26[:, 13:]], dim=1)


def _corner_weights(points, lshift: int):
    """Raw trilinear weights from the in-voxel fractional position."""
    frac = (points & ((1 << lshift) - 1)).to(torch.float32) / float(1 << lshift)
    w = []
    for (bx, by, bz) in _KS2_OFFSETS:
        wx = frac[:, 0] if bx else (1.0 - frac[:, 0])
        wy = frac[:, 1] if by else (1.0 - frac[:, 1])
        wz = frac[:, 2] if bz else (1.0 - frac[:, 2])
        w.append(wx * wy * wz)
    return torch.stack(w, dim=1)


def _scatter_set(size, fill, pos, values):
    """``full(size, fill).at[pos].set(values, mode="drop")`` over dim 0:
    positions equal to ``size[0]`` land in a dropped dump row."""
    buf = values.new_full((size[0] + 1,) + tuple(size[1:]), fill)
    buf[pos.long()] = values
    return buf[:size[0]]


FULL_SCALE_LOG2 = 12        # voxel coords lie in [0, 4096)
POINT_LEVELS = (0, 2, 4)    # levels the model maps points to and from


def build_hierarchy(coords, batch_idx, valid,
                    level_caps: Tuple[int, ...]) -> Hierarchy:
    """Build the voxel hierarchy and every kernel map for one batch.

    Args:
      coords: [N, 3] int32 voxel coords in [0, 2**FULL_SCALE_LOG2), unique
        per scan.
      batch_idx: [N] int32 scan index.
      valid: [N] bool mask for padding.
      level_caps: static per-level voxel capacities (level 0 may be < N).

    Point<->voxel maps are built at ``POINT_LEVELS``.
    """
    dev = coords.device
    n = coords.shape[0]
    num_levels = len(level_caps)
    cap0 = level_caps[0]
    if cap0 > n:
        raise ValueError("level-0 capacity cannot exceed the point capacity")
    i32 = dict(dtype=torch.int32, device=dev)

    # ----- level 0: sort the input voxels (invalid keys sort to the tail)
    hi, lo = K.pack_keys(batch_idx, coords, valid)
    hi_s, lo_s, perm = K.sort_by_key(hi, lo, torch.arange(n, **i32))
    nvalid_raw0 = (hi_s != K.INVALID_KEY).sum(dtype=torch.int32)
    hi_s, lo_s, perm = hi_s[:cap0], lo_s[:cap0], perm[:cap0]
    b_s, c_s = K.unpack_keys(hi_s, lo_s)
    valid_s = hi_s != K.INVALID_KEY
    levels = [Level(
        key_hi=hi_s, key_lo=lo_s,
        coords=torch.where(valid_s[:, None], c_s, 0),
        batch=torch.where(valid_s, b_s, 0),
        valid=valid_s, nvalid=valid_s.sum(dtype=torch.int32),
        nvalid_raw=nvalid_raw0,
        nbr_idx=None, child_idx=None, parent_idx=None, child_kidx=None)]

    pt_sorted_pos = torch.full((n,), cap0, **i32)
    pt_sorted_pos[perm.long()] = torch.arange(cap0, **i32)
    pt_sorted_pos = torch.where(valid, pt_sorted_pos, cap0)
    vox0_point_idx = torch.where(valid_s, perm, n).to(torch.int32)

    # ----- levels 1..L: Morton shift + cumsum-unique (no re-sort)
    parent_links = []
    for l in range(1, num_levels):
        prev = levels[l - 1]
        cap, cap_prev = level_caps[l], level_caps[l - 1]
        phi, plo = K.parent_keys(prev.key_hi, prev.key_lo, prev.valid)
        is_first, position, nuniq = K.unique_sorted(phi, plo)
        in_cap = position < cap
        parent_idx = torch.where(prev.valid & in_cap, position, cap).to(
            torch.int32)
        child_kidx = prev.key_lo & 7     # the child's octant = ks2 offset
        parent_links.append((parent_idx, child_kidx))

        scatter_pos = torch.where(is_first & in_cap, position, cap)
        key_hi = _scatter_set((cap,), K.INVALID_KEY, scatter_pos, phi)
        key_lo = _scatter_set((cap,), K.INVALID_KEY, scatter_pos, plo)
        b_l, c_l = K.unpack_keys(key_hi, key_lo)
        valid_l = key_hi != K.INVALID_KEY
        child_idx = torch.full((cap + 1, 8), cap_prev, **i32)
        child_idx[parent_idx.long(), child_kidx.long()] = torch.arange(
            cap_prev, **i32)
        levels.append(Level(
            key_hi=key_hi, key_lo=key_lo,
            coords=torch.where(valid_l[:, None], c_l, 0),
            batch=torch.where(valid_l, b_l, 0),
            valid=valid_l,
            nvalid=torch.clamp(nuniq, max=cap),
            nvalid_raw=nuniq,
            nbr_idx=None, child_idx=child_idx[:cap],
            parent_idx=None, child_kidx=None))

    # ----- kernel maps: one join at the top + search-free descent
    top_l = num_levels - 1
    top = levels[top_l]
    nq_hi, nq_lo = _nbr_queries(top, 1 << (FULL_SCALE_LOG2 - top_l))
    nbr26 = K.sorted_join(top.key_hi, top.key_lo, nq_hi, nq_lo)
    nbr_by_level = [None] * num_levels
    nbr_by_level[top_l] = _nbr_from_26(top, nbr26)
    for l in range(top_l - 1, -1, -1):
        cap, cap_next = level_caps[l], level_caps[l + 1]
        p_idx, c_kidx = parent_links[l]
        pnbr = _pad_rows(nbr_by_level[l + 1], cap_next)[p_idx.long()]  # [V, 27]
        brick8 = _select(pnbr, _NBR_COLSEL, c_kidx)                    # [V, 8]
        child2d = _pad_rows(levels[l + 1].child_idx, cap)
        childs = child2d[brick8.long()]                                # [V, 8, 8]
        nbr_by_level[l] = _select(childs.reshape(-1, 64), _NBR_SEL64, c_kidx)

    out_levels = []
    for l in range(num_levels):
        p_idx, c_kidx = parent_links[l] if l < top_l else (None, None)
        out_levels.append(levels[l]._replace(
            nbr_idx=nbr_by_level[l], parent_idx=p_idx, child_kidx=c_kidx))

    # ----- point->voxel containment + trilinear corner maps
    pt_corner_idx = [None] * num_levels
    pt_corner_w = [None] * num_levels
    pt_voxel_idx = [None] * num_levels
    if 0 in POINT_LEVELS:
        pt_voxel_idx[0] = pt_sorted_pos
    need_pt = sorted(l for l in POINT_LEVELS if l > 0)
    if need_pt:
        anc = {0: pt_sorted_pos}
        for l in range(top_l):
            p_idx, _ = parent_links[l]
            anc[l + 1] = _pad_rows(p_idx, level_caps[l + 1])[anc[l].long()]
        for l in need_pt:
            cap = level_caps[l]
            nbr8 = nbr_by_level[l][:, _CORNER_TOP_COLS]
            idx8 = _pad_rows(nbr8, cap)[anc[l].long()]                # [N, 8]
            idx8 = torch.where(valid[:, None], idx8, cap)
            w8 = _corner_weights(coords.to(torch.int32), l)
            w8 = torch.where(idx8 == cap, 0.0, w8)
            # Renormalized over the present corners (torchsparse
            # ``calc_ti_weights``).
            w8 = w8 / (w8.sum(dim=1, keepdim=True) + 1e-8)
            pt_corner_idx[l] = idx8
            pt_corner_w[l] = w8
            pt_voxel_idx[l] = torch.where(valid, idx8[:, 0], cap)

    return Hierarchy(
        levels=tuple(out_levels),
        pt_sorted_pos=pt_sorted_pos,
        vox0_point_idx=vox0_point_idx,
        pt_valid=valid,
        pt_corner_idx=tuple(pt_corner_idx),
        pt_corner_w=tuple(pt_corner_w),
        pt_voxel_idx=tuple(pt_voxel_idx),
    )


def attach_grouped_slots(hier: Hierarchy, batch) -> Hierarchy:
    """Attach host-built group-pooled slot maps (``gslot_src_{l}`` /
    ``gslot_bin_{l}`` in ``batch``) to the levels that have them."""
    levels = list(hier.levels)
    for l in range(len(levels)):
        if f"gslot_src_{l}" in batch:
            levels[l] = levels[l]._replace(slot_idx=(
                batch[f"gslot_src_{l}"], batch[f"gslot_bin_{l}"]))
    return hier._replace(levels=tuple(levels))
