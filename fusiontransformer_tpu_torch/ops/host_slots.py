"""Host-built group-pooled conv slot maps (built per batch on the host).

A copy of ``fusiontransformer_tpu/ops/host_slots.py``: ``scan_slot_triples``
joins each level's ks3 neighbours in the port's native C++
(``native.slot_triples``), as the JAX package does in its own;
``scan_slot_triples_ref`` is the vectorized numpy ``searchsorted`` join, the
plain reference.  Both emit the triples voxel-major with taps ascending, so
the assembled maps are equal slot for slot.

The ks3 conv kernel (K1, ``ops/kernels/binned_conv.py``) works on groups of
8 consecutive Morton-order voxels.  Pooling the live neighbor slots of each
group (rather than giving every voxel a fixed number of slots) is exact and
leaves few empty slots, because a group's live-tap sum varies far less than
one voxel's live-tap count.

Produces, per level, pre-packed maps for ``sparse_conv.subm_conv3``'s
grouped path:

* ``src_pack [cap/8, S]`` int32 — source voxel row per slot (sentinel =
  level cap, the zero pad row);
* ``bin_pack [cap/8, S]`` int32 — destination bin id ``tap*8 +
  voxel_in_group`` (sentinel 216).

Index-space contract: identical to the device hierarchy
(``ops.hierarchy.build_hierarchy``).  Voxels sort by (scan, Morton) —
scan-major — so the batch level array is the concatenation of per-scan
Morton-ordered levels; per-scan triples assemble with scan offsets
(cumsum of per-scan level counts), and groups may span scan boundaries
(bin ids are scan-agnostic).  The level capacities must be those of
``modules.steps.level_caps_for_n`` for the same point buffer; both call
``caps_from_fractions``.
"""

from __future__ import annotations

import numpy as np

from fusiontransformer_tpu_torch import native

FULL_SCALE_LOG2 = 12          # voxel coords lie in [0, 4096)
POOL_FLOOR, POOL_CEIL = 32, 216

_OFFS = np.array([(dx, dy, dz)
                  for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dz in (-1, 0, 1)], np.int64)


def _part1by2(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton36(c):
    """[n] int64 36-bit Morton code of [n, 3] coords in [0, 4096)
    (bit 3i+2 <- x_i, 3i+1 <- y_i, 3i <- z_i, matching ops.keys)."""
    c = c.astype(np.int64)
    x, y, z = c[:, 0], c[:, 1], c[:, 2]
    lo = (_part1by2(x) << 2) | (_part1by2(y) << 1) | _part1by2(z)

    def high(v):
        return (((v >> 10) & 1) << 30) | (((v >> 11) & 1) << 33)

    return (high(x) << 2) | (high(y) << 1) | high(z) | lo


def scan_levels(coords, num_levels):
    """Per-level Morton-sorted unique voxels of ONE scan.

    Returns a list of dicts ``{"key": [n_l] int64 Morton keys, "level": l}``
    — the scan's slice of each device hierarchy level, in the device's
    order.
    """
    out = []
    c = np.asarray(coords, np.int64)
    key0 = np.sort(morton36(c))
    out.append({"key": key0, "level": 0})
    prev = key0
    for l in range(1, num_levels):
        # morton(c >> l) == morton(c) >> 3l and the shift preserves order,
        # so each level is a unique() of the previous keys — no re-encode,
        # no re-sort (the same invariant the device build rides).
        p = prev >> 3
        prev = p[np.concatenate(([True], p[1:] != p[:-1]))] if len(p) else p
        out.append({"key": prev, "level": l})
    return out


def scan_slot_triples(levels, slot_levels):
    """Live ks=3 (dst, tap, src) triples per slot level for one scan.

    Args:
      levels: ``scan_levels`` output.
      slot_levels: iterable of level indices to build (others skipped).
    Returns:
      dict level -> (dst [m] int32, tap [m] int32, src [m] int32), indices
      local to the scan's Morton-ordered level array, voxel-major with taps
      ascending (the native join's order).
    """
    return {l: native.slot_triples(levels[l]["key"],
                                   1 << (FULL_SCALE_LOG2 - l))
            for l in slot_levels}


def scan_slot_triples_ref(levels, slot_levels):
    """The numpy version of ``scan_slot_triples``: the same triples in the
    same order."""
    out = {}
    for l in slot_levels:
        key = levels[l]["key"]
        n = len(key)
        if n == 0:
            z = np.zeros(0, np.int32)
            out[l] = (z, z, z)
            continue
        limit = 1 << (FULL_SCALE_LOG2 - l)
        coords = _coords_from_morton(key)
        # All 27 offsets in one vectorized query; the center tap finds the
        # voxel itself (keys are unique).
        q = coords[:, None, :] + _OFFS[None, :, :]          # [n, 27, 3]
        inb = ((q >= 0) & (q < limit)).all(axis=-1)         # [n, 27]
        qk = morton36(q.reshape(-1, 3)).reshape(n, 27)
        pos = np.minimum(np.searchsorted(key, qk.reshape(-1)), n - 1)
        pos = pos.reshape(n, 27)
        hit = inb & (key[pos] == qk)
        dst, tap = np.nonzero(hit)                           # row-major
        out[l] = (dst.astype(np.int32), tap.astype(np.int32),
                  pos[dst, tap].astype(np.int32))
    return out


def _coords_from_morton(key):
    """Inverse of morton36 -> [n, 3] int64 coords."""
    key = np.asarray(key, np.int64)

    def compact(v):
        v = v & 0x9249249
        v = (v | (v >> 2)) & 0x30C30C3
        v = (v | (v >> 4)) & 0x300F00F
        v = (v | (v >> 8)) & 0x30000FF
        v = (v | (v >> 16)) & 0x3FF
        return v

    def axis(shift):
        lo10 = compact((key >> shift) & 0x3FFFFFFF)
        b10 = (key >> (30 + shift)) & 1
        b11 = (key >> (33 + shift)) & 1
        return lo10 | (b10 << 10) | (b11 << 11)

    return np.stack([axis(2), axis(1), axis(0)], axis=1)


def slot_pool_size(max_group_sum, quantum=16):
    """Per-batch pool size S: the smallest multiple of ``quantum`` >= the
    batch's largest group live-tap sum, within [POOL_FLOOR, POOL_CEIL]
    (few distinct S values, so few distinct map shapes)."""
    s = max(POOL_FLOOR, -(-int(max_group_sum) // quantum) * quantum)
    return min(s, POOL_CEIL)


def assemble_grouped_slots(scan_triples, scan_counts, level_caps,
                           slot_levels, quantum=16):
    """Batch-level grouped slot maps from per-scan triples.

    Args:
      scan_triples: list (one per scan) of ``scan_slot_triples`` outputs.
      scan_counts: [num_scans, num_levels] per-scan level voxel counts.
      level_caps: the batch's per-level capacities — should cover the
        summed counts (triples beyond a cap are dropped and counted).
    Returns:
      (maps, overflow): maps is dict level -> (src_pack [cap/8, S],
      bin_pack [cap/8, S]) int32; overflow counts dropped live taps
      (0 unless a cap or the 216 pool ceiling truncates).
    """
    counts = np.asarray(scan_counts)
    maps = {}
    overflow = 0
    for l in slot_levels:
        cap = int(level_caps[l])
        offs = np.concatenate([[0], np.cumsum(counts[:, l])])
        dst_all, tap_all, src_all = [], [], []
        for i, tri in enumerate(scan_triples):
            dst, tap, src = tri[l]
            dst_all.append(dst.astype(np.int64) + offs[i])
            tap_all.append(tap)
            src_all.append(src.astype(np.int64) + offs[i])
        dst = np.concatenate(dst_all)
        tap = np.concatenate(tap_all)
        src = np.concatenate(src_all)
        # Capacity clamp (counted; lossless capacities make it a no-op).
        keep = (dst < cap) & (src < cap)
        overflow += int(len(dst) - keep.sum())
        dst, tap, src = dst[keep], tap[keep], src[keep]

        group = dst >> 3
        binid = tap.astype(np.int64) * 8 + (dst & 7)
        if len(group) == 0 or (np.diff(group) >= 0).all():
            # The triples are voxel-major and scans concatenate in
            # order, so the group key is already sorted — skip the sort.
            g_s, b_s, s_s = group, binid, src
        else:
            order = np.argsort(group, kind="stable")
            g_s, b_s, s_s = group[order], binid[order], src[order]
        # Slot rank within each group: position minus the group's start.
        start = np.searchsorted(g_s, g_s)      # first index of each value
        rank = np.arange(len(g_s)) - start
        gmax = int(rank.max()) + 1 if len(rank) else 0
        S = slot_pool_size(gmax, quantum=quantum)
        drop = rank >= S
        overflow += int(drop.sum())
        g_s, b_s, s_s, rank = g_s[~drop], b_s[~drop], s_s[~drop], rank[~drop]

        ng = cap // 8
        src_pack = np.full((ng, S), cap, np.int32)
        bin_pack = np.full((ng, S), 216, np.int32)
        src_pack[g_s, rank] = s_s
        bin_pack[g_s, rank] = b_s
        maps[l] = (src_pack, bin_pack)
    return maps, overflow


def caps_from_fractions(n_total, l0_fraction, level_fractions):
    """Voxel capacities per level for a point buffer of ``n_total`` rows:
    L0 a fraction of the buffer, L1+ chained fractions, all 128-multiples."""
    caps = [min(n_total,
                max(128, int(round(n_total * l0_fraction / 128.0)) * 128))]
    for frac in level_fractions:
        caps.append(max(128, int(round(caps[-1] * frac / 128.0)) * 128))
    return tuple(caps)


def ladder_cap(count: int) -> int:
    """Smallest ladder capacity >= count: 128-multiples on a ~1.25x
    geometric grid, so capacity tracks occupancy within ~25% while the
    distinct shapes stay few."""
    n = max(1, -(-int(count) // 128))
    lad = 1
    while lad < n:
        lad = max(lad + 1, int(lad * 1.25))
    return lad * 128


def adaptive_caps(static_caps, level_counts):
    """Occupancy-compacted capacities: each level's exact voxel count
    rounded up the ladder, with the static capacity as a ceiling."""
    return tuple(min(s, ladder_cap(c))
                 for s, c in zip(static_caps, list(level_counts)))


class SlotPoolSpec:
    """What ``collate_padded`` needs to build a batch's grouped slot maps:
    the levels that carry them, the capacity rule (``caps_from_fractions``,
    and with ``adaptive`` the batch's level counts up the ladder, as the
    train step sizes its hierarchy) and the pool quantum.  The maps' shapes
    then match the hierarchy the step builds."""

    def __init__(self, slot_levels, l0_fraction, level_fractions,
                 quantum=16, adaptive=False):
        self.slot_levels = tuple(slot_levels)
        self.l0_fraction = float(l0_fraction)
        self.level_fractions = tuple(level_fractions)
        self.quantum = int(quantum)
        self.adaptive = bool(adaptive)
        self.num_levels = 1 + len(self.level_fractions)

    def caps_for(self, n_total, level_counts=None):
        static = caps_from_fractions(n_total, self.l0_fraction,
                                     self.level_fractions)
        return adaptive_caps(static, level_counts) if self.adaptive \
            else static


def build_batch_slot_maps(scan_coords_list, level_caps, slot_levels,
                          quantum=16):
    """One-call convenience: per-scan coords -> batch grouped slot maps.

    ``scan_coords_list``: list of [n_i, 3] int32 deduped voxel coords (one
    per scan, already cut to the point capacity by the caller).
    """
    tris, cnts = [], []
    for c in scan_coords_list:
        levels = scan_levels(c, len(level_caps))
        tris.append(scan_slot_triples(levels, slot_levels))
        cnts.append([len(lv["key"]) for lv in levels])
    return assemble_grouped_slots(tris, np.asarray(cnts), level_caps,
                                  slot_levels, quantum=quantum)
