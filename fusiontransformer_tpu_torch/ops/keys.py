"""Morton voxel keys, stable sort and exact-match lookup (torch).

Port of ``fusiontransformer_tpu/ops/keys.py``.  A voxel at integer coords
``(x, y, z)`` in scan ``b`` is the int32 key pair

    hi = (b << 6) | morton[35:30]       lo = morton[29:0]

with ``INVALID_KEY = 2**31 - 1`` for padding, so it sorts last.  Every valid
key half is non-negative, so the single int64 ``hi * 2**32 + lo`` orders
exactly as the pair does; sorting and lookup use it.  ``morton >> 3`` is the
parent voxel and preserves order, which is why one sort orders every level.
"""

from __future__ import annotations

import torch

COORD_BITS = 12
COORD_MASK = (1 << COORD_BITS) - 1

INVALID_KEY = 2**31 - 1


def _part1by2(v):
    """Spread the low 10 bits of v so bit i lands at bit 3*i."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def _compact1by2(v):
    """Inverse of _part1by2."""
    v = v & 0x9249249
    v = (v | (v >> 2)) & 0x30C30C3
    v = (v | (v >> 4)) & 0x300F00F
    v = (v | (v >> 8)) & 0x30000FF
    v = (v | (v >> 16)) & 0x3FF
    return v


def pack_keys(batch_idx, coords, valid):
    """(batch [N], coords [N, 3], valid [N]) -> Morton (hi, lo) int32 pair.

    Bit layout: morton bit 3i+2 <- x_i, 3i+1 <- y_i, 3i <- z_i, so
    ``lo & 7 == (x&1)*4 + (y&1)*2 + (z&1)`` (the ks=2 offset convention).
    """
    coords = coords.to(torch.int32)
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    lo = (_part1by2(x) << 2) | (_part1by2(y) << 1) | _part1by2(z)
    mh = ((((x >> 10) & 1) << 2) | (((y >> 10) & 1) << 1) | ((z >> 10) & 1)
          | (((x >> 11) & 1) << 5) | (((y >> 11) & 1) << 4)
          | (((z >> 11) & 1) << 3))
    hi = (batch_idx.to(torch.int32) << 6) | mh
    invalid = torch.full_like(hi, INVALID_KEY)
    return torch.where(valid, hi, invalid), torch.where(valid, lo, invalid)


def unpack_keys(hi, lo):
    """Inverse of pack_keys (only meaningful for valid keys)."""
    batch_idx = hi >> 6
    mh = hi & 0x3F
    x = _compact1by2(lo >> 2) | (((mh >> 2) & 1) << 10) | (((mh >> 5) & 1) << 11)
    y = _compact1by2(lo >> 1) | (((mh >> 1) & 1) << 10) | (((mh >> 4) & 1) << 11)
    z = _compact1by2(lo) | ((mh & 1) << 10) | (((mh >> 3) & 1) << 11)
    return batch_idx, torch.stack([x, y, z], dim=-1)


def parent_keys(hi, lo, valid):
    """Key of the parent voxel (coords >> 1); order-preserving."""
    mh = hi & 0x3F
    b = hi & ~0x3F
    new_lo = ((mh & 7) << 27) | ((lo >> 3) & 0x7FFFFFF)
    new_hi = b | (mh >> 3)
    invalid = torch.full_like(hi, INVALID_KEY)
    return (torch.where(valid, new_hi, invalid),
            torch.where(valid, new_lo, invalid))


def key64(hi, lo):
    """The pair as one int64 with the same order (both halves are >= 0)."""
    return (hi.to(torch.int64) << 32) | lo.to(torch.int64)


def sort_by_key(hi, lo, *payload):
    """Stable sort of payload tensors by the (hi, lo) key pair."""
    _, perm = torch.sort(key64(hi, lo), stable=True)
    return (hi[perm], lo[perm]) + tuple(p[perm] for p in payload)


def sorted_join(table_hi, table_lo, q_hi, q_lo):
    """Exact-match lookup of query keys in a sorted table of unique keys
    (INVALID_KEY padding at its tail): the matching table position, or
    ``len(table)`` where the key is absent or invalid."""
    v = table_hi.shape[0]
    table = key64(table_hi, table_lo)
    q = key64(q_hi, q_lo)
    pos = torch.searchsorted(table, q.reshape(-1)).reshape(q.shape)
    pos_c = pos.clamp(max=max(v - 1, 0))
    found = (pos < v) & (table[pos_c] == q) & (q_hi != INVALID_KEY)
    return torch.where(found, pos_c, torch.full_like(pos_c, v)).to(torch.int32)


def unique_sorted(hi, lo):
    """First occurrence flags, dense rank and count of the distinct valid
    keys of a sorted key array (``keys.unique_sorted`` of the JAX package)."""
    valid = hi != INVALID_KEY
    prev_hi = torch.cat([hi.new_full((1,), -1), hi[:-1]])
    prev_lo = torch.cat([lo.new_full((1,), -1), lo[:-1]])
    is_first = ((hi != prev_hi) | (lo != prev_lo)) & valid
    position = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
    return is_first, position, is_first.sum(dtype=torch.int32)
