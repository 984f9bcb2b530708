"""Padded static-shape batch collation (a copy of ``fusiontransformer_tpu/data/collate.py``).

The reference concatenates variable-length scans and appends a batch column
(``data/collate.py:37-86``); here each scan is placed in its own
fixed-capacity slice of a [B*cap] buffer with a validity mask, so a batch
has one of a few static shapes (one per capacity bucket).  Scans larger
than the capacity are truncated (counted in ``num_dropped`` so callers can
monitor; capacities are sized so this never happens on the real datasets).

Eval-only fields (original labels, inverse maps) stay host-side Python lists,
exactly like the reference.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from fusiontransformer_tpu_torch.ops.host_slots import (assemble_grouped_slots,
                                                        scan_levels,
                                                        scan_slot_triples)


def collate_padded(samples: List[Dict], batch_size: int, point_capacity: int,
                   image_height: int, image_width: int,
                   capacity_buckets: tuple = (), slot_pool=None):
    b = batch_size
    cap = point_capacity
    if capacity_buckets:
        # Pick the smallest bucket that fits the batch's largest scan:
        # gathers and GEMMs scale with capacity, so small scans shouldn't
        # pay for the worst case.  There are at most len(buckets) shapes.
        biggest = max((len(s["coords"]) for s in samples), default=0)
        cap = None
        for bk in sorted(capacity_buckets):
            if bk >= biggest:
                cap = int(bk)
                break
        if cap is None:   # largest bucket; overflow points get dropped
            cap = int(max(capacity_buckets))
    n = b * cap
    out = {
        "coords": np.zeros((n, 3), np.int32),
        "feats": np.zeros((n, 4), np.float32),
        "seg_label": np.zeros((n,), np.int32),
        "pt_batch": np.zeros((n,), np.int32),
        "pt_valid": np.zeros((n,), bool),
        "scan_count": np.zeros((b,), np.int32),
        "num_dropped": 0,
    }
    out["img"] = np.zeros((b, image_height, image_width, 3), np.float32)
    out["img_indices"] = np.zeros((n, 2), np.int32)
    out["orig_seg_label"] = []
    out["sparse_orig_points_idx"] = []
    out["inverse_map"] = []
    out["seq"] = []
    out["filename"] = []

    assert len(samples) <= b
    for i, s in enumerate(samples):
        k = len(s["coords"])
        if k > cap:
            out["num_dropped"] += k - cap
            k = cap
        lo = i * cap
        out["coords"][lo:lo + k] = s["coords"][:k]
        out["feats"][lo:lo + k, :s["feats"].shape[1]] = s["feats"][:k]
        out["seg_label"][lo:lo + k] = s["seg_label"][:k]
        out["pt_batch"][lo:lo + k] = i
        out["pt_valid"][lo:lo + k] = True
        out["scan_count"][i] = k
        img = s["img"]
        if img.shape[0] == 3 and img.ndim == 3:   # CHW -> HWC safety
            img = np.moveaxis(img, 0, -1)
        h, w = img.shape[:2]
        out["img"][i, :h, :w] = img
        out["img_indices"][lo:lo + k] = s["img_indices"][:k]
        out["orig_seg_label"].append(s["orig_seg_label"])
        out["sparse_orig_points_idx"].append(s["sparse_orig_points_idx"])
        out["inverse_map"].append(s["inverse_map"])
        out["seq"].append(s.get("seq", ""))
        out["filename"].append(s.get("filename", ""))

    if slot_pool is not None:
        # Host-built group-pooled conv slot maps (ops/host_slots.py): walk
        # each scan's Morton pyramid, join its ks3 neighbors and emit
        # pre-packed [cap/8, S] maps at the capacities the step's hierarchy
        # will have for this buffer (modules/steps.level_caps_for_n).
        tris, cnts = [], []
        for s in samples:
            k = min(len(s["coords"]), cap)
            levels = scan_levels(np.asarray(s["coords"][:k]),
                                 slot_pool.num_levels)
            tris.append(scan_slot_triples(levels, slot_pool.slot_levels))
            cnts.append([len(lv["key"]) for lv in levels])
        maps, overflow = assemble_grouped_slots(
            tris, np.asarray(cnts) if cnts else
            np.zeros((0, slot_pool.num_levels), np.int64),
            slot_pool.caps(n), slot_pool.slot_levels,
            quantum=slot_pool.quantum)
        for l, (src, binp) in maps.items():
            out[f"gslot_src_{l}"] = src
            out[f"gslot_bin_{l}"] = binp
        out["gslot_overflow"] = overflow
    return out
