"""Microbench: how fast can a hand-written kernel gather table rows by the
flagship's slot-map indices?

    python -m fusiontransformer_tpu_torch.tools.microbench_dma_gather
    python -m fusiontransformer_tpu_torch.tools.microbench_dma_gather \
        --device cpu

Port of ``tools/microbench_dma_gather.py``.  The indices are the flattened
per-voxel ``src`` maps (K = 16 slots per voxel, sentinel = the pad row) of
one SyntheticSCN scan of 18,000 points through ``build_hierarchy``, at L0
(C = 32) and L2 (C = 128), gathered from a bf16 table ``[cap + 1, C]``; it
prints the share of the indices that name the pad row (most of them: every
empty slot does).
Variants, per ``CHUNK`` indices and for the whole level's list in one
launch:

  index_select               the plain gather (the JAX tool's "xla" row)
  T1 gather_blocks8          8-row-aligned blocks, one per index (the first
                             n/8 indices)
  T2 gather_rows_sum_pipelined  a ring of cp.async row copies, summed in f32
  T3 gather_rows_sum_smem    the table resident in a cluster's shared memory,
                             summed

On the card each time is a CUDA-event median over CUDA-graph replays of
``CALLS`` calls (a call of ``CHUNK`` rows is shorter than a launch from
Python); rows/s counts the rows each call gathers (T1 writes n rows from n/8
blocks).  The errors are T1's max abs difference from its plain version and
T2/T3's from the f32 sum, over the sum of |rows|.  ``--device cpu`` runs the
plain versions and times them on the host clock.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from fusiontransformer_tpu_torch.ops.kernels.row_gather import (
    gather_blocks8, gather_blocks8_ref, gather_rows_sum_pipelined,
    gather_rows_sum_ref, gather_rows_sum_smem)
from fusiontransformer_tpu_torch.utils.device import resolve_device
from fusiontransformer_tpu_torch.utils.profiler import time_cuda, time_host

CHUNK = 16384                 # indices per call
CALLS = 20                    # calls per CUDA graph
CAPS = (17408, 11648, 7808, 4352, 1792)
POINT_CAPACITY = 20_480
N_POINTS = 18_000
TAP_SLOTS = 16
LEVELS = ((0, 32), (2, 128))  # (level, C)
VARIANTS = ("index_select", "T1 gather_blocks8",
            "T2 gather_rows_sum_pipelined", "T3 gather_rows_sum_smem")


def level_indices(device, n_points=N_POINTS):
    """``{level: flattened per-voxel src map [cap * K] int32}`` at the
    levels of ``LEVELS``, from one SyntheticSCN scan."""
    from fusiontransformer_tpu_torch.data.collate import collate_padded
    from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
    from fusiontransformer_tpu_torch.ops.hierarchy import build_hierarchy

    ds = SyntheticSCN(split=("train",), num_scans=1, num_points=n_points)
    batch = collate_padded([ds[0]], 1, POINT_CAPACITY, 370, 1226)
    hier = build_hierarchy(
        torch.as_tensor(batch["coords"], device=device),
        torch.as_tensor(batch["pt_batch"], device=device),
        torch.as_tensor(batch["pt_valid"], device=device), CAPS,
        tap_slots=(TAP_SLOTS,) * len(CAPS))
    return {level: hier.levels[level].slot_idx[0].reshape(-1).to(
        torch.int32).contiguous() for level, _ in LEVELS}


def level_table(level, c, device):
    """The bf16 table ``[cap + 1, C]`` of a level, from
    ``RandomState(level)``."""
    rng = np.random.RandomState(level)
    table = rng.randn(CAPS[level] + 1, c).astype(np.float32)
    return torch.as_tensor(table).to(device, torch.bfloat16)


def variant_fns(feats):
    """Each variant as a function of the indices, with no host
    synchronisation (the indices are checked once before timing)."""
    return {
        VARIANTS[0]: lambda ix: feats.index_select(0, ix),
        VARIANTS[1]: lambda ix: gather_blocks8(feats, ix, check=False),
        VARIANTS[2]: lambda ix: gather_rows_sum_pipelined(feats, ix,
                                                          check=False),
        VARIANTS[3]: lambda ix: gather_rows_sum_smem(feats, ix, check=False),
    }


def errors(feats, idx):
    """T1's max abs difference from its plain version (exact copy: 0), and
    T2's and T3's from the f32 sum over the sum of |rows|; the indices are
    checked by the kernels' error flags."""
    t1 = gather_blocks8(feats, idx)
    err = {VARIANTS[1]: (t1.float() - gather_blocks8_ref(feats, idx).float())
           .abs().max().item()}
    ref = gather_rows_sum_ref(feats, idx)
    scale = gather_rows_sum_ref(feats.abs(), idx).max().item()
    for name, fn in ((VARIANTS[2], gather_rows_sum_pipelined),
                     (VARIANTS[3], gather_rows_sum_smem)):
        err[name] = (fn(feats, idx) - ref).abs().max().item() / scale
    return err


def _timer(device, iters):
    if device.type == "cuda":
        return lambda fn: time_cuda(fn, iters=iters, calls=CALLS,
                                    graph=True)[0]
    return lambda fn: time_host(fn, iters=iters)[0]


def run_level(level, c, src_flat, device, chunk=CHUNK, iters=5):
    """Time every variant per ``chunk`` indices (cycling through the level's
    chunks, as the JAX tool does) and on the whole list in one launch; print
    two lines and return the readings."""
    feats = level_table(level, c, device)
    n_chunks = src_flat.shape[0] // chunk
    if n_chunks == 0:
        raise ValueError(f"L{level}: {src_flat.shape[0]} indices, fewer than "
                         f"one chunk of {chunk}")
    chunks = list(src_flat[:n_chunks * chunk].view(n_chunks, chunk))
    whole = src_flat[:src_flat.shape[0] // 8 * 8]
    timer = _timer(device, iters)
    fns = variant_fns(feats)
    err_whole = errors(feats, whole)
    res = {"level": level, "cap": CAPS[level], "C": c, "chunk": chunk,
           "whole_rows": int(whole.shape[0]),
           "pad_row_share": float((whole == CAPS[level]).float().mean()),
           "ms": {}, "ms_whole": {},
           "err": {**errors(feats, chunks[0]),
                   **{f"{k} whole": v for k, v in err_whole.items()}}}
    for name, fn in fns.items():
        turn = itertools.count()
        res["ms"][name] = timer(
            lambda fn=fn: fn(chunks[next(turn) % n_chunks]))
        res["ms_whole"][name] = timer(lambda fn=fn: fn(whole))

    def rate(ms, rows):
        return rows / (ms * 1e-3) / 1e6

    for key, rows, label in (("ms", chunk, f"{chunk} rows"),
                             ("ms_whole", whole.shape[0],
                              f"whole level, {whole.shape[0]} rows")):
        cells = " | ".join(f"{name} {res[key][name]:.4f} ms = "
                           f"{rate(res[key][name], rows):.1f} M rows/s"
                           for name in fns)
        print(f"L{level} cap={CAPS[level]} C={c} ({2 * c} B rows), {label} "
              f"| {cells}", flush=True)
    print(f"L{level}: {res['pad_row_share']:.4f} of the indices name the "
          f"pad row ({CAPS[level]})", flush=True)
    print(f"L{level} errors: " + ", ".join(
        f"{k} {v:.3g}" for k, v in res["err"].items()), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions, host times)")
    ap.add_argument("--points", type=int, default=N_POINTS,
                    help="points of the SyntheticSCN scan")
    ap.add_argument("--chunk", type=int, default=CHUNK,
                    help="indices per timed call (a multiple of 8)")
    ap.add_argument("--iters", type=int, default=5, help="timing windows")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.chunk <= 0 or args.chunk % 8:
        raise ValueError(f"--chunk {args.chunk} is not a positive multiple "
                         "of 8")
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu (plain versions, host times)",
          flush=True)
    idx = level_indices(device, args.points)
    return [run_level(level, c, idx[level], device, args.chunk, args.iters)
            for level, c in LEVELS]


if __name__ == "__main__":
    main()
