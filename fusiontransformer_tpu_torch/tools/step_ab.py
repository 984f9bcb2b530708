"""Step times of two checkouts of this repository on one card, in turns.

    python -m fusiontransformer_tpu_torch.tools.step_ab ROOT_A ROOT_B
    python -m fusiontransformer_tpu_torch.tools.step_ab --k3 ROOT_A ROOT_B
    python -m fusiontransformer_tpu_torch.tools.step_ab --gather ROOT_A ROOT_B

Runs A, B, B, A, each in a process of its own that imports the port from
that checkout (two commits, or a commit and its parent unpacked with
``git archive``): the flagship's bf16 train step (``middlefusion.yaml``,
batch 10 of SyntheticSCN scans of 18,000 rays, adaptive caps; the
group-pooled and the per-voxel configuration) and the per-voxel predict
step at batch 1.  Each time is the median of CUDA-event windows around one
step after warm-up steps on the same batch.  With ``--k3`` it times the
segment sum (K3) instead, on the streams of the same batches: the two
``voxelize_mean`` calls (L4, L2) of a request, and of a train step those
and the two devoxelize adjoints (E = 8), bf16-rounding, each summed over
its calls, eagerly (the host's launch included) and over CUDA-graph
replays (the device).  With ``--gather`` it times the row-gather sums T2
(``gather_rows_sum_pipelined``) and T3 (``gather_rows_sum_smem``) on the
microbench's inputs (one scan's per-voxel L0 and L2 slot maps, one call over
the whole level's list), eagerly and over CUDA-graph replays, with each
call's kernels by name from the profiler.  Prints one JSON line per run and
the card's name and power limit; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CONFIG = "configs/semantic_kitti/middlefusion.yaml"
N_POINTS = 18000
BATCH = 10


def _events(fn, n, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def one(root, steps, k3=False, gather=False):
    """The step times of the checkout at ``root`` (run in its own process)."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import fusiontransformer_tpu_torch as pkg
    if not pkg.__file__.startswith(root):
        raise RuntimeError(f"imported {pkg.__file__}, not from {root}")
    from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
    from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
        SemanticTrainer)
    from fusiontransformer_tpu_torch.modules.steps import device_batch
    from fusiontransformer_tpu_torch.serving.engine import InferenceEngine

    def cfg_of(train, slot_pool):
        cfg = get_default_cfg()
        cfg.merge_from_file(CONFIG)
        cfg.TPU.CONV_SLOT_POOL = slot_pool
        if train:
            cfg.DATASET.TYPE = "SyntheticSCN"
            cfg.DATASET.SyntheticSCN.num_points = N_POINTS
            cfg.DATASET.SyntheticSCN.num_scans = BATCH
            cfg.TRAIN.BATCH_SIZE = cfg.VAL.BATCH_SIZE = BATCH
            cfg.OUTPUT_DIR, cfg.AUTO_RESUME = "", False
        cfg.freeze()
        return cfg

    res = {"root": root}
    if k3:
        return k3_times(res, cfg_of, steps)
    if gather:
        return gather_times(res, steps)
    for label, slot_pool in (("group-pooled", True), ("per-voxel", False)):
        tr = SemanticTrainer(cfg_of(True, slot_pool))
        ds = tr.train_dataloader.dataset
        hb = tr.train_dataloader.collate_fn([ds[i] for i in range(BATCH)])
        caps = tr.level_caps(hb)
        db = device_batch(hb, tr.device)
        res[f"train_step_ms {label}"] = _events(
            lambda: tr.train_step(db, tr.generator, caps), steps)
        del tr, db
        torch.cuda.empty_cache()
    eng = InferenceEngine(cfg_of(False, False), batch_size=1, seed=0)
    db = device_batch(eng.collate([eng.preprocess(_request(eng))]),
                      eng.device)
    with torch.inference_mode():
        res["predict_step_ms per-voxel"] = _events(lambda: eng._step(db),
                                                   2 * steps)
    return res


def k3_times(res, cfg_of, reps):
    """K3's times per request and per train step (see the module
    docstring) on the checkout already imported."""
    import torch
    from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
        SemanticTrainer)
    from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                           hier_from_cfg)
    from fusiontransformer_tpu_torch.ops import sparse_conv as sc
    from fusiontransformer_tpu_torch.ops.kernels.segment_sum import (
        sorted_segment_weighted_sum)
    from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
    from fusiontransformer_tpu_torch.utils.profiler import time_cuda
    gen = torch.Generator().manual_seed(0)

    def streams(hier, adjoint):
        n = hier.pt_valid.shape[0]
        for level, width in ((4, 256), (2, 128)):
            plan = sc.devox_plan(hier, level)
            num_out = hier.levels[level].valid.shape[0]
            feats = torch.randn(n, width, generator=gen).to(
                hier.pt_valid.device)
            yield (*sc.voxmean_stream(feats, hier.pt_valid, plan), num_out)
            if adjoint:
                yield (*sc.devox_adjoint_stream(
                    feats, hier.pt_corner_w[level], plan), num_out)

    def timed(label, hier, adjoint):
        calls = [(lambda a=a: sorted_segment_weighted_sum(*a))
                 for a in streams(hier, adjoint)]

        def all_calls():
            for c in calls:
                c()
        for key, graph in (("eager", False), ("device", True)):
            res[f"k3_ms {label} {key}"] = time_cuda(
                all_calls, iters=reps, warmup=3, graph=graph)[0]

    eng = InferenceEngine(cfg_of(False, True), batch_size=1, seed=0)
    rec = _request(eng)
    timed("request", hier_from_cfg(
        eng.cfg, device_batch(eng.collate([eng.preprocess(rec)]),
                              eng.device)), False)
    del eng
    tr = SemanticTrainer(cfg_of(True, True))
    ds = tr.train_dataloader.dataset
    hb = tr.train_dataloader.collate_fn([ds[i] for i in range(BATCH)])
    timed("train step", hier_from_cfg(
        tr.cfg, device_batch(hb, tr.device), tr.level_caps(hb)), True)
    return res


def kernels_by_name(fn, calls=10):
    """``{kernel: [records per call, median ms]}`` of the device kernels
    that ``calls`` calls of ``fn`` ran, from a profiler trace (the
    template arguments kept, the parameter list dropped)."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+_kernel(<[^()]*>)?)", e.name)
            times.setdefault(m.group(1) if m else e.name, []).append(
                e.time_range.elapsed_us() / 1e3)
    return {k: [len(v) / calls, statistics.median(v)]
            for k, v in times.items()}


def gather_times(res, reps):
    """T2's and T3's times at L0 and L2 (see the module docstring) on the
    checkout already imported."""
    from fusiontransformer_tpu_torch.ops.kernels import row_gather as rg
    from fusiontransformer_tpu_torch.tools import microbench_dma_gather as mdg
    from fusiontransformer_tpu_torch.utils.profiler import time_cuda
    idx = mdg.level_indices("cuda")
    for level, c in mdg.LEVELS:
        feats = mdg.level_table(level, c, "cuda")
        ix = idx[level][:idx[level].shape[0] // 8 * 8]
        for name, fn in ((rg.PIPELINED, rg.gather_rows_sum_pipelined),
                         (rg.SMEM, rg.gather_rows_sum_smem)):
            def call(fn=fn):
                return fn(feats, ix, check=False)
            key = f"{name} L{level}"
            res[f"{key} n"] = int(ix.shape[0])
            for label, graph in (("eager", False), ("graph", True)):
                res[f"{key} {label}_ms"] = time_cuda(
                    call, iters=reps, warmup=3, calls=20, graph=graph)[0]
            res[f"{key} GB/s"] = (ix.shape[0] * 2 * c
                                  / (res[f"{key} graph_ms"] * 1e6))
            res[f"{key} kernels"] = kernels_by_name(call)
    return res


def _request(eng):
    """The batch-1 request record: one SyntheticSCN scan, a random image."""
    import numpy as np
    from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
    gen = SyntheticSCN(split=("test",), num_scans=1, num_points=N_POINTS,
                       image_height=eng.image_height,
                       image_width=eng.image_width)
    rng = np.random.RandomState(100)
    points, _, _ = gen._make_scan(rng)
    return {"points": points,
            "feats": np.concatenate(
                [points, rng.rand(len(points), 1).astype(np.float32)], 1),
            "img": rng.rand(eng.image_height, eng.image_width,
                            3).astype(np.float32),
            "points_img": gen._project(points)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="*", help="two checkouts: A B")
    p.add_argument("--steps", type=int, default=12,
                   help="timed steps per configuration and run")
    p.add_argument("--k3", action="store_true",
                   help="time the segment sum (K3), not the steps")
    p.add_argument("--gather", action="store_true",
                   help="time the row-gather sums (T2, T3), not the steps")
    p.add_argument("--one", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.k3 and args.gather:
        p.error("--k3 and --gather exclude each other")
    if args.one:
        print("STEP_AB " + json.dumps(one(os.path.abspath(args.one),
                                          args.steps, args.k3, args.gather)),
              flush=True)
        return 0
    import torch
    if len(args.roots) != 2:
        p.error("give two checkouts")
    if not torch.cuda.is_available():
        raise RuntimeError("step_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    a, b = (os.path.abspath(r) for r in args.roots)
    for root in (a, b, b, a):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root,
             "--steps", str(args.steps)] + ["--k3"] * args.k3
            + ["--gather"] * args.gather,
            capture_output=True, text=True)
        line = [x for x in out.stdout.splitlines()
                if x.startswith("STEP_AB ")]
        if out.returncode or not line:
            sys.stderr.write(out.stdout[-2000:] + out.stderr[-4000:])
            raise RuntimeError(f"the run of {root} failed")
        print(line[0][len("STEP_AB "):], flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
