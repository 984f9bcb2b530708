"""Step times of two checkouts of this repository on one card, in turns.

    python -m fusiontransformer_tpu_torch.tools.step_ab ROOT_A ROOT_B

Runs A, B, B, A, each in a process of its own that imports the port from
that checkout (two commits, or a commit and its parent unpacked with
``git archive``): the flagship's bf16 train step (``middlefusion.yaml``,
batch 10 of SyntheticSCN scans of 18,000 rays, adaptive caps; the
group-pooled and the per-voxel configuration) and the per-voxel predict
step at batch 1.  Each time is the median of CUDA-event windows around one
step after warm-up steps on the same batch.  Prints one JSON line per run
and the card's name and power limit; needs a CUDA device.
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


def one(root, steps):
    """The step times of the checkout at ``root`` (run in its own process)."""
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch
    import fusiontransformer_tpu_torch as pkg
    if not pkg.__file__.startswith(root):
        raise RuntimeError(f"imported {pkg.__file__}, not from {root}")
    from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
    from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
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
    gen = SyntheticSCN(split=("test",), num_scans=1, num_points=N_POINTS,
                       image_height=eng.image_height,
                       image_width=eng.image_width)
    rng = np.random.RandomState(100)
    points, _, _ = gen._make_scan(rng)
    rec = {"points": points,
           "feats": np.concatenate(
               [points, rng.rand(len(points), 1).astype(np.float32)], 1),
           "img": rng.rand(eng.image_height, eng.image_width,
                           3).astype(np.float32),
           "points_img": gen._project(points)}
    db = device_batch(eng.collate([eng.preprocess(rec)]), eng.device)
    with torch.inference_mode():
        res["predict_step_ms per-voxel"] = _events(lambda: eng._step(db),
                                                   2 * steps)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="*", help="two checkouts: A B")
    p.add_argument("--steps", type=int, default=12,
                   help="timed steps per configuration and run")
    p.add_argument("--one", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        print("STEP_AB " + json.dumps(one(os.path.abspath(args.one),
                                          args.steps)), flush=True)
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
             "--steps", str(args.steps)], capture_output=True, text=True)
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
