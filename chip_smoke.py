#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives ``fusiontransformer_tpu_torch`` (and nothing of the JAX package) on
the card, in phases; any failure raises and the exit code is non-zero:

1. device and build — the card's name and power limit, then every kernel
   in ``fusiontransformer_tpu_torch/csrc`` built with nvcc (in parallel);
2. K3 ``sorted_segment_weighted_sum`` against its plain version at the
   flagship's shapes (voxelize_mean at L4 and L2 of a real batch, plus one
   E=8 case), bf16-rounding and precise;
3. K1 ``binned_conv_grouped_fwd`` against its plain version on the same
   batch's group-pooled maps at L0-L3, for every (Cin, Cout) the flagship
   runs there, bf16 and f32;
4. the main path — ``InferenceEngine`` for
   ``configs/semantic_kitti/middlefusion.yaml`` (DeiT-B/384 + SPVCNN cr 1.0,
   20 classes, random weights from a seed): warmup, then requests of
   SyntheticSCN scans of about 18,000 points at batch 1, with the kernels'
   launch counts read around them;
5. the main path against the plain path — the same weights and records in
   f32 on the card (TF32 off) and through the port on the CPU; and the
   bf16 main path's drift from the f32 one on the card (reported);
6. a ``{"kernels": [...]}`` line: launches, errors and times of each kernel.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Times are CUDA-event medians; ``bound_ms`` is the larger of bytes over
3.35 TB/s and flops over the peak rate of the operand type (989 TFLOP/s
bf16, 67 TFLOP/s f32) of an H100 SXM.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

CONFIG = "configs/semantic_kitti/middlefusion.yaml"
N_REQUESTS = 8
N_POINTS = 18000
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
K1_SOURCE = "fusiontransformer_tpu_torch/csrc/binned_conv.cu"
K1_REPLACES = "fusiontransformer_tpu/ops/pallas/binned_conv.py:123"
K3_SOURCE = "fusiontransformer_tpu_torch/csrc/segment_sum.cu"
K3_REPLACES = "fusiontransformer_tpu/ops/pallas/segment_sum.py:129"
# Kernel vs plain version: both sum the same f32 products in another order,
# so the difference is held against the sum of |products| (the plain
# version on absolute values) times this factor.
SUM_ORDER_RTOL = 2e-5
# Main path in f32, card vs CPU: same arithmetic, other summation orders
# through ~40 layers.  Each output is held to this factor of its largest
# |logit|; H100 runs measured ~1e-6 of it (PERF.md), so 1e-4 leaves 100x.
F32_LOGIT_RTOL = 1e-4
LABEL_AGREEMENT = 0.999


def log(msg=""):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, reps=5):
    """Median over ``reps`` CUDA-event windows of ``iters`` calls, in ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def records(n, n_points, height, width):
    """Raw request records: SyntheticSCN ray-cast scans, random images."""
    import numpy as np
    from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
    gen = SyntheticSCN(split=("test",), num_scans=n, num_points=n_points,
                       image_height=height, image_width=width)
    out = []
    for i in range(n):
        rng = np.random.RandomState(100 + i)
        points, _, _ = gen._make_scan(rng)
        out.append({
            "points": points,
            "feats": np.concatenate(
                [points, rng.rand(len(points), 1).astype(np.float32)], 1),
            "img": rng.rand(height, width, 3).astype(np.float32),
            "points_img": gen._project(points),
        })
    return out


# --------------------------------------------------------------------------- #
def phase_k3(hier, gen):
    """K3 vs plain at L4 (C=257) and L2 (C=129), E=1, and an E=8 case."""
    import torch
    from fusiontransformer_tpu_torch.ops import sparse_conv as sc
    from fusiontransformer_tpu_torch.ops.kernels.segment_sum import (
        sorted_segment_weighted_sum, sorted_segment_weighted_sum_ref)
    dev = hier.pt_valid.device
    n_pts = hier.pt_valid.shape[0]
    cases = []
    for level, width in ((4, 256), (2, 128)):
        plan = sc.devox_plan(hier, level)
        feats = torch.randn(n_pts, width, generator=gen).to(dev)
        g, w, ids = sc.voxmean_stream(feats, hier.pt_valid, plan)
        cases.append((f"voxelize_mean L{level}", level, g, w, ids, True))
    plan = sc.devox_plan(hier, 2)
    perm = plan.sort_perm.long()
    dout = torch.randn(n_pts, 128, generator=gen).to(dev)
    g = sc.pad_row(dout)[perm].contiguous()
    w = sc.pad_row(hier.pt_corner_w[2])[perm].contiguous()
    cases.append(("corner sums L2 (E=8)", 2, g, w,
                  plan.ids_sorted.contiguous(), False))

    rows, main = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0, "max_abs_err": 0.0, "bound_t": {}}
    for label, level, g, w, ids, on_path in cases:
        num_out = hier.levels[level].valid.shape[0]
        for precise in (False, True):
            out = sorted_segment_weighted_sum(g, w, ids, num_out, precise)
            ref = sorted_segment_weighted_sum_ref(g, w, ids, num_out, precise)
            scale = sorted_segment_weighted_sum_ref(
                g.abs(), w.abs(), ids, num_out, True).max().item()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            if not err <= SUM_ORDER_RTOL * scale:
                raise AssertionError(f"K3 {label} precise={precise}: max abs "
                                     f"err {err} > {SUM_ORDER_RTOL} x {scale}")
            ms = cuda_ms(lambda: sorted_segment_weighted_sum(
                g, w, ids, num_out, precise))
            plain_ms = cuda_ms(lambda: sorted_segment_weighted_sum_ref(
                g, w, ids, num_out, precise), iters=5, reps=3)
            live = int((ids < num_out).sum())
            e, c = w.shape[1], g.shape[1]
            nbytes = 4 * (g.numel() + w.numel() + ids.numel()
                          + num_out * e * c)
            b_ms, b_by = bound(nbytes, 2 * live * e * c, "float32")
            # One PyTorch call computing the same sums from the same
            # per-point products: index_add_ (the products precomputed).
            contrib = (w[:, :, None] * g[:, None, :]).reshape(len(ids), -1)
            ids_c = ids.long().clamp(max=num_out)
            acc = torch.zeros(num_out + 1, e * c, device=dev)
            lib_ms = cuda_ms(lambda: acc.index_add_(0, ids_c, contrib))
            rows.append(dict(case=label, precise=precise, N=len(ids), C=c,
                             E=e, num_out=num_out, max_abs_err=err,
                             tol=SUM_ORDER_RTOL * scale, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms))
            log(f"  K3 {label:22s} precise={int(precise)} N={len(ids)} "
                f"C={c} E={e} rows={num_out}: err {err:.3g} "
                f"(tol {SUM_ORDER_RTOL * scale:.3g})  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  index_add_ {lib_ms:.4f} ms  "
                f"bound {b_ms:.4f} ms ({b_by})")
            if on_path and not precise:      # the bf16 main path's calls
                main["ms"] += ms
                main["plain_ms"] += plain_ms
                main["bound_ms"] += b_ms
                main["library_ms"] += lib_ms
                main["bound_t"][b_by] = main["bound_t"].get(b_by, 0) + b_ms
            main["max_abs_err"] = max(main["max_abs_err"], err)
    return rows, main


def grouped_convs(model, hier):
    """(level, Cin, Cout, kernel) of every ks3 conv of the model that runs
    at a level carrying group-pooled maps, in the model's order."""
    from fusiontransformer_tpu_torch.models.spvcnn import SubMConv3
    level_of = {"stem0": 0, "stem1": 0, "stage1": 1, "stage2": 2,
                "stage3": 3, "stage4": 4, "up1": 3, "up2": 2, "up3": 1,
                "up4": 0}
    out = []
    for name, m in model.lidar_backbone.backbone.named_modules():
        if isinstance(m, SubMConv3):
            level = level_of[name.split("_")[0]]
            if hier.levels[level].slot_idx is not None:
                out.append((level, m.kernel.shape[1], m.kernel.shape[2],
                            m.kernel.detach()))
    return out


def phase_k1(hier, model, gen):
    """K1 vs plain at every grouped (level, Cin, Cout), bf16 and f32."""
    import torch
    from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
        binned_conv_grouped_fwd, binned_conv_grouped_ref)
    dev = hier.pt_valid.device
    convs = grouped_convs(model, hier)
    shapes = {}
    for level, cin, cout, w in convs:
        shapes.setdefault((level, cin, cout), [0, w])[0] += 1
    rows, main = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "max_abs_err": 0.0, "bound_t": {}}
    for (level, cin, cout), (count, w) in sorted(shapes.items()):
        src, binp = hier.levels[level].slot_idx
        v = hier.levels[level].valid.shape[0]
        live = int(((binp < 216) & (src < v)).sum())
        x32 = torch.randn(v, cin, generator=gen).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x, wd = x32.to(dtype), w.to(dtype).contiguous()
            out = binned_conv_grouped_fwd(x, src, binp, wd)
            ref = binned_conv_grouped_ref(x, src, binp, wd)
            scale = binned_conv_grouped_ref(x.abs(), src, binp,
                                            wd.abs()).max().item()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            if not err <= SUM_ORDER_RTOL * scale:
                raise AssertionError(
                    f"K1 L{level} {cin}->{cout} {dtype}: max abs err {err} "
                    f"> {SUM_ORDER_RTOL} x {scale}")
            ms = cuda_ms(lambda: binned_conv_grouped_fwd(x, src, binp, wd))
            plain_ms = cuda_ms(lambda: binned_conv_grouped_ref(
                x, src, binp, wd), iters=3, reps=3)
            tname = str(dtype).replace("torch.", "")
            nbytes = (x.numel() * x.element_size() + 8 * src.numel()
                      + wd.numel() * wd.element_size() + 4 * v * cout)
            b_ms, b_by = bound(nbytes, 2 * live * cin * cout, tname)
            rows.append(dict(level=level, cin=cin, cout=cout, dtype=tname,
                             per_request=count, V=v, S=src.shape[1],
                             live_slots=live, max_abs_err=err,
                             tol=SUM_ORDER_RTOL * scale, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by))
            log(f"  K1 L{level} {cin:3d}->{cout:3d} {tname:8s} x{count} "
                f"V={v} S={src.shape[1]} live={live}: err {err:.3g} "
                f"(tol {SUM_ORDER_RTOL * scale:.3g})  kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
            if dtype == torch.bfloat16:
                main["ms"] += count * ms
                main["plain_ms"] += count * plain_ms
                main["bound_ms"] += count * b_ms
                main["bound_t"][b_by] = (main["bound_t"].get(b_by, 0)
                                         + count * b_ms)
            main["max_abs_err"] = max(main["max_abs_err"], err)
    return rows, main, len(convs)


def step_breakdown(engine, db, top=12):
    """Where one predict step's time goes.  CUDA events recorded between the
    hierarchy build, the image stream and the lidar stream + heads of the
    same step split it (medians of 7 steps; the parts of one step add up to
    its time); ``torch.profiler`` sums the kernels of one step by name.  The
    device busy share is that kernel time over the unprofiled step time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fusiontransformer_tpu_torch.modules.steps import hier_from_cfg
    model = engine.model

    def split():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with torch.inference_mode():
            ev[0].record()
            hier = hier_from_cfg(engine.cfg, db)
            ev[1].record()
            img = model.image_backbone(db["img"], db["img_indices"],
                                       db["pt_batch"])
            ev[2].record()
            model.lidar_backbone(db["feats"], hier,
                                 fusion_feats=img.get("img_middle_feats"))
            ev[3].record()
        ev[3].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    split()
    parts = [split() for _ in range(7)]
    hier_ms, image_ms, lidar_ms = (statistics.median(p[i] for p in parts)
                                   for i in range(3))
    step_ms = cuda_ms(lambda: engine._step(db), iters=3, reps=5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine._step(db)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    kernel_ms = sum(ms for _, ms in by_name.values())
    n_kernels = sum(n for n, _ in by_name.values())
    busy = f"{kernel_ms / step_ms:.3f}" if n_kernels else "not measured"
    log(f"predict step {step_ms:.2f} ms (CUDA events); split of one step: "
        f"hierarchy {hier_ms:.2f} ms, image stream {image_ms:.2f} ms, lidar "
        f"stream + heads {lidar_ms:.2f} ms; profiler: {n_kernels} device "
        f"activities, {kernel_ms:.2f} ms, busy share {busy}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    for name, (n, ms) in ranked:
        log(f"  {ms:8.3f} ms  x{n:<5d} {name[:100]}")
    return {"step_ms": step_ms, "hier_ms": hier_ms, "image_ms": image_ms,
            "lidar_and_heads_ms": lidar_ms, "device_activities": n_kernels,
            "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / step_ms if n_kernels else None,
            "top": [{"name": k, "count": n, "ms": ms}
                    for k, (n, ms) in ranked]}


# --------------------------------------------------------------------------- #
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np
    from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                           hier_from_cfg)
    from fusiontransformer_tpu_torch.ops.kernels import (LAUNCHES,
                                                         reset_launches)
    from fusiontransformer_tpu_torch.ops.kernels import build as kbuild
    from fusiontransformer_tpu_torch.serving.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # ---- 1. device and build
    log("== 1. device and build")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.time()
    report = kbuild.build()
    log(f"kernels built in {time.time() - t0:.1f} s (parallel nvcc): "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in report.items()))
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.freeze()
    t0 = time.time()
    engine = InferenceEngine(cfg, batch_size=1, seed=0)
    log(f"engine built in {time.time() - t0:.1f} s: {cfg.MODEL.TYPE}, ViT "
        f"{cfg.MODEL.VIT_IMG_SIZE}px depth {cfg.MODEL.VIT_DEPTH} width "
        f"{cfg.MODEL.VIT_EMBED_DIM}, buckets {engine.buckets}, "
        f"{sum(p.numel() for p in engine.model.parameters())} parameters, "
        f"compute {cfg.TPU.COMPUTE_DTYPE}")
    recs = records(N_REQUESTS, N_POINTS, engine.image_height,
                   engine.image_width)

    # A real batch through the port's hierarchy gives the kernels' shapes.
    samples = [engine.preprocess(recs[0])]
    batch = engine.collate(samples)
    if batch["gslot_overflow"] != 0:
        raise AssertionError(f"slot-map overflow {batch['gslot_overflow']}")
    hier = hier_from_cfg(cfg, device_batch(batch, engine.device))
    gen = torch.Generator().manual_seed(0)
    log(f"batch: {int(batch['scan_count'][0])} voxels in bucket "
        f"{len(batch['pt_valid'])}, level caps "
        f"{[l.valid.shape[0] for l in hier.levels]}, pool sizes "
        f"{[l.slot_idx[0].shape[1] for l in hier.levels if l.slot_idx]}")

    log("== 2. K3 sorted_segment_weighted_sum vs plain")
    k3_rows, k3 = phase_k3(hier, gen)
    log("== 3. K1 binned_conv_grouped_fwd vs plain")
    k1_rows, k1, k1_per_request = phase_k1(hier, engine.model, gen)

    # ---- 4. main path
    log("== 4. main path: InferenceEngine, bf16, batch 1")
    warm = engine.warmup()
    log(f"warmup (s per bucket): {warm}")
    reset_launches()
    lat, outs = [], []
    for rec in recs:
        t0 = time.perf_counter()
        outs.append(engine.predict(rec))
        lat.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    stats = engine.stats()
    for rec, out in zip(recs, outs):
        n = len(rec["points"])
        for key in ("labels", "labels_2d", "labels_3d"):
            lab = out[key]
            if lab.shape != (n,) or lab.min() < 0 or lab.max() >= 20:
                raise AssertionError(f"{key}: shape {lab.shape}, range "
                                     f"[{lab.min()}, {lab.max()}]")
    if stats["voxel_overflow"] != 0 or stats["collate_dropped_points"] != 0:
        raise AssertionError(f"lossy request path: {stats}")
    want = {"binned_conv_grouped_fwd": k1_per_request * N_REQUESTS,
            "sorted_segment_weighted_sum": 2 * N_REQUESTS}
    for name, n in want.items():
        if launches.get(name, 0) != n:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches "
                                 f"on the main path, expected {n}")
    _, logits = engine.forward([engine.preprocess(recs[0])])
    for k, v in logits.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite {k}")
    p50 = statistics.median(lat)
    log(f"requests {N_REQUESTS}: points {[len(r['points']) for r in recs]}, "
        f"p50 latency {p50 * 1e3:.1f} ms, {1 / statistics.mean(lat):.2f} "
        f"scans/s ({card}); launches {launches}; stats {stats}")
    # Where a request's time goes: its parts one after another, per record
    # (host clock; the device part ends in a synchronize).
    split = {"preprocess": [], "collate": [], "step": [], "complete": []}
    for rec in recs:
        t = [time.perf_counter()]
        sample = engine.preprocess(rec)
        t.append(time.perf_counter())
        host_batch = engine.collate([sample])
        t.append(time.perf_counter())
        packed = engine._step(device_batch(host_batch, engine.device))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        engine.complete(([sample], host_batch, packed), count_stats=False)
        t.append(time.perf_counter())
        for i, key in enumerate(split):
            split[key].append((t[i + 1] - t[i]) * 1e3)
    split_ms = {k: statistics.median(v) for k, v in split.items()}
    log(f"request split (host clock, medians of {len(recs)}): preprocess "
        f"{split_ms['preprocess']:.1f} ms, collate + slot maps "
        f"{split_ms['collate']:.1f} ms, copy + predict step "
        f"{split_ms['step']:.1f} ms, complete {split_ms['complete']:.1f} ms")
    db = device_batch(engine.collate([engine.preprocess(recs[0])]),
                      engine.device)
    breakdown = step_breakdown(engine, db)

    # ---- 5. main path against the plain path (f32, card vs CPU)
    log("== 5. f32 on the card vs the plain path on the CPU")
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    cfg32.freeze()
    state = {k: v.cpu() for k, v in engine.model.state_dict().items()}
    m_gpu = build_model(cfg32, "cuda")
    m_gpu.load_state_dict(state)
    m_cpu = build_model(cfg32, "cpu")
    m_cpu.load_state_dict(state)
    e_gpu = InferenceEngine(cfg32, model=m_gpu)
    e_cpu = InferenceEngine(cfg32, model=m_cpu, device="cpu")
    sample = e_gpu.preprocess(recs[0])
    t0 = time.time()
    _, out_gpu = e_gpu.forward([sample])
    _, out_cpu = e_cpu.forward([sample])
    log(f"  forward on card and CPU in {time.time() - t0:.1f} s")
    worst = 0.0
    for k in out_cpu:
        d = (out_gpu[k].cpu() - out_cpu[k]).abs().max().item()
        tol = F32_LOGIT_RTOL * out_cpu[k].abs().max().item()
        worst = max(worst, d)
        log(f"  {k}: max abs diff {d:.3g} (tol {tol:.3g})")
        if not d <= tol:
            raise AssertionError(f"f32 {k} differs by {d} > {tol}")
    lab_gpu = e_gpu.predict(recs[0])
    lab_cpu = e_cpu.predict(recs[0])
    for key in ("labels", "labels_2d", "labels_3d"):
        agree = float(np.mean(lab_gpu[key] == lab_cpu[key]))
        log(f"  {key}: card/CPU agreement {agree:.6f}")
        if agree < LABEL_AGREEMENT:
            raise AssertionError(f"{key} agreement {agree} < "
                                 f"{LABEL_AGREEMENT}")
    # How far the bf16 main path drifts from f32 at full width (reported,
    # not gated: random weights put many points near a class tie).
    _, out_bf16 = engine.forward([sample])
    lab_bf16 = engine.predict(recs[0])
    bf16_drift = {}
    for k in out_cpu:
        bf16_drift[k] = (out_bf16[k].float() - out_gpu[k]).abs().max().item()
        log(f"  bf16 vs f32 on the card, {k}: max abs diff "
            f"{bf16_drift[k]:.3g} (max |logit| "
            f"{out_gpu[k].abs().max().item():.3g})")
    for key in ("labels", "labels_2d", "labels_3d"):
        bf16_drift[key] = float(np.mean(lab_bf16[key] == lab_gpu[key]))
        log(f"  bf16 vs f32 on the card, {key}: agreement "
            f"{bf16_drift[key]:.6f}")

    # ---- 6. kernels line
    def entry(name, source, replaces, m, library_ms):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches.get(name, 0),
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": max(m["bound_t"], key=m["bound_t"].get),
                "library_ms": library_ms}

    detail = {"card": card, "binned_conv_grouped_fwd": k1_rows,
              "sorted_segment_weighted_sum": k3_rows,
              "engine": {"p50_ms": p50 * 1e3,
                         "scans_per_s": 1 / statistics.mean(lat),
                         "latencies_ms": [x * 1e3 for x in lat],
                         "request_split_ms": split_ms,
                         "step_breakdown": breakdown,
                         "f32_card_vs_cpu_max_abs": worst,
                         "bf16_vs_f32_on_card": bf16_drift}}
    log("== 6. kernels (ms, plain_ms, bound_ms, library_ms: per request "
        "at batch 1, summed over the path's calls, bf16)")
    log("detail: " + json.dumps(detail))
    print(json.dumps({"kernels": [
        entry("binned_conv_grouped_fwd", K1_SOURCE, K1_REPLACES, k1, None),
        entry("sorted_segment_weighted_sum", K3_SOURCE, K3_REPLACES, k3,
              k3["library_ms"])]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
