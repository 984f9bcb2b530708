#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives ``fusiontransformer_tpu_torch`` (and nothing of the JAX package) on
the card, in phases; any failure raises and the exit code is non-zero:

1. device and build — the card's name and power limit, then every kernel
   in ``fusiontransformer_tpu_torch/csrc`` built with nvcc (in parallel),
   with ptxas's registers, static shared memory and spills per kernel;
2. K3 ``sorted_segment_weighted_sum`` against its plain version at the
   flagship's shapes (voxelize_mean at L4 and L2 of a real batch, plus one
   E=8 case), bf16-rounding and precise, bitwise repeatable; eager and
   device (CUDA-graph) times, and each stream's rows, empty rows and
   points per row;
3. K1 ``binned_conv_grouped_fwd`` against its plain version on the same
   batch's group-pooled maps at L0-L3, for every (Cin, Cout) the flagship
   runs there, bf16 (the tensor-core kernel) and f32 (the CUDA-core one),
   each bitwise repeatable; for bf16 also the CUDA-core kernel's time on
   the same operands, the live (64-voxel tile, tap) and (group, tap)
   shares, and a forward that skips the center tap, which the check must
   fail;
4. the inference path — ``InferenceEngine`` for
   ``configs/semantic_kitti/middlefusion.yaml`` (DeiT-B/384 + SPVCNN cr 1.0,
   20 classes, random weights from a seed): warmup (one CUDA-graph capture
   per bucket), then requests of SyntheticSCN scans of about 18,000 points
   at batch 1 (graph replays), with the kernels' launch counts read around
   them (the wrappers launch while a graph is captured, exactly
   ``RUNS_PER_CAPTURE`` step runs a capture; every K1 on the tensor-core
   forward); then the same requests under the profiler, each replay's K1
   and K3 kernels counted exactly by name; the eager step's split and the
   replay's kernels and busy share;
5. the inference path against the plain path — the same weights and records
   in f32 on the card (TF32 off) and through the port on the CPU; and the
   bf16 path's drift from the f32 one on the card (reported);
6. K1 as in phase 3 and K2 ``binned_conv_grouped_bwd`` against its plain
   version at every grouped (level, Cin, Cout) of the flagship's train
   step, on a real training batch (10 scans, adaptive capacities), bf16 (dX
   and dW on the tensor cores) and f32 (on the CUDA cores), with dX and dW
   bitwise equal across two launches; each launch split into row table,
   dX, dW and reduce by kernel name from the profiler, each beside its
   bound, and for bf16 the CUDA-core route on the same operands beside the
   tensor-core one; whether the forward's, dX's and dW's times follow
   the live (tile, tap) share (the same maps with only the center tap, and
   with no live bin); K3 as in phase 2 at E=1 (voxelize_mean) and E=8 (the
   devoxelize adjoint) at L4 and L2 of the same batch; the card's bf16 GEMM
   gradient
   against the CPU's at the ViT's shapes;
7. one train step: f32, TF32 off, shared weights, dropout off, 2 scans (the
   batch is cut from 10 to keep the CPU's time short), on the CPU and on
   the card with the kernels, with the plain versions in their place, and
   with two deliberately wrong K2s; losses, every gradient, BN running
   statistics, confusion matrices, and each kernel call of the step
   against its plain version on the same inputs;
8. the training path — ``SemanticTrainer`` at the flagship's widths in
   bf16, batch 10 as ``middlefusion.yaml`` sets it, 3 steps and one
   validation over 30 SyntheticSCN scans through the trainer's CUDA graphs,
   with the kernels' launch counts read around it (held exactly against
   the trainer's captures: the wrappers launch in the eager run and the
   capture of each new signature); then the eager step's breakdown (host
   collate + slot maps, copy, step on CUDA events; forward / backward /
   optimizer / metrics from the step's own ``record_function`` ranges;
   device busy share); then every K1 and K2 call of one more bf16 eager
   train step (``make_train_step``) against its plain version on the same
   inputs (with the step's tensor-core launches counted), and the same step
   with a K2 whose dW misses 1/16 of the groups, which that check must
   catch;
17a. the trainer's CUDA graphs, group-pooled: ``set_sync_debug_mode
   ("error")`` around one eager train and eval step; one replay and two
   replays (fresh dropout masks) bit for bit the eager steps from the same
   saved state (losses, confusion matrices, parameters, BN statistics,
   gradients, Adam's moments and step, the generator), bf16 and f32, with
   each capture's seconds and the pool's bytes; a learning rate set after
   the capture reaching the replay; one replay's kernels by name from the
   profiler (K1 / K2 per conv, K3 and K3' twice) and its busy share; the
   step eager against graph, A B B A; validation's graphs bit for bit the
   eager eval step; ``train_for_one_epoch`` over 6 batches (a first epoch
   that captures, then 0 workers and N, all replays), train scans/s, with
   N, ``os.cpu_count()`` and no CUDA in a worker; ``GRAD_ACCUM_STEPS 2``:
   parameters bitwise unchanged after the odd micro-steps, after the even
   one within ``ACCUM_RTOL`` of one eager step on the mean gradient;

then the same configuration with ``TPU.CONV_SLOT_POOL False`` (no host slot
maps; the hierarchy builds per-voxel K-slot maps on the card):

9. K1' ``binned_conv_slots_fwd`` on the batch-1 serving scan's and the
   batch-10 training batch's per-voxel maps (as K1 in phase 3) and K2'
   ``binned_conv_slots_bwd`` on the training batch's, at every L0-L3
   (Cin, Cout), against their plain versions, bf16 and f32, bitwise
   repeatable, K2' split as K2 in phase 6; what the maps cost inside the
   hierarchy build;
10. ``InferenceEngine`` on the per-voxel path, 8 requests at batch 1 as in
    phase 4 (graphs, launches held exactly as there); its f32 logits on
    the card against the CPU's and against the group-pooled path's on the
    card; its eager predict step side by side with the group-pooled one;
11. one f32 train step on the per-voxel path as in phase 7 (with a K2'
    whose dW misses 1/16 of the groups), then ``SemanticTrainer`` as in
    phase 8, with its bf16 per-call K1' / K2' check; its train step side by
    side with the group-pooled one;
17b. the trainer's CUDA graphs on the per-voxel path, as 17a;

then the flagship on real-format data, each path with every launch count
set to 0 just before it and read just after (held exactly against the
trainer's captures):

18. SemanticKITTI-format: a raw tree (``tools/fabricate.py``: 20 train, 10
    val and 4 test frames of ~21,000 in-frustum points, 370 x 1226 PNGs)
    through the preprocess CLI, ``train.py`` with ``middlefusion.yaml``
    (only the directories, one epoch and a validation set: 2 steps of 10),
    finite losses, no overflow and no lost point; the item's host time,
    validation's, the training window at 0 and 6 workers; one val batch's
    eval replay bit for bit the eager eval step, and K1 and K3 on that
    batch's maps against their plain versions as in phases 3 and 2; then
    ``test.py`` on the checkpoint (batch 1), its confusion matrices equal
    to an in-process ``validate`` of the same checkpoint, every prediction
    a raw SemanticKITTI id after the inverse map;
19. NuScenes-format: a database of ~10,000-point scans with 1600 x 900
    JPEGs (``tools/fabricate.py::FakeNuScenes``) through the preprocessor
    (USA train, Singapore validation subsets) and ``train.py`` with
    ``configs/nuscenes/middlefusion.yaml`` (5 classes, 400 x 225, batch 8):
    2 steps and a validation, finite losses, no lost point, predictions in
    [0, 5);
20. the uni-modal models on the same trees, each config as shipped but
    for its directories, each path's launch counts set to 0 just before it
    and read just after:
    20a ``lidar.yaml`` (LidarSeg: SPVCNN cr 1.0 alone, batch 10, bf16):
    ``train.py`` (2 steps and a validation), K1 / K2 / K3 / K3' launches
    held exactly against the trainer's captures, validation's ms a scan,
    one train replay bit for bit the eager step, the replay's time, its
    kernels by name and busy share, the training window at 0 and 6
    workers, every K1 and K2 call of one bf16 step against its plain
    version; ``test.py`` (batch 1) equal to an in-process ``validate``;
    ``InferenceEngine`` for 8 requests at batch 1 through its graphs (K1 /
    K3 launches held against its captures and counted in the replays,
    ``pred`` == ``pred_3d``), its f32 logits on the card (TF32 off) within
    2e-3 of the CPU's;
    20b ``nuscenes/lidar.yaml``: 2 steps and a validation, launches held
    as in 20a, predictions in [0, 5);
    20c ``imageBilinear.yaml`` (the ViT alone): 2 steps and a validation,
    batches without slot maps (their host collate timed), no hand-written
    kernel launched, one train replay bit for bit the eager step;
    ``InferenceEngine`` for 8 requests;
    20d ``image.yaml`` (the STN ``ImageSeg``): as 20c without the engine,
    with the peak device memory;

then the tool kernels, the port's counterparts of the JAX tools' Pallas
kernels:

12. the port's three microbenches as a user runs them
    (``fusiontransformer_tpu_torch.tools.microbench_dma_gather``,
    ``microbench_gather``, ``microbench_attention``, default arguments),
    with the launch counts read around them; then T1 ``gather_blocks8``,
    T2 ``gather_rows_sum_pipelined`` and T3 ``gather_rows_sum_smem`` on the
    flagship's own L0 and L2 per-voxel maps (T1 bit for bit, T2/T3 within
    SUM_ORDER_RTOL of the sum of |rows| and bitwise repeatable; per 16384
    indices and for the whole level in one launch; T2/T3 timed over
    CUDA-graph replays and eagerly, with the gathered GB/s and the bound,
    beside the previous design's times in ``EARLIER``), and T4
    ``flash_attention`` at DeiT-B/384 shapes, B = 1, 2, 8, 12 chained calls,
    plus a tail-heavy and a negative-score input, each within ATTN_TOL of
    its plain version, with SDPA timed beside it;
14. the native host code (``native/ftx_host.cpp``): its g++ build time;
    the native quantize and slot triples bit for bit against their numpy
    versions on every call of phase 4's 8 requests and of one batch-10
    training batch, every ``gslot_*`` array equal both ways, and the host
    ms of each side per request and per batch of 10;
15. the engine's CUDA graphs, in both configurations: per bucket (and the
    serving scan) the capture's seconds and the graph pool's bytes, the
    replay bit for bit against the eager step in bf16 and f32; three
    batches dispatched before any completes, each equal to its serial
    result; ``TPU.STEP_CACHE_SIZE 1`` evicting and recapturing; the 8
    requests eager against graph, A B B A (p50, scans/s), the predict step
    side by side on CUDA events, the replay's kernels and busy share;
16. the server: ``fusiontransformer_tpu_torch.tools.serve --selftest 16
    --clients 4`` at full width, over HTTP on the loopback: p50 / p99
    latency and scans/s of each of its two passes (the first captures the
    graphs of new slot-pool sizes), each response equal to the engine's
    serial prediction, ``/stats`` and ``/healthz``;

13. (printed after 14-16) a ``{"kernels": [...]}`` line: launches, errors
    and times of each kernel; K1 and K1' also carry their device time over
    CUDA-graph replays, the CUDA-core kernel's times on the same operands,
    the tensor-core forward's launches on the path, the engine's captures
    and the kernel's launches in the 8 requests' replays
    (``replay_launches``, as K3 does), and the same numbers per train
    step; K2 and K2' their row table / dX / dW / reduce times, the dX
    and dW bounds, the CUDA-core route's times on the same bf16 operands,
    and the tensor-core launches on the path (``dw_launches``,
    ``fwd_mma_launches``); K1 / K2 / K3 / K3' and the per-voxel pair
    their kernels in one train-graph replay (``train_replay_kernels``),
    and K1 / K2 / K3 / K3' those of the lidar-only model's replay and its
    training path's launches (``lidar_train_replay_kernels``,
    ``lidar_launches``, phase 20a).

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Times are CUDA-event medians (phase 12's kernel and library times over
CUDA-graph replays: those calls are shorter than a launch from Python);
``bound_ms`` is the larger of bytes over 3.35 TB/s and flops over the peak
rate of the operand type (989 TFLOP/s bf16, 67 TFLOP/s f32) of an H100 SXM;
T4's also counts its exponentials at 16 a clock per SM.  The ``detail`` line
carries each redesigned kernel's time before its redesign, from earlier
runs of this script (``EARLIER``), beside this run's.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

CONFIG = "configs/semantic_kitti/middlefusion.yaml"
N_REQUESTS = 8
N_POINTS = 18000
SERVER_REQUESTS = 16
SERVER_CLIENTS = 4
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# Exponentials: the special-function units give 16 results a clock per SM
# for ex2 (CUDA C Programming Guide, arithmetic instruction throughput,
# compute capability 9.0), at the card's max SM clock (nvidia-smi).
H100_SMS = 132
EXP_PER_CLOCK_PER_SM = 16
K1_SOURCE = "fusiontransformer_tpu_torch/csrc/binned_conv.cu"
K1_REPLACES = "fusiontransformer_tpu/ops/pallas/binned_conv.py:123"
K3_SOURCE = "fusiontransformer_tpu_torch/csrc/segment_sum.cu"
K3_REPLACES = "fusiontransformer_tpu/ops/pallas/segment_sum.py:129"
K2_REPLACES = "fusiontransformer_tpu/ops/pallas/binned_conv.py:198"
# The tool kernels (phase 12): the port's counterparts of the Pallas
# row-gather probes and of the TPU flash attention the JAX tools call.
GATHER_SOURCE = "fusiontransformer_tpu_torch/csrc/row_gather.cu"
FLASH_SOURCE = "fusiontransformer_tpu_torch/csrc/flash_attention.cu"
TOOL_KERNELS = {
    "gather_blocks8": "tools/microbench_dma_gather.py:89",
    "gather_rows_sum_pipelined": "tools/microbench_dma_gather.py:155",
    "gather_rows_sum_smem": "tools/microbench_dma_gather.py:190",
    "flash_attention": "tools/microbench_attention.py:42"}
ATTN_BATCHES = (1, 2, 8)
# Times of the redesigned kernels in their designs before, on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md section 6): T4, K3 and K3' before wgmma /
# TMA and the point-balanced chunks (earlier runs of this script; T4 per 12
# chained calls, K3 per request at batch 1, K3' per train step at batch 10);
# T2 and T3 before the staged indices, the cluster-resident table and the
# single launch (tools/step_ab.py --gather on that design beside this one:
# one whole-level call at L0 and at L2 over CUDA-graph replays, the mean of
# the design's two runs, and the levels' sum).
EARLIER_FROM = "earlier runs of this script, the previous kernel designs"
GATHER_FROM = "tools/step_ab.py --gather, the previous kernel design"
EARLIER = {"flash_attention": {"b1_ms": 0.162, "b2_ms": 0.211,
                               "b8_ms": 0.645, "from": EARLIER_FROM},
           "sorted_segment_weighted_sum": {"ms": 0.0467,
                                           "from": EARLIER_FROM},
           "sorted_segment_weighted_sum[E=8]": {"ms": 0.850,
                                                "from": EARLIER_FROM},
           "gather_rows_sum_pipelined": {"ms": 0.0892, "L0_ms": 0.0456,
                                         "L2_ms": 0.0437,
                                         "from": GATHER_FROM},
           "gather_rows_sum_smem": {"ms": 0.0586, "L0_ms": 0.0298,
                                    "L2_ms": 0.0288, "from": GATHER_FROM}}
# The training path: the flagship's model and training settings
# (middlefusion.yaml) on SyntheticSCN scans, 3 steps of batch 10 and one
# validation over the same number of scans; then a steady window of
# WINDOW_STEPS more steps.
TRAIN_STEPS = 3
TRAIN_BATCH = 10
WINDOW_STEPS = 6
PARITY_SCANS = 2
# Kernel vs plain version: both sum the same f32 products in another order,
# so the difference is held against the sum of |products| (the plain
# version on absolute values) times this factor.
SUM_ORDER_RTOL = 2e-5
# Main path in f32, card vs CPU: same arithmetic, other summation orders
# through ~40 layers.  Each output is held to this factor of its largest
# |logit|; H100 runs measured ~1e-6 of it (PERF.md), so 1e-4 leaves 100x.
F32_LOGIT_RTOL = 1e-4
LABEL_AGREEMENT = 0.999
# bf16 GEMM gradient, card vs CPU: one extra bf16 rounding (2^-8 relative)
# of the incoming gradient and one of the result, against the sum of |terms|.
GEMM_GRAD_RTOL = 1e-2
# One f32 train step, compared leaf by leaf (phase 7): losses relative;
# gradients as shares of each leaf's largest |g| (each leaf within "leaf"
# plus LEAF_ATOL, the median over all leaves, the median over the 30 K1/K2
# conv kernels); BN running statistics as shares of each buffer's largest
# value.  Train-mode BatchNorm amplifies f32 summation-order differences
# into the conv kernels' gradients.  Readings on an H100 (PERF.md):
# card with the kernels vs CPU: worst leaf 0.0249 (an L3 conv), conv median
# 1.31e-3, all-leaf median 7.9e-6, BN 1.3e-6, losses 2e-7; the card with the
# plain versions in place of the kernels reads the same against the CPU
# (0.025, 1.35e-3), so the gap is not the kernels'; card with kernels vs
# card with plain versions: worst leaf 2.4e-3, conv median 1.75e-4; a K2
# whose dW misses 1/16 of the groups or whose dX skips the tap reversal:
# conv median 0.37 / 0.85, worst leaf 0.97 / 2.0.  Each limit sits between.
LEAF_ATOL = 1e-7
CPU_GATES = {"loss": 1e-5, "leaf": 0.1, "median": 1e-4, "conv_median": 1e-2,
             "bn": 1e-4}
CARD_GATES = {**CPU_GATES, "leaf": 2e-2, "conv_median": 2e-3}


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
    from fusiontransformer_tpu_torch.utils.profiler import time_cuda
    return time_cuda(fn, iters=reps, calls=iters)[0]


def kernel_name(mangled):
    """A kernel's name (and its tile, for the dW kernel) from its mangled
    name: the length-prefixed identifier ending in ``_kernel`` (the
    anonymous namespace's own mangled name ends in hex digits, so each
    suffix of a digit run is tried as the length)."""
    import re
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            n = int(m.group()[i:])
            ident = mangled[m.end():m.end() + n]
            if n and len(ident) == n and ident.endswith("_kernel") \
                    and ident.isidentifier():
                tile = re.match(r"ILi(\d+)ELi(\d+)E", mangled[m.end() + n:])
                return ident + (f"<{tile[1]},{tile[2]}>" if tile else "") + (
                    " (bf16)" if "bfloat16" in mangled else "")
    return mangled


def ptxas_summary(text):
    """(kernel, properties) for each entry function in nvcc's ``-Xptxas -v``
    log: its spills and stack, then its registers and static shared memory
    (the dW kernel's ring is dynamic shared memory, 3 x 64 x (tile_m +
    tile_n) bf16, which ptxas does not count)."""
    import re
    out, entry = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = kernel_name(m.group(1))
        elif entry and ("registers" in line or "spill" in line):
            out.append((entry, line.split(":", 1)[-1].strip()))
    return out


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def segment_stats(ids, num_out):
    """Rows, empty rows and points per non-empty row (p50 / p99 / max) of a
    sorted K3 stream."""
    import torch
    counts = torch.bincount(ids[ids < num_out].long(), minlength=num_out)
    live = counts[counts > 0].float()
    q = (torch.quantile(live, torch.tensor([0.5, 0.99], device=live.device))
         .tolist() if live.numel() else [0.0, 0.0])
    return {"rows": num_out, "empty_rows": int((counts == 0).sum()),
            "p50": q[0], "p99": q[1],
            "max": int(live.max()) if live.numel() else 0}


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
def k3_case(label, g, w, ids, num_out, main=None):
    """K3 on one stream against its plain version, bf16-rounding and
    precise: the check (SUM_ORDER_RTOL of the sum of |products|, bitwise
    repeatable), times eager (``ms``, the host launch included) and over
    CUDA-graph replays (``graph_ms``, the device), the plain version's, one
    ``index_add_`` of the precomputed products, the bound, and the stream's
    segment lengths.  The bf16 rows add into ``main``."""
    import torch
    from fusiontransformer_tpu_torch.ops.kernels.segment_sum import (
        sorted_segment_weighted_sum, sorted_segment_weighted_sum_ref)
    dev = g.device
    e, c = w.shape[1], g.shape[1]
    stats = segment_stats(ids, num_out)
    rows = []
    for precise in (False, True):
        out = sorted_segment_weighted_sum(g, w, ids, num_out, precise)
        again = sorted_segment_weighted_sum(g, w, ids, num_out, precise)
        ref = sorted_segment_weighted_sum_ref(g, w, ids, num_out, precise)
        scale = sorted_segment_weighted_sum_ref(
            g.abs(), w.abs(), ids, num_out, True).max().item()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not err <= SUM_ORDER_RTOL * scale:
            raise AssertionError(f"K3 {label} precise={precise}: max abs "
                                 f"err {err} > {SUM_ORDER_RTOL} x {scale}")
        if not torch.equal(out, again):
            raise AssertionError(f"K3 {label} precise={precise}: two "
                                 "launches differ")
        del out, again, ref
        ms = cuda_ms(lambda: sorted_segment_weighted_sum(
            g, w, ids, num_out, precise))
        g_ms = graph_ms(lambda: sorted_segment_weighted_sum(
            g, w, ids, num_out, precise))
        plain_ms = cuda_ms(lambda: sorted_segment_weighted_sum_ref(
            g, w, ids, num_out, precise), iters=3, reps=3)
        live = int((ids < num_out).sum())
        nbytes = 4 * (g.numel() + w.numel() + ids.numel()
                      + num_out * e * c)
        b_ms, b_by = bound(nbytes, 2 * live * e * c, "float32")
        # One PyTorch call computing the same sums from the same per-point
        # products: index_add_ (the products precomputed).
        contrib = (w[:, :, None] * g[:, None, :]).reshape(len(ids), -1)
        ids_c = ids.long().clamp(max=num_out)
        acc = torch.zeros(num_out + 1, e * c, device=dev)
        lib_ms = cuda_ms(lambda: acc.index_add_(0, ids_c, contrib))
        del contrib, acc
        rows.append(dict(case=label, precise=precise, N=len(ids), C=c, E=e,
                         num_out=num_out, segments=stats, max_abs_err=err,
                         tol=SUM_ORDER_RTOL * scale, ms=ms, graph_ms=g_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms))
        log(f"  K3 {label:22s} precise={int(precise)} N={len(ids)} C={c} "
            f"E={e} rows={num_out}: err {err:.3g} (tol "
            f"{SUM_ORDER_RTOL * scale:.3g})  kernel {ms:.4f} ms (device "
            f"{g_ms:.4f})  plain {plain_ms:.4f} ms  index_add_ {lib_ms:.4f} "
            f"ms  bound {b_ms:.4f} ms ({b_by})")
        if main is not None:
            main["max_abs_err"] = max(main["max_abs_err"], err)
            if not precise:              # the bf16 main path's calls
                for k, v in (("ms", ms), ("graph_ms", g_ms),
                             ("plain_ms", plain_ms), ("bound_ms", b_ms),
                             ("library_ms", lib_ms)):
                    main[k] += v
                main["bound_t"][b_by] = main["bound_t"].get(b_by, 0) + b_ms
    log(f"  K3 {label:22s} segments: {stats['rows']} rows, "
        f"{stats['empty_rows']} empty; points per row p50 {stats['p50']:.0f}"
        f" p99 {stats['p99']:.0f} max {stats['max']}")
    return rows


def k3_main():
    return {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "library_ms": 0.0, "max_abs_err": 0.0, "bound_t": {}}


def k3_voxmean_cases(hier, gen):
    """voxelize_mean's K3 streams at L4 (C = 257) and L2 (C = 129)."""
    import torch
    from fusiontransformer_tpu_torch.ops import sparse_conv as sc
    dev = hier.pt_valid.device
    n_pts = hier.pt_valid.shape[0]
    for level, width in ((4, 256), (2, 128)):
        plan = sc.devox_plan(hier, level)
        feats = torch.randn(n_pts, width, generator=gen).to(dev)
        yield (f"voxelize_mean L{level}",
               *sc.voxmean_stream(feats, hier.pt_valid, plan),
               hier.levels[level].valid.shape[0])


def phase_k3(hier, gen):
    """K3 vs plain at L4 (C=257) and L2 (C=129), E=1, on the serving batch,
    and an E=8 case (off the serving path)."""
    import torch
    from fusiontransformer_tpu_torch.ops import sparse_conv as sc
    dev = hier.pt_valid.device
    n_pts = hier.pt_valid.shape[0]
    rows, main = [], k3_main()
    for label, g, w, ids, num_out in k3_voxmean_cases(hier, gen):
        rows += k3_case(label, g, w, ids, num_out, main)
    plan = sc.devox_plan(hier, 2)
    perm = plan.sort_perm.long()
    dout = torch.randn(n_pts, 128, generator=gen).to(dev)
    g = sc.pad_row(dout)[perm].contiguous()
    w = sc.pad_row(hier.pt_corner_w[2])[perm].contiguous()
    rows += k3_case("corner sums L2 (E=8)", g, w,
                    plan.ids_sorted.contiguous(),
                    hier.levels[2].valid.shape[0])
    return rows, main


def slot_convs(model, hier):
    """(level, Cin, Cout, kernel) of every ks3 conv of the model that runs
    at a level carrying slot maps (group-pooled or per-voxel), in the
    model's order."""
    from fusiontransformer_tpu_torch.models.spvcnn import SubMConv3
    level_of = {"stem0": 0, "stem1": 0, "stage1": 1, "stage2": 2,
                "stage3": 3, "stage4": 4, "up1": 3, "up2": 2, "up3": 1,
                "up4": 0}
    out = []
    backbone = (model.lidar_backbone.backbone
                if hasattr(model, "lidar_backbone") else model.backbone)
    for name, m in backbone.named_modules():
        if isinstance(m, SubMConv3):
            level = level_of[name.split("_")[0]]
            if hier.levels[level].slot_idx is not None:
                out.append((level, m.kernel.shape[1], m.kernel.shape[2],
                            m.kernel.detach()))
    return out


def binned_kernels(kind):
    """The kernel pair of one kind of slot map, with their plain versions:
    "grouped" (K1, K2 on group-pooled maps) or "slots" (K1', K2' on
    per-voxel K-slot maps); ``live`` counts the slots that feed a bin."""
    from fusiontransformer_tpu_torch.ops.kernels import binned_conv as bc
    if kind == "grouped":
        return dict(ids=("K1", "K2"), width="S",
                    fwd=bc.binned_conv_grouped_fwd,
                    ref=bc.binned_conv_grouped_ref,
                    bwd=bc.binned_conv_grouped_bwd,
                    bwd_ref=bc.binned_conv_grouped_bwd_ref,
                    bwd_launch=(bc.BWD_NAME, "ftx_binned_conv_grouped_bwd"),
                    sentinel=216,
                    live=lambda src, codes, v: int(
                        ((codes < 216) & (src < v)).sum()))
    return dict(ids=("K1'", "K2'"), width="K", fwd=bc.binned_conv_slots_fwd,
                ref=bc.binned_conv_slots_ref, bwd=bc.binned_conv_slots_bwd,
                bwd_ref=bc.binned_conv_slots_bwd_ref,
                bwd_launch=(bc.SLOTS_BWD_NAME, "ftx_binned_conv_slots_bwd"),
                sentinel=27,
                live=lambda src, codes, v: int(((codes < 27) & (src < v))
                                               .sum()))


def dw_missing_groups(kind):
    """A deliberately wrong K2 (or K2'): dX as the kernel's, dW from maps
    whose first 1/16 of the voxel groups feed no bin.  Map rows are groups
    (group-pooled maps) or voxels, 8 to a group (per-voxel maps)."""
    kk = binned_kernels(kind)
    bwd = kk["bwd"]

    def wrong(d, x, src, codes, w):
        cut = codes.clone()
        rows = len(cut) // 16 if kind == "grouped" else len(cut) // 128 * 8
        cut[:max(1, rows)] = kk["sentinel"]
        return bwd(d, x, src, codes, w)[0], bwd(d, x, src, cut, w)[1]
    return wrong


# K2's launch runs these kernels, by the name the profiler gives them: the
# row table (bf16: one a launch, read by dX and dW), dX (bf16: the
# tensor-core forward on dout and W[26-t] read transposed; f32: the
# tap-reversed W, then the CUDA-core forward), dW (the tensor-core kernel
# for bf16, the CUDA-core kernel for f32), and the fixed-order sum of the
# chunks' partials.
BWD_PARTS = {"rows": ("bin_rows_kernel", "Memset"),
             "dx": ("flip_transpose_kernel", "binned_conv_grouped_fwd_kernel",
                    "binned_conv_fwd_mma_kernel"),
             "dw": ("binned_conv_dw_mma_kernel",
                    "binned_conv_grouped_dw_kernel"),
             "reduce": ("reduce_chunks_kernel",)}
BWD_NEED = {1: ("bin_rows_kernel", "binned_conv_fwd_mma_kernel",
                "binned_conv_dw_mma_kernel", "reduce_chunks_kernel"),
            0: ("flip_transpose_kernel", "binned_conv_grouped_fwd_kernel",
                "binned_conv_grouped_dw_kernel", "reduce_chunks_kernel")}


def bwd_split(fn, route, calls=5, attempts=4):
    """Device ms per call of each part of one backward launch (BWD_PARTS)
    from a profiler trace of ``calls`` calls after one warm call.  Each of
    the launch's kernels runs once a call, so a part's time is the sum of
    its kernels' median durations.  The H100 machines' traces drop some
    kernel records; a median needs only one record, so a trace is taken
    again (up to ``attempts`` times) only while a kernel has none, and
    otherwise every part is None (not measured)."""
    import statistics as st
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = next((n for names in BWD_PARTS.values() for n in names
                             if n in e.name), None)
                if name is not None:
                    times.setdefault(name, []).append(
                        e.time_range.elapsed_us() / 1e3)
        if all(n in times for n in BWD_NEED[route]):
            return {p: sum(st.median(times[n]) for n in names if n in times)
                    for p, names in BWD_PARTS.items()}
    return dict.fromkeys(BWD_PARTS)


def tap_skipped(kind, fwd, tap=13):
    """A deliberately wrong forward: the kernel on maps whose tap ``tap``
    (the center tap by default, live at every valid voxel) feeds no bin."""
    sentinel = binned_kernels(kind)["sentinel"]

    def wrong(x, src, codes, w):
        cut = codes.clone()
        cut[(cut // 8 if kind == "grouped" else cut) == tap] = sentinel
        return fwd(x, src, cut, w)
    return wrong


def phase_k1(hier, model, gen, kind="grouped", per="request"):
    """K1 (or K1') vs plain at every slot-map (level, Cin, Cout), bf16 (the
    tensor-core kernel) and f32 (the CUDA-core kernel), each launch bitwise
    repeatable.  For bf16 also the CUDA-core kernel on the same operands (the
    route f32 takes, and the kernel bf16 ran before), the share of (64-voxel
    tile, tap) and (8-voxel group, tap) pairs that hold a live bin, the
    device time of every (Cout tile, k-step) pair beside the schedule's
    pick, and a forward that skips the center tap, which the check must
    fail.  Times on
    CUDA events: eager (``ms``, what a caller's launch costs) and over
    CUDA-graph replays (``graph_ms``, the device's time).  ``per``: what the
    counts are per (a "request" or a "train step")."""
    import torch
    from fusiontransformer_tpu_torch.ops.kernels import binned_conv as bc
    kk = binned_kernels(kind)
    fwd, fwd_ref, kid = kk["fwd"], kk["ref"], kk["ids"][0]
    symbol = ("ftx_binned_conv_grouped_fwd" if kind == "grouped"
              else "ftx_binned_conv_slots_fwd")
    wrong_fwd = tap_skipped(kind, fwd)
    dev = hier.pt_valid.device
    convs = slot_convs(model, hier)
    shapes = {}
    for level, cin, cout, w in convs:
        shapes.setdefault((level, cin, cout), [0, w])[0] += 1
    keys = ("ms", "graph_ms", "plain_ms", "bound_ms", "cuda_core_ms",
            "cuda_core_graph_ms", "best_tiles_graph_ms", "live_flops",
            "tile_flops", "group_flops")
    rows, main = [], {**dict.fromkeys(keys, 0.0), "max_abs_err": 0.0,
                      "max_share": 0.0, "wrong_share": math.inf,
                      "bound_t": {}, "per": per}
    for (level, cin, cout), (count, w) in sorted(shapes.items()):
        src, binp = hier.levels[level].slot_idx
        v = hier.levels[level].valid.shape[0]
        live = kk["live"](src, binp, v)
        table = bc.bin_rows_ref(src, binp, per_voxel=kind == "slots")
        share64 = bc.live_tile_share(table, 64)
        share8 = bc.live_tile_share(table, 8)
        del table
        x32 = torch.randn(v, cin, generator=gen).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x, wd = x32.to(dtype), w.to(dtype).contiguous()
            out = fwd(x, src, binp, wd)
            out2 = fwd(x, src, binp, wd)
            ref = fwd_ref(x, src, binp, wd)
            scale = fwd_ref(x.abs(), src, binp, wd.abs()).max().item()
            torch.cuda.synchronize()
            if not torch.equal(out, out2):
                raise AssertionError(f"{kid} L{level} {cin}->{cout} {dtype}: "
                                     f"differs between two launches")
            err = (out - ref).abs().max().item()
            if not err <= SUM_ORDER_RTOL * scale:
                raise AssertionError(
                    f"{kid} L{level} {cin}->{cout} {dtype}: max abs err "
                    f"{err} > {SUM_ORDER_RTOL} x {scale}")
            del out2
            ms = cuda_ms(lambda: fwd(x, src, binp, wd))
            gms = graph_ms(lambda: fwd(x, src, binp, wd))
            plain_ms = cuda_ms(lambda: fwd_ref(x, src, binp, wd), iters=3,
                               reps=3)
            tname = str(dtype).replace("torch.", "")
            nbytes = (x.numel() * x.element_size() + 8 * src.numel()
                      + wd.numel() * wd.element_size() + 4 * v * cout)
            b_ms, b_by = bound(nbytes, 2 * live * cin * cout, tname)
            row = dict(level=level, cin=cin, cout=cout, dtype=tname,
                       **{f"per_{per.replace(' ', '_')}": count}, V=v,
                       **{kk["width"]: src.shape[1]}, live_slots=live,
                       live_tile64_share=share64, live_group8_share=share8,
                       max_abs_err=err, tol=SUM_ORDER_RTOL * scale,
                       bitwise_repeat=True, ms=ms, graph_ms=gms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            extra = ""
            if dtype == torch.bfloat16:
                sched = bc.fwd_schedule(v, cin, cout, dtype)
                core = bc.fwd_schedule(v, cin, cout, torch.float32)
                wrong = (wrong_fwd(x, src, binp, wd) - ref).abs().max().item()
                if wrong <= SUM_ORDER_RTOL * scale:
                    raise AssertionError(f"the check does not catch a {kid} "
                                         f"that skips the center tap: {wrong}")

                def launch(s):
                    return lambda: bc._launch_fwd(kid, symbol, x, src, binp,
                                                  wd, s)
                core_ms = cuda_ms(launch(core))
                core_gms = graph_ms(launch(core))
                # The schedule's pick against every (Cout tile, k-step).
                tiles = {f"{tn}x{tk}": graph_ms(launch(sched._replace(
                    tile_n=tn, tile_k=tk, tiles_n=-(-cout // tn))))
                    for tn in (32, 64) for tk in (32, 64)}
                best = min(tiles, key=tiles.get)
                row.update(schedule=sched._asdict(), cuda_core_ms=core_ms,
                           cuda_core_graph_ms=core_gms, tiles_graph_ms=tiles,
                           wrong_share=wrong / scale)
                main["best_tiles_graph_ms"] += count * tiles[best]
                extra = (f"; tensor cores {sched.tile_m}x{sched.tile_n}x"
                         f"{sched.tile_k} (of the Cout tile x k-step pairs "
                         f"{best} is fastest: " + ", ".join(
                             f"{k} {v:.4f}" for k, v in tiles.items())
                         + f"), CUDA cores on these operands "
                         f"{core_ms:.4f} ms (graph {core_gms:.4f}); live "
                         f"(64-voxel tile, tap) {share64:.3f}, (group, tap) "
                         f"{share8:.3f}; center tap skipped: "
                         f"{wrong / scale:.3g}")
                for key, val in (("ms", ms), ("graph_ms", gms),
                                 ("plain_ms", plain_ms), ("bound_ms", b_ms),
                                 ("cuda_core_ms", core_ms),
                                 ("cuda_core_graph_ms", core_gms),
                                 ("live_flops", 2 * live * cin * cout),
                                 ("tile_flops", 2 * share64 * 27 * v * cin
                                  * cout),
                                 ("group_flops", 2 * share8 * 27 * v * cin
                                  * cout)):
                    main[key] += count * val
                main["bound_t"][b_by] = (main["bound_t"].get(b_by, 0)
                                         + count * b_ms)
                main["wrong_share"] = min(main["wrong_share"], wrong / scale)
            rows.append(row)
            log(f"  {kid} L{level} {cin:3d}->{cout:3d} {tname:8s} x{count} "
                f"V={v} {kk['width']}={src.shape[1]} live={live}: err "
                f"{err:.3g} (tol {SUM_ORDER_RTOL * scale:.3g}), bitwise "
                f"repeatable  kernel {ms:.4f} ms (graph {gms:.4f})  plain "
                f"{plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}){extra}")
            main["max_abs_err"] = max(main["max_abs_err"], err)
            main["max_share"] = max(main["max_share"], err / scale)
    log(f"  {kid} per {per}, bf16, summed over its {len(convs)} calls: "
        f"tensor cores {main['ms']:.3f} ms (graph {main['graph_ms']:.3f}; "
        f"with each shape's fastest tiles {main['best_tiles_graph_ms']:.3f}), "
        f"CUDA cores on the same operands {main['cuda_core_ms']:.3f} ms "
        f"(graph {main['cuda_core_graph_ms']:.3f}), bound "
        f"{main['bound_ms']:.4f} ms; TFLOP live bins "
        f"{main['live_flops'] / 1e12:.4f}, live (64-voxel tile, tap) "
        f"{main['tile_flops'] / 1e12:.4f} (what the kernel multiplies), "
        f"live (group, tap) {main['group_flops'] / 1e12:.4f}; worst share "
        f"{main['max_share']:.3g}, center tap skipped >= "
        f"{main['wrong_share']:.3g}")
    return rows, main, len(convs)


def step_breakdown(engine, db, top=12):
    """Where one eager predict step's time goes.  CUDA events recorded
    between the hierarchy build, the image stream and the lidar stream +
    heads of the same step split it (medians of 7 steps; the parts of one
    step add up to its time); ``torch.profiler`` sums the kernels of one
    step by name.  The device busy share is that kernel time over the
    unprofiled step time."""
    import torch
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
    by_name = device_kernels(lambda: engine._step(db))
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


# Every capture runs the step twice through the kernels' wrappers: eagerly
# on a side stream (which builds the kernels), then into the graph.  A
# replay runs no wrapper, so its kernels are read from the profiler.
RUNS_PER_CAPTURE = 2


def device_kernels(fn):
    """{name: (count, ms)} of the device activities (kernels, copies) that
    ``torch.profiler`` records while ``fn`` runs, synchronised at the end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return by_name


def count_of(by_name, part):
    """Activities whose name holds ``part``."""
    return sum(n for name, (n, _) in by_name.items() if part in name)


def kernels_only(by_name):
    return {k: v for k, v in by_name.items()
            if not k.startswith(("Memcpy", "Memset"))}


def replay_breakdown(engine, batch, top=8):
    """One graph replay of ``batch``'s signature: its device time on CUDA
    events (median), and by the profiler its kernels by name and their
    time, whose share of the replay is the busy share."""
    from fusiontransformer_tpu_torch.modules.steps import batch_signature
    graph = engine.graphs.get(batch_signature(batch))
    replay_ms = cuda_ms(graph.graph.replay, iters=5, reps=5)
    by_name = kernels_only(device_kernels(graph.graph.replay))
    n = sum(c for c, _ in by_name.values())
    kernel_ms = sum(ms for _, ms in by_name.values())
    log(f"  graph replay {replay_ms:.2f} ms (CUDA events); profiler: {n} "
        f"kernels, {kernel_ms:.2f} ms, busy share "
        f"{kernel_ms / replay_ms:.3f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    for name, (c, ms) in ranked:
        log(f"  {ms:8.3f} ms  x{c:<5d} {name[:100]}")
    return {"replay_ms": replay_ms, "kernels": n, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / replay_ms,
            "top": [{"name": k, "count": c, "ms": ms}
                    for k, (c, ms) in ranked]}


def replay_kernels(k1_per_request):
    """The kernels of one replay of the bf16 predict step, by the name the
    profiler gives them: K1 (or K1') on the tensor cores, none on the CUDA
    cores, K3 at L4 and L2."""
    return {"binned_conv_fwd_mma_kernel": k1_per_request,
            "binned_conv_grouped_fwd_kernel": 0,
            "sorted_segment_weighted_sum_kernel": 2}


def drive_engine(engine, recs, card, per_run, per_replay):
    """The inference main path: warmup (one graph capture per bucket), then
    one ``predict`` per record at batch 1, with every launch count set to 0
    just before and read just after.  The wrappers launch while a graph is
    captured, ``RUNS_PER_CAPTURE`` runs of the step each: ``per_run`` (each
    wrapper's launches per run of the step) is held exactly against the
    engine's captures.  Then the same records again under the profiler,
    every one a replay: ``per_replay`` (kernels by name per replay) held
    exactly.  Labels checked, zero overflow and dropped points; then where
    a request's time goes (``step_breakdown`` of the eager step,
    ``replay_breakdown`` of the graph)."""
    import torch
    from fusiontransformer_tpu_torch.modules.steps import device_batch
    from fusiontransformer_tpu_torch.ops.kernels import (LAUNCHES,
                                                         reset_launches)
    reset_launches()
    warm = engine.warmup()
    log(f"warmup (s per bucket, one capture each): {warm}")
    lat, outs = [], []
    for rec in recs:
        t0 = time.perf_counter()
        outs.append(engine.predict(rec))
        lat.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    stats = engine.stats()
    captures = stats["captures"]
    for rec, out in zip(recs, outs):
        n = len(rec["points"])
        for key in (k for k in out if k.startswith("labels")):
            lab = out[key]
            if lab.shape != (n,) or lab.min() < 0 or lab.max() >= 20:
                raise AssertionError(f"{key}: shape {lab.shape}, range "
                                     f"[{lab.min()}, {lab.max()}]")
    if stats["voxel_overflow"] != 0 or stats["collate_dropped_points"] != 0:
        raise AssertionError(f"lossy request path: {stats}")
    if not captures >= len(engine.buckets):
        raise AssertionError(f"{captures} captures for buckets "
                             f"{engine.buckets}")
    for name, n in per_run.items():
        want = n * RUNS_PER_CAPTURE * captures
        if launches.get(name, 0) != want:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches "
                                 f"on the main path, expected {want} ({n} "
                                 f"a run, {captures} captures)")
    by_name = device_kernels(lambda: [engine.predict(r) for r in recs])
    if engine.stats()["captures"] != captures:
        raise AssertionError("a request under the profiler captured a graph")
    replay_launches = {}
    for name, n in per_replay.items():
        replay_launches[name] = count_of(by_name, name)
        if replay_launches[name] != n * len(recs):
            raise AssertionError(f"{name}: {replay_launches[name]} kernels in "
                                 f"{len(recs)} replays, expected "
                                 f"{n * len(recs)}")
    kernels = kernels_only(by_name)
    per_request = sum(c for c, _ in kernels.values()) / len(recs)
    _, logits = engine.forward([engine.preprocess(recs[0])])
    for k, v in logits.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite {k}")
    p50 = statistics.median(lat)
    log(f"requests {len(recs)}: points {[len(r['points']) for r in recs]}, "
        f"p50 latency {p50 * 1e3:.1f} ms, {1 / statistics.mean(lat):.2f} "
        f"scans/s ({card}); {captures} captures; wrapper launches "
        f"{launches}; kernels of the {len(recs)} replays (profiler) "
        f"{replay_launches}, {per_request:.0f} kernels a request; stats "
        f"{stats}")
    # Where a request's time goes: its parts one after another, per record
    # (host clock; the replay's part ends when its output is on the host).
    split = {"preprocess": [], "collate": [], "replay": [], "complete": []}
    for rec in recs:
        t = [time.perf_counter()]
        sample = engine.preprocess(rec)
        t.append(time.perf_counter())
        host_batch = engine.collate([sample])
        t.append(time.perf_counter())
        with engine._device_lock:
            packed = engine.graph_for(host_batch).replay(host_batch)
        packed.numpy()
        t.append(time.perf_counter())
        engine.complete(([sample], host_batch, packed), count_stats=False)
        t.append(time.perf_counter())
        for i, key in enumerate(split):
            split[key].append((t[i + 1] - t[i]) * 1e3)
    split_ms = {k: statistics.median(v) for k, v in split.items()}
    log(f"request split (host clock, medians of {len(recs)}): preprocess "
        f"{split_ms['preprocess']:.1f} ms, collate (+ host slot maps) "
        f"{split_ms['collate']:.1f} ms, copy in + replay + copy out "
        f"{split_ms['replay']:.1f} ms, complete {split_ms['complete']:.1f} ms")
    host_batch = engine.collate([engine.preprocess(recs[0])])
    return {"p50_ms": p50 * 1e3, "scans_per_s": 1 / statistics.mean(lat),
            "latencies_ms": [x * 1e3 for x in lat], "launches": launches,
            "captures": captures, "warmup_s": warm,
            "replay_launches": replay_launches,
            "kernels_per_request": per_request,
            "request_split_ms": split_ms,
            # The split of the eager step into its streams: fusion models.
            "step_breakdown": step_breakdown(
                engine, device_batch(host_batch, engine.device))
            if hasattr(engine.model, "lidar_backbone") else None,
            "replay_breakdown": replay_breakdown(engine, host_batch)}


# --------------------------------------------------------------------------- #
def train_cfg():
    """The flagship's model and training settings (``middlefusion.yaml``:
    Adam, wd 5e-4, lambda_xm 0.1, its class weights, batch 10, its capacity
    buckets, bf16) on SyntheticSCN scans of ``N_POINTS`` rays."""
    from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.DATASET.TYPE = "SyntheticSCN"
    cfg.DATASET.SyntheticSCN.num_points = N_POINTS
    cfg.DATASET.SyntheticSCN.num_scans = TRAIN_STEPS * TRAIN_BATCH
    cfg.TRAIN.BATCH_SIZE = TRAIN_BATCH
    cfg.VAL.BATCH_SIZE = TRAIN_BATCH
    cfg.VAL.PERIOD = 1
    cfg.SCHEDULER.MAX_EPOCH = 1
    cfg.OUTPUT_DIR = ""
    cfg.AUTO_RESUME = False
    cfg.freeze()
    return cfg


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_k2(hier, model, gen, kind="grouped"):
    """K2 (or K2') vs plain at every slot-map (level, Cin, Cout) of the
    train step, bf16 and f32; dX and dW bitwise equal across two launches.
    Each launch split into row table, dX, dW and reduce (``bwd_split``),
    each part beside its bound; for bf16 also the CUDA-core route (the f32
    route's kernels, run on the same bf16 operands) in the same call, as the
    before of the tensor-core one."""
    import torch
    from fusiontransformer_tpu_torch.ops.kernels import binned_conv as bc
    kk = binned_kernels(kind)
    bwd, bwd_ref, kid = kk["bwd"], kk["bwd_ref"], kk["ids"][1]
    dev = hier.pt_valid.device
    shapes = {}
    for level, cin, cout, w in slot_convs(model, hier):
        shapes.setdefault((level, cin, cout), [0, w])[0] += 1
    keys = ("ms", "plain_ms", "bound_ms", "rows_ms", "dx_ms", "dw_ms",
            "reduce_ms", "dx_bound_ms", "dw_bound_ms", "cuda_core_ms",
            "cuda_core_dx_ms", "cuda_core_dw_ms")
    rows, main = [], {**dict.fromkeys(keys, 0.0), "max_abs_err": 0.0,
                      "bound_t": {}}
    for (level, cin, cout), (count, w) in sorted(shapes.items()):
        src, binp = hier.levels[level].slot_idx
        v = hier.levels[level].valid.shape[0]
        live = kk["live"](src, binp, v)
        x32 = torch.randn(v, cin, generator=gen).to(dev)
        d32 = torch.randn(v, cout, generator=gen).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x, d, wd = x32.to(dtype), d32.to(dtype), w.to(dtype).contiguous()
            dx, dw = bwd(d, x, src, binp, wd)
            dx2, dw2 = bwd(d, x, src, binp, wd)
            rdx, rdw = bwd_ref(d, x, src, binp, wd)
            sdx, sdw = bwd_ref(d.abs(), x.abs(), src, binp, wd.abs())
            torch.cuda.synchronize()
            if not (torch.equal(dw, dw2) and torch.equal(dx, dx2)):
                raise AssertionError(f"{kid} L{level} {cin}->{cout} {dtype}: "
                                     f"dX or dW differs between two launches")
            tname = str(dtype).replace("torch.", "")
            errs = {}
            for key, got, ref, terms in (("dX", dx, rdx, sdx),
                                         ("dW", dw, rdw, sdw)):
                err = (got - ref).abs().max().item()
                tol = SUM_ORDER_RTOL * terms.max().item()
                if not err <= tol:
                    raise AssertionError(f"{kid} L{level} {cin}->{cout} "
                                         f"{tname} {key}: max abs err {err} "
                                         f"> {tol}")
                errs[key] = (err, tol)
            del rdx, rdw, sdx, sdw, dx, dw, dx2, dw2
            sched = bc.dw_schedule(v, cin, cout, dtype)
            ms = cuda_ms(lambda: bwd(d, x, src, binp, wd), iters=3, reps=3)
            split = bwd_split(lambda: bwd(d, x, src, binp, wd),
                              sched.route)
            plain_ms = (cuda_ms(lambda: bwd_ref(d, x, src, binp, wd),
                                iters=1, reps=3)
                        if dtype == torch.bfloat16 else None)
            core_ms = core_dx = core_dw = None
            if dtype == torch.bfloat16:
                # The CUDA-core route on the same bf16 operands: the
                # kernels bf16 ran before.
                core = bc.dw_schedule(v, cin, cout, torch.float32)

                def core_fn():
                    return bc._launch_bwd(*kk["bwd_launch"], d, x, src, binp,
                                          wd, sched=core)
                core_ms = cuda_ms(core_fn, iters=3, reps=3)
                core_split = bwd_split(core_fn, core.route)
                core_dx, core_dw = core_split["dx"], core_split["dw"]
            es = x.element_size()
            maps = 8 * src.numel()
            nbytes = (es * (d.numel() + x.numel() + wd.numel()) + maps
                      + 4 * (v * cin + wd.numel()))
            flops = 2 * live * cin * cout
            b_ms, b_by = bound(nbytes, 2 * flops, tname)
            dx_b, _ = bound(es * (d.numel() + wd.numel()) + maps
                            + 4 * v * cin, flops, tname)
            dw_b, dw_by = bound(es * (d.numel() + x.numel()) + maps
                                + 4 * wd.numel(), flops, tname)
            rows.append(dict(level=level, cin=cin, cout=cout, dtype=tname,
                             per_step=count, V=v,
                             **{kk["width"]: src.shape[1]},
                             live_slots=live,
                             max_abs_err_dx=errs["dX"][0],
                             tol_dx=errs["dX"][1],
                             max_abs_err_dw=errs["dW"][0],
                             tol_dw=errs["dW"][1], bitwise_repeat=True,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, dw_route=sched.route,
                             dw_schedule=sched._asdict(),
                             **{f"{p}_ms": t for p, t in split.items()},
                             dx_bound_ms=dx_b, dw_bound_ms=dw_b,
                             dw_bound_by=dw_by, cuda_core_ms=core_ms,
                             cuda_core_dx_ms=core_dx, cuda_core_dw_ms=core_dw))
            log(f"  {kid} L{level} {cin:3d}->{cout:3d} {tname:8s} x{count} "
                f"V={v} {kk['width']}={src.shape[1]} live={live}: err dX "
                f"{errs['dX'][0]:.3g} (tol {errs['dX'][1]:.3g}) dW "
                f"{errs['dW'][0]:.3g} (tol {errs['dW'][1]:.3g}), dX and dW "
                f"bitwise repeatable  kernel {ms:.4f} ms = row table "
                f"{fmt(split['rows'])} + dX {fmt(split['dx'])} "
                f"(bound {dx_b:.4f}) + dW {fmt(split['dw'])} (route "
                f"{sched.route}, {sched.tile_m}x{sched.tile_n} x "
                f"{sched.nchunks} chunks; bound {dw_b:.4f}, {dw_by}) + reduce "
                f"{fmt(split['reduce'])}"
                + (f"; the CUDA-core route on these bf16 operands "
                   f"{core_ms:.4f} ms: dX {fmt(core_dx)}, dW {fmt(core_dw)}"
                   if dtype == torch.bfloat16 else "")
                + f"  plain "
                f"{plain_ms if plain_ms is None else round(plain_ms, 4)} ms  "
                f"bound {b_ms:.4f} ms ({b_by})")
            if dtype == torch.bfloat16:
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("bound_ms", b_ms),
                                 ("rows_ms", split["rows"]),
                                 ("dx_ms", split["dx"]),
                                 ("dw_ms", split["dw"]),
                                 ("reduce_ms", split["reduce"]),
                                 ("dx_bound_ms", dx_b), ("dw_bound_ms", dw_b),
                                 ("cuda_core_ms", core_ms),
                                 ("cuda_core_dx_ms", core_dx),
                                 ("cuda_core_dw_ms", core_dw)):
                    main[key] = (None if val is None or main[key] is None
                                 else main[key] + count * val)
                main["bound_t"][b_by] = (main["bound_t"].get(b_by, 0)
                                         + count * b_ms)
            main["max_abs_err"] = max(main["max_abs_err"], errs["dX"][0],
                                      errs["dW"][0])
    return rows, main


def live_share_scaling(hier, gen, shapes=((0, 96, 96), (3, 256, 256))):
    """Whether a kernel's time follows the live (64-voxel tile, tap) share:
    the bf16 forward (CUDA-graph time) and the backward's dX and dW
    (``bwd_split``) on the batch's group-pooled maps, on the same maps with
    every tap but the center one emptied, and with no live bin at all."""
    import torch
    from fusiontransformer_tpu_torch.ops.kernels import binned_conv as bc
    rows = []
    for level, cin, cout in shapes:
        src, binp = hier.levels[level].slot_idx
        v = hier.levels[level].valid.shape[0]
        x = torch.randn(v, cin, generator=gen).cuda().bfloat16()
        d = torch.randn(v, cout, generator=gen).cuda().bfloat16()
        w = torch.randn(27, cin, cout, generator=gen).cuda().bfloat16()
        center = torch.where(binp // 8 == 13, binp, 216)
        for label, codes in (("real maps", binp), ("center tap only", center),
                             ("no live bin", torch.full_like(binp, 216))):
            share = bc.live_tile_share(bc.bin_rows_ref(src, codes), 64)
            split = bwd_split(lambda: bc.binned_conv_grouped_bwd(
                d, x, src, codes, w), 1)
            fwd_ms = graph_ms(lambda: bc.binned_conv_grouped_fwd(
                x, src, codes, w))
            rows.append(dict(level=level, cin=cin, cout=cout, V=v,
                             maps=label, live_tile64_share=share,
                             fwd_graph_ms=fwd_ms, **{f"{k}_ms": t for k, t in
                                                     split.items()}))
            log(f"  L{level} {cin}->{cout} V={v} {label:15s}: live (64-voxel "
                f"tile, tap) {share:.3f}  forward {fwd_ms:.4f} ms (graph)  "
                f"dX {fmt(split['dx'])}  dW {fmt(split['dw'])}")
    return rows


def phase_k3_train(hier, gen):
    """K3 on a real training batch: E=1 (voxelize_mean, L4 and L2) and E=8
    (the devoxelize adjoint at L4, C=256, and L2, C=128), vs plain; the
    main entries sum the bf16 calls of one train step of each."""
    import torch
    from fusiontransformer_tpu_torch.ops import sparse_conv as sc
    dev = hier.pt_valid.device
    n_pts = hier.pt_valid.shape[0]
    rows, e1, e8 = [], k3_main(), k3_main()
    for label, g, w, ids, num_out in k3_voxmean_cases(hier, gen):
        rows += k3_case(label, g, w, ids, num_out, e1)
    del g, w
    for level, width in ((4, 256), (2, 128)):
        plan = sc.devox_plan(hier, level)
        dout = torch.randn(n_pts, width, generator=gen).to(dev)
        g, w, ids = sc.devox_adjoint_stream(dout, hier.pt_corner_w[level],
                                            plan)
        rows += k3_case(f"devox adjoint L{level} (E=8)", g, w, ids,
                        hier.levels[level].valid.shape[0], e8)
        del g, w, dout
    return rows, e1, e8


def phase_gemm_grads(cfg):
    """The card's bf16 GEMM gradient (``sparse_conv._MatmulF32Out``, which
    rounds the incoming gradient to bf16) against the CPU's bf16
    formulation (the incoming gradient kept in f32) at the ViT's shapes in a
    batch-``TRAIN_BATCH`` train step: every element of both operands'
    gradients within GEMM_GRAD_RTOL of the sum of |terms| (one bf16
    rounding of the incoming gradient, then one of the result)."""
    import torch
    from fusiontransformer_tpu_torch.ops.sparse_conv import cdt_matmul
    b, d, h = TRAIN_BATCH, cfg.MODEL.VIT_EMBED_DIM, cfg.MODEL.VIT_HEADS
    n = (cfg.MODEL.VIT_IMG_SIZE // 16) ** 2 + 2
    cases = {"qkv": ((b, n, d), (d, 3 * d)), "proj": ((b, n, d), (d, d)),
             "fc1": ((b, n, d), (d, 4 * d)), "fc2": ((b, n, 4 * d), (4 * d, d)),
             "q @ k^T": ((b, h, n, d // h), (b, h, d // h, n)),
             "attn @ v": ((b, h, n, n), (b, h, n, d // h))}
    gen = torch.Generator().manual_seed(7)
    worst = {}
    for name, (sa, sb) in cases.items():
        a, bm = torch.randn(*sa, generator=gen), torch.randn(*sb,
                                                            generator=gen)
        g = torch.randn(*sa[:-1], sb[-1], generator=gen)
        grads = {}
        for dev in ("cpu", "cuda"):
            ta = a.detach().to(dev).requires_grad_(True)
            tb = bm.detach().to(dev).requires_grad_(True)
            cdt_matmul(ta, tb, torch.bfloat16).backward(g.to(dev))
            grads[dev] = (ta.grad.cuda(), tb.grad.cuda())
        ac, bc, gc = a.cuda().abs(), bm.cuda().abs(), g.cuda().abs()
        terms_a = torch.matmul(gc, bc.transpose(-1, -2))
        terms_b = torch.matmul(ac.transpose(-1, -2), gc)
        if bm.dim() == 2:
            terms_b = terms_b.reshape(-1, *terms_b.shape[-2:]).sum(0)
        share = 0.0
        for got, want, terms in zip(grads["cuda"], grads["cpu"],
                                    (terms_a, terms_b)):
            share = max(share, ((got - want).abs() / terms.clamp(min=1e-30))
                        .max().item())
        worst[name] = share
        if not share <= GEMM_GRAD_RTOL:
            raise AssertionError(f"bf16 GEMM gradient {name} {sa} x {sb}: "
                                 f"card vs CPU {share} of the sum of |terms| "
                                 f"> {GEMM_GRAD_RTOL}")
    log("  bf16 GEMM gradients, card vs CPU at the ViT's shapes (worst "
        "share of the sum of |terms|, bound "
        f"{GEMM_GRAD_RTOL}): " + ", ".join(f"{k} {v:.3g}"
                                           for k, v in worst.items()))
    return worst


LOSS_KEYS = ("total_loss", "seg_loss_2d", "seg_loss_3d", "xm_loss_2d",
             "xm_loss_3d")


@contextlib.contextmanager
def patched(module, **fns):
    """Swap names in ``module`` for the duration."""
    old = {k: getattr(module, k) for k in fns}
    for k, v in fns.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def replaced(**fns):
    """Swap functions that ``ops.sparse_conv`` calls by name (the kernel
    wrappers) for the duration of the block."""
    from fusiontransformer_tpu_torch.ops import sparse_conv as sc
    return patched(sc, **fns)


def recording(fn, calls):
    """``fn`` that also keeps a copy of each call's arguments and result
    (the step may later write into either)."""
    import torch

    def copy(x):
        if isinstance(x, tuple):
            return tuple(copy(t) for t in x)
        return x.clone() if torch.is_tensor(x) else x

    def wrapped(*args, **kw):
        kept = copy(args)
        out = fn(*args, **kw)
        calls.append((kept, kw, copy(out)))
        return out
    return wrapped


def one_train_step(cfg32, state, host_batch, caps, dev):
    """One f32 train step of ``make_train_step`` from ``state``: (metrics,
    gradients, buffers after the step, seconds), all on the CPU."""
    import torch
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                           make_train_step)
    from fusiontransformer_tpu_torch.solver.build import build_optimizer
    model = build_model(cfg32, dev)
    model.load_state_dict(state)
    opt, _ = build_optimizer(cfg32, model.parameters())
    grads = {}
    opt.register_step_pre_hook(lambda o, a, k: grads.update(
        {n: p.grad.detach().cpu().clone()
         for n, p in model.named_parameters()}))
    t0 = time.time()
    metrics = make_train_step(cfg32, model, opt)(
        device_batch(host_batch, dev), torch.Generator(dev), caps)
    metrics = {k: v.cpu() for k, v in metrics.items()}
    return (metrics, grads, {n: b.cpu() for n, b in model.named_buffers()},
            time.time() - t0)


def grad_readings(ref, got, conv_names, gates):
    """How far one train step ``got`` is from ``ref``, and which of
    ``gates`` (CPU_GATES or CARD_GATES) it fails."""
    import numpy as np
    import torch
    (mr, gr, br, _), (mg, gg, bg, _) = ref, got
    loss = max(abs(mg[k].item() - mr[k].item()) / abs(mr[k].item())
               for k in LOSS_KEYS)
    cms = all(torch.equal(mg[k], mr[k]) for k in ("cm_2d", "cm_3d"))
    shares, beyond = {}, []
    for n, g in gr.items():
        scale = g.abs().max().item()
        err = (gg[n] - g).abs().max().item()
        if not err <= gates["leaf"] * scale + LEAF_ATOL:
            beyond.append(n)
        if scale > 0 and err > LEAF_ATOL:
            shares[n] = err / scale
    conv = [shares.get(n, 0.0) for n in conv_names]
    bn = max((bg[n] - b).abs().max().item() / (b.abs().max().item() + 1e-12)
             for n, b in br.items())
    r = {"loss_rel": loss, "cms_equal": cms,
         "median": float(np.median([shares.get(n, 0.0) for n in gr])),
         "conv_median": float(np.median(conv)), "conv_worst": max(conv),
         "worst": max(shares.values(), default=0.0),
         "worst_leaf": max(shares, key=shares.get, default=None),
         "beyond_leaf_bound": beyond, "bn_worst": bn}
    r["fails"] = [k for k, bad in (
        ("losses", not loss <= gates["loss"]), ("confusion", not cms),
        ("leaf", bool(beyond)), ("median", not r["median"] <= gates["median"]),
        ("conv_median", not r["conv_median"] <= gates["conv_median"]),
        ("bn", not bn <= gates["bn"])) if bad]
    return r


def call_shares(calls, ref_fn):
    """Each recorded kernel call against its plain version on the same
    inputs: the worst error over the calls as a share of the sum of
    |terms|, for each output of the kernel (dX and dW for K2)."""
    import torch
    worst = []
    for args, kw, out in calls:
        ref = ref_fn(*args, **kw)
        terms = ref_fn(*(a.abs() if torch.is_tensor(a)
                         and a.is_floating_point() else a for a in args),
                       **{**kw, **({"precise": True} if "precise" in kw
                                   else {})})
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        sums = terms if isinstance(terms, tuple) else (terms,)
        for k, (o, r, t) in enumerate(zip(outs, refs, sums)):
            share = (o - r).abs().max().item() / max(t.max().item(), 1e-30)
            if k == len(worst):
                worst.append(0.0)
            worst[k] = max(worst[k], share)
    return worst


def check_recorded_calls(calls, ref_fn):
    """``call_shares`` within SUM_ORDER_RTOL (raises past it); the worst."""
    worst = max(call_shares(calls, ref_fn), default=0.0)
    if not worst <= SUM_ORDER_RTOL:
        raise AssertionError(f"{ref_fn.__name__} in the train step: error "
                             f"{worst} of the sum of |terms| > "
                             f"{SUM_ORDER_RTOL}")
    return worst


def phase_train_parity(cfg, state, host_batch, caps, conv_names,
                       kind="grouped"):
    """One f32 train step (TF32 off, dropout off) from the same weights and
    batch on the CPU (plain versions) and on the card several ways: with the
    kernels (the path; each binned-conv and K3 call also held against its
    plain version on the same inputs), with the plain versions in place of
    the kernels, and with deliberately wrong backward kernels (dW missing
    the first sixteenth of the voxel groups; for K2 also dX without the tap
    reversal), to show what the gates read for a kernel fault.  Each card
    step is held against the CPU's (CPU_GATES) and, but for the plain one,
    against the card's plain step (CARD_GATES): the kernel and plain steps
    must pass, each wrong kernel must fail.  ``kind`` "grouped" runs K1/K2
    on the batch's group-pooled maps, "slots" K1'/K2' on per-voxel maps
    (the batch carries no host maps, ``cfg`` has CONV_SLOT_POOL off)."""
    from fusiontransformer_tpu_torch.models import spvcnn
    from fusiontransformer_tpu_torch.ops.kernels.segment_sum import (
        sorted_segment_weighted_sum, sorted_segment_weighted_sum_ref)
    kk = binned_kernels(kind)
    k1, k2 = kk["ids"]
    fname, bname = kk["fwd"].__name__, kk["bwd"].__name__
    bwd = kk["bwd"]
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    cfg32.freeze()

    def dx_taps_unreversed(d, x, src, codes, w):
        return (bwd(d, x, src, codes, w.flip(0).contiguous())[0],
                bwd(d, x, src, codes, w)[1])

    calls = {k1: [], k2: [], "K3": []}
    variants = {
        "kernels": {
            fname: recording(kk["fwd"], calls[k1]),
            bname: recording(bwd, calls[k2]),
            "sorted_segment_weighted_sum": recording(
                sorted_segment_weighted_sum, calls["K3"])},
        "plain on the card": {
            fname: kk["ref"], bname: kk["bwd_ref"],
            "sorted_segment_weighted_sum": sorted_segment_weighted_sum_ref},
        f"wrong {k2}: dW misses 1/16 of the groups": {
            bname: dw_missing_groups(kind)},
    }
    if kind == "grouped":
        variants[f"wrong {k2}: dX taps not reversed"] = {
            bname: dx_taps_unreversed}
    dropout, spvcnn.DROPOUT = spvcnn.DROPOUT, 0.0
    try:
        cpu = one_train_step(cfg32, state, host_batch, caps, "cpu")
        runs = {}
        for name, fns in variants.items():
            with replaced(**fns):
                runs[name] = one_train_step(cfg32, state, host_batch, caps,
                                            "cuda")
    finally:
        spvcnn.DROPOUT = dropout
    log(f"  step on the CPU {cpu[3]:.1f} s, on the card with the kernels "
        f"{runs['kernels'][3]:.1f} s (first call)")
    for metrics, *_ in (cpu, runs["kernels"]):
        if int(metrics["voxel_overflow"]) or int(
                metrics.get("tap_overflow", 0)):
            raise AssertionError(f"lossy parity step: {metrics}")
    in_step = {k: check_recorded_calls(calls[k], ref) for k, ref in (
        (k1, kk["ref"]), (k2, kk["bwd_ref"]),
        ("K3", sorted_segment_weighted_sum_ref))}
    if not all(calls.values()):
        raise AssertionError(f"a kernel was not called in the step: "
                             f"{ {k: len(v) for k, v in calls.items()} }")
    log(f"  kernel calls of the step against their plain versions on the "
        f"same inputs (worst share of the sum of |terms|, bound "
        f"{SUM_ORDER_RTOL}): " + ", ".join(
            f"{k} x{len(calls[k])} {v:.3g}" for k, v in in_step.items()))
    readings = {}
    for ref_name, gates, names in (
            ("CPU", CPU_GATES, list(runs)),
            ("card (plain)", CARD_GATES,
             [n for n in runs if n != "plain on the card"])):
        ref = cpu if ref_name == "CPU" else runs["plain on the card"]
        for name in names:
            r = readings[f"{name} vs {ref_name}"] = grad_readings(
                ref, runs[name], conv_names, gates)
            log(f"  card ({name}) vs {ref_name}: losses {r['loss_rel']:.3g} "
                f"relative, confusion matrices "
                f"{'equal' if r['cms_equal'] else 'DIFFER'}, gradient shares "
                f"of the leaf's max |g|: median {r['median']:.3g}, conv "
                f"kernels median {r['conv_median']:.3g} worst "
                f"{r['conv_worst']:.3g}, worst leaf {r['worst']:.3g} "
                f"({r['worst_leaf']}); BN statistics {r['bn_worst']:.3g}; "
                f"fails {r['fails'] or 'none'}")
    log(f"  gates against the CPU {CPU_GATES}, against the card's plain "
        f"versions {CARD_GATES} (leaf: share of the leaf's max |g| + "
        f"{LEAF_ATOL}; the {k1}/{k2} conv kernels: {len(conv_names)})")
    for key, r in readings.items():
        wrong = key.startswith("wrong")
        if wrong and not r["fails"]:
            raise AssertionError(f"the gates do not catch '{key}'")
        if not wrong and r["fails"]:
            raise AssertionError(f"train step '{key}' fails {r['fails']}: "
                                 f"{r}")
    return {"cpu_s": cpu[3], "card_s": runs["kernels"][3],
            "in_step_kernel_share": in_step, "readings": readings,
            "losses": {k: [runs["kernels"][0][k].item(), cpu[0][k].item()]
                       for k in ("total_loss", "seg_loss_2d",
                                 "seg_loss_3d")}}


def relaunched_equal(fn, call):
    """Whether ``fn`` launched again on a recorded call's inputs gives its
    recorded result bit for bit."""
    import torch
    args, kw, out = call
    again = fn(*args, **kw)
    outs, agains = ((out, again) if isinstance(out, tuple)
                    else ((out,), (again,)))
    return all(torch.equal(a, b) for a, b in zip(outs, agains))


def bf16_step_calls(trainer, kind, db, caps, convs_per_step):
    """Every K1 and K2 (or K1', K2') call of one bf16 train step of
    ``trainer`` (the shipped ``trainer.train_step`` on ``db``) against its
    plain version on the same inputs, within SUM_ORDER_RTOL of the sum of
    |terms|, and bitwise equal to itself launched again on them, with the
    step's tensor-core launches counted (forward and dX on the forward
    kernel, dW on its own, none on the CUDA-core forward);
    then the same with a K2 whose dW misses the first 1/16 of the groups
    (``dw_missing_groups``), which that check must catch."""
    import torch
    from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES
    from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
        DW_MMA_NAME, FWD_CORE_NAME, FWD_MMA_NAME)
    kk = binned_kernels(kind)
    (k1, k2), fname, bname = kk["ids"], kk["fwd"].__name__, kk["bwd"].__name__
    want = {FWD_MMA_NAME: 2 * convs_per_step, DW_MMA_NAME: convs_per_step,
            FWD_CORE_NAME: 0}
    out = {}
    for label, fn in (("kernels", kk["bwd"]),
                      ("wrong dW", dw_missing_groups(kind))):
        fcalls, calls = [], []
        before = {n: LAUNCHES[n] for n in want}
        with replaced(**{fname: recording(kk["fwd"], fcalls),
                         bname: recording(fn, calls)}):
            trainer.train_step(db, trainer.generator, caps)
            torch.cuda.synchronize()
        got = {n: LAUNCHES[n] - before[n] for n in want}
        if label == "kernels" and got != want:
            raise AssertionError(f"tensor-core launches in one bf16 step: "
                                 f"{got}, expected {want}")
        if len(calls) != convs_per_step or len(fcalls) != convs_per_step:
            raise AssertionError(f"{label}: {len(fcalls)} {k1} and "
                                 f"{len(calls)} {k2} calls in one bf16 step, "
                                 f"expected {convs_per_step} each")
        out[label] = dict(zip(("dx", "dw"), call_shares(calls,
                                                       kk["bwd_ref"])))
        out[label]["fwd"] = max(call_shares(fcalls, kk["ref"]))
        if label == "kernels":
            repeat = [relaunched_equal(kk["fwd"], c) for c in fcalls] + [
                relaunched_equal(fn, c) for c in calls]
            if not all(repeat):
                raise AssertionError(f"{repeat.count(False)} {k1} / {k2} "
                                     f"calls of the bf16 step differ when "
                                     f"launched again on their inputs")
        del calls, fcalls
        torch.cuda.empty_cache()
    log(f"  {k1} and {k2} calls of one bf16 train step against their plain "
        f"versions on the same inputs (worst share of the sum of |terms|, "
        f"bound {SUM_ORDER_RTOL}): the kernels x{convs_per_step} forward "
        f"{out['kernels']['fwd']:.3g}, dX {out['kernels']['dx']:.3g}, dW "
        f"{out['kernels']['dw']:.3g}, each bitwise equal when launched "
        f"again; tensor-core launches {want}; a {k2} "
        f"whose dW misses 1/16 of the groups: dW {out['wrong dW']['dw']:.3g}")
    if not max(out["kernels"].values()) <= SUM_ORDER_RTOL:
        raise AssertionError(f"bf16 {k1} / {k2} in the train step: {out}")
    if out["wrong dW"]["dw"] <= SUM_ORDER_RTOL:
        raise AssertionError(f"the bf16 per-call check does not catch a "
                             f"wrong {k2} dW: {out}")
    return out


def step_parts(prof):
    """Device spans of the train step's parts from a profiler trace of one
    ``make_train_step`` call, whose ``record_function`` ranges mark them.
    Kernels of one stream run in order, so the parts are cut at range
    boundaries on the device: the forward runs from the step's first kernel
    to the end of the ``train_step.forward`` range's device span, the
    backward from there to the start of the optimizer's (autograd launches
    the backward from its own thread, outside the range), the optimizer
    from there to the start of ``train_step.metrics``'s, the metrics to the
    step's last kernel.  Returns each part's span and the kernel time inside
    it in ms, or None when the trace holds no device span of the ranges."""
    from torch.autograd import DeviceType
    kernels, spans = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False) or e.name.startswith(
                "train_step."):
            spans.setdefault(e.name, []).append(e.time_range)
        else:
            kernels.append(e.time_range)

    def first_start(*prefixes):
        return min((r.start for n, rs in spans.items()
                    if n.startswith(prefixes) for r in rs), default=None)

    fwd_end = max((r.end for r in spans.get("train_step.forward", [])),
                  default=None)
    opt_start = first_start("train_step.optimizer", "Optimizer.step")
    met_start = first_start("train_step.metrics")
    if not kernels or None in (fwd_end, opt_start, met_start):
        return None
    t0 = min(k.start for k in kernels)
    t_end = max(k.end for k in kernels)
    bounds = {"forward": (t0, fwd_end), "backward": (fwd_end, opt_start),
              "optimizer": (opt_start, met_start),
              "metrics": (met_start, t_end)}
    out = {}
    for part, (a, b) in bounds.items():
        busy = sum(min(k.end, b) - max(k.start, a) for k in kernels
                   if k.end > a and k.start < b)
        out[part] = {"ms": (b - a) / 1e3, "kernel_ms": busy / 1e3}
    return out


def train_breakdown(trainer, top=12):
    """Where a train step's time goes, on a batch of the trainer's own
    loader: dataset items and collate + slot maps (host clock), the copy and
    the shipped step ``trainer.train_step`` (CUDA events, medians of 3), the
    step's parts and the kernel time inside them (profiler, one step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fusiontransformer_tpu_torch.modules.steps import device_batch
    loader = trainer.train_dataloader
    ds, collate = loader.dataset, loader.collate_fn
    t0 = time.perf_counter()
    items = [ds[i] for i in range(TRAIN_BATCH)]
    item_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_BATCH
    rows = []
    for _ in range(3):
        t0 = time.perf_counter()
        hb = collate(items)
        collate_ms = (time.perf_counter() - t0) * 1e3
        caps = trainer.level_caps(hb)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        db = device_batch(hb, trainer.device)
        ev[1].record()
        trainer.train_step(db, trainer.generator, caps)
        ev[2].record()
        ev[2].synchronize()
        rows.append((collate_ms, ev[0].elapsed_time(ev[1]),
                     ev[1].elapsed_time(ev[2])))
    collate_ms, copy_ms, step_ms = (statistics.median(r[i] for r in rows)
                                    for i in range(3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(db, trainer.generator, caps)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False) and not e.name.startswith(
                    "train_step."):
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    kernel_ms = sum(ms for _, ms in by_name.values())
    n_kernels = sum(n for n, _ in by_name.values())
    busy = kernel_ms / step_ms if n_kernels else None
    parts = step_parts(prof)
    log(f"train step (batch {TRAIN_BATCH}, medians of 3): dataset item "
        f"{item_ms:.1f} ms/scan, collate + slot maps {collate_ms:.1f} ms "
        f"(host clock), copy {copy_ms:.2f} ms, step {step_ms:.2f} ms (CUDA "
        f"events around trainer.train_step)")
    if parts is None:
        log("step parts: not measured (the trace holds no device span of "
            "the step's record_function ranges)")
    else:
        log("step parts (device spans in one profiled step, kernel time "
            "inside): " + ", ".join(
                f"{k} {v['ms']:.2f} ms ({v['kernel_ms']:.2f})"
                for k, v in parts.items()))
    log(f"profiler: {n_kernels} device activities, {kernel_ms:.2f} ms, busy "
        f"share {busy if busy is None else round(busy, 3)} of the step")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    for name, (n, ms) in ranked:
        log(f"  {ms:8.3f} ms  x{n:<5d} {name[:100]}")
    return {"item_ms_per_scan": item_ms, "collate_ms": collate_ms,
            "copy_ms": copy_ms, "step_ms": step_ms, "parts": parts,
            "device_activities": n_kernels, "kernel_ms": kernel_ms,
            "busy_share": busy,
            "top": [{"name": k, "count": n, "ms": ms}
                    for k, (n, ms) in ranked]}


def drive_trainer(trainer, cfg, card, kind, convs_per_step, k3_name,
                  k3e8_name):
    """The training main path: ``trainer.train()`` (TRAIN_STEPS steps and a
    validation, through the trainer's CUDA graphs) with every launch count
    set to 0 just before and read just after: finite losses and
    validation, zero overflow, and the launches of ``kind``'s binned-conv
    pair and of K3 / K3[E=8] held exactly against the trainer's captures
    (the wrappers launch in the eager run and the capture of each new
    signature, ``RUNS_PER_CAPTURE`` runs; a replay runs no wrapper, and
    phase 17 counts a replay's kernels by name), none of the other pair's;
    then the eager step's breakdown."""
    import numpy as np
    import torch
    from fusiontransformer_tpu_torch.ops.kernels import (LAUNCHES,
                                                         reset_launches)
    kk = binned_kernels(kind)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    n_val = len(trainer.val_dataloader)
    meters = trainer.train_metric_logger.meters
    if trainer.step != TRAIN_STEPS:
        raise AssertionError(f"{trainer.step} train steps, expected "
                             f"{TRAIN_STEPS}")
    losses = {k: meters[k].global_avg for k in LOSS_KEYS}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite losses {losses}")
    overflow = {k: meters[k].sum for k in ("voxel_overflow", "slot_overflow",
                                           "tap_overflow") if k in meters}
    if any(overflow.values()) or (kind == "slots"
                                  and "tap_overflow" not in overflow):
        raise AssertionError(f"lossy train steps: {overflow}")
    captures = dict(trainer.captures)
    if not (1 <= captures["train"] <= TRAIN_STEPS
            and 1 <= captures["eval"] <= n_val and not captures["update"]):
        raise AssertionError(f"captures {captures} for {TRAIN_STEPS} train "
                             f"and {n_val} eval batches")
    check_launches(f"training path (captures {captures})", launches,
                   trainer_launches_expected(captures, convs_per_step,
                                             k3_name, k3e8_name, kind))
    val = {k: trainer.val_metric_logger.meters[k].global_avg
           for k in ("seg_iou_2d", "seg_iou_3d", "seg_loss_2d",
                     "seg_loss_3d")}
    if not all(np.isfinite(v) for v in val.values()):
        raise AssertionError(f"non-finite validation metrics {val}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    k1, k2 = kk["ids"]
    log(f"trained {TRAIN_STEPS} steps + validated {n_val} batches through "
        f"the trainer's CUDA graphs in {train_s:.1f} s "
        f"({TRAIN_STEPS * TRAIN_BATCH / train_s:.2f} train scans/s over the "
        f"whole run, first-step set-up, captures and validation included; "
        f"{card}); captures {captures}; launches {launches} = per eager run "
        f"or capture of a train step {k1} {convs_per_step}, {k2} "
        f"{convs_per_step} (each with one tensor-core dX and dW), K3 2, "
        f"K3[E=8] 2, and of an eval step {k1} {convs_per_step}, K3 2, every "
        f"{k1} and dX on the tensor-core forward, none on the CUDA-core "
        f"one; overflow {overflow}; mean losses {losses}; validation {val}; "
        f"peak device memory {peak_gb:.1f} GB")
    tbreak = train_breakdown(trainer)
    return {"val_batches": n_val, "run_s": train_s, "launches": launches,
            "captures": captures, "losses": losses, "overflow": overflow,
            "validation": val, "peak_memory_gb": peak_gb,
            "breakdown": tbreak}


# --------------------------------------------------------------------------- #
# Phase 17: the train and eval steps through the trainer's CUDA graphs.

# The kernels of one train-graph replay by the name the profiler gives them,
# per slot-map conv of the step: K1 / K1' and K2 / K2''s dX on the
# tensor-core forward, K2's row table, dW and chunk sum; and K3 at L4 and L2
# (E=1, voxelize_mean) and its E=8 devoxelize adjoint (the template's first
# argument).
TRAIN_REPLAY_PER_CONV = {"binned_conv_fwd_mma_kernel": 2,
                         "bin_rows_kernel": 1, "binned_conv_dw_mma_kernel": 1,
                         "reduce_chunks_kernel": 1,
                         "binned_conv_grouped_fwd_kernel": 0,
                         "binned_conv_grouped_dw_kernel": 0}
K3_KERNEL = "sorted_segment_weighted_sum_kernel"
# GRAD_ACCUM_STEPS 2 against one eager optimizer step on the mean gradient:
# each parameter within this share of its largest update (both sides run the
# same deterministic kernels; the sum is halved where the reference adds
# the halves).
ACCUM_RTOL = 1e-6


def train_state(trainer):
    """Clones of what a train step reads and writes: parameters and BN
    statistics, the static gradients, the optimizer's state and the dropout
    generator's state."""
    opt = trainer.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    return {"model": {k: v.clone()
                      for k, v in trainer.model.state_dict().items()},
            "grads": [g.clone() for g in trainer.train_step.grads],
            "opt": [{k: v.clone() for k, v in opt.state[p].items()}
                    for p in params],
            "gen": trainer.generator.get_state()}


def set_train_state(trainer, state):
    """Put ``state`` back in place, into the same tensors (the graphs keep
    their addresses)."""
    import torch
    opt = trainer.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    with torch.no_grad():
        for k, v in trainer.model.state_dict().items():
            v.copy_(state["model"][k])
        for g, v in zip(trainer.train_step.grads, state["grads"]):
            g.copy_(v)
        for p, saved in zip(params, state["opt"]):
            for k, v in saved.items():
                opt.state[p][k].copy_(v)
    trainer.generator.set_state(state["gen"])


def state_diffs(a, b):
    """The names of what differs between two ``train_state``s, bit for
    bit."""
    import torch
    out = [k for k in a["model"] if not torch.equal(a["model"][k],
                                                    b["model"][k])]
    out += [f"grad {i}" for i, (x, y) in enumerate(zip(a["grads"],
                                                       b["grads"]))
            if not torch.equal(x, y)]
    out += [f"opt {i}.{k}" for i, (x, y) in enumerate(zip(a["opt"],
                                                          b["opt"]))
            for k in x if not torch.equal(x[k], y[k])]
    if not torch.equal(a["gen"], b["gen"]):
        out.append("generator")
    return out


def metric_diffs(a, b):
    import numpy as np
    return [k for k in a if not np.array_equal(a[k], b[k])]


def graph_key(trainer, host_batch):
    from fusiontransformer_tpu_torch.modules.steps import batch_signature
    return batch_signature(host_batch), trainer.level_caps(host_batch)


def replays_equal_eager(trainer, batches):
    """From one saved state, ``batches`` through the trainer's graphs (every
    signature already captured: replays) and the same batches through its
    eager step: the metrics and the state after them bit for bit.  Returns
    the state after the replays."""
    from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                           read_back)
    for hb in batches:
        if trainer.train_graphs.get(graph_key(trainer, hb)) is None:
            raise AssertionError("the batch's signature is not captured")
    s0, step0 = train_state(trainer), trainer.step
    graph = [trainer.run_train_step(hb).numpy() for hb in batches]
    after = train_state(trainer)
    set_train_state(trainer, s0)
    eager = [read_back(trainer.train_step(
        device_batch(hb, trainer.device), trainer.generator,
        trainer.level_caps(hb))).numpy() for hb in batches]
    trainer.step = step0 + len(batches)
    diffs = state_diffs(after, train_state(trainer)) + [
        d for g, e in zip(graph, eager) for d in metric_diffs(g, e)]
    if diffs:
        raise AssertionError(f"{len(batches)} replays differ from as many "
                             f"eager steps in {len(diffs)} tensors: "
                             f"{diffs[:12]}")
    return after


def lr_reaches_replay(trainer, hb, factor=10.0):
    """The learning rate set after the capture reaches the replay: from one
    saved state, the replay at rate r and at factor * r (set with
    ``set_learning_rate``, no new capture), the second bit for bit the
    eager step at factor * r, and its parameter update factor times the
    first's (Adam's update is linear in the rate)."""
    import torch
    from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                           read_back)
    from fusiontransformer_tpu_torch.solver.build import (get_learning_rate,
                                                          set_learning_rate)
    lr = get_learning_rate(trainer.optimizer)
    if not lr > 0:
        raise AssertionError(f"learning rate {lr}")
    captures = dict(trainer.captures)
    params = dict(trainer.model.named_parameters())
    s0, step0 = train_state(trainer), trainer.step
    trainer.run_train_step(hb).numpy()
    low = train_state(trainer)
    set_train_state(trainer, s0)
    set_learning_rate(trainer.optimizer, lr * factor)
    trainer.run_train_step(hb).numpy()
    high = train_state(trainer)
    set_train_state(trainer, s0)
    read_back(trainer.train_step(device_batch(hb, trainer.device),
                                 trainer.generator,
                                 trainer.level_caps(hb))).numpy()
    diffs = state_diffs(high, train_state(trainer))
    ratio_err, moved = 0.0, 0
    for k in params:
        p0 = s0["model"][k]
        d_low = low["model"][k] - p0
        d_high = high["model"][k] - p0
        scale = d_high.abs().max().item()
        if scale > 0:
            moved += 1
            ratio_err = max(ratio_err, (d_high - factor * d_low).abs().max()
                            .item() / scale)
    set_train_state(trainer, s0)
    set_learning_rate(trainer.optimizer, lr)
    trainer.step = step0
    torch.cuda.synchronize()
    if diffs or trainer.captures != captures or not ratio_err < 1e-2 \
            or not moved:
        raise AssertionError(f"LR after the capture: replay vs eager "
                             f"differ in {diffs[:8]}, captures "
                             f"{captures} -> {trainer.captures}, update "
                             f"ratio error {ratio_err}")
    return {"factor": factor, "update_ratio_err": ratio_err}


def no_host_sync(trainer, hb):
    """One eager train step and one eager eval step under
    ``torch.cuda.set_sync_debug_mode("error")``: an operation that waits for
    the card raises."""
    import torch
    from fusiontransformer_tpu_torch.modules.steps import device_batch
    db = device_batch(hb, trainer.device)
    caps = trainer.level_caps(hb)
    s0, step0 = train_state(trainer), trainer.step
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_step(db, trainer.generator, caps)
        trainer.eval_step(db, caps)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    set_train_state(trainer, s0)
    trainer.step = step0


def train_replay_kernels(trainer, hb, convs_per_step):
    """One train-graph replay of ``hb``'s signature: its device time on CUDA
    events, and its kernels by name from the profiler, held exactly against
    TRAIN_REPLAY_PER_CONV and K3's 2 + 2; the busy share.  The replays run
    the step (the state moves on)."""
    graph = trainer.train_graphs.get(graph_key(trainer, hb))
    replay_ms = cuda_ms(graph.graph.replay, iters=3, reps=3)
    by_name = kernels_only(device_kernels(graph.graph.replay))
    counts = {n: count_of(by_name, n) for n in TRAIN_REPLAY_PER_CONV}
    for e, key in ((1, "K3 (E=1)"), (8, "K3' (E=8)")):
        counts[key] = sum(c for name, (c, _) in by_name.items() if re.search(
            K3_KERNEL + rf"<{e}\b", name))
    want = {n: k * convs_per_step for n, k in TRAIN_REPLAY_PER_CONV.items()}
    want.update({"K3 (E=1)": 2, "K3' (E=8)": 2})
    n = sum(c for c, _ in by_name.values())
    kernel_ms = sum(ms for _, ms in by_name.values())
    log(f"  train-graph replay {replay_ms:.2f} ms (CUDA events); profiler: "
        f"{n} kernels, {kernel_ms:.2f} ms, busy share "
        f"{kernel_ms / replay_ms:.3f}; by name {counts}")
    if counts != want:
        k3 = {k: v for k, v in by_name.items() if K3_KERNEL in k}
        raise AssertionError(f"kernels of one train replay {counts}, "
                             f"expected {want} (K3 names: {k3})")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (c, ms) in ranked:
        log(f"  {ms:8.3f} ms  x{c:<5d} {name[:100]}")
    return {"replay_ms": replay_ms, "kernels": n, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / replay_ms, "by_name": counts,
            "top": [{"name": k, "count": c, "ms": ms}
                    for k, (c, ms) in ranked]}


def loader_batches(cfg, n_batches, seed_offset=0):
    """``n_batches`` collated training batches of ``cfg``'s loader (scans
    ``seed_offset`` on)."""
    from fusiontransformer_tpu_torch.data.build import build_dataloader
    wcfg = cfg.clone()
    wcfg.DATASET.SyntheticSCN.num_scans = n_batches * TRAIN_BATCH
    wcfg.DATASET.SyntheticSCN.seed = seed_offset
    wcfg.freeze()
    return list(build_dataloader(wcfg, mode="train"))


def train_windows(trainer, cfg, replay_ms):
    """Train scans/s of ``train_for_one_epoch`` over WINDOW_STEPS batches
    at NUM_WORKERS 0 and N (the loader's worker pool): one epoch with the
    workers first captures the window's signatures (its captures and time
    reported), then the window at 0 workers and at N, each all replays,
    host clock, end synchronised; the card's share of each (steps x the
    replay's CUDA-event time / window).  The pool's workers never
    initialised CUDA."""
    import os
    import torch
    from fusiontransformer_tpu_torch.data.build import build_dataloader
    workers = max(1, min(6, (os.cpu_count() or 2) - 2))
    loaders = {}
    for n in (workers, 0):
        wcfg = cfg.clone()
        wcfg.DATASET.SyntheticSCN.num_scans = WINDOW_STEPS * TRAIN_BATCH
        wcfg.DATALOADER.NUM_WORKERS = n
        wcfg.freeze()
        loaders[n] = build_dataloader(wcfg, mode="train")
    out = {"workers": workers, "cpu_count": os.cpu_count()}
    try:
        for name, n in (("first epoch (captures)", workers), ("0 workers", 0),
                        (f"{workers} workers", workers)):
            trainer.train_dataloader = loaders[n]
            before, step0 = dict(trainer.captures), trainer.step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_for_one_epoch(1)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            steps = trainer.step - step0
            captures = trainer.captures["train"] - before["train"]
            meters = trainer.train_metric_logger.meters
            if steps != WINDOW_STEPS:
                raise AssertionError(f"{steps} steps in the window")
            if any(meters[k].sum != 0 for k in (
                    "voxel_overflow", "slot_overflow", "tap_overflow")
                    if k in meters):
                raise AssertionError("lossy steps in the window")
            if not math.isfinite(meters["total_loss"].global_avg):
                raise AssertionError("non-finite loss in the window")
            if name != "first epoch (captures)" and captures:
                raise AssertionError(f"{captures} captures in the window "
                                     f"'{name}' after its first epoch")
            rate = steps * TRAIN_BATCH / window_s
            out[name] = {"seconds": window_s, "scans_per_s": rate,
                         "ms_per_step": window_s / steps * 1e3,
                         "captures": captures,
                         "card_share": steps * replay_ms / 1e3 / window_s}
            log(f"  window, {name}: train_for_one_epoch over {steps} "
                f"batches of {TRAIN_BATCH} in {window_s:.2f} s = "
                f"{rate:.3f} train scans/s, {window_s / steps * 1e3:.1f} ms "
                f"a step (host clock), {captures} captures; the card's "
                f"share {out[name]['card_share']:.3f}")
        cuda_in_worker = loaders[workers]._get_pool().apply(
            torch.cuda.is_initialized)
        if cuda_in_worker:
            raise AssertionError("a loader worker initialised CUDA")
    finally:
        for loader in loaders.values():
            loader.close()
    log(f"  NUM_WORKERS {workers} of os.cpu_count() {os.cpu_count()}; no "
        f"worker initialised CUDA")
    return out


def accumulation(cfg, batches):
    """``TRAIN.GRAD_ACCUM_STEPS 2`` on the card, through the graphs: the
    parameters bitwise unchanged after each odd micro-step (the BN
    statistics move), and after the second update (a replay of the update
    graph, Adam's moments no longer zero) each parameter within ACCUM_RTOL
    of its largest update of one eager optimizer step on the mean of the
    two micro-batches' gradients."""
    import torch
    from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
        SemanticTrainer)
    from fusiontransformer_tpu_torch.modules.steps import device_batch
    acfg = cfg.clone()
    acfg.TRAIN.GRAD_ACCUM_STEPS = 2
    acfg.freeze()
    tr = SemanticTrainer(acfg)
    names = [n for n, _ in tr.model.named_parameters()]
    params = dict(tr.model.named_parameters())
    order = [batches[0], batches[1], batches[0], batches[1]]
    odd_ok, bn_moved = [], []
    for i, hb in enumerate(order):
        if i == 2:
            s2 = train_state(tr)
        before = train_state(tr)
        tr.run_train_step(hb).numpy()
        now = train_state(tr)
        if i % 2 == 0:
            odd_ok.append(all(torch.equal(now["model"][n], before["model"][n])
                              for n in names))
            bn_moved.append(any(
                not torch.equal(now["model"][k], before["model"][k])
                for k in now["model"] if k not in params))
    p4 = train_state(tr)["model"]
    # The reference: from the state before the window, each micro-batch's
    # gradient alone, their mean, one optimizer step.
    set_train_state(tr, s2)
    grads = []
    for hb in order[2:]:
        torch._foreach_zero_(tr.train_step.grads)
        tr.train_step(device_batch(hb, tr.device), tr.generator,
                      tr.level_caps(hb), update=False)
        grads.append([g.clone() for g in tr.train_step.grads])
    for g, a, b in zip(tr.train_step.grads, *grads):
        g.copy_((a + b) / 2)
    tr.optimizer.step()
    err = 0.0
    for n in names:
        upd = (p4[n] - s2["model"][n]).abs().max().item()
        if upd > 0:
            err = max(err, (p4[n] - params[n]).abs().max().item() / upd)
    captures = dict(tr.captures)
    del tr
    torch.cuda.empty_cache()
    log(f"  GRAD_ACCUM_STEPS 2: parameters bitwise unchanged after the odd "
        f"micro-steps {odd_ok}, BN statistics moved {bn_moved}; after the "
        f"second update (a replay of the update graph) each parameter "
        f"within {err:.3g} of its largest update of one eager step on the "
        f"mean gradient (bound {ACCUM_RTOL}); captures {captures}")
    if not (all(odd_ok) and all(bn_moved) and err <= ACCUM_RTOL
            and captures["update"] == 1):
        raise AssertionError(f"accumulation: odd {odd_ok}, BN {bn_moved}, "
                             f"err {err}, captures {captures}")
    return {"odd_unchanged": odd_ok, "bn_moved": bn_moved,
            "max_share_of_update": err, "captures": captures}


def eval_replays_equal_eager(trainer, batches):
    """Validation's graphs: each batch through ``run_eval_batch`` (a capture
    on a miss, else a replay) and again (a replay), bit for bit the eager
    eval step."""
    import numpy as np
    from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                           read_back)
    before = trainer.captures["eval"]
    for hb in batches:
        for _ in range(2):
            got = trainer.run_eval_batch(hb).numpy()
            want = read_back(trainer.eval_step(
                device_batch(hb, trainer.device),
                trainer.level_caps(hb))).numpy()
            bad = [k for k in want if not np.array_equal(got[k], want[k])]
            if bad:
                raise AssertionError(f"eval replay differs from the eager "
                                     f"eval step in {bad}")
    return trainer.captures["eval"] - before


def phase_train_graphs(label, trainer, cfg, cfg32, convs_per_step):
    """The trainer's CUDA graphs in one configuration (``trainer``: phase 8's
    or 11's, bf16): per signature met, the capture's seconds and the graph
    pool's bytes; replays bit for bit the eager step from the same saved
    state, bf16 and (a second trainer) f32, one replay and two (fresh
    dropout masks); a learning rate set after the capture reaching the
    replay; no host sync in an eager train and eval step; a replay's
    kernels by name and its busy share; the step eager against graph, A B B
    A; the training window at 0 and N workers; GRAD_ACCUM_STEPS 2; the eval
    graphs bit for bit the eager eval step."""
    import torch
    from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
        SemanticTrainer)
    from fusiontransformer_tpu_torch.modules.steps import device_batch
    res = {"seconds": {}}
    t_part = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        res["seconds"][name] = round(now - t_part[0], 1)
        t_part[0] = now

    hb = loader_batches(cfg, 2, seed_offset=1000)
    lap("batches")
    no_host_sync(trainer, hb[0])
    log(f"  {label}: set_sync_debug_mode('error') holds for one eager train "
        f"step and one eager eval step")
    for b in hb:
        trainer.run_train_step(b).numpy()         # captured if new
    replays_equal_eager(trainer, hb[:1])
    replays_equal_eager(trainer, [hb[0], hb[0]])
    trainers = {"bf16": trainer}
    t32 = SemanticTrainer(cfg32)
    t32.model.load_state_dict(trainer.model.state_dict())
    for b in hb:
        t32.run_train_step(b).numpy()
    replays_equal_eager(t32, hb[:1])
    replays_equal_eager(t32, [hb[0], hb[0]])
    trainers["f32"] = t32
    res["captures"] = {}
    for dtype, tr in trainers.items():
        for key in list(tr.train_graphs):
            g = tr.train_graphs.get(key)
            res["captures"].setdefault(dtype, []).append(
                {"caps": list(key[1] or ()), "capture_s": g.capture_s})
        res["captures"][f"{dtype} pool_bytes"] = pool_bytes(tr._pool)
    log(f"  {label}: one replay and two replays (two dropout draws) bit for "
        f"bit the eager steps from the same state (losses, confusion "
        f"matrices, parameters, BN statistics, gradients, Adam's moments and "
        f"step, the generator), bf16 and f32; captures (caps, s): "
        + "; ".join(f"{d} " + ", ".join(
            f"{c['caps']} {c['capture_s']:.2f}" for c in v)
            for d, v in res["captures"].items() if isinstance(v, list))
        + "; pool bytes " + ", ".join(
            f"{d} {v}" for d, v in res["captures"].items()
            if not isinstance(v, list)))
    del t32, trainers
    torch.cuda.empty_cache()
    lap("bit for bit, bf16 and f32")
    res["lr"] = lr_reaches_replay(trainer, hb[0])
    log(f"  {label}: a learning rate set after the capture reaches the "
        f"replay (x{res['lr']['factor']}: bit for bit the eager step, "
        f"update ratio error {res['lr']['update_ratio_err']:.2g}), no "
        f"recapture")
    res["replay"] = train_replay_kernels(trainer, hb[0], convs_per_step)
    db = device_batch(hb[0], trainer.device)
    caps = trainer.level_caps(hb[0])
    graph = trainer.train_graphs.get(graph_key(trainer, hb[0]))
    res["step_ms"] = side_by_side(f"{label} train step", {
        "eager": lambda: trainer.train_step(db, trainer.generator, caps),
        "graph": graph.graph.replay}, rounds=2)
    res["eval_captures"] = eval_replays_equal_eager(trainer, hb)
    log(f"  {label}: validation through its graphs ({res['eval_captures']} "
        f"captures) bit for bit the eager eval step, twice per batch")
    lap("LR, kernels, A B B A, eval")
    res["windows"] = train_windows(trainer, cfg, res["replay"]["replay_ms"])
    lap("windows")
    res["accumulation"] = accumulation(cfg, hb)
    lap("accumulation")
    log(f"  {label}: seconds {res['seconds']}")
    return res


def per_voxel(cfg):
    """``cfg`` with TPU.CONV_SLOT_POOL off: per-voxel K-slot maps built on
    the device, K1' / K2'."""
    out = cfg.clone()
    out.TPU.CONV_SLOT_POOL = False
    out.freeze()
    return out


def without_host_maps(host_batch):
    return {k: v for k, v in host_batch.items() if not k.startswith("gslot_")}


def side_by_side(label, fns, rounds=3):
    """Each of ``fns`` ({name: zero-argument callable}) timed on CUDA events
    one call at a time, in the order A B B A per round after one warm call
    each, as medians in ms.  The host's launch rate drifts through a run
    (on the H100 machines, the launch-bound predict step read up to 1.6x
    slower in phase 10 than in phase 4), so two paths are compared only
    side by side."""
    import torch
    names = list(fns)
    for n in names:
        fns[n]()
    times = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fns[n]()
            ev[1].record()
            ev[1].synchronize()
            times[n].append(ev[0].elapsed_time(ev[1]))
    med = {n: statistics.median(t) for n, t in times.items()}
    log(f"  {label}, side by side (A B B A x {rounds}, CUDA events, "
        f"medians): " + ", ".join(f"{n} {m:.2f} ms" for n, m in med.items()))
    return med


def hier_cost(cfg, db, caps):
    """What the per-voxel maps cost inside the hierarchy: the build with
    and without them, side by side, and their compaction alone
    (``tap_slot_maps`` at each level), CUDA events; their tap overflow (must
    be 0) and the most live taps of a voxel per level."""
    from fusiontransformer_tpu_torch.modules.steps import (level_caps_for_n,
                                                           norm_tap_slots,
                                                           tap_overflow)
    from fusiontransformer_tpu_torch.ops.hierarchy import (build_hierarchy,
                                                           tap_slot_maps)
    caps = caps or level_caps_for_n(cfg, db["coords"].shape[0])
    ts = norm_tap_slots(cfg, len(caps))
    args = (db["coords"], db["pt_batch"], db["pt_valid"], caps)
    build = side_by_side(f"hierarchy build at caps {caps}", {
        "with the maps": lambda: build_hierarchy(*args, tap_slots=ts),
        "without": lambda: build_hierarchy(*args)})
    hier = build_hierarchy(*args, tap_slots=ts)
    levels = [(l.nbr_idx, c, k) for l, c, k in zip(hier.levels, caps, ts)
              if k]
    maps_ms = cuda_ms(lambda: [tap_slot_maps(*a) for a in levels], iters=5)
    over = int(tap_overflow(hier, ts))
    max_live = [int((l.nbr_idx < c).sum(1).max())
                for l, c in zip(hier.levels, caps)]
    log(f"  K {ts}: the compaction alone {maps_ms:.3f} ms; tap_overflow "
        f"{over}; most live taps of a voxel per level {max_live}")
    if over:
        raise AssertionError(f"tap_overflow {over} on the flagship's scans")
    return {"caps": list(caps), "tap_slots": list(ts),
            "with_maps_ms": build["with the maps"],
            "without_maps_ms": build["without"], "compaction_ms": maps_ms,
            "tap_overflow": over, "max_live_taps": max_live}


def per_voxel_f32(cfg32, state, sample, grouped_f32):
    """One scan's f32 logits (TF32 off) on the per-voxel path: the card's
    against the CPU's (the same path, plain versions) and against the
    group-pooled path's on the card (``grouped_f32``, the same function with
    lossless maps), each output within F32_LOGIT_RTOL of its largest
    |logit|."""
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                           hier_from_cfg,
                                                           norm_tap_slots,
                                                           tap_overflow)
    from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
    pcfg = per_voxel(cfg32)
    engines = {}
    for dev in ("cuda", "cpu"):
        model = build_model(pcfg, dev)
        model.load_state_dict(state)
        engines[dev] = InferenceEngine(pcfg, model=model, device=dev)
    t0 = time.time()
    batch, out_gpu = engines["cuda"].forward([sample])
    _, out_cpu = engines["cpu"].forward([sample])
    log(f"  f32 forward on card and CPU in {time.time() - t0:.1f} s")
    hier = hier_from_cfg(pcfg, device_batch(batch, "cuda"))
    over = int(tap_overflow(hier, norm_tap_slots(pcfg, len(hier.levels))))
    if over:
        raise AssertionError(f"tap_overflow {over}")
    res = {"tap_overflow": over, "vs_cpu": {}, "vs_grouped": {}}
    for k in out_cpu:
        got = out_gpu[k].cpu()
        for key, want in (("vs_cpu", out_cpu[k]), ("vs_grouped",
                                                   grouped_f32[k])):
            d = (got - want).abs().max().item()
            tol = F32_LOGIT_RTOL * want.abs().max().item()
            res[key][k] = d
            log(f"  {k}: per-voxel on the card {key.replace('_', ' ')} "
                f"(f32): max abs diff {d:.3g} (tol {tol:.3g})")
            if not d <= tol:
                raise AssertionError(f"f32 {k} {key} differs by {d} > {tol}")
    return res


# --------------------------------------------------------------------------- #
# Phase 12: the tool kernels T1-T4 behind the port's microbenches.

def tool_paths():
    """The slice's main path: the port's three microbenches as a user runs
    them (``python -m fusiontransformer_tpu_torch.tools.<name>``, defaults:
    the card, the flagship's L0/L2 slot maps, B = 1, 2, 8 at DeiT-B/384),
    with every launch count set to 0 just before and read just after."""
    from fusiontransformer_tpu_torch.ops.kernels import (LAUNCHES,
                                                         reset_launches)
    from fusiontransformer_tpu_torch.tools import (microbench_attention,
                                                   microbench_dma_gather,
                                                   microbench_gather)
    reset_launches()
    t0 = time.time()
    res = {"microbench_dma_gather": microbench_dma_gather.main([]),
           "microbench_gather": microbench_gather.main([]),
           "microbench_attention": microbench_attention.main([])}
    res["launches"] = dict(LAUNCHES)
    res["seconds"] = time.time() - t0
    log(f"  microbenches in {res['seconds']:.1f} s; launches "
        f"{res['launches']}")
    for name in TOOL_KERNELS:
        if not res["launches"].get(name, 0) > 0:
            raise AssertionError(f"{name} was not launched by the "
                                 f"microbenches: {res['launches']}")
    return res


def graph_ms(fn, calls=20):
    """ms per call: CUDA-event median over CUDA-graph replays of ``calls``
    calls, so that the host's launch overhead drops out of kernels shorter
    than it (the gathers at one chunk run in microseconds)."""
    from fusiontransformer_tpu_torch.utils.profiler import time_cuda
    return time_cuda(fn, iters=5, calls=calls, graph=True)[0]


def _gather_bounds(feats, ix):
    """Bytes each function must move for these indices (the rows they
    touch, read once; the indices; the output): T1's, then T2/T3's."""
    import torch
    r, c = feats.shape
    n = ix.shape[0]
    groups = torch.unique(ix[:n // 8].long() // 8)
    rows_t1 = int((r - 8 * groups).clamp(max=8).sum())
    rows_sum = int(torch.unique(ix).numel())
    return (2 * c * rows_t1 + 4 * (n // 8) + 2 * c * n,
            2 * c * rows_sum + 4 * n + 4 * c)


def phase_gather_kernels():
    """T1-T3 on the flagship's own L0 (C = 32) and L2 (C = 128) per-voxel
    maps, as the microbench builds them: T1 bit for bit against its plain
    version, T2/T3 within SUM_ORDER_RTOL of the sum of |rows| and equal bit
    for bit across two launches, per CHUNK indices and for the whole level
    in one launch; times of the kernel and ``library`` in CUDA graphs, of
    the plain version eagerly (it checks its indices on the host)."""
    import torch
    import torch.nn.functional as F
    from fusiontransformer_tpu_torch.ops.kernels import row_gather as rg
    from fusiontransformer_tpu_torch.tools import microbench_dma_gather as mdg
    kernels = {rg.BLOCKS8: (rg.gather_blocks8, rg.gather_blocks8_ref),
               rg.PIPELINED: (rg.gather_rows_sum_pipelined,
                              rg.gather_rows_sum_ref),
               rg.SMEM: (rg.gather_rows_sum_smem, rg.gather_rows_sum_ref)}
    idx = mdg.level_indices("cuda")
    rows = []
    main = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "max_abs_err": 0.0, "bound_t": {}}
            for k in kernels}
    for k in (rg.PIPELINED, rg.SMEM):
        main[k].update(eager_ms=0.0, gathered_bytes=0, levels={})
    for level, c in mdg.LEVELS:
        feats = mdg.level_table(level, c, "cuda")
        r = feats.shape[0]
        whole = idx[level][:idx[level].shape[0] // 8 * 8]
        blocks = torch.cat([feats, feats.new_zeros(((-r) % 8, c))]).view(
            -1, 8, c)
        for label, ix in (("chunk", whole[:mdg.CHUNK]), ("whole", whole)):
            n = ix.shape[0]
            groups = ix[:n // 8].long() // 8
            ix_bag = ix.long().view(1, -1)
            bytes_t1, bytes_sum = _gather_bounds(feats, ix)
            ref_sum = rg.gather_rows_sum_ref(feats, ix)
            scale = rg.gather_rows_sum_ref(feats.abs(), ix).max().item()
            for name, (fn, ref_fn) in kernels.items():
                out = fn(feats, ix)
                if name == rg.BLOCKS8:
                    err = (out.float() - ref_fn(feats, ix).float()).abs().max(
                    ).item()
                    if err != 0.0:
                        raise AssertionError(f"T1 {name} L{level} {label}: "
                                             f"not a copy (max abs {err})")
                    lib = lambda: blocks.index_select(0, groups)  # noqa: E731
                    b_ms, b_by = bound(bytes_t1, 0, "bfloat16")
                else:
                    again = fn(feats, ix)
                    if not torch.equal(out, again):
                        raise AssertionError(f"{name} L{level} {label}: two "
                                             "launches differ")
                    err = (out - ref_sum).abs().max().item()
                    if not err <= SUM_ORDER_RTOL * scale:
                        raise AssertionError(
                            f"{name} L{level} {label}: max abs err {err} > "
                            f"{SUM_ORDER_RTOL} x {scale}")
                    lib = lambda: F.embedding_bag(  # noqa: E731
                        ix_bag, feats, mode="sum")
                    b_ms, b_by = bound(bytes_sum, n * c, "float32")
                ms = graph_ms(lambda: fn(feats, ix, check=False))
                eager = cuda_ms(lambda: fn(feats, ix, check=False))
                plain_ms = cuda_ms(lambda: ref_fn(feats, ix), iters=5,
                                   reps=3)
                lib_ms = graph_ms(lib)
                rate = n / (ms * 1e-3) / 1e6
                lib_rate = n / (lib_ms * 1e-3) / 1e6
                gbps = n * 2 * c / (ms * 1e6)
                rows.append(dict(kernel=name, level=level, C=c, rows=r,
                                 case=label, n=n, max_abs_err=err, ms=ms,
                                 eager_ms=eager, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms, M_rows_per_s=rate,
                                 gathered_GB_per_s=gbps,
                                 library_M_rows_per_s=lib_rate))
                log(f"  {name:26s} L{level} C={c:3d} {label:5s} n={n:6d}: "
                    f"err {err:.3g}  kernel {ms:.4f} ms (eager "
                    f"{eager:.4f}; {rate:.0f} M rows/s, {gbps:.0f} GB/s "
                    f"gathered)  plain {plain_ms:.4f} ms  library "
                    f"{lib_ms:.4f} ms ({lib_rate:.0f} M rows/s)  bound "
                    f"{b_ms:.4f} ms ({b_by})")
                m = main[name]
                m["max_abs_err"] = max(m["max_abs_err"], err)
                if label == "whole":
                    m["ms"] += ms
                    m["plain_ms"] += plain_ms
                    m["library_ms"] += lib_ms
                    m["bound_ms"] += b_ms
                    m["bound_t"][b_by] = m["bound_t"].get(b_by, 0) + b_ms
                    if name != rg.BLOCKS8:
                        m["eager_ms"] += eager
                        m["gathered_bytes"] += n * 2 * c
                        m["levels"][f"L{level}"] = {
                            "ms": ms, "eager_ms": eager, "bound_ms": b_ms,
                            "gathered_GB_per_s": gbps}
    for k in (rg.PIPELINED, rg.SMEM):
        m = main[k]
        m["gathered_GB_per_s"] = m.pop("gathered_bytes") / (m["ms"] * 1e6)
        log(f"  {k}: whole L0 + L2 {m['ms']:.4f} ms on the device, "
            f"{m['eager_ms']:.4f} eager, {m['gathered_GB_per_s']:.0f} GB/s "
            f"gathered, bound {m['bound_ms']:.4f} ms; the design before: "
            f"{EARLIER[k]['ms']} ms ({EARLIER[k]['from']})")
    return rows, main


def tail_heavy(b, h, n, seed=0):
    """q > 0 and the last two keys 2.0 in every dim: they carry nearly all of
    each row's softmax mass, with values 3 and 5 (5 alone at n = 1)."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    q = np.abs(rs.randn(b, h, n, 64))
    k = 0.1 * rs.randn(b, h, n, 64)
    k[:, :, -2:] = 2.0
    v = rs.randn(b, h, n, 64)
    v[:, :, -2:] = np.array([3.0, 5.0])[-min(n, 2):, None]
    return [torch.as_tensor(x.astype(np.float32)).to("cuda", torch.bfloat16)
            for x in (q, k, v)]


def negative_scores(b, h, n, seed=0):
    """q > 0 and k < 0: every score is about -5, so a key past the end that
    scored 0 instead of -inf would take most of the mass."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, h, n, 64) for _ in range(3))
    return [torch.as_tensor(x.astype(np.float32)).to("cuda", torch.bfloat16)
            for x in (np.abs(q), -np.abs(k), v)]


def phase_flash():
    """T4 at DeiT-B/384 (12 heads, 578 tokens, head dim 64), B = 1, 2, 8: 12
    chained calls (each output the next query, as the microbench runs
    them), each held against the plain version on its own inputs within
    ATTN_TOL of every output's sum_j p_ij |v_j|; the tail-heavy and the
    negative-score inputs likewise, and the tail-heavy input with the last
    two keys dropped must fail that bound.  Times per 12 calls: the kernel
    and SDPA in CUDA graphs, the plain version eagerly.  The bound is the
    largest of bytes / 3.35 TB/s, flops / 989 TFLOP/s and exponentials
    (B*H*N^2) / (SMs x 16 a clock x the max SM clock)."""
    import torch
    import torch.nn.functional as F
    from fusiontransformer_tpu_torch.ops.kernels.flash_attention import (
        ATTN_TOL, attention_error_scale, flash_attention, flash_attention_ref)
    from fusiontransformer_tpu_torch.tools import microbench_attention as mat
    h, n, d, depth = mat.H, mat.N, mat.D, mat.DEPTH
    scale = d ** -0.5
    exp_rate = H100_SMS * EXP_PER_CLOCK_PER_SM * max_sm_clock_hz()

    def share(out, q, k, v):
        diff = (out.float() - flash_attention_ref(q, k, v, scale).float())
        bound_ = ATTN_TOL * attention_error_scale(q, k, v, scale)
        return (diff.abs() / bound_).max().item(), diff.abs().max().item()

    rows = []
    main = None
    for b in ATTN_BATCHES:
        q, k, v = mat.inputs(b, h, n, "cuda")
        worst, err, x = 0.0, 0.0, q
        for _ in range(depth):
            out = flash_attention(x, k, v, scale)
            s, e = share(out, x, k, v)
            worst, err = max(worst, s), max(err, e)
            x = out
        special = {}
        for label, make in (("tail-heavy", tail_heavy),
                            ("negative scores", negative_scores)):
            tq, tk, tv = make(b, h, n)
            special[label], e = share(flash_attention(tq, tk, tv, scale),
                                      tq, tk, tv)
            err = max(err, e)
            if label == "tail-heavy":
                tail_mass = torch.softmax(
                    torch.matmul(tq.float(), tk.float().transpose(-1, -2))
                    * scale, -1)[..., -2:].sum(-1).min().item()
                dropped = flash_attention(tq, tk[:, :, :-2].contiguous(),
                                          tv[:, :, :-2].contiguous(), scale)
                special["tail dropped"] = share(dropped, tq, tk, tv)[0]
        if not (worst <= 1.0 and max(v_ for k_, v_ in special.items()
                                     if k_ != "tail dropped") <= 1.0):
            raise AssertionError(f"T4 b={b}: worst share of the bound "
                                 f"{worst} (chain), {special}")
        if not (tail_mass > 0.5 and special["tail dropped"] > 1.0):
            raise AssertionError(f"T4 b={b}: the tail-heavy input does not "
                                 f"catch a dropped tail: mass {tail_mass}, "
                                 f"{special}")
        ms = graph_ms(lambda: mat.chain(mat.flash, q, k, v, depth), calls=1)
        plain_ms = cuda_ms(lambda: mat.chain(
            lambda *a: flash_attention_ref(*a, scale), q, k, v, depth),
            iters=2, reps=3)
        lib_ms = graph_ms(lambda: mat.chain(mat.sdpa, q, k, v, depth),
                          calls=1)
        nbytes = 4 * b * h * n * d * 2
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = 4 * b * h * n * n * d / PEAK_FLOPS["bfloat16"] * 1e3
        t_exps = b * h * n * n / exp_rate * 1e3
        b_ms = depth * max(t_bytes, t_flops, t_exps)
        b_by = "bytes" if t_bytes >= max(t_flops, t_exps) else "operations"
        row = dict(batch=b, heads=h, tokens=n, depth=depth,
                   worst_share_of_bound=worst, special_share=special,
                   tail_mass_min=tail_mass, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, bound_parts_ms={
                       "bytes": depth * t_bytes, "flops": depth * t_flops,
                       "exponentials": depth * t_exps})
        rows.append(row)
        log(f"  flash_attention b={b} x{depth} chained: worst {worst:.3g} of "
            f"the bound; tail-heavy {special['tail-heavy']:.3g} (tail mass "
            f">= {tail_mass:.4f}; dropped: {special['tail dropped']:.3g}), "
            f"negative scores {special['negative scores']:.3g}; kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  SDPA "
            f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}: bytes "
            f"{depth * t_bytes:.4f}, flops {depth * t_flops:.4f}, exp "
            f"{depth * t_exps:.4f}) per {depth} calls")
        main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "library_ms": lib_ms,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "bound_t": {b_by: b_ms},
                "batches": {str(r["batch"]): {
                    k_: r[k_] for k_ in ("ms", "library_ms", "bound_ms")}
                    for r in rows}}
    return rows, main


# --------------------------------------------------------------------------- #
# --------------------------------------------------------------------------- #
# Phases 14-16: the native host code, the engine's CUDA graphs, the server.

def phase_native(engine, recs, ds, tcfg):
    """The native host code: its g++ build time; the native quantize and
    slot triples against their numpy versions (``*_ref``) bit for bit on
    every call that the 8 requests' preprocess and collate and one batch-10
    training batch (its items and its collate) make, and every ``gslot_*``
    array of those batches equal both ways; host ms of each side (medians),
    per request and per training batch."""
    import os
    import shutil
    import tempfile
    import numpy as np
    from fusiontransformer_tpu_torch import native
    from fusiontransformer_tpu_torch.data import collate as collate_mod
    from fusiontransformer_tpu_torch.data import synthetic as synthetic_mod
    from fusiontransformer_tpu_torch.data.build import slot_pool_spec
    from fusiontransformer_tpu_torch.data.collate import get_collate
    from fusiontransformer_tpu_torch.data.quantize import (
        sparse_quantize, sparse_quantize_ref)
    from fusiontransformer_tpu_torch.ops.host_slots import (
        scan_slot_triples, scan_slot_triples_ref)
    from fusiontransformer_tpu_torch.serving import engine as engine_mod

    os.makedirs(native.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=native.BUILD_DIR)
    try:
        t0 = time.perf_counter()
        native.build(tmp)
        build_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)

    ms = {"quantize": ([], []), "triples": ([], [])}
    calls = {"quantize": 0, "triples": 0}

    def timed(key, native_fn, ref_fn, *args):
        t0 = time.perf_counter()
        got = native_fn(*args)
        t1 = time.perf_counter()
        want = ref_fn(*args)
        ms[key][0].append((t1 - t0) * 1e3)
        ms[key][1].append((time.perf_counter() - t1) * 1e3)
        calls[key] += 1
        return got, want

    def quantize(coords):
        got, want = timed("quantize", sparse_quantize, sparse_quantize_ref,
                          coords)
        for g, w in zip(got, want):
            if not np.array_equal(g, w):
                raise AssertionError("native quantize differs from numpy")
        return got

    def triples(levels, slot_levels):
        got, want = timed("triples", scan_slot_triples,
                          scan_slot_triples_ref, levels, slot_levels)
        for l in slot_levels:
            for g, w in zip(got[l], want[l]):
                if not np.array_equal(g, w):
                    raise AssertionError(f"native slot triples differ from "
                                         f"numpy at L{l}")
        return got

    collate10 = get_collate(
        TRAIN_BATCH, tcfg.TPU.POINT_CAPACITY,
        tcfg.DATASET.SyntheticSCN.image_height,
        tcfg.DATASET.SyntheticSCN.image_width,
        tuple(tcfg.TPU.CAPACITY_BUCKETS),
        level_counts=1 + len(tcfg.TPU.LEVEL_CAPACITY_FRACTIONS),
        slot_pool=slot_pool_spec(tcfg, adaptive=True))
    with patched(engine_mod, sparse_quantize=quantize), \
            patched(synthetic_mod, sparse_quantize=quantize), \
            patched(collate_mod, scan_slot_triples=triples):
        samples = [engine.preprocess(r) for r in recs]
        items = [ds[i] for i in range(TRAIN_BATCH)]
        for s in samples:
            engine.collate([s])
        collate10(items)
    log(f"  g++ build {build_s:.2f} s; native == numpy, bit for bit: "
        f"{calls['quantize']} quantize calls ({len(recs)} requests, "
        f"{TRAIN_BATCH} training items), {calls['triples']} slot-triple "
        f"joins (L0-L3 of every scan)")

    def maps_equal(collate, samples):
        """The batch and its host time through native triples, then through
        numpy; every gslot_* array equal."""
        t0 = time.perf_counter()
        got = collate(samples)
        t1 = time.perf_counter()
        with patched(collate_mod, scan_slot_triples=scan_slot_triples_ref):
            want = collate(samples)
        t2 = time.perf_counter()
        keys = [k for k in want if k.startswith("gslot_")]
        if len(keys) != 9:
            raise AssertionError(f"slot maps {keys}")
        for k in keys:
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"{k}: native and numpy maps differ")
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3

    per_request = [maps_equal(engine.collate, [s]) for s in samples]
    per_batch = [maps_equal(collate10, items) for _ in range(2)]
    med = statistics.median
    q_n, q_p = ms["quantize"]
    res = {
        "build_s": build_s, "calls": calls,
        "quantize_ms_request": {"native": med(q_n[:len(recs)]),
                                "numpy": med(q_p[:len(recs)])},
        "quantize_ms_batch10": {"native": sum(q_n[len(recs):]),
                                "numpy": sum(q_p[len(recs):])},
        "collate_maps_ms_request": {"native": med(a for a, _ in per_request),
                                    "numpy": med(b for _, b in per_request)},
        "collate_maps_ms_batch10": {"native": med(a for a, _ in per_batch),
                                    "numpy": med(b for _, b in per_batch)}}
    log("  host ms (medians; quantize of a batch of 10 summed over its "
        "items), native / numpy: " + "; ".join(
            f"{k} {v['native']:.2f} / {v['numpy']:.2f}"
            for k, v in res.items() if k.endswith(("request", "batch10"))))
    return res


def pool_bytes(pool):
    """Bytes of the segments of a graph memory pool, or None where the
    allocator's snapshot names no segment of it."""
    import torch
    pool = tuple(pool)
    segs = [sg["total_size"] for sg in torch.cuda.memory_snapshot()
            if tuple(sg.get("segment_pool_id", ())) == pool]
    return sum(segs) if segs else None


def replay_equals_eager(engine, batch):
    """The graph of ``batch``'s signature (captured now on a miss) replayed
    on it, bit for bit against the eager step on the same batch."""
    import numpy as np
    from fusiontransformer_tpu_torch.modules.steps import device_batch
    with engine._device_lock:
        graph = engine.graph_for(batch)
        got = graph.replay(batch).numpy()
    want = engine._step(device_batch(batch, engine.device)).cpu().numpy()
    rows = int((got != want).any(1).sum())
    if rows:
        raise AssertionError(f"replay differs from the eager step in {rows} "
                             f"of {len(got)} rows")
    return graph


def eager_request(engine, rec):
    """A request through the eager step (what the engine ran before it kept
    graphs), for the side-by-side reading."""
    from fusiontransformer_tpu_torch.modules.steps import device_batch
    sample = engine.preprocess(rec)
    batch = engine.collate([sample])
    packed = engine._step(device_batch(batch, engine.device))
    return engine.complete(([sample], batch, packed), count_stats=False)[0]


def phase_graphs(label, cfg, cfg32, state, recs):
    """The engine's CUDA graphs in one configuration: for each bucket (a
    dense grid filling it, the warmup's batch) and for the serving scan,
    the capture's seconds and the graph pool's bytes, and the replay bit
    for bit against the eager step, bf16 and f32 (TF32 off); three batches
    dispatched before any completes, each equal to its serial result; a
    cache of one graph that evicts and recaptures; then the 8 requests
    eagerly and through the graphs, A B B A, with the predict step side by
    side on CUDA events and the replay's kernels from the profiler."""
    import numpy as np
    import torch
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.modules.steps import (batch_signature,
                                                           device_batch)
    from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
    res = {"captures": {}}
    engines = {}
    for dtype, c in (("bf16", cfg), ("f32", cfg32)):
        model = build_model(c, "cuda")
        model.load_state_dict(state)
        eng = engines[dtype] = InferenceEngine(c, model=model)
        batches = {f"bucket {b}": eng.collate([eng._dummy_sample(b)])
                   for b in eng.buckets}
        batches["scan"] = eng.collate([eng.preprocess(recs[0])])
        for name, batch in batches.items():
            graph = replay_equals_eager(eng, batch)
            s_sizes = [batch[k].shape[1] for k in sorted(batch)
                       if k.startswith("gslot_src_")]
            res["captures"][f"{dtype} {name}"] = {
                "capture_s": graph.capture_s,
                "pool_bytes": pool_bytes(eng._pool),
                "pool_sizes": s_sizes}
        log(f"  {label} {dtype}: replay == eager bit for bit at "
            f"{list(batches)}; captures (s, pool bytes after it, S): "
            + ", ".join(f"{k.split(' ', 1)[1]} {v['capture_s']:.2f} "
                        f"{v['pool_bytes']} {v['pool_sizes']}"
                        for k, v in res["captures"].items()
                        if k.startswith(dtype)))
    del engines["f32"]
    torch.cuda.empty_cache()
    eng = engines["bf16"]

    samples = [eng.preprocess(r) for r in recs[:3]]
    serial = [eng.run_samples([s], count_stats=False)[0] for s in samples]
    handles = [eng.dispatch_samples([s]) for s in samples]
    for i, (h, want) in enumerate(zip(handles, serial)):
        got = eng.complete(h, count_stats=False)[0]
        for key in ("labels", "labels_2d", "labels_3d"):
            if not np.array_equal(got[key], want[key]):
                raise AssertionError(f"pipelined batch {i}: {key} differs "
                                     f"from its serial result")

    one = cfg.clone()
    one.TPU.STEP_CACHE_SIZE = 1
    one.freeze()
    small = InferenceEngine(one, model=eng.model)
    scan = small.collate([samples[0]])           # the smallest bucket
    grid = small.collate([small._dummy_sample(small.buckets[-1])])
    lengths = []
    for batch in (scan, grid, scan, scan):
        replay_equals_eager(small, batch)
        lengths.append(len(small.graphs))
    if lengths != [1, 1, 1, 1] or small.stats()["captures"] != 3:
        raise AssertionError(f"a cache of one: lengths {lengths}, "
                             f"{small.stats()['captures']} captures")
    del small
    log(f"  {label}: 3 pipelined batches each equal to their serial "
        f"results; STEP_CACHE_SIZE 1: lengths {lengths}, 3 captures for "
        f"scan, grid, scan, scan")

    for rec in recs:
        eng.predict(rec)                # every signature captured
    lat = {"eager": [], "graph": []}
    fns = {"eager": lambda r: eager_request(eng, r),
           "graph": lambda r: eng.predict(r)}
    for side in ("eager", "graph", "graph", "eager"):
        for rec in recs:
            t0 = time.perf_counter()
            fns[side](rec)
            lat[side].append((time.perf_counter() - t0) * 1e3)
    reqs = {side: {"p50_ms": statistics.median(v),
                   "scans_per_s": 1e3 / statistics.mean(v)}
            for side, v in lat.items()}
    db_batch = eng.collate([samples[0]])
    db = device_batch(db_batch, "cuda")
    graph = eng.graphs.get(batch_signature(db_batch))
    step = side_by_side(f"{label} predict step", {
        "eager": lambda: eng._step(db), "graph": graph.graph.replay})
    log(f"  {label}: {len(recs)} requests x 2 each side, A B B A (host "
        "clock): " + ", ".join(f"{k} p50 {v['p50_ms']:.1f} ms, "
                               f"{v['scans_per_s']:.2f} scans/s"
                               for k, v in reqs.items()))
    res.update(requests=reqs, step_ms=step,
               replay=replay_breakdown(eng, db_batch))
    del eng, engines
    torch.cuda.empty_cache()
    return res


def phase_server():
    """The port's ``tools/serve.py --selftest`` at full width on the card:
    the flagship behind its HTTP front end, SERVER_REQUESTS SyntheticSCN
    requests of ``N_POINTS`` rays from 4 client threads, twice (the first
    pass meets new slot-pool sizes and captures their graphs, the second
    finds them captured), each response held against the engine's serial
    prediction; /stats and /healthz answer."""
    from fusiontransformer_tpu_torch.tools import serve
    report = serve.main(["--cfg", CONFIG, "--selftest", str(SERVER_REQUESTS),
                         "--clients", str(SERVER_CLIENTS), "--points",
                         str(N_POINTS), "--port", "0"])
    st = report["stats"]
    if not report["matches_serial"] or st["voxel_overflow"] \
            or st["collate_dropped_points"] \
            or st["requests_completed"] != len(report["passes"]) \
            * SERVER_REQUESTS:
        raise AssertionError(f"server self-test: {report}")
    for i, run in enumerate(report["passes"]):
        lat = run["client_latency_ms"]
        log(f"  pass {i + 1}: {SERVER_REQUESTS} requests from "
            f"{SERVER_CLIENTS} clients over HTTP: p50 {lat['p50']:.1f} ms, "
            f"p99 {lat['p99']:.1f} ms, {run['scans_per_s']:.2f} scans/s, "
            f"{run['captures']} captures during it")
    log(f"  server stats: p50 {st['latency_ms']['p50']} ms over both "
        f"passes, {st['captures']} captures, bucket hits "
        f"{st['bucket_hits']}; responses equal the serial predictions")
    return report


# --------------------------------------------------------------------------- #
# Phases 18 and 19: the flagship on SemanticKITTI- and NuScenes-format data,
# through the port's preprocessors, train.py and test.py.

NUSCENES_CONFIG = "configs/nuscenes/middlefusion.yaml"
ONE_EPOCH = ["SCHEDULER.MAX_EPOCH", "1", "VAL.PERIOD", "1"]
# Raw trees (tools/fabricate.py): SemanticKITTI frames in the regular
# splits' sequences (train 00, val 07, test 08), 370 x 1226 PNGs, ~21,300
# in-frustum points a frame from 36,000 rays; NuScenes samples of ~10,000
# points, 1600 x 900 JPEGs resized to 400 x 225, in a USA train scene and a
# Singapore validation scene.
KITTI_RAYS = 36000
NUSCENES_RAYS = 10500
NUSCENES_SCENES = (("scene-0001", "day", "boston-seaport", 16),
                   ("scene-0004", "day", "singapore-onenorth", 8))
# SyntheticSCN's item a scan on the host (PERF.md section 5, the train cell).
SYNTHETIC_ITEM_MS = 46.5
PATH_KERNELS = ("binned_conv_grouped_fwd", "binned_conv_grouped_bwd")


@contextlib.contextmanager
def cli_logging():
    """Undo the root logging handlers a CLI's ``main`` installs, so later
    phases do not log every INFO line to stderr."""
    import logging
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        yield
    finally:
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        root.setLevel(level)


def trainer_launches_expected(captures, convs_per_step, k3_name, k3e8_name,
                              kind="grouped"):
    """The kernels' launches of a trainer's run with ``captures``: the
    wrappers launch in the eager run and the capture of each new signature
    (RUNS_PER_CAPTURE runs), a replay runs none; ``kind``'s binned-conv
    pair on the tensor cores, none of the other pair's."""
    from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
        DW_MMA_NAME, FWD_CORE_NAME, FWD_MMA_NAME)
    kk = binned_kernels(kind)
    other = binned_kernels("slots" if kind == "grouped" else "grouped")
    runs_t = RUNS_PER_CAPTURE * captures["train"]
    runs_f = runs_t + RUNS_PER_CAPTURE * captures["eval"]
    return {kk["fwd"].__name__: convs_per_step * runs_f,
            kk["bwd"].__name__: convs_per_step * runs_t,
            FWD_MMA_NAME: convs_per_step * (runs_f + runs_t),
            FWD_CORE_NAME: 0, DW_MMA_NAME: convs_per_step * runs_t,
            other["fwd"].__name__: 0, other["bwd"].__name__: 0,
            k3_name: 2 * runs_f, k3e8_name: 2 * runs_t}


def check_launches(what, launches, want):
    """Each kernel of ``want`` launched exactly its count (None: at least
    once) on ``what``."""
    for name, n in want.items():
        got = launches.get(name, 0)
        if got != n if n is not None else not got:
            raise AssertionError(f"{name}: {got} launches on the {what}, "
                                 f"expected {n or 'some'}")


def graph_seconds(runner):
    """Capture seconds of each graph a trainer or StepRunner holds."""
    out = {}
    for kind in ("train", "eval"):
        cache = getattr(runner, f"{kind}_graphs", None)
        if cache is not None:
            out[kind] = [round(cache.get(k).capture_s, 3)
                         for k in list(cache)]
    return out


def train_cli_run(argv):
    """``train.py`` as a user runs it, with every launch count set to 0
    just before and read just after: (trainer, launches, seconds)."""
    import torch
    from fusiontransformer_tpu_torch import train as train_cli
    from fusiontransformer_tpu_torch.ops.kernels import (LAUNCHES,
                                                         reset_launches)
    reset_launches()
    t0 = time.perf_counter()
    with cli_logging():
        trainer = train_cli.main(argv)
    torch.cuda.synchronize()
    return trainer, dict(LAUNCHES), time.perf_counter() - t0


def trained_losses(trainer, n_steps):
    import numpy as np
    meters = trainer.train_metric_logger.meters
    if trainer.step != n_steps:
        raise AssertionError(f"{trainer.step} train steps, expected "
                             f"{n_steps}")
    losses = {k: meters[k].global_avg for k in LOSS_KEYS if k in meters}
    want = {"total_loss", *(f"seg_loss_{m}" for m in trainer.modalities)}
    if not want <= set(losses) or not all(np.isfinite(v)
                                          for v in losses.values()):
        raise AssertionError(f"losses {losses}, expected finite {want}")
    overflow = {k: meters[k].sum for k in ("voxel_overflow", "slot_overflow")
                if k in meters}
    if any(overflow.values()):
        raise AssertionError(f"lossy train steps: {overflow}")
    val = trainer.val_metric_logger.meters
    lost = {k: val[k].global_avg for k in ("collate_dropped", "oob_points")}
    if any(lost.values()):
        raise AssertionError(f"points lost in validation: {lost}")
    return losses, overflow, lost


def kitti_windows(trainer, cfg, workers):
    """Train scans/s of ``train_for_one_epoch`` over the training split at
    NUM_WORKERS ``workers`` (the first, which may capture new signatures of
    this epoch's batches), 0 and ``workers`` again, host clock."""
    import torch
    from fusiontransformer_tpu_torch.data.build import build_dataloader
    loaders = {}
    for n in (workers, 0):
        wcfg = cfg.clone()
        wcfg.DATALOADER.NUM_WORKERS = n
        wcfg.freeze()
        loaders[n] = build_dataloader(wcfg, mode="train")
    out = {}
    try:
        for name, n in (("first", workers), ("0 workers", 0),
                        (f"{workers} workers", workers)):
            trainer.train_dataloader = loaders[n]
            before, step0 = trainer.captures["train"], trainer.step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_for_one_epoch(1)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            steps = trainer.step - step0
            scans = len(loaders[n].dataset)
            out[name] = {"scans_per_s": scans / dt, "seconds": dt,
                         "steps": steps,
                         "captures": trainer.captures["train"] - before}
            if name != "first" and out[name]["captures"]:
                raise AssertionError(f"captures in the window '{name}'")
            if not math.isfinite(
                    trainer.train_metric_logger.meters["total_loss"]
                    .global_avg):
                raise AssertionError("non-finite loss in the window")
    finally:
        for loader in loaders.values():
            loader.close()
    return out


def kitti_args(kitti_dirs, out):
    """The overrides that point a SemanticKITTI config at a fabricated,
    preprocessed tree and an output directory."""
    raw, pre = kitti_dirs
    return ["OUTPUT_DIR", out, "DATASET.SemanticKITTISCN.preprocess_dir", pre,
            "DATASET.SemanticKITTISCN.semantic_kitti_dir", raw]


def test_cli_run(config, dirs, ckpt, n_test, k3_name):
    """``test.py`` on ``ckpt`` as a user runs it (batch 1), with every
    launch count set to 0 just before and read just after (the binned conv
    and K3 launched where the model has the 3D stream, no backward; none
    without it); no lost point; then the same checkpoint through an
    in-process ``validate``: the same confusion matrices, every prediction
    a raw SemanticKITTI id after the inverse map."""
    import logging

    import numpy as np
    import torch
    from fusiontransformer_tpu_torch import test as test_cli
    from fusiontransformer_tpu_torch.data.build import build_dataloader
    from fusiontransformer_tpu_torch.data.semantic_kitti import labels as L
    from fusiontransformer_tpu_torch.data.utils.validate import validate
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
        StepRunner)
    from fusiontransformer_tpu_torch.ops.kernels import (LAUNCHES,
                                                         reset_launches)
    from fusiontransformer_tpu_torch.train import load_cfg
    from fusiontransformer_tpu_torch.utils.metric_logger import MetricLogger
    res = {}
    tcfg = load_cfg(config, dirs)
    reset_launches()
    t0 = time.perf_counter()
    with cli_logging():
        tested = test_cli.main(["--cfg", config, "--ckpt", ckpt, *dirs])
    torch.cuda.synchronize()
    res["test_s"] = time.perf_counter() - t0
    res["test_launches"] = dict(LAUNCHES)
    lidar = tcfg.MODEL.USE_LIDAR
    check_launches("test path", res["test_launches"], {
        "binned_conv_grouped_fwd": None if lidar else 0,
        k3_name: None if lidar else 0, "binned_conv_grouped_bwd": 0})
    meters = tested["meters"].meters
    if meters["collate_dropped"].global_avg or \
            meters["oob_points"].global_avg:
        raise AssertionError("test.py lost points")
    res["test_ms_a_scan"] = res["test_s"] * 1e3 / n_test
    res["test_batch_ms"] = meters["time"].global_avg * 1e3
    res["test_captures"] = tested["captures"]
    res["test_iou"] = {m: ev.overall_iou
                       for m, ev in tested["evaluators"].items()}
    model = build_model(tcfg, "cuda")
    model.load_state_dict(torch.load(ckpt, map_location="cpu",
                                     weights_only=True)["model"])
    runner = StepRunner(tcfg, model, next(model.parameters()).device,
                        logging.getLogger("chip_smoke"))
    loader = build_dataloader(tcfg, "test")
    mapped = []
    inverse = loader.dataset.map_inverse_label
    loader.dataset.map_inverse_label = \
        lambda x: mapped.append(inverse(x)) or mapped[-1]
    again = dict(validate(tcfg, runner.run_eval_batch, loader,
                          MetricLogger(), log_tables=False))
    raw_ids = set(L.LABELS)
    if not mapped or any(set(np.unique(m)) - raw_ids for m in mapped):
        raise AssertionError("a validated prediction is not a raw "
                             "SemanticKITTI id")
    if again.keys() != tested["evaluators"].keys():
        raise AssertionError(f"test.py scored {list(tested['evaluators'])}"
                             f", validate {list(again)}")
    for m, ev in again.items():
        if not np.array_equal(ev.confusion_matrix,
                              tested["evaluators"][m].confusion_matrix):
            raise AssertionError(f"test.py's {m} confusion matrix "
                                 f"differs from an in-process validate")
    del runner, model
    torch.cuda.empty_cache()
    return res


def phase_kitti(card, convs_per_step, k3_name, k3e8_name, work):
    """Phase 18: ``middlefusion.yaml`` on a SemanticKITTI-format tree, made
    under ``work`` (phase 20 reads it again)."""
    import os

    import numpy as np
    import torch
    from fusiontransformer_tpu_torch.data.build import build_dataloader
    from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                           hier_from_cfg)
    from fusiontransformer_tpu_torch.tools.fabricate import (KITTI_FRAMES,
                                                             make_kitti)
    from fusiontransformer_tpu_torch.train import load_cfg
    res = {"card": card}
    os.makedirs(work, exist_ok=True)
    raw, pre, out = (os.path.join(work, d) for d in ("raw", "pre", "out"))
    t0 = time.perf_counter()
    make_kitti(raw, KITTI_FRAMES, rays=KITTI_RAYS)
    res["fabricate_s"] = time.perf_counter() - t0
    frames = sum(KITTI_FRAMES.values())
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "fusiontransformer_tpu_torch."
                    "data.semantic_kitti.preprocess", "--root", raw,
                    "--out", pre, "--workers", "6"], check=True,
                   capture_output=True, text=True, timeout=600,
                   cwd=os.path.dirname(os.path.abspath(__file__)))
    res["preprocess_ms_a_frame"] = (time.perf_counter() - t0) * 1e3 \
        / frames
    dirs = kitti_args((raw, pre), out)
    cfg = load_cfg(CONFIG, dirs + ONE_EPOCH)
    steps = -(-KITTI_FRAMES["00"] // cfg.TRAIN.BATCH_SIZE)
    trainer, launches, train_s = train_cli_run(
        ["--cfg", CONFIG, "--run_name", "kitti", *dirs, *ONE_EPOCH])
    losses, overflow, lost = trained_losses(trainer, steps)
    captures = dict(trainer.captures)
    check_launches("real-format training path", launches,
                   trainer_launches_expected(captures, convs_per_step,
                                             k3_name, k3e8_name))
    res.update(train_s=train_s, losses=losses, overflow=overflow,
               lost=lost, captures=captures, launches=launches,
               capture_s=graph_seconds(trainer))
    log(f"  SemanticKITTI-format tree: {frames} frames fabricated in "
        f"{res['fabricate_s']:.1f} s, preprocess CLI "
        f"{res['preprocess_ms_a_frame']:.1f} ms a frame; train.py "
        f"({steps} steps of {cfg.TRAIN.BATCH_SIZE} + validation) in "
        f"{train_s:.1f} s: losses {losses}, overflow {overflow}, "
        f"validation lost {lost}; captures {captures} "
        f"({res['capture_s']} s); launches {launches}")
    ds = trainer.train_dataloader.dataset
    t0 = time.perf_counter()
    for i in range(len(ds)):
        np.random.seed(i)
        ds[i]
    res["item_ms"] = (time.perf_counter() - t0) * 1e3 / len(ds)
    t0 = time.perf_counter()
    trainer.validate_for_one_epoch(0)
    torch.cuda.synchronize()
    res["validate_ms_a_scan"] = (time.perf_counter() - t0) * 1e3 \
        / len(trainer.val_dataloader.dataset)
    res["windows"] = kitti_windows(trainer, cfg, 6)
    # One real-format batch: the eval replay against the eager eval
    # step, then K1 and K3 on its maps against their plain versions.
    hb = next(iter(build_dataloader(cfg, "val")))
    res["eval_replay_captures"] = eval_replays_equal_eager(trainer, [hb])
    hier = hier_from_cfg(cfg, device_batch(hb, trainer.device),
                         trainer.level_caps(hb))
    gen = torch.Generator().manual_seed(18)
    res["k1_rows"], k1, _ = phase_k1(hier, trainer.model, gen,
                                     per="real-format batch")
    res["k3_rows"], k3 = phase_k3(hier, gen)
    res["k1"] = {k: k1[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "max_abs_err", "max_share")}
    res["k3"] = {k: k3[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "max_abs_err")}
    ckpt = os.path.join(out, "kitti", "model000000.pth")
    del trainer, hier
    torch.cuda.empty_cache()
    log(f"  item {res['item_ms']:.1f} ms a scan (SyntheticSCN "
        f"{SYNTHETIC_ITEM_MS}); validate {res['validate_ms_a_scan']:.1f} "
        f"ms a scan; windows " + ", ".join(
            f"{k}: {v['scans_per_s']:.3f} train scans/s "
            f"({v['captures']} captures)"
            for k, v in res["windows"].items())
        + f"; the eval replay of a real-format batch bit for bit the "
        f"eager eval step; {card}")

    n_test = KITTI_FRAMES["08"]
    res.update(test_cli_run(CONFIG, dirs, ckpt, n_test, k3_name))
    log(f"  test.py on the checkpoint: {n_test} scans at batch 1 in "
        f"{res['test_s']:.1f} s (model build, checkpoint load and "
        f"{res['test_captures']} eval captures included; "
        f"{res['test_batch_ms']:.1f} ms a batch on average), IoU "
        f"{res['test_iou']}, its confusion matrices equal an in-process "
        f"validate's; every prediction a raw SemanticKITTI id; launches "
        f"{res['test_launches']}; {card}")
    res["kitti_dirs"] = (raw, pre)
    return res


def phase_nuscenes(card, convs_per_step, k3_name, k3e8_name, work):
    """Phase 19: ``configs/nuscenes/middlefusion.yaml`` on a NuScenes-format
    database, made under ``work`` (phase 20 reads it again)."""
    import os

    import numpy as np
    import torch
    from fusiontransformer_tpu_torch.data.build import build_dataloader
    from fusiontransformer_tpu_torch.data.nuscenes.preprocess import (
        preprocess)
    from fusiontransformer_tpu_torch.tools.fabricate import FakeNuScenes
    from fusiontransformer_tpu_torch.train import load_cfg
    res = {"card": card}
    os.makedirs(work, exist_ok=True)
    root, out = os.path.join(work, "nusc"), os.path.join(work, "out")
    t0 = time.perf_counter()
    nusc = FakeNuScenes(root, NUSCENES_SCENES, rays=NUSCENES_RAYS)
    res["fabricate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    preprocess(nusc, ["train", "test"], root, out, location="boston",
               subset_name="usa")
    preprocess(nusc, ["train", "val", "test"], root, out,
               location="singapore", subset_name="singapore")
    res["preprocess_ms_a_sample"] = (time.perf_counter() - t0) * 1e3 \
        / len(nusc.sample)
    dirs = ["OUTPUT_DIR", os.path.join(work, "logs"),
            "DATASET.NuScenesSCN.preprocess_dir",
            os.path.join(out, "preprocess"),
            "DATASET.NuScenesSCN.nuscenes_dir", root]
    cfg = load_cfg(NUSCENES_CONFIG, dirs + ONE_EPOCH)
    steps = -(-NUSCENES_SCENES[0][3] // cfg.TRAIN.BATCH_SIZE)
    trainer, launches, train_s = train_cli_run(
        ["--cfg", NUSCENES_CONFIG, "--run_name", "nuscenes", *dirs,
         *ONE_EPOCH])
    losses, overflow, lost = trained_losses(trainer, steps)
    captures = dict(trainer.captures)
    check_launches("NuScenes training path", launches,
                   trainer_launches_expected(captures, convs_per_step,
                                             k3_name, k3e8_name))
    hb = next(iter(build_dataloader(cfg, "val")))
    got = trainer.run_eval_batch(hb).numpy()
    valid = hb["pt_valid"]
    n_cls = cfg.MODEL.NUM_CLASSES
    for key in ("pred_2d", "pred_3d", "pred_ensemble"):
        p = got[key][valid]
        if not (p.size and p.min() >= 0 and p.max() < n_cls):
            raise AssertionError(f"{key} outside [0, {n_cls})")
    ds = trainer.train_dataloader.dataset
    t0 = time.perf_counter()
    for i in range(len(ds)):
        np.random.seed(i)
        ds[i]
    res.update(train_s=train_s, losses=losses, overflow=overflow,
               lost=lost, captures=captures, launches=launches,
               capture_s=graph_seconds(trainer),
               item_ms=(time.perf_counter() - t0) * 1e3 / len(ds),
               points_a_scan=float(hb["scan_count"].mean()),
               image=list(hb["img"].shape[1:3]))
    del trainer
    torch.cuda.empty_cache()
    log(f"  NuScenes-format database: {len(nusc.sample)} samples "
        f"fabricated in {res['fabricate_s']:.1f} s, preprocess "
        f"{res['preprocess_ms_a_sample']:.1f} ms a sample; item "
        f"{res['item_ms']:.1f} ms a scan ({res['points_a_scan']:.0f} voxels "
        f"a scan, images {res['image']}); train.py ({steps} steps of "
        f"{cfg.TRAIN.BATCH_SIZE} + validation) in {train_s:.1f} s: losses "
        f"{losses}, overflow {overflow}, validation lost {lost}, every "
        f"prediction in [0, {n_cls}); captures {captures} "
        f"({res['capture_s']} s); launches {launches}; {card}")
    res["nuscenes_dirs"] = (root, os.path.join(out, "preprocess"))
    return res


# --------------------------------------------------------------------------- #
# Phase 20: the uni-modal models, the paper's baselines, on the trees of
# phases 18 and 19, each config as shipped but for its directories.

LIDAR_CONFIG = "configs/semantic_kitti/lidar.yaml"
NUSCENES_LIDAR_CONFIG = "configs/nuscenes/lidar.yaml"
IMAGE_CONFIG = "configs/semantic_kitti/imageBilinear.yaml"
STN_CONFIG = "configs/semantic_kitti/image.yaml"
# The lidar engine's f32 logits, card (TF32 off) against the CPU: the
# full-model bound of PARITY.md.
PARITY_ATOL = 2e-3


def first_train_batch(cfg, epoch=0):
    """The first batch the trainer's loader gives at ``epoch``."""
    from fusiontransformer_tpu_torch.data.build import build_dataloader
    loader = build_dataloader(cfg, mode="train")
    loader.set_epoch(epoch)
    try:
        return next(iter(loader))
    finally:
        loader.close()


def unimodal_train(label, config, dirs, n_train):
    """``train.py`` with ``config`` (one epoch of ``n_train`` scans and a
    validation) as ``train_cli_run`` runs it: finite losses of the model's
    one stream, no overflow, no lost point.  Returns (cfg, trainer, its
    record)."""
    import torch
    from fusiontransformer_tpu_torch.train import load_cfg
    cfg = load_cfg(config, dirs + ONE_EPOCH)
    steps = -(-n_train // cfg.TRAIN.BATCH_SIZE)
    torch.cuda.reset_peak_memory_stats()
    trainer, launches, train_s = train_cli_run(
        ["--cfg", config, "--run_name", label, *dirs, *ONE_EPOCH])
    losses, overflow, lost = trained_losses(trainer, steps)
    if trainer.modalities != (["3d"] if cfg.MODEL.USE_LIDAR else ["2d"]):
        raise AssertionError(f"{label}: modalities {trainer.modalities}")
    rec = {"train_s": train_s, "steps": steps, "losses": losses,
           "overflow": overflow, "lost": lost,
           "captures": dict(trainer.captures), "launches": launches,
           "capture_s": graph_seconds(trainer),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  {label}: train.py ({steps} steps of {cfg.TRAIN.BATCH_SIZE} + "
        f"validation) in {train_s:.1f} s: losses {losses}, overflow "
        f"{overflow}, validation lost {lost}; captures {rec['captures']} "
        f"({rec['capture_s']} s); launches {launches}; peak device memory "
        f"{rec['peak_memory_gb']:.1f} GB")
    return cfg, trainer, rec


def lidar_convs(trainer, cfg, hb):
    """The slot-map convs of one step of ``trainer``'s model on ``hb``."""
    from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                           hier_from_cfg)
    hier = hier_from_cfg(cfg, device_batch(hb, trainer.device),
                         trainer.level_caps(hb))
    return len(slot_convs(trainer.model, hier))


def no_launches(what, launches):
    if any(launches.values()):
        raise AssertionError(f"{what} launched hand-written kernels: "
                             f"{dict(launches)}")


def phase_lidar_only(card, k3_name, k3e8_name, kitti_dirs, work):
    """Phase 20a: ``lidar.yaml`` (LidarSeg: SPVCNN cr 1.0 and one linear
    head, batch 10, bf16) trained, validated and tested, then served."""
    import os

    import numpy as np
    import torch
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                           hier_from_cfg)
    from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
        FWD_CORE_NAME, FWD_MMA_NAME)
    from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
    from fusiontransformer_tpu_torch.tools.fabricate import KITTI_FRAMES
    from fusiontransformer_tpu_torch.train import load_cfg
    out = os.path.join(work, "lidar")
    dirs = kitti_args(kitti_dirs, out)
    cfg, trainer, res = unimodal_train("lidar", LIDAR_CONFIG, dirs,
                                       KITTI_FRAMES["00"])
    hb = first_train_batch(cfg)
    caps = trainer.level_caps(hb)
    convs = lidar_convs(trainer, cfg, hb)
    check_launches("lidar-only training path", res["launches"],
                   trainer_launches_expected(res["captures"], convs,
                                             k3_name, k3e8_name))
    t0 = time.perf_counter()
    trainer.validate_for_one_epoch(0)
    torch.cuda.synchronize()
    res["validate_ms_a_scan"] = (time.perf_counter() - t0) * 1e3 \
        / len(trainer.val_dataloader.dataset)
    replays_equal_eager(trainer, [hb])
    res["replay"] = train_replay_kernels(trainer, hb, convs)
    res["windows"] = kitti_windows(trainer, cfg, 6)
    res["bf16_step_calls"] = bf16_step_calls(
        trainer, "grouped", device_batch(hb, trainer.device), caps, convs)
    res["convs_per_step"] = convs
    del trainer
    torch.cuda.empty_cache()
    log(f"  lidar-only: one train replay bit for bit the eager step; "
        f"replay {res['replay']['replay_ms']:.2f} ms, busy share "
        f"{res['replay']['busy_share']:.3f}; validate "
        f"{res['validate_ms_a_scan']:.1f} ms a scan; windows " + ", ".join(
            f"{k}: {v['scans_per_s']:.3f} train scans/s"
            for k, v in res["windows"].items()) + f"; {card}")
    n_test = KITTI_FRAMES["08"]
    res.update(test_cli_run(LIDAR_CONFIG, dirs, os.path.join(
        out, "lidar", "model000000.pth"), n_test, k3_name))
    log(f"  lidar-only test.py: {n_test} scans at batch 1 in "
        f"{res['test_s']:.1f} s, IoU {res['test_iou']}, its matrix equal "
        f"to an in-process validate's, raw ids; launches "
        f"{res['test_launches']}")

    # Serving: 8 requests at batch 1 through the engine's graphs.
    scfg = load_cfg(LIDAR_CONFIG, [])
    engine = InferenceEngine(scfg, batch_size=1, seed=0)
    recs = records(N_REQUESTS, N_POINTS, engine.image_height,
                   engine.image_width)
    sample = engine.preprocess(recs[0])
    shier = hier_from_cfg(scfg, device_batch(engine.collate([sample]),
                                             engine.device))
    per_request = len(slot_convs(engine.model, shier))
    del shier
    res["engine"] = drive_engine(engine, recs, card, {
        "binned_conv_grouped_fwd": per_request, FWD_MMA_NAME: per_request,
        FWD_CORE_NAME: 0, k3_name: 2}, replay_kernels(per_request))
    for rec in recs:
        got = engine.predict(rec)
        if set(got) != {"labels", "labels_3d", "in_frustum", "num_voxels"} \
                or not np.array_equal(got["labels"], got["labels_3d"]):
            raise AssertionError("the lidar engine's pred is not its "
                                 "pred_3d")
    # f32 on the card (TF32 off) against the plain path on the CPU.
    cfg32 = scfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    cfg32.freeze()
    state = {k: v.cpu() for k, v in engine.model.state_dict().items()}
    del engine
    torch.cuda.empty_cache()
    outs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg32, dev)
        model.load_state_dict(state)
        eng = InferenceEngine(cfg32, model=model, device=dev)
        outs[dev] = {k: v.float().cpu()
                     for k, v in eng.forward([sample])[1].items()}
        del eng, model
    torch.cuda.empty_cache()
    diff = {k: (outs["cuda"][k] - outs["cpu"][k]).abs().max().item()
            for k in outs["cpu"]}
    res["f32_card_vs_cpu_max_abs"] = diff
    log(f"  lidar engine, f32 on the card vs the CPU: max abs {diff} "
        f"(bound {PARITY_ATOL}); pred == pred_3d on every request")
    if not diff["lidar_seg_logit"] <= PARITY_ATOL:
        raise AssertionError(f"f32 lidar logits differ by {diff}")
    return res


def phase_nuscenes_lidar(card, k3_name, k3e8_name, nus_dirs, work):
    """Phase 20b: ``nuscenes/lidar.yaml`` (LidarSeg, 5 merged classes,
    batch 8)."""
    import os

    import torch
    from fusiontransformer_tpu_torch.data.build import build_dataloader
    root, pre = nus_dirs
    dirs = ["OUTPUT_DIR", os.path.join(work, "nuscenes_lidar"),
            "DATASET.NuScenesSCN.preprocess_dir", pre,
            "DATASET.NuScenesSCN.nuscenes_dir", root]
    cfg, trainer, res = unimodal_train("nuscenes lidar",
                                       NUSCENES_LIDAR_CONFIG, dirs,
                                       NUSCENES_SCENES[0][3])
    convs = lidar_convs(trainer, cfg, first_train_batch(cfg))
    check_launches("NuScenes lidar-only training path", res["launches"],
                   trainer_launches_expected(res["captures"], convs,
                                             k3_name, k3e8_name))
    hb = next(iter(build_dataloader(cfg, "val")))
    got = trainer.run_eval_batch(hb).numpy()
    n_cls = cfg.MODEL.NUM_CLASSES
    p = got["pred_3d"][hb["pt_valid"]]
    if set(got) != {"pred_3d", "seg_loss_3d"} or not (
            p.size and p.min() >= 0 and p.max() < n_cls):
        raise AssertionError(f"eval results {sorted(got)}, pred_3d in "
                             f"[{p.min()}, {p.max()}] of {n_cls} classes")
    del trainer
    torch.cuda.empty_cache()
    log(f"  NuScenes lidar-only: every prediction in [0, {n_cls}); {card}")
    return res


def phase_image_only(card, kitti_dirs, work, config, label, serve):
    """Phase 20c / 20d: an image-only config on the SemanticKITTI tree:
    batches without slot maps or level counts (their host collate timed),
    no hand-written kernel launched, one train replay bit for bit the
    eager step; with ``serve`` the engine for 8 requests."""
    import os

    import torch
    from fusiontransformer_tpu_torch.ops.kernels import (LAUNCHES,
                                                         reset_launches)
    from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
    from fusiontransformer_tpu_torch.tools.fabricate import KITTI_FRAMES
    from fusiontransformer_tpu_torch.train import load_cfg
    dirs = kitti_args(kitti_dirs, os.path.join(work, label))
    cfg, trainer, res = unimodal_train(label, config, dirs,
                                       KITTI_FRAMES["00"])
    no_launches(f"{label} training path", res["launches"])
    hb = first_train_batch(cfg)
    maps = [k for k in hb if k.startswith(("gslot_", "level_counts"))]
    if maps:
        raise AssertionError(f"{label} batches carry {maps}")
    loader = trainer.train_dataloader
    items = [loader.dataset[i] for i in range(cfg.TRAIN.BATCH_SIZE)]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loader.collate_fn(items)
        times.append((time.perf_counter() - t0) * 1e3)
    res["collate_ms_a_batch"] = statistics.median(times)
    reset_launches()
    replays_equal_eager(trainer, [hb])
    res["replay_ms"] = cuda_ms(trainer.train_graphs.get(graph_key(
        trainer, hb)).graph.replay, iters=3, reps=3)
    no_launches(f"{label} replay check", LAUNCHES)
    del trainer, items
    torch.cuda.empty_cache()
    log(f"  {label}: batches carry no slot maps nor level counts; host "
        f"collate {res['collate_ms_a_batch']:.1f} ms a batch of "
        f"{cfg.TRAIN.BATCH_SIZE} (host clock); one train replay bit for "
        f"bit the eager step, replay {res['replay_ms']:.2f} ms (CUDA "
        f"events); no hand-written kernel launched; {card}")
    if serve:
        scfg = load_cfg(config, [])
        engine = InferenceEngine(scfg, batch_size=1, seed=0)
        if engine._slot_pool is not None:
            raise AssertionError("the image-only engine builds slot maps")
        recs = records(N_REQUESTS, N_POINTS, engine.image_height,
                       engine.image_width)
        res["engine"] = drive_engine(engine, recs, card, {}, {
            "binned_conv_fwd_mma_kernel": 0,
            "sorted_segment_weighted_sum_kernel": 0})
        no_launches(f"{label} engine", res["engine"]["launches"])
        del engine
        torch.cuda.empty_cache()
    return res


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
    from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
        DW_MMA_NAME, FWD_CORE_NAME, FWD_MMA_NAME)
    from fusiontransformer_tpu_torch.ops.kernels.segment_sum import (
        launch_name)
    k3_name, k3e8_name = launch_name(1), launch_name(8)
    from fusiontransformer_tpu_torch.serving.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    t_start = time.time()
    phase_s = {}

    def phase_end(name):
        phase_s[name] = round(time.time() - t_start - sum(phase_s.values()),
                              1)
        log(f"-- phase {name}: {phase_s[name]} s")

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
        for entry, props in ptxas_summary(rep["log"]):
            log(f"  ptxas {name} {entry}: {props}")

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

    phase_end("1")
    log("== 2. K3 sorted_segment_weighted_sum vs plain")
    k3_rows, k3 = phase_k3(hier, gen)
    phase_end("2")
    log("== 3. K1 binned_conv_grouped_fwd vs plain")
    k1_rows, k1, k1_per_request = phase_k1(hier, engine.model, gen)
    phase_end("3")

    # ---- 4. main path
    log("== 4. inference path: InferenceEngine, bf16, batch 1")
    serve = drive_engine(engine, recs, card, {
        "binned_conv_grouped_fwd": k1_per_request,
        FWD_MMA_NAME: k1_per_request, FWD_CORE_NAME: 0, k3_name: 2},
        replay_kernels(k1_per_request))
    phase_end("4")

    # ---- 5. main path against the plain path (f32, card vs CPU)
    log("== 5. f32 on the card vs the plain path on the CPU")
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    cfg32.freeze()
    serve_state = {k: v.cpu() for k, v in engine.model.state_dict().items()}
    m_gpu = build_model(cfg32, "cuda")
    m_gpu.load_state_dict(serve_state)
    m_cpu = build_model(cfg32, "cpu")
    m_cpu.load_state_dict(serve_state)
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

    # The group-pooled f32 logits on the card, for phase 10.
    grouped_f32 = {k: v.cpu() for k, v in out_gpu.items()}
    del e_gpu, e_cpu, m_gpu, m_cpu, engine, out_gpu
    torch.cuda.empty_cache()
    phase_end("5")

    # ---- 6. K2 and K3 E=8 on a real training batch
    log("== 6. K1 binned_conv_grouped_fwd, K2 binned_conv_grouped_bwd and "
        "K3 at E=8 vs plain, on a training batch")
    from fusiontransformer_tpu_torch.data.build import slot_pool_spec
    from fusiontransformer_tpu_torch.data.collate import get_collate
    from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
        SemanticTrainer)
    tcfg = train_cfg()
    t0 = time.time()
    trainer = SemanticTrainer(tcfg)
    ds = trainer.train_dataloader.dataset
    hb = trainer.train_dataloader.collate_fn(
        [ds[i] for i in range(TRAIN_BATCH)])
    if hb["gslot_overflow"] != 0 or hb["num_dropped"] != 0:
        raise AssertionError(f"lossy training batch: slot overflow "
                             f"{hb['gslot_overflow']}, dropped "
                             f"{hb['num_dropped']}")
    caps = trainer.level_caps(hb)
    thier = hier_from_cfg(tcfg, device_batch(hb, trainer.device), caps)
    log(f"trainer built in {time.time() - t0:.1f} s; training batch: "
        f"{int(hb['scan_count'].sum())} voxels in {TRAIN_BATCH} scans, "
        f"buffer {len(hb['pt_valid'])}, adaptive level caps {caps}, pool "
        f"sizes {[l.slot_idx[0].shape[1] for l in thier.levels if l.slot_idx]}")
    k1t_rows, k1t, _ = phase_k1(thier, trainer.model, gen,
                                per="train step")
    k2_rows, k2 = phase_k2(thier, trainer.model, gen)
    share_rows = live_share_scaling(thier, gen)
    k3t_rows, k3t, k3e8 = phase_k3_train(thier, gen)
    gemm_grads = phase_gemm_grads(tcfg)
    convs_per_step = len(slot_convs(trainer.model, thier))
    del thier
    torch.cuda.empty_cache()
    phase_end("6")

    # ---- 7. train step, card vs CPU
    log(f"== 7. one f32 train step on the card vs the plain path on the "
        f"CPU (cut: batch {TRAIN_BATCH} -> {PARITY_SCANS} scans; full "
        f"width and depth)")
    collate2 = get_collate(
        PARITY_SCANS, tcfg.TPU.POINT_CAPACITY,
        tcfg.DATASET.SyntheticSCN.image_height,
        tcfg.DATASET.SyntheticSCN.image_width,
        tuple(tcfg.TPU.CAPACITY_BUCKETS),
        level_counts=1 + len(tcfg.TPU.LEVEL_CAPACITY_FRACTIONS),
        slot_pool=slot_pool_spec(tcfg, adaptive=True))
    hb2 = collate2([ds[i] for i in range(PARITY_SCANS)])
    state = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    # The ks3 convs at L0-L3, which run K1 and K2 (stage4 is at L4, dense).
    conv_names = {f"lidar_backbone.backbone.{n}.kernel"
                  for n, m in trainer.model.lidar_backbone.backbone
                  .named_modules() if type(m).__name__ == "SubMConv3"
                  and not n.startswith("stage4")}
    parity = phase_train_parity(tcfg, state, hb2, trainer.level_caps(hb2),
                                conv_names)
    del state
    phase_end("7")

    # ---- 8. the training path
    log(f"== 8. training path: SemanticTrainer, bf16, batch {TRAIN_BATCH}, "
        f"{TRAIN_STEPS} steps + validation over {len(ds)} scans")
    train = drive_trainer(trainer, tcfg, card, "grouped", convs_per_step,
                          k3_name, k3e8_name)
    tlaunches = train["launches"]
    train["bf16_k2_calls"] = bf16_step_calls(
        trainer, "grouped", device_batch(hb, trainer.device), caps,
        convs_per_step)
    phase_end("8")

    # ---- 17a. the train and eval steps through the trainer's graphs
    log("== 17a. train graphs, group-pooled: replays against the eager step "
        "(bf16, f32), LR, host syncs, kernels per replay, eager against "
        "graph, the window at 0 and N workers, GRAD_ACCUM_STEPS 2, eval")
    tcfg32 = tcfg.clone()
    tcfg32.TPU.COMPUTE_DTYPE = "float32"
    tcfg32.freeze()
    train_graphs = {"group-pooled": phase_train_graphs(
        "group-pooled", trainer, tcfg, tcfg32, convs_per_step)}
    del trainer
    torch.cuda.empty_cache()
    phase_end("17a")

    # ---- 9. K1' and K2' on the flagship's per-voxel maps
    log("== 9. K1' binned_conv_slots_fwd and K2' binned_conv_slots_bwd vs "
        "plain, on the flagship's own per-voxel K-slot maps (built on the "
        "card), and what building them costs")
    pcfg, ptcfg = per_voxel(cfg), per_voxel(tcfg)
    sdb = device_batch(without_host_maps(batch), "cuda")
    tdb = device_batch(without_host_maps(hb), "cuda")
    maps_cost = {"serve (batch 1)": hier_cost(pcfg, sdb, None),
                 f"train (batch {TRAIN_BATCH})": hier_cost(ptcfg, tdb, caps)}
    shier = hier_from_cfg(pcfg, sdb)
    pmodel = build_model(pcfg, "cuda")
    pmodel.load_state_dict(serve_state)
    k1p_rows, k1p, k1p_per_request = phase_k1(shier, pmodel, gen, "slots")
    thier = hier_from_cfg(ptcfg, tdb, caps)
    k1pt_rows, k1pt, _ = phase_k1(thier, pmodel, gen, "slots",
                                  per="train step")
    k2p_rows, k2p = phase_k2(thier, pmodel, gen, "slots")
    del shier, thier, pmodel
    torch.cuda.empty_cache()
    phase_end("9")

    # ---- 10. per-voxel serving
    log("== 10. per-voxel serving: InferenceEngine with TPU.CONV_SLOT_POOL "
        "False, bf16, batch 1")
    pengine = InferenceEngine(pcfg, model=build_model(pcfg, "cuda"))
    pengine.model.load_state_dict(serve_state)
    if pengine._slot_pool is not None:
        raise AssertionError("the per-voxel engine builds host slot maps")
    pserve = drive_engine(pengine, recs, card, {
        "binned_conv_slots_fwd": k1p_per_request,
        FWD_MMA_NAME: k1p_per_request, FWD_CORE_NAME: 0,
        "binned_conv_grouped_fwd": 0, k3_name: 2},
        replay_kernels(k1p_per_request))
    # The engine's step routes on the batch: with the host maps it runs K1.
    gdb = device_batch(batch, "cuda")
    pserve["step_side_by_side_ms"] = side_by_side("predict step", {
        "group-pooled maps (K1)": lambda: pengine._step(gdb),
        "per-voxel maps (K1')": lambda: pengine._step(sdb)})
    del pengine
    pserve["f32"] = per_voxel_f32(cfg32, serve_state, sample, grouped_f32)
    torch.cuda.empty_cache()
    phase_end("10")

    # ---- 11. per-voxel training
    log(f"== 11. per-voxel training: one f32 train step on the card vs the "
        f"CPU ({PARITY_SCANS} scans), then SemanticTrainer with "
        f"TPU.CONV_SLOT_POOL False, bf16, batch {TRAIN_BATCH}")
    collate2p = get_collate(
        PARITY_SCANS, tcfg.TPU.POINT_CAPACITY,
        tcfg.DATASET.SyntheticSCN.image_height,
        tcfg.DATASET.SyntheticSCN.image_width,
        tuple(tcfg.TPU.CAPACITY_BUCKETS),
        level_counts=1 + len(tcfg.TPU.LEVEL_CAPACITY_FRACTIONS),
        slot_pool=slot_pool_spec(ptcfg, adaptive=True))
    hb2p = collate2p([ds[i] for i in range(PARITY_SCANS)])
    ptrainer = SemanticTrainer(ptcfg)
    if any(k.startswith("gslot_") for k in hb2p):
        raise AssertionError("the per-voxel collate built host slot maps")
    state = {k: v.cpu() for k, v in ptrainer.model.state_dict().items()}
    pparity = phase_train_parity(ptcfg, state, hb2p,
                                 ptrainer.level_caps(hb2p), conv_names,
                                 kind="slots")
    del state
    ptrain = drive_trainer(ptrainer, ptcfg, card, "slots", convs_per_step,
                           k3_name, k3e8_name)
    ptlaunches = ptrain["launches"]
    ptrain["bf16_k2_calls"] = bf16_step_calls(ptrainer, "slots", tdb, caps,
                                              convs_per_step)
    # The train step routes on the batch too: with the host maps K1 / K2.
    pdb = device_batch(hb, "cuda")
    ptrain["step_side_by_side_ms"] = side_by_side("train step", {
        "group-pooled maps (K1/K2)": lambda: ptrainer.train_step(
            pdb, ptrainer.generator, caps),
        "per-voxel maps (K1'/K2')": lambda: ptrainer.train_step(
            tdb, ptrainer.generator, caps)})
    phase_end("11")

    log("== 17b. train graphs, per-voxel: as 17a")
    train_graphs["per-voxel"] = phase_train_graphs(
        "per-voxel", ptrainer, ptcfg, per_voxel(tcfg32), convs_per_step)
    del ptrainer
    torch.cuda.empty_cache()
    phase_end("17b")

    # ---- 18. / 19. the flagship on real-format data
    log("== 18. SemanticKITTI-format data: fabricated raw tree -> the "
        "preprocess CLI -> train.py (middlefusion.yaml, batch "
        f"{TRAIN_BATCH}) -> validation -> test.py, bf16, through the "
        "trainer's CUDA graphs")
    import os
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="ftx_real_")
    try:
        real = {"kitti": phase_kitti(card, convs_per_step, k3_name,
                                     k3e8_name, os.path.join(work, "kitti"))}
        phase_end("18")
        log("== 19. NuScenes-format data: fabricated database -> preprocess "
            "-> train.py (nuscenes/middlefusion.yaml: 5 classes, 400 x 225, "
            "batch 8) -> validation, bf16")
        real["nuscenes"] = phase_nuscenes(card, convs_per_step, k3_name,
                                          k3e8_name,
                                          os.path.join(work, "nuscenes"))
        phase_end("19")

        # ---- 20. the uni-modal models on the same trees
        kitti_dirs = real["kitti"].pop("kitti_dirs")
        nus_dirs = real["nuscenes"].pop("nuscenes_dirs")
        unimodal = {}
        log("== 20a. lidar.yaml (LidarSeg alone, batch 10, bf16): train.py "
            "-> validation -> test.py, then InferenceEngine at batch 1")
        unimodal["lidar"] = phase_lidar_only(card, k3_name, k3e8_name,
                                             kitti_dirs, work)
        phase_end("20a")
        log("== 20b. nuscenes/lidar.yaml (LidarSeg, 5 classes, batch 8): "
            "train.py -> validation")
        unimodal["nuscenes_lidar"] = phase_nuscenes_lidar(
            card, k3_name, k3e8_name, nus_dirs, work)
        phase_end("20b")
        log("== 20c. imageBilinear.yaml (ImageSegBilinear, DeiT-B/384, batch "
            "10, bf16): train.py -> validation, then InferenceEngine")
        unimodal["image_bilinear"] = phase_image_only(
            card, kitti_dirs, work, IMAGE_CONFIG, "imageBilinear", True)
        phase_end("20c")
        log("== 20d. image.yaml (the STN ImageSeg, batch 10, bf16): train.py "
            "-> validation")
        unimodal["image_stn"] = phase_image_only(
            card, kitti_dirs, work, STN_CONFIG, "image", False)
        phase_end("20d")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 12. the tool kernels behind the port's microbenches
    log("== 12. tool kernels: the port's microbenches (T1-T3 row gathers "
        "at the flagship's L0/L2 slot maps, T4 flash attention at "
        "DeiT-B/384), then each kernel against its plain version")
    tools = tool_paths()
    gather_rows, gather_main = phase_gather_kernels()
    flash_rows, flash_main = phase_flash()
    phase_end("12")

    # ---- 14. native host code
    log("== 14. native host code: g++ build, native vs numpy quantize and "
        "slot triples bit for bit, host ms side by side")
    nengine = InferenceEngine(cfg, model=build_model(cfg, "cuda"))
    native_host = phase_native(nengine, recs, ds, tcfg)
    del nengine
    torch.cuda.empty_cache()
    phase_end("14")

    # ---- 15. the engine's CUDA graphs, both configurations
    log("== 15. CUDA graphs: one per input signature, both configurations")
    graphs = {"group-pooled": phase_graphs("group-pooled", cfg, cfg32,
                                           serve_state, recs),
              "per-voxel": phase_graphs("per-voxel", pcfg, per_voxel(cfg32),
                                        serve_state, recs)}
    phase_end("15")

    # ---- 16. the request server over HTTP
    log(f"== 16. server: tools/serve.py --selftest {SERVER_REQUESTS} "
        f"--clients {SERVER_CLIENTS} at full width over HTTP")
    server = phase_server()
    phase_end("16")

    # ---- 13. kernels line (printed after phases 14-16)
    def entry(name, source, replaces, m, library_ms, launches_of):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_of.get(name, 0),
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": max(m["bound_t"], key=m["bound_t"].get),
                "library_ms": library_ms}

    def fwd_entry(name, m, train_m, path):
        """K1 / K1' per request, with the device time (``graph_ms``), the
        CUDA-core kernel on the same operands, the tensor-core forward's
        launches on the path (the wrappers', while the graphs are
        captured; ``replay_launches``: the kernel's in the 8 requests'
        replays, from the profiler), and the same per train step (batch
        10)."""
        keys = ("graph_ms", "cuda_core_ms", "cuda_core_graph_ms",
                "best_tiles_graph_ms")
        launches_of = path["launches"]
        return {**entry(name, K1_SOURCE, K1_REPLACES, m, None, launches_of),
                **{k: m[k] for k in keys},
                "captures": path["captures"],
                "replay_launches": path["replay_launches"][
                    "binned_conv_fwd_mma_kernel"],
                "mma_launches": launches_of.get(FWD_MMA_NAME, 0),
                "cuda_core_launches": launches_of.get(FWD_CORE_NAME, 0),
                "train_step": {k: train_m[k] for k in (
                    "ms", "plain_ms", "bound_ms", *keys, "live_flops",
                    "tile_flops")}}

    def bwd_entry(name, m, launches_of):
        """K2 / K2' with their launch split into row table, dX (the
        tensor-core forward), dW (the tensor-core kernel, launched
        ``dw_launches`` times on the path) and reduce, and the CUDA-core
        route on the same operands."""
        return {**entry(name, K1_SOURCE, K2_REPLACES, m, None, launches_of),
                **{k: m[k] for k in ("rows_ms", "dx_ms", "dw_ms",
                                     "reduce_ms", "dx_bound_ms",
                                     "dw_bound_ms", "cuda_core_ms",
                                     "cuda_core_dx_ms", "cuda_core_dw_ms")},
                "dw_launches": launches_of.get(DW_MMA_NAME, 0),
                "fwd_mma_launches": launches_of.get(FWD_MMA_NAME, 0)}

    detail = {"card": card, "earlier": EARLIER,
              "binned_conv_grouped_fwd": k1_rows,
              "binned_conv_grouped_fwd_train": k1t_rows,
              "live_share_scaling": share_rows,
              "binned_conv_slots_fwd_train": k1pt_rows,
              "sorted_segment_weighted_sum": k3_rows,
              "binned_conv_grouped_bwd": k2_rows,
              "sorted_segment_weighted_sum_train": k3t_rows,
              "binned_conv_slots_fwd": k1p_rows,
              "binned_conv_slots_bwd": k2p_rows,
              "engine": {**serve, "f32_card_vs_cpu_max_abs": worst,
                         "bf16_vs_f32_on_card": bf16_drift},
              "train": {**train, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
                        "card_vs_cpu": parity,
                        "bf16_gemm_grad_share": gemm_grads},
              "per_voxel": {"slot_maps_cost": maps_cost, "engine": pserve,
                            "train": {**ptrain, "card_vs_cpu": pparity}},
              "tools": {"runs": tools, "row_gather": gather_rows,
                        "flash_attention": flash_rows},
              "native_host": native_host, "graphs": graphs,
              "train_graphs": train_graphs,
              "server": server, "real_format": real, "unimodal": unimodal,
              "phase_s": phase_s}
    log("== 13. kernels (ms, plain_ms, bound_ms, library_ms: K1, K1' and K3 "
        "per inference request at batch 1 (K1 and K1' also per train step "
        "under train_step), K2, K2' and K3[E=8] per train "
        f"step at batch {TRAIN_BATCH}; each summed over the path's calls, "
        "bf16; launches from the path each entry is timed on: K1' from "
        "phase 10, K2' from phase 11 (the wrappers' in the trainer's eager "
        "runs and captures); train_replay_kernels: by name in one "
        "train-graph replay, phase 17, and lidar_train_replay_kernels the "
        "lidar-only model's, phase 20a; T1-T3 one whole-level launch at L0 "
        "plus one at L2, T4 12 chained calls at B=8, launches from the "
        "microbenches in phase 12)")
    log("detail: " + json.dumps(detail))
    log(f"phase seconds: {phase_s}, total {time.time() - t_start:.1f} s")
    # Each kernel's launches in one train-graph replay, by name from the
    # profiler (phase 17): the forward kernel runs K1 / K1' and K2's dX.
    per_replay = {c: train_graphs[c]["replay"]["by_name"]
                  for c in ("group-pooled", "per-voxel")}

    lidar = unimodal["lidar"]

    def replay_of(config, *names):
        """The kernels of one train replay by name: the flagship's in
        ``config``, and for the group-pooled kernels the lidar-only
        model's (phase 20a) with that path's launches."""
        out = {"train_replay_kernels": {n: per_replay[config][n]
                                        for n in names}}
        if config == "group-pooled":
            out["lidar_train_replay_kernels"] = {
                n: lidar["replay"]["by_name"][n] for n in names}
            out["lidar_launches"] = {
                n: lidar["launches"].get(n, 0) for n in (
                    "binned_conv_grouped_fwd", "binned_conv_grouped_bwd",
                    k3_name, k3e8_name)}
        return out

    fwd_names = ("binned_conv_fwd_mma_kernel",)
    bwd_names = ("bin_rows_kernel", "binned_conv_dw_mma_kernel",
                 "reduce_chunks_kernel")
    print(json.dumps({"kernels": [
        {**fwd_entry("binned_conv_grouped_fwd", k1, k1t, serve),
         **replay_of("group-pooled", *fwd_names)},
        {**bwd_entry("binned_conv_grouped_bwd", k2, tlaunches),
         **replay_of("group-pooled", *bwd_names)},
        {**entry(k3_name, K3_SOURCE, K3_REPLACES, k3, k3["library_ms"],
                 serve["launches"]), "graph_ms": k3["graph_ms"],
         "replay_launches": serve["replay_launches"][
             "sorted_segment_weighted_sum_kernel"],
         "train_step": {k: k3t[k] for k in (
             "ms", "graph_ms", "plain_ms", "bound_ms", "library_ms")},
         **replay_of("group-pooled", "K3 (E=1)")},
        {**entry(k3e8_name, K3_SOURCE, K3_REPLACES, k3e8, k3e8["library_ms"],
                 tlaunches), "graph_ms": k3e8["graph_ms"],
         **replay_of("group-pooled", "K3' (E=8)")},
        {**fwd_entry("binned_conv_slots_fwd", k1p, k1pt, pserve),
         **replay_of("per-voxel", *fwd_names)},
        {**bwd_entry("binned_conv_slots_bwd", k2p, ptlaunches),
         **replay_of("per-voxel", *bwd_names)},
        *({**entry(name, GATHER_SOURCE, TOOL_KERNELS[name], m,
                   m["library_ms"], tools["launches"]),
           **{k: m[k] for k in ("eager_ms", "gathered_GB_per_s", "levels")
              if k in m}}
          for name, m in gather_main.items()),
        {**entry("flash_attention", FLASH_SOURCE,
                 TOOL_KERNELS["flash_attention"], flash_main,
                 flash_main["library_ms"], tools["launches"]),
         "batches": flash_main["batches"]}]}),
        flush=True)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
