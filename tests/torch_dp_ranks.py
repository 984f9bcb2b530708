"""The ranks of the port's parallel CPU tests (data, ZeRO, tensor and
pipeline parallelism): each job runs in one of ``world`` spawned processes
joined in a gloo group over a ``FileStore`` (no TCP port to clash between
test workers), and writes what it returns to ``rank<r>.pt``, removed once
read (or its traceback to ``error<r>.txt``).  Imports the port and torch
only: no JAX in a rank."""

import copy
import multiprocessing as mp
import os
import os.path as osp
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist


def spawn(tmp_path, job, *args, world=2, timeout=120, check=True):
    """``job`` in ``world`` spawned gloo ranks; each rank's result.  The
    ranks are joined within ``timeout`` seconds in all: one still running
    then is killed, and the caller's test fails.  ``check=False``: each
    rank's ``(exit code, traceback or None)`` instead."""
    ctx = mp.get_context("spawn")
    out = tmp_path / f"ranks_{job}"
    out.mkdir()
    store = str(tmp_path / f"store_{job}")
    procs = [ctx.Process(target=run, args=(job, r, world, store, str(out),
                                           args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join()
    errors = [(out / f"error{r}.txt").read_text() for r in range(world)
              if (out / f"error{r}.txt").exists()]
    assert not hung, f"ranks {hung} still running after {timeout} s: " \
        f"{errors}"
    if not check:
        return [(p.exitcode, (out / f"error{r}.txt").read_text()
                 if (out / f"error{r}.txt").exists() else None)
                for r, p in enumerate(procs)]
    assert all(p.exitcode == 0 for p in procs), errors
    results = []
    for r in range(world):
        path = out / f"rank{r}.pt"
        results.append(torch.load(path, weights_only=False))
        path.unlink()       # the steps' states take hundreds of MB
    return results


def run(job, rank, world, store_path, out_dir, args):
    """Entry point of one spawned rank."""
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=90))
        result = JOBS[job](rank, world, *args)
        torch.save(result, osp.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(osp.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def fake_predictions(batch):
    """Per-voxel predictions made from a batch alone (coordinates and
    labels), so that both packages' validation loops get the same ones."""
    c = np.asarray(batch["coords"]).astype(np.int64)
    base = (c[:, 0] * 7 + c[:, 1] * 3 + c[:, 2]) % 20
    return {"pred_2d": base, "pred_3d": (base + 3) % 20,
            "pred_ensemble": np.where(base % 3 == 0,
                                      np.asarray(batch["seg_label"]), base),
            "seg_loss_2d": np.float32(base.mean()),
            "seg_loss_3d": np.float32(1.5)}


def _matrices(eval_list):
    return {m: ev.confusion_matrix.copy() for m, ev in eval_list}


def load_jax_state(step, params, stats, mu, nu):
    """JAX's train state (parameters, BatchNorm statistics, Adam's moments)
    into a ``TrainStep``'s model and optimizer, by the port->JAX name map
    (Adam's step count stays the port's)."""
    from fusiontransformer_tpu_torch.utils.convert_jax import (
        load_jax_variables)
    load_jax_variables(step.model, params, stats)
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        named = dict(load_jax_variables(copy.deepcopy(step.model), tree,
                                        stats).named_parameters())
        with torch.no_grad():
            for n, p in step.model.named_parameters():
                step.optimizer.state[p][key].copy_(named[n])


def job_steps(rank, world, cfg, params, stats, batches, after_first):
    """Two data-parallel train steps on this rank's share of each global
    batch, the first from JAX's initial weights, the second from JAX's
    state after its first step (``after_first``), through the trainer; the
    same steps in this one process (each shard's eager step from the same
    state, the gradients and BatchNorm buffers averaged, one update: what
    ``pmean`` means) and through a bare ``TrainStep`` with the reduce hook;
    then the validation matrices: fake predictions and the model's, summed
    over the ranks and the rank's own."""
    from fusiontransformer_tpu_torch.data.utils.validate import validate
    from fusiontransformer_tpu_torch.models import spvcnn
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.modules.DistributedTrainer import (
        DistributedTrainer)
    from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                           make_train_step,
                                                           read_back)
    from fusiontransformer_tpu_torch.parallel.data_parallel import shard_of
    from fusiontransformer_tpu_torch.solver.build import build_optimizer
    from fusiontransformer_tpu_torch.utils.convert_jax import (
        load_jax_variables)
    from fusiontransformer_tpu_torch.utils.metric_logger import MetricLogger

    spvcnn.DROPOUT = 0.0            # the JAX side runs without dropout too

    def step_of(model):
        opt, _ = build_optimizer(cfg, model.parameters())
        return make_train_step(cfg, model, opt)

    def state_of(step):
        names = {id(p): n for n, p in step.model.named_parameters()}
        return {"params": {n: p.detach().clone()
                           for n, p in step.model.named_parameters()},
                "buffers": {n: b.clone()
                            for n, b in step.model.named_buffers()},
                "moments": {names[id(p)]: s["exp_avg"].clone()
                            for p, s in step.optimizer.state.items()}}

    tr = DistributedTrainer(cfg, "", device="cpu")
    load_jax_variables(tr.model, params, stats)
    tr.broadcast_state()
    hooked = step_of(load_jax_variables(build_model(cfg, "cpu"), params,
                                        stats))
    hooked.reduce = tr.reducer
    ref = step_of(load_jax_variables(build_model(cfg, "cpu"), params, stats))
    out = {"metrics": [], "hooked_metrics": [], "pt_batch": [],
           "trainer": [], "ref": [], "hooked": [], "shard_grad_max": []}
    for i, gb in enumerate(batches):
        if i == 1:
            for step in (tr.train_step, ref):
                load_jax_state(step, *after_first)
        local = shard_of(gb, rank, world)
        out["pt_batch"].append(local["pt_batch"])
        out["metrics"].append(tr.run_train_step(local).numpy())
        out["trainer"].append(state_of(tr.train_step))
        if i == 0:      # the hook's first step (each costs seconds here)
            out["hooked_metrics"].append(read_back(hooked(
                device_batch(local, "cpu"), torch.Generator(),
                update=True)).numpy())
            out["hooked"].append(state_of(hooked))
        # One process: every shard's step from the same state, averaged.
        start = [b.clone() for b in ref.buffers]
        grads, bufs = [], []
        for r in range(world):
            with torch.no_grad():
                for b, s in zip(ref.buffers, start):
                    b.copy_(s)
            ref(device_batch(shard_of(gb, r, world), "cpu"),
                torch.Generator(), update=False)
            grads.append([g.clone() for g in ref.grads])
            bufs.append([b.clone() for b in ref.buffers])
            torch._foreach_zero_(ref.grads)
        with torch.no_grad():
            for i, g in enumerate(ref.grads):
                g.copy_(sum(x[i] for x in grads) / world)
            for i, b in enumerate(ref.buffers):
                b.copy_(sum(x[i] for x in bufs) / world)
        names = [n for n, _ in ref.model.named_parameters()]
        out["shard_grad_max"].append(
            {n: [float(x[i].abs().max()) for x in grads]
             for i, n in enumerate(names)})
        ref.update()
        out["ref"].append(state_of(ref))

    fake = validate(cfg, lambda b: read_back(
        {k: torch.as_tensor(v) for k, v in fake_predictions(b).items()}),
        tr.val_dataloader, MetricLogger(), cm_allreduce=tr.cm_allreduce())
    own = {}

    def keep_own(cm):
        own[len(own)] = cm.copy()
        return tr.cm_allreduce()(cm)

    summed = validate(cfg, tr.run_eval_batch, tr.val_dataloader,
                      MetricLogger(), cm_allreduce=keep_own)
    out.update(fake=_matrices(fake), summed=_matrices(summed),
               own={m: own[i] for i, (m, _) in enumerate(summed)})
    return out


def _state(tr):
    """What a train step reads and writes, cloned: parameters and buffers,
    the static gradients, the optimizer's state, the generator."""
    params = [p for g in tr.optimizer.param_groups for p in g["params"]]
    return {"model": {k: v.clone() for k, v in tr.model.state_dict().items()},
            "grads": [g.clone() for g in tr.train_step.grads],
            "opt": [{k: v.clone() for k, v in tr.optimizer.state[p].items()}
                    for p in params],
            "generator": tr.generator.get_state(), "step": tr.step,
            "window": tr.window}


def _diffs(a, b):
    out = [k for k in a["model"] if not torch.equal(a["model"][k],
                                                    b["model"][k])]
    out += [f"grad {i}" for i, (x, y) in enumerate(zip(a["grads"],
                                                       b["grads"]))
            if not torch.equal(x, y)]
    out += [f"opt {i}.{k}" for i, (x, y) in enumerate(zip(a["opt"], b["opt"]))
            for k in x if not torch.equal(x[k], y[k])]
    out += [k for k in ("generator",) if not torch.equal(a[k], b[k])]
    out += [k for k in ("step", "window") if a[k] != b[k]]
    return out


def job_resume(rank, world, whole_cfg, half_cfg, resume_cfg, bad_cfg,
               dirs):
    """A run of two epochs; one of one epoch (``TorchpackInterface.main``)
    and a run resumed from its checkpoint for the second; ``test()`` of the
    first; a trainer whose ``TPU.NUM_DEVICES`` is not the world size."""
    from fusiontransformer_tpu_torch.modules import TorchpackInterface
    from fusiontransformer_tpu_torch.modules.DistributedTrainer import (
        DistributedTrainer)

    a, b = dirs
    whole = DistributedTrainer(whole_cfg, a, "r", device="cpu")
    whole.train()
    whole_state = _state(whole)
    half = TorchpackInterface.main(half_cfg, b, "r", device="cpu")
    half_step = half.step
    resumed = DistributedTrainer(resume_cfg, b, "r", device="cpu")
    start = {"epoch": resumed.start_epoch, "step": resumed.step,
             "window": resumed.window,
             "open_window": any(bool(g.any())
                                for g in resumed.train_step.grads)}
    resumed.train()
    diffs = _diffs(whole_state, _state(resumed))

    restored = osp.basename(whole.best_checkpoint())
    meters = whole.test()
    dist.barrier()
    pred_dir = osp.join(a, "predictions")
    files = sorted(os.listdir(pred_dir))
    keys = sorted(np.load(osp.join(pred_dir, files[0])).files)
    try:
        DistributedTrainer(bad_cfg, "", device="cpu")
        bad = None
    except ValueError as e:
        bad = str(e)
    return {"diffs": diffs, "start": start, "half_step": half_step,
            "whole_step": whole.step,
            "params": {k: v for k, v in whole_state["model"].items()},
            "generator": whole_state["generator"],
            "restored": restored, "files": files, "keys": keys,
            "test_iou": {k: m.global_avg for k, m in meters.meters.items()
                         if k.startswith("seg_iou")},
            "saved": sorted(os.listdir(a)), "bad": bad}


def job_abandoned(rank, world):
    """Rank 1 leaves at once; rank 0's next collective raises."""
    from fusiontransformer_tpu_torch.parallel.data_parallel import Reducer
    if rank == 1:
        os._exit(3)
    Reducer(torch.device("cpu")).mean_([torch.ones(4)])


# --------------------------------------------------------------------------- #
# ZeRO-1, tensor parallelism, the GPipe ViT (test_torch_port_zero.py,
# _tensor_parallel.py, _pipeline_parallel.py).

def _named(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _moments(opt_state, names):
    """``{(parameter name, key): tensor}`` of a canonical optimizer state."""
    return {(names[i], k): v.clone() for i, s in opt_state["state"].items()
            for k, v in s.items() if torch.is_tensor(v)}


def _canonical(tr):
    """A trainer's canonical parameters, buffers and optimizer state
    (collective under ZeRO and tensor parallelism)."""
    model, opt = tr.canonical_state()
    names = [n for n, _ in tr.model.named_parameters()]
    buffers = {n for n, _ in tr.model.named_buffers()}
    return {"params": {k: v.clone() for k, v in model.items()
                       if k not in buffers},
            "buffers": {k: v.clone() for k, v in model.items()
                        if k in buffers},
            "moments": _moments(opt, names)}


def _record_updates(tr):
    """Record each optimizer update of ``tr``: the parameters before it,
    the (averaged) gradients it reads, the parameters and the canonical
    moments after it."""
    updates = []
    real = tr.train_step.update

    def update():
        names = [n for n, _ in tr.model.named_parameters()]
        rec = {"before": _named(tr.model),
               "grads": {n: p.grad.clone()
                         for n, p in tr.model.named_parameters()}}
        real()
        rec["after"] = _named(tr.model)
        rec["moments"] = _moments(tr.canonical_state()[1], names)
        updates.append(rec)

    tr.train_step.update = update
    return updates


def job_zero(rank, world, cfgs, dirs):
    """ZeRO against the replicated optimizer: one epoch (2 steps) of each,
    their updates recorded; the optimizer state's bytes; then the
    checkpoints across the two: a ZeRO epoch resumed without ZeRO, a
    replicated epoch resumed with it, each against an uninterrupted
    2-epoch replicated run."""
    from fusiontransformer_tpu_torch.modules.DistributedTrainer import (
        DistributedTrainer)
    out = {}
    for name in ("dp", "zero"):
        tr = DistributedTrainer(cfgs[name], dirs[name], "r", device="cpu")
        updates = _record_updates(tr)
        chunks = [tuple(c.param.shape) for c in tr.optimizer.chunks] \
            if name == "zero" else None
        tr.train()
        out[name] = {"final": _canonical(tr), "updates": updates,
                     "state_bytes": tr.optimizer_state_bytes(),
                     "chunks": chunks, "step": tr.step}
    dist.barrier()                  # rank 0's checkpoint is on disk
    saved = torch.load(os.path.join(dirs["zero"], "max-MeanIoU-000000.pth"),
                       weights_only=True)
    out["saved_shapes"] = {
        i: {k: tuple(v.shape) for k, v in s.items() if torch.is_tensor(v)}
        for i, s in saved["optimizer"]["state"].items()}
    for name in ("whole", "zero_then_dp", "dp_then_zero"):
        tr = DistributedTrainer(cfgs[name], dirs[name], "r", device="cpu")
        start = {"epoch": tr.start_epoch, "step": tr.step}
        tr.train()
        out[name] = {"final": _canonical(tr), "start": start}
    return out


def job_tp_vit(rank, world, params, images, tps):
    """The tensor-parallel ViT at each degree of ``tps`` (model groups of
    consecutive ranks): each rank loads its shard of JAX's canonical
    parameters, runs the forward and the gradients of the sum of squares
    of its outputs."""
    from fusiontransformer_tpu_torch.models.vit import VisionTransformer2D
    from fusiontransformer_tpu_torch.parallel.tensor_parallel import Mesh2D
    from fusiontransformer_tpu_torch.utils.convert_jax import (
        load_jax_variables)
    out = {}
    for tp in tps:
        mesh = Mesh2D(tp)
        vit = VisionTransformer2D(img_size=32, patch_size=16, embed_dim=64,
                                  depth=2, num_heads=4,
                                  compute_dtype=torch.float32, tp=tp,
                                  tp_group=mesh.model_group)
        load_jax_variables(vit, params, tp=tp, tp_rank=mesh.model_index,
                           num_heads=4)
        taps = vit(torch.as_tensor(images))
        loss = sum((v ** 2).sum() for v in taps.values())
        names = [n for n, _ in vit.named_parameters()]
        grads = torch.autograd.grad(loss, list(vit.parameters()))
        out[tp] = {"m": mesh.model_index,
                   "taps": {k: v.detach() for k, v in taps.items()},
                   "grads": dict(zip(names, grads))}
    return out


def _tp_trainer(cfg, params, stats, out_dir=""):
    """A tensor-parallel trainer from JAX's canonical weights."""
    from fusiontransformer_tpu_torch.modules.DistributedTrainer import (
        DistributedTrainer)
    from fusiontransformer_tpu_torch.utils.convert_jax import (
        load_jax_variables)
    tr = DistributedTrainer(cfg, out_dir, "r", device="cpu")
    load_jax_variables(tr.model, params, stats, tp=tr.model_parallel,
                       tp_rank=tr.mesh.model_index,
                       num_heads=cfg.MODEL.VIT_HEADS)
    load_jax_variables(tr.eval_model, params, stats)
    return tr


def job_tp_trainer(rank, world, cfgs, params, stats, batch, dirs):
    """(data 2, model 2): one train step from JAX's initial weights (its
    metrics, the canonical state after it, each shard's largest |g| per
    leaf before the data mean, digests of every parameter across the
    ranks); the same step with REMAT_VIT; then a trainer cycle with
    adaptive caps (train, validate, checkpoint), resumed at tp = 1 for a
    second epoch and ``test()``."""
    import hashlib
    from fusiontransformer_tpu_torch.models import spvcnn
    from fusiontransformer_tpu_torch.modules.DistributedTrainer import (
        DistributedTrainer)
    from fusiontransformer_tpu_torch.parallel.data_parallel import shard_of
    spvcnn.DROPOUT = 0.0            # the JAX side runs without dropout too
    out = {}
    for name in ("step", "remat"):
        tr = _tp_trainer(cfgs[name], params, stats)
        local = shard_of(batch, tr.data_rank, tr.data_size)
        shard_max = {}
        mean = tr.data_reducer.mean_

        def keep_max(tensors, _mean=mean, _tr=tr):
            tensors = list(tensors)
            if tensors and tensors[0] is _tr.train_step.grads[0]:
                for (n, _), g in zip(_tr.model.named_parameters(), tensors):
                    shard_max[n] = float(g.abs().max())
            _mean(tensors)

        tr.data_reducer.mean_ = keep_max
        launched = []
        launch = tr._launch

        def record_launch(kind, *a, _launch=launch, **k):
            launched.append(kind)
            return _launch(kind, *a, **k)

        tr._launch = record_launch
        metrics = tr.run_train_step(local).numpy()
        digests = {n: hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
                   for n, p in tr.model.named_parameters()}
        out[name] = {"metrics": metrics, "state": _canonical(tr),
                     "shard_max": shard_max, "m": tr.mesh.model_index,
                     "d": tr.data_rank, "pt_batch": local["pt_batch"],
                     "launched": launched,
                     "generator": tr.generator.get_state(),
                     "digests": tr.reducer.gather_objects(digests)}
    caps = []
    tr = DistributedTrainer(cfgs["cycle"], dirs["cycle"], "r", device="cpu")
    agree = tr.agree

    def recording(host_batch):
        hb, c = agree(host_batch)
        caps.append((len(hb["pt_valid"]), c))
        return hb, c

    tr.agree = recording
    tr.train()
    merged = _canonical(tr)
    tr.reducer.barrier()
    path = os.path.join(dirs["cycle"], "max-MeanIoU-000000.pth")
    saved = torch.load(path, weights_only=True)
    names = [n for n, _ in tr.model.named_parameters()]
    out["cycle"] = {
        "caps": caps, "merged": merged,
        "saved_model": saved["model"],
        "saved_moments": _moments(saved["optimizer"], names),
        "val": sorted(tr.val_metric_logger.meters),
        "overflow": tr.train_metric_logger.meters[
            "voxel_overflow"].global_avg,
        "local_qkv": tuple(tr.model.image_backbone.backbone.block0.attn
                           .qkv.kernel.shape)}
    one = DistributedTrainer(cfgs["resume"], dirs["cycle"], "r",
                             device="cpu")
    out["resume"] = {"start_epoch": one.start_epoch,
                     "loaded": _canonical(one)}
    one.train()
    meters = one.test(save_predictions=False)
    out["resume"]["test_iou"] = {k: m.global_avg
                                 for k, m in meters.meters.items()
                                 if k.startswith("seg_iou")}
    return out


def job_pp(rank, world, params, images, micros, taps):
    """The GPipe ViT over ``world`` stages at each microbatch count of
    ``micros``, from JAX's canonical parameters: its taps and the
    gradients of the sum of squares of them, this rank's stage and the
    embedding; the hand-off point to point and through ``all_gather``."""
    from fusiontransformer_tpu_torch.models.vit import VisionTransformer2D
    from fusiontransformer_tpu_torch.parallel import pipeline_parallel as pp
    from fusiontransformer_tpu_torch.utils.convert_jax import (
        load_jax_variables)
    vit = VisionTransformer2D(img_size=32, patch_size=16, embed_dim=64,
                              depth=4, num_heads=4,
                              compute_dtype=torch.float32)
    load_jax_variables(vit, params)
    staged, rest = pp.stack_vit_blocks(
        {n: p.detach() for n, p in vit.named_parameters()}, world)
    images = torch.as_tensor(images)
    out = {}
    for micro in micros:
        for mode in ("p2p", "gather"):
            local = {k: v[rank].clone().requires_grad_()
                     for k, v in staged.items()}
            rst = {k: v.clone().requires_grad_() for k, v in rest.items()}
            res = pp.pp_vit_apply(vit, local, rst, images, None, micro, taps,
                                  mode=mode)
            loss = sum((res[str(k)] ** 2).sum() for k in taps)
            loss.backward()
            out[(micro, mode)] = {
                "taps": {k: v.detach() for k, v in res.items()},
                "stage_grads": {k: v.grad for k, v in local.items()},
                "rest_grads": {k: v.grad for k, v in rst.items()}}
    return out


JOBS = {"steps": job_steps, "resume": job_resume,
        "abandoned": job_abandoned, "zero": job_zero,
        "tp_vit": job_tp_vit, "tp_trainer": job_tp_trainer, "pp": job_pp}
