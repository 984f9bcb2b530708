"""The ranks of the port's data-parallel CPU tests: each job runs in one of
``world`` spawned processes joined in a gloo group over a ``FileStore``
(no TCP port to clash between test workers), and writes what it returns
to ``rank<r>.pt``, removed once read (or its traceback to
``error<r>.txt``).  Imports the port and torch only: no JAX in a rank."""

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


JOBS = {"steps": job_steps, "resume": job_resume,
        "abandoned": job_abandoned}
