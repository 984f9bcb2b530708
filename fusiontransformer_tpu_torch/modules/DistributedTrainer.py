"""Data-parallel trainer: one process per device over ``torch.distributed``.

Port of ``fusiontransformer_tpu/modules/DistributedTrainer.py`` for its
multi-process case (the reference's torchpack/DDP stack), launched one
process per card by ``python -m torch.distributed.run`` (torchrun):

* the process group from torchrun's environment
  (``parallel.data_parallel.init_distributed``: NCCL on the card, gloo on
  the CPU), the device ``cuda:LOCAL_RANK``;
* ``TRAIN.BATCH_SIZE`` is the global batch: each process loads
  ``BATCH_SIZE / data_size`` scans a step from its ``ShardedView`` of the
  split with loader seed ``data_rank`` (without tensor parallelism the
  rank and the world size), and validates and tests its own shard of
  those splits; batches carry no group-pooled maps (per-voxel K-slot maps,
  K1' / K2');
* every process starts from rank 0's parameters and buffers
  (``broadcast_``), at start and after a checkpoint load; the ranks meet at
  a barrier before they look for a checkpoint, so that none reads before
  rank 0's write has landed;
* per batch, one all-gather of small ints agrees on the capacity bucket
  (each rank's batch is re-padded to the largest) and, with
  ``TPU.ADAPTIVE_LEVEL_CAPS``, on the level capacities (the largest
  per-rank voxel counts), so that every rank runs the same step shapes;
  it also carries the ranks' SIGTERM flags, so that all stop after the same
  step;
* the train step runs as on one device (on the card its CUDA graph, with
  ``update=False``, as under ``TRAIN.GRAD_ACCUM_STEPS``); then, eagerly:
  its metrics reduced (losses averaged, confusion matrices summed) and the
  BatchNorm buffers averaged after each step, the gradients averaged
  before each optimizer update (with accumulation, the local sum of the
  window's micro-steps, which by linearity equals JAX's ``pmean`` at every
  micro-step) — ``parallel.data_parallel.Reducer``.  Each rank normalises
  with its own shard's batch statistics, as each JAX device does;
* each train replay's parts timed (``step_times``: the local step, the
  reductions, the update; CUDA events), their medians logged by rank 0
  after each epoch;
* the validation's confusion matrices summed over the processes
  (``cm_allreduce``), so every rank holds the global tables; only rank 0
  logs them;
* rank 0 alone writes ``max-MeanIoU-{epoch:06d}.pth`` (the best-IoU
  checkpoint, MaxSaver's naming), the preemption checkpoint,
  ``metrics.jsonl`` and the summaries; a checkpoint holds every rank's
  dropout generator (``rank_generators``), gathered to rank 0, so that a
  resumed run draws what the uninterrupted one draws.  A save inside an
  accumulation window first averages the window's gradients (linear, so
  the update at the window's end is unchanged), and rank 0's state is
  every rank's;
* ``test()``: the newest ``max-MeanIoU-*`` checkpoint (else the manifest's
  newest), per-scan ``predictions/<seq>_<filename>.npz`` dumps of each
  rank's shard with the JAX package's keys, and ``validate`` with the
  matrices summed.

With ``TPU.ZERO_OPTIMIZER`` (ZeRO-1, ``parallel/zero.py``) each rank keeps
``1/world_size`` of the optimizer's moments: the train step replays its
graph with ``update=False`` as above, then the reductions and the ZeRO
update (this rank's chunks, then an ``all_gather`` of the parameters) run
eagerly.

With ``TPU.MODEL_PARALLEL`` = mp > 1 (``parallel/tensor_parallel.py``) the
ranks form a (data, model) mesh, rank = d * mp + m, and each holds its
model group's m-th shard of the ViT blocks (heads and MLP width), the rest
replicated:

* the loader shards, loader seeds and dropout generators are keyed on the
  data index d, not the rank: the ranks of a model group step the same
  scans with the same masks, as JAX folds only ``axis_index("data")`` into
  its key, so that their replicated parameters stay equal;
* gradients, BatchNorm buffers, metrics and the validation's matrices are
  reduced over the data group only: the f / g pair already makes the
  replicated parameters' gradients full sums within a model group, and the
  sharded ones are local; the bucket and caps agreement stays world-wide,
  so that every rank runs the same shapes;
* the train step runs eagerly, on the card too: its all-reduces sit inside
  every ViT block's forward and backward, which gloo cannot capture;
* validation and ``test()`` run the canonical tp=1 model (``eval_model``,
  its eval steps through their CUDA graphs) on the merged parameters,
  merged once a validation and copied in place into its parameters.

Checkpoints, the preemption checkpoint, ``test()``'s load and the
summaries' histograms hold the canonical single-device layout, with
``torch.optim``'s own ``state_dict`` for the moments, so a checkpoint
loads across TP degrees and with or without ZeRO; a load splits it again.
The gathers that build it are collectives: every rank runs them
(``canonical_state``, ``canonical_model``) before the rank-0 guard, where
a gather on rank 0 alone would wait for ever.  ``GRAD_ACCUM_STEPS`` > 1
composes with neither key, and the two keys not with each other, as in
JAX; these and the mesh's divisibility are checked before the process
group is joined.

Deliberate differences from the JAX package (ROADMAP.md, Queue 3): one
process per device where JAX runs one process over a mesh; the collectives
outside the CUDA graphs; dropout generators seeded per data rank
(``rank_seed``) where JAX folds the device index into its key; the TP
train step eager; the collective merges before the rank-0 guard, where
JAX assembles its addressable shards on the host.
"""

from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np
import torch

from fusiontransformer_tpu_torch.data.build import build_dataloader
from fusiontransformer_tpu_torch.data.utils.validate import validate
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
    SemanticTrainer, check_ported_keys)
from fusiontransformer_tpu_torch.modules.steps import (adaptive_level_caps,
                                                       device_batch,
                                                       make_eval_step,
                                                       read_back)
from fusiontransformer_tpu_torch.parallel.data_parallel import (
    Reducer, init_distributed, repad)
from fusiontransformer_tpu_torch.parallel.tensor_parallel import (
    Mesh2D, merge_state, shard_state)
from fusiontransformer_tpu_torch.parallel.tensor_parallel import (
    merge_opt_state as tp_merge_opt_state,
    shard_opt_state as tp_shard_opt_state)
from fusiontransformer_tpu_torch.parallel.zero import Zero1
from fusiontransformer_tpu_torch.solver.build import (build_optimizer,
                                                      make_lr_schedule)
from fusiontransformer_tpu_torch.utils.checkpoint import Checkpointer
from fusiontransformer_tpu_torch.utils.device import resolve_device
from fusiontransformer_tpu_torch.utils.metric_logger import MetricLogger


class StepMarks:
    """Four marks around one data-parallel step (before it, after the local
    step, after the reductions, after the update): CUDA events on the card,
    read only when ``intervals`` is asked for; the host clock on the
    CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals(self):
        """The three intervals between the marks, in ms."""
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def check_parallel_keys(cfg, world_size: int):
    """The config checks of a run of ``world_size`` ranks (the JAX
    trainer's asserts), before any process group is joined: ``ValueError``
    where the keys do not compose or the mesh does not divide."""
    mp = int(cfg.TPU.MODEL_PARALLEL)
    zero = bool(cfg.TPU.ZERO_OPTIMIZER)
    accum = int(cfg.TRAIN.GRAD_ACCUM_STEPS)
    if mp < 1:
        raise ValueError(f"TPU.MODEL_PARALLEL = {mp} must be >= 1")
    if mp > 1 and zero:
        raise ValueError("TPU.ZERO_OPTIMIZER composes with data parallelism "
                         "only: unset it or TPU.MODEL_PARALLEL")
    if mp > 1 and accum > 1:
        raise ValueError("TPU.MODEL_PARALLEL > 1 does not compose with "
                         "TRAIN.GRAD_ACCUM_STEPS > 1 (as in the JAX package): "
                         "run tensor parallelism with accumulation disabled")
    if zero and accum > 1:
        raise ValueError("TPU.ZERO_OPTIMIZER does not compose with "
                         "TRAIN.GRAD_ACCUM_STEPS > 1: the accumulated "
                         "gradients are whole on every rank")
    if mp > 1:
        m = cfg.MODEL
        if not (m.USE_FUSION or m.TYPE == "ImageSegBilinear"):
            raise ValueError(f"TPU.MODEL_PARALLEL shards a ViT stream; "
                             f"{m.TYPE} has none that it splits")
        if m.VIT_HEADS % mp:
            raise ValueError(f"MODEL.VIT_HEADS = {m.VIT_HEADS} must divide "
                             f"over TPU.MODEL_PARALLEL = {mp}")
    if world_size % mp:
        raise ValueError(f"TPU.NUM_DEVICES = {world_size} (the world size) "
                         f"must be a multiple of TPU.MODEL_PARALLEL = {mp}")
    data, bs = world_size // mp, int(cfg.TRAIN.BATCH_SIZE)
    if bs % data:
        raise ValueError(f"TRAIN.BATCH_SIZE = {bs} (the global batch) must "
                         f"divide over the data axis of {data} rank(s)")


def expected_world_size(cfg) -> int:
    """The world size a trainer will join: the group's where one exists,
    else torchrun's ``WORLD_SIZE``, else ``TPU.NUM_DEVICES`` (or 1)."""
    if torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 0)) \
        or int(cfg.TPU.NUM_DEVICES) or 1


class DistributedTrainer(SemanticTrainer):
    """``SemanticTrainer`` on this process's rank of the default process
    group (made from torchrun's environment, or the caller's).  ``backend``
    names the group's backend (default: NCCL on the card, gloo on the
    CPU)."""

    distributed = True

    def __init__(self, cfg, output_dir="", run_name="", device=None,
                 backend=None):
        # Keys that do not compose, and a mesh that does not divide, raise
        # before the process group is joined.
        world = expected_world_size(cfg)
        check_ported_keys(cfg, world, distributed=True)
        check_parallel_keys(cfg, world)
        device = resolve_device(device)
        self.rank, self.world_size = init_distributed(device, backend)
        check_parallel_keys(cfg, self.world_size)
        self.model_parallel = int(cfg.TPU.MODEL_PARALLEL)
        self.zero = bool(cfg.TPU.ZERO_OPTIMIZER)
        self.heads = int(cfg.MODEL.VIT_HEADS)
        if self.model_parallel > 1:
            self.mesh = Mesh2D(self.model_parallel)
            self.data_rank, self.data_size = (self.mesh.data_index,
                                              self.mesh.data)
            data_group = self.mesh.data_group
        else:
            self.mesh = None
            self.data_rank, self.data_size = self.rank, self.world_size
            data_group = None
        # World-wide: the agreement, barriers, the generators' gather.
        self.reducer = Reducer(device)
        # Over the data group: gradients, buffers, metrics, matrices.
        self.data_reducer = Reducer(device, data_group) \
            if data_group is not None else self.reducer
        self.scans_per_rank = int(cfg.TRAIN.BATCH_SIZE) // self.data_size
        self._stop = False
        self.step_marks = []        # StepMarks of the train steps
        # A checkpoint that rank 0 was writing (an earlier trainer of this
        # process group) is on disk before any rank looks for one.
        self.reducer.barrier()
        super().__init__(cfg, output_dir, run_name, device)
        self.train_step.reduce = self.data_reducer
        if self.model_parallel > 1:
            self.eval_step = make_eval_step(cfg, self.eval_model)
        self.broadcast_state()

    # ------------------------------------------------------------------ #
    def build_train_model(self, cfg, device):
        """Under tensor parallelism this rank's shard of the canonical
        model, which stays beside it as ``eval_model``; else the model."""
        model = super().build_train_model(cfg, device)
        if self.model_parallel == 1:
            return model
        self.eval_model = model
        return build_model(cfg, device, vit_tp=self.model_parallel,
                           vit_tp_group=self.mesh.model_group,
                           canonical=model)

    def build_train_optimizer(self, cfg, steps_per_epoch):
        """Under ZeRO the optimizer on this rank's chunks (``Zero1``)."""
        if not self.zero:
            return super().build_train_optimizer(cfg, steps_per_epoch)
        opt = Zero1(lambda chunks: build_optimizer(cfg, chunks,
                                                   steps_per_epoch)[0],
                    self.model.parameters(), self.data_reducer.group)
        return opt, make_lr_schedule(cfg, steps_per_epoch)

    def build_loader(self, mode):
        """This data rank's shard of ``mode``'s split: a ``1/data_size``
        share of the global train batch with loader seed ``data_rank``;
        val and test at their batch sizes."""
        if mode == "train":
            return build_dataloader(
                self.cfg, "train", seed=self.data_rank,
                batch_size=self.scans_per_rank, use_distributed=True,
                rank=self.data_rank, world_size=self.data_size)
        return build_dataloader(self.cfg, mode, use_distributed=True,
                                rank=self.data_rank,
                                world_size=self.data_size)

    def broadcast_state(self):
        """The data group's rank 0's parameters and buffers on every rank
        of the group (each model shard from its own)."""
        self.data_reducer.broadcast_(list(self.model.parameters())
                                     + list(self.model.buffers()))

    # ------------------------------------------------------------------ #
    def _param_names(self):
        return [n for n, _ in self.model.named_parameters()]

    def canonical_state(self):
        """The canonical single-device ``(model, optimizer)`` state dicts:
        under tensor parallelism the shards gathered over the model group,
        under ZeRO the moments over the data group (collectives: every
        rank calls this)."""
        model, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.model_parallel > 1:
            group = self.mesh.model_group
            model = merge_state(model, group, self.heads)
            opt = tp_merge_opt_state(opt, self._param_names(), group,
                                     self.heads)
        return model, opt

    def canonical_model(self):
        """Under tensor parallelism ``eval_model`` with the merged weights
        (``prepare_eval``); else the model."""
        if self.model_parallel == 1:
            return self.model
        self.prepare_eval()
        return self.eval_model

    def prepare_eval(self):
        """Under tensor parallelism: the shards merged over the model group
        (a collective) and copied in place into ``eval_model``, whose eval
        graphs read them."""
        if self.model_parallel == 1:
            return
        merged = merge_state(self.model.state_dict(), self.mesh.model_group,
                             self.heads)
        with torch.no_grad():
            for k, v in self.eval_model.state_dict().items():
                v.copy_(merged[k])

    def load_model_state(self, state):
        """A canonical model state: under tensor parallelism into
        ``eval_model`` and this rank's shard into the model."""
        if self.model_parallel == 1:
            return super().load_model_state(state)
        self.eval_model.load_state_dict(state)
        self.model.load_state_dict(shard_state(
            state, self.model_parallel, self.mesh.model_index, self.heads))

    def load_optimizer(self, state):
        """A canonical optimizer state, this rank's part of it kept (ZeRO
        splits it in ``Zero1.load_state_dict``)."""
        if self.model_parallel > 1:
            state = tp_shard_opt_state(state, self._param_names(),
                                       self.model_parallel,
                                       self.mesh.model_index, self.heads)
        super().load_optimizer(state)

    def optimizer_state_bytes(self):
        """Bytes of this rank's optimizer state tensors."""
        return sum(v.numel() * v.element_size()
                   for s in self.optimizer.state.values()
                   for v in s.values() if torch.is_tensor(v))

    def agree(self, host_batch):
        """``(host_batch, level_caps)`` that every rank steps with: the batch
        re-padded to the ranks' largest capacity bucket, and with
        ``TPU.ADAPTIVE_LEVEL_CAPS`` the capacities of the ranks' largest
        voxel counts (else None: sized from the buffer).  The same
        all-gather agrees on stopping after this step (SIGTERM on any
        rank)."""
        b = len(host_batch["scan_count"])
        cap = len(host_batch["pt_valid"]) // b
        counts = host_batch.get("level_counts") if self.adaptive_caps \
            else None
        row = [cap, int(self.preempted)] + (
            [] if counts is None else [int(c) for c in counts])
        rows = self.reducer.all_gather_ints(row)
        target = int(rows[:, 0].max())
        self._stop = bool(rows[:, 1].any())
        host_batch = repad(host_batch, cap, target)
        caps = None if counts is None else adaptive_level_caps(
            self.cfg, b * target, tuple(int(c) for c in rows[:, 2:].max(0)))
        return host_batch, caps

    def _should_stop(self):
        return self._stop

    def run_train_step(self, host_batch):
        """One data-parallel train step on this rank's share of the global
        batch: the local step (its graph on the card; eager under tensor
        parallelism), then its metrics reduced and the BatchNorm buffers
        averaged; at a window's last micro-step the gradients averaged and
        the optimizer update."""
        host_batch, caps = self.agree(host_batch)
        captures = self.captures["train"]
        marks = StepMarks(self.device)
        if self.model_parallel > 1:
            graph = None
            out = self.train_step(device_batch(host_batch, self.device),
                                  self.generator, caps, update=False)
        else:
            out, graph = self._launch(
                "train", self.train_graphs,
                lambda batch: self.train_step(batch, self.generator, caps,
                                              update=False),
                host_batch, caps, self.generator)
        marks.mark()
        self.step += 1
        self.window += 1
        update = self.window == self.accum_steps
        metrics = self.train_step.sync(out, grads=update)
        marks.mark()
        if update:
            self._update()
            self.window = 0
        marks.mark()
        if self.captures["train"] == captures:      # a replay, or eager TP
            self.step_marks.append(marks)
        return read_back(metrics, graph)

    def _update(self):
        """The optimizer update: under ZeRO (its gather) and tensor
        parallelism eagerly, else as on one device (its graph on the
        card)."""
        if self.zero or self.model_parallel > 1:
            self.train_step.update()
        else:
            super()._update()

    def step_times(self):
        """Medians over the train replays (eager steps under tensor
        parallelism) since the last call, in ms:
        ``local`` (the rank's own step: the batch's copy into the graph's
        inputs and the replay), ``reduce`` (metrics,
        buffers and, at an update, gradients), ``update`` and ``step``
        (their sum, from before the replay to after the update); CUDA
        events on the card, the host clock on the CPU.  ``{}`` without a
        replay."""
        marks, self.step_marks = self.step_marks, []
        if not marks:
            return {}
        parts = np.array([m.intervals() for m in marks])
        out = {k: float(np.median(parts[:, i]))
               for i, k in enumerate(("local", "reduce", "update"))}
        out["step"] = float(np.median(parts.sum(1)))
        out["replays"] = len(marks)
        return out

    def train_for_one_epoch(self, epoch):
        super().train_for_one_epoch(epoch)
        times = self.step_times()
        if times and self.rank == 0:
            self.logger.info(
                "data-parallel train steps, %d replays, world %d (%s): "
                "local step %.3f ms, reductions %.3f ms, update %.3f ms, "
                "step %.3f ms (medians; the local step from the batch's "
                "copy in to the replay's end)", times["replays"], self.world_size,
                self.reducer.backend, times["local"], times["reduce"],
                times["update"], times["step"])

    def cm_allreduce(self):
        return self.data_reducer.sum_array

    # ------------------------------------------------------------------ #
    def update_checkpoint(self, epoch):
        """The best-IoU checkpoint ``max-MeanIoU-{epoch:06d}`` (MaxSaver's
        naming), written by rank 0."""
        self._save(f"max-MeanIoU-{epoch:06d}", epoch + 1)

    def _save(self, name, next_epoch):
        if self.window:
            # Inside a window: its gradients averaged now, so that rank 0's
            # state is every rank's (the update at the window's end takes
            # the same mean).
            self.data_reducer.mean_(self.train_step.grads)
        super()._save(name, next_epoch)

    def _rank_states(self):
        return {"rank_generators": self.reducer.gather_objects(
            self.generator.get_state())}

    # ------------------------------------------------------------------ #
    def best_checkpoint(self):
        """The newest ``max-MeanIoU-*`` checkpoint of the output directory,
        or None."""
        if not self.output_dir or not osp.isdir(self.output_dir):
            return None
        names = sorted(p for p in os.listdir(self.output_dir)
                       if p.startswith("max-MeanIoU-") and p.endswith(".pth"))
        return osp.join(self.output_dir, names[-1]) if names else None

    def test(self, save_predictions=True):
        """Score the test split (the JAX ``DistributedTrainer.test``):
        restore the newest ``max-MeanIoU-*`` checkpoint (else the
        manifest's newest), dump each of this rank's scans to
        ``predictions/<seq>_<filename>.npz`` (``targets``, ``coords``,
        ``predictions_3d`` / ``predictions_2d``, ``img_indices``, ``img`` in
        f16), then ``validate`` with the confusion matrices summed over the
        ranks.  Returns the test meters."""
        self.checkpointer.wait()
        self.reducer.barrier()      # rank 0's checkpoints are on disk
        path = self.best_checkpoint()
        payload = Checkpointer(self.output_dir, self.logger).load(
            path, resume=bool(self.output_dir))
        if payload:
            self.load_model_state(payload["model"])
            self.clear_graphs()
            self.broadcast_state()
        self.prepare_eval()
        loader = self.build_loader("test")
        meters = MetricLogger(delimiter="  ")
        try:
            if save_predictions and self.output_dir:
                self.save_predictions(loader)
            validate(self.cfg, self.run_eval_batch, loader, meters,
                     log_tables=self.rank == 0,
                     cm_allreduce=self.cm_allreduce())
        finally:
            loader.close()
        self.logger.info("Test %s", meters.summary_str)
        return meters

    def save_predictions(self, loader):
        """Each scan of ``loader`` through the eval step, dumped to
        ``predictions/<seq>_<filename>.npz`` (written whole: a scan that
        two ranks' wrapped shards share is written twice, the same)."""
        pred_dir = osp.join(self.output_dir, "predictions")
        os.makedirs(pred_dir, exist_ok=True)
        for batch in loader:
            res = self.run_eval_batch(batch).numpy()
            cap = len(batch["pt_valid"]) // len(batch["scan_count"])
            for i, n_pts in enumerate(batch["scan_count"]):
                if n_pts == 0:
                    continue
                sl = slice(i * cap, i * cap + int(n_pts))
                dump = {"targets": batch["seg_label"][sl],
                        "coords": batch["coords"][sl]}
                for key in ("3d", "2d"):
                    if f"pred_{key}" in res:
                        dump[f"predictions_{key}"] = res[f"pred_{key}"][sl]
                if "img_indices" in batch:
                    dump["img_indices"] = batch["img_indices"][sl]
                if "img" in batch:
                    dump["img"] = np.asarray(batch["img"][i], np.float16)
                name = f"{batch['seq'][i]}_{batch['filename'][i]}.npz"
                tmp = osp.join(pred_dir, f".{name}.{self.rank}.tmp.npz")
                np.savez(tmp, **dump)
                os.replace(tmp, osp.join(pred_dir, name))
        self.logger.info("Saved predictions to %s", pred_dir)
