"""Data-parallel trainer: one process per device over ``torch.distributed``.

Port of ``fusiontransformer_tpu/modules/DistributedTrainer.py`` for its
multi-process case (the reference's torchpack/DDP stack), launched one
process per card by ``python -m torch.distributed.run`` (torchrun):

* the process group from torchrun's environment
  (``parallel.data_parallel.init_distributed``: NCCL on the card, gloo on
  the CPU), the device ``cuda:LOCAL_RANK``;
* ``TRAIN.BATCH_SIZE`` is the global batch: each process loads
  ``BATCH_SIZE / world_size`` scans a step from its ``ShardedView`` of the
  split with loader seed ``rank``, and validates and tests its own shard of
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

Deliberate differences from the JAX package (ROADMAP.md, Queue 3): one
process per device where JAX runs one process over a mesh; the collectives
outside the CUDA graphs; dropout generators seeded per rank
(``rank_seed``) where JAX folds the device index into its key.  Tensor
parallelism and ZeRO (``TPU.MODEL_PARALLEL`` > 1, ``TPU.ZERO_OPTIMIZER``)
raise ``NotImplementedError`` (Queue 1 item 4).
"""

from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np
import torch

from fusiontransformer_tpu_torch.data.build import build_dataloader
from fusiontransformer_tpu_torch.data.utils.validate import validate
from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
    SemanticTrainer, check_ported_keys)
from fusiontransformer_tpu_torch.modules.steps import (adaptive_level_caps,
                                                       read_back)
from fusiontransformer_tpu_torch.parallel.data_parallel import (
    Reducer, init_distributed, repad)
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


class DistributedTrainer(SemanticTrainer):
    """``SemanticTrainer`` on this process's rank of the default process
    group (made from torchrun's environment, or the caller's).  ``backend``
    names the group's backend (default: NCCL on the card, gloo on the
    CPU)."""

    def __init__(self, cfg, output_dir="", run_name="", device=None,
                 backend=None):
        # The keys that would ask for another kind of parallelism raise
        # before the process group is joined.
        check_ported_keys(cfg, int(cfg.TPU.NUM_DEVICES) or 1)
        device = resolve_device(device)
        self.rank, self.world_size = init_distributed(device, backend)
        self.reducer = Reducer(device)
        bs = int(cfg.TRAIN.BATCH_SIZE)
        if bs % self.world_size:
            raise ValueError(f"TRAIN.BATCH_SIZE = {bs} (the global batch) "
                             f"must divide over {self.world_size} ranks")
        self.scans_per_rank = bs // self.world_size
        self._stop = False
        self.step_marks = []        # StepMarks of the train replays
        # A checkpoint that rank 0 was writing (an earlier trainer of this
        # process group) is on disk before any rank looks for one.
        self.reducer.barrier()
        super().__init__(cfg, output_dir, run_name, device)
        self.train_step.reduce = self.reducer
        self.broadcast_state()

    # ------------------------------------------------------------------ #
    def build_loader(self, mode):
        """This rank's shard of ``mode``'s split: a ``1/world_size`` share
        of the global train batch with loader seed ``rank``; val and test
        at their batch sizes."""
        if mode == "train":
            return build_dataloader(
                self.cfg, "train", seed=self.rank,
                batch_size=self.scans_per_rank, use_distributed=True,
                rank=self.rank, world_size=self.world_size)
        return build_dataloader(self.cfg, mode, use_distributed=True,
                                rank=self.rank, world_size=self.world_size)

    def broadcast_state(self):
        """Rank 0's parameters and buffers on every rank."""
        self.reducer.broadcast_(list(self.model.parameters())
                                + list(self.model.buffers()))

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
        batch: the local step (its graph on the card), then its metrics
        reduced and the BatchNorm buffers averaged; at a window's last
        micro-step the gradients averaged and the optimizer update."""
        host_batch, caps = self.agree(host_batch)
        captures = self.captures["train"]
        marks = StepMarks(self.device)
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
        if self.captures["train"] == captures:      # a replay
            self.step_marks.append(marks)
        return read_back(metrics, graph)

    def step_times(self):
        """Medians over the train replays since the last call, in ms:
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
        return self.reducer.sum_array

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
            self.reducer.mean_(self.train_step.grads)
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
            self.model.load_state_dict(payload["model"])
            self.clear_graphs()
            self.broadcast_state()
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
