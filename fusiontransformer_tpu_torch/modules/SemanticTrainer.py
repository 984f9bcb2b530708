"""Epoch trainer for one device (torch).

Port of ``fusiontransformer_tpu/modules/SemanticTrainer.py``: build the model
(random weights from ``RNG_SEED``) and the train/val loaders, the optimizer
and per-epoch LR schedule, the checkpointer (auto-resume); then per epoch:
train (one train step per batch, capacities sized per batch from its voxel
counts when ``TPU.ADAPTIVE_LEVEL_CAPS`` is on and the model has the 3D
stream), log, validate (each present stream and, for a fusion model, the
2D+3D softmax-sum ensemble), track the best metric of each present stream
(``modalities``) and checkpoint on it.  A non-finite loss stops the run with
``FloatingPointError``.  Metrics are read one step late, so the host queues
the next step before it waits for the card.

On the card the train and eval steps run as CUDA graphs, as the JAX trainer
jits them once per input signature: one ``StepGraph`` per
(``batch_signature``, level capacities), in a ``StepCache`` of
``TPU.STEP_CACHE_SIZE`` each, all in one graph memory pool.  A signature's
first batch runs the step eagerly (its real step) and the step is captured
after it; later batches of that signature replay the graph.  Each step's
output is copied to pinned host memory in stream order (``Readback``)
before the next step is enqueued.  With ``TRAIN.GRAD_ACCUM_STEPS`` = k > 1
the per-signature graphs only add their gradients, and the optimizer update
runs as one graph of its own every k-th micro-step.  There is no switch to
train eagerly on the card, and a capture that fails raises.  On the CPU
(``device="cpu"``) the same steps run eagerly.  The checkpoint and the
optimizer's state are loaded before any capture.

``StepRunner`` is the part the eval CLI (``test.py``) uses alone: the eval
step of a model through the same per-signature graphs.

With ``TRAIN.GRAD_ACCUM_STEPS`` = k the trainer counts the micro-steps of
the open window and updates when the count reaches k; the count is saved
with the window's gradients and dropped with them (``RESUME_STATES
False``), as the JAX package keeps it in ``optax.MultiSteps``' state.  Each
epoch's line of ``metrics.jsonl`` is written before that epoch validates,
as in the JAX trainer: it carries the previous validation's meters.

Runs on the card unless it is given ``device="cpu"``; with no CUDA device
and no explicit CPU it raises.  ``MODEL.IMAGE_PRETRAINED_PATH`` loads a
DeiT / SimCLR checkpoint into the ViT (``utils/torch_checkpoint.py``).

As the JAX trainer, it also:

* writes TensorBoard summaries every ``TRAIN.SUMMARY_PERIOD`` epochs into
  ``tb.<run_name>`` under the output directory (``update_summary``): the
  train meters whose names hold ``loss``, ``acc`` or ``iou`` as scalars
  ``train/<meter>``, and with ``TRAIN.LOG_HISTOGRAM`` each parameter's
  values and gradient as histograms ``params/<flax path>`` /
  ``grads/<flax path>``.  The gradients come from a gradients-only pass
  (``gradient_pass``) on the epoch's last batch with per-voxel maps, which
  leaves the BatchNorm statistics, the optimizer, the static gradients, the
  open accumulation window and the dropout generator as they were.  Where
  a summary is asked for and ``torch.utils.tensorboard`` cannot be
  imported, the trainer raises at construction (the JAX trainer goes on
  without a writer);
* writes checkpoints from a background thread with
  ``TRAIN.ASYNC_CHECKPOINT`` (``utils/checkpoint.py``: the snapshot to
  host memory is taken before ``save`` returns);
* stops at a step boundary on SIGTERM (a flag set by the handler, which is
  installed from the main thread only), writes ``preempt<epoch>`` with the
  interrupted epoch's index (a resume runs that epoch again), the open
  accumulation window and the generator, and returns;
* logs the host's resident set after every epoch (``utils/memdiag.py``)
  and writes it to ``metrics.jsonl`` as ``host_rss_mb``.

Data, tensor and ZeRO parallelism are ``modules/DistributedTrainer.py``, a
subclass: this class holds its rank guards (``rank`` / ``world_size``, 0 /
1 here): only rank 0 writes summaries, ``metrics.jsonl``, checkpoints and
the per-class tables, and each data rank's dropout generator has a seed of
its own (``parallel.data_parallel.rank_seed`` of ``data_rank``; rank 0's
is ``RNG_SEED``).  What a checkpoint or a histogram holds comes from
``canonical_state`` / ``canonical_model``, which every rank calls before
the rank-0 guard (the subclass gathers sharded state there: a collective);
a load goes through ``load_model_state`` / ``load_optimizer``, and a
validation first runs ``prepare_eval`` on every rank.
``TPU.NUM_DEVICES``, where set, must equal the number of processes;
``TPU.MODEL_PARALLEL`` > 1 and ``TPU.ZERO_OPTIMIZER`` shard over the ranks
of a distributed run, and this trainer, which runs one device, refuses
them (``check_ported_keys``).  ``TPU.REMAT_VIT`` is honoured by the model
(``models/vit.py``).
"""

from __future__ import annotations

import json
import logging
import math
import os.path as osp
import signal
import threading
import time

import torch

from fusiontransformer_tpu_torch.data.build import build_dataloader
from fusiontransformer_tpu_torch.data.utils.validate import validate
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.models.metric import SegIoU
from fusiontransformer_tpu_torch.modules.steps import (StepCache,
                                                       StepGraph,
                                                       batch_level_caps,
                                                       batch_signature,
                                                       device_batch,
                                                       losses,
                                                       make_eval_step,
                                                       make_train_step,
                                                       read_back, step_hier)
from fusiontransformer_tpu_torch.parallel.data_parallel import rank_seed
from fusiontransformer_tpu_torch.solver.build import (build_optimizer,
                                                      get_learning_rate,
                                                      load_optimizer_state,
                                                      set_learning_rate)
from fusiontransformer_tpu_torch.utils import memdiag
from fusiontransformer_tpu_torch.utils.checkpoint import Checkpointer
from fusiontransformer_tpu_torch.utils.convert_jax import jax_leaf_path
from fusiontransformer_tpu_torch.utils.device import resolve_device
from fusiontransformer_tpu_torch.utils.metric_logger import MetricLogger
from fusiontransformer_tpu_torch.utils.torch_checkpoint import (
    load_pretrained_image)

# Keys the port does not honour yet, the test that a key is set away from
# its default, and the ROADMAP.md item that will port it.
UNPORTED_KEYS = ()
# Keys that shard over the ranks of a distributed run, and the test that a
# key is set away from its default.
DISTRIBUTED_KEYS = (("TPU.MODEL_PARALLEL", lambda v: v > 1),
                    ("TPU.ZERO_OPTIMIZER", bool))


def cfg_value(cfg, key):
    node = cfg
    for part in key.split("."):
        node = node[part]
    return node


def modalities(cfg):
    """The streams the config's model has: ``["2d", "3d"]`` for a fusion
    model, ``["3d"]`` for a lidar-only and ``["2d"]`` for an image-only
    model (the JAX trainer's ``modalities``)."""
    m = cfg.MODEL
    return ["2d", "3d"] if m.USE_FUSION else ["3d"] if m.USE_LIDAR \
        else ["2d"]


def check_ported_keys(cfg, world_size=1, distributed=False):
    """Raise ``NotImplementedError`` for a key of UNPORTED_KEYS that ``cfg``
    sets away from its default: the port would ignore it; ``ValueError``
    for a key of DISTRIBUTED_KEYS in a run that is not ``distributed`` (one
    device has nothing to shard over); and ``ValueError`` where
    ``TPU.NUM_DEVICES`` is set to another number than the run's
    ``world_size`` (one process a device)."""
    for key, is_set, item in UNPORTED_KEYS:
        node = cfg_value(cfg, key)
        if is_set(node):
            raise NotImplementedError(f"{key} = {node} is not ported yet "
                                      f"(ROADMAP.md, {item})")
    for key, is_set in () if distributed else DISTRIBUTED_KEYS:
        node = cfg_value(cfg, key)
        if is_set(node):
            raise ValueError(
                f"{key} = {node} shards over the ranks of a distributed "
                f"run, and this trainer runs one device: launch one process "
                f"a device with --distributed 1 (python -m "
                f"torch.distributed.run --nproc_per_node N -m "
                f"fusiontransformer_tpu_torch.train ... --distributed 1)")
    n = int(cfg.TPU.NUM_DEVICES)
    if n and n != world_size:
        raise ValueError(
            f"TPU.NUM_DEVICES = {n} but the run has {world_size} "
            f"process(es) of one device each: launch {n} (python -m "
            f"torch.distributed.run --nproc_per_node {n} ... --distributed "
            f"1), or leave TPU.NUM_DEVICES at 0")


class StepRunner:
    """A model's steps on collated host batches: eagerly on the CPU; on the
    card through one ``StepGraph`` per (``batch_signature``, level
    capacities), all captured into one memory pool, a signature's first
    batch being its eager step.  Holds the eval step and its graphs
    (``eval_graphs``); ``SemanticTrainer`` adds the train step's."""

    def __init__(self, cfg, model, device, logger):
        self.cfg, self.model, self.device = cfg, model, device
        self.logger = logger
        self.eval_step = make_eval_step(cfg, model)
        # Capacities follow the batch only where there is a hierarchy.
        self.adaptive_caps = bool(cfg.TPU.ADAPTIVE_LEVEL_CAPS
                                  and cfg.MODEL.USE_LIDAR)
        self.eval_graphs = StepCache(cfg.TPU.STEP_CACHE_SIZE)
        self._pool = None
        self.captures = {"train": 0, "eval": 0, "update": 0}

    def clear_graphs(self):
        self.eval_graphs.clear()

    def level_caps(self, host_batch):
        """The batch's voxel capacities (None: sized from its buffer)."""
        if not self.adaptive_caps:
            return None
        return batch_level_caps(self.cfg, host_batch)

    def _run(self, kind, cache, step, host_batch, caps, generator=None):
        """``step`` on a collated host batch at level capacities ``caps``,
        read back (``Readback``)."""
        return read_back(*self._launch(kind, cache, step, host_batch, caps,
                                       generator))

    def _launch(self, kind, cache, step, host_batch, caps, generator=None):
        """``step`` on a collated host batch, enqueued: ``(output, graph)``,
        the output on the device.  On the card through the graph of the
        batch's signature and ``caps`` (its static output), captured after
        an eager run of this batch on a miss; eagerly on the CPU (no
        graph)."""
        if self.device.type == "cpu":
            return step(device_batch(host_batch, self.device)), None
        key = (batch_signature(host_batch), caps)
        graph = cache.get(key)
        if graph is not None:
            graph.load(host_batch)
            graph.graph.replay()
            return graph.out, graph
        graph = self._capture(step, host_batch, generator)
        cache[key] = graph
        self.captures[kind] += 1
        self.logger.info("captured the %s step for capacities %s in %.2f s",
                         kind, caps, graph.capture_s)
        first, graph.first = graph.first, None
        return first, graph

    def _capture(self, step, host_batch, generator=None):
        """``StepGraph`` of ``step`` into the runner's pool (a new pool
        after a capture that failed)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        try:
            return StepGraph(step, host_batch, self.device, self._pool,
                             generator)
        except BaseException:
            self._pool = None
            raise

    def run_eval_batch(self, host_batch):
        """The eval step's results on a collated host batch, on their way to
        pinned host memory of their own (``Readback``): the next batch's
        replay, enqueued before they are read, cannot overwrite them."""
        caps = self.level_caps(host_batch)
        return self._run("eval", self.eval_graphs,
                         lambda batch: self.eval_step(batch, caps),
                         host_batch, caps)


def summary_writer(cfg, output_dir, run_name):
    """The TensorBoard writer of ``tb.<run_name>`` under ``output_dir``
    when the config asks for summaries there, else None.  Raises where
    ``torch.utils.tensorboard`` (the ``tensorboard`` package) cannot be
    imported: the run would write none of what it asks for."""
    if not (output_dir and cfg.TRAIN.SUMMARY_PERIOD > 0):
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError(
            f"TRAIN.SUMMARY_PERIOD = {cfg.TRAIN.SUMMARY_PERIOD} needs the "
            f"tensorboard package (torch.utils.tensorboard): {e}") from e
    return SummaryWriter(osp.join(output_dir, f"tb.{run_name}"))


class SemanticTrainer(StepRunner):
    rank = 0            # this process's rank and the number of processes
    world_size = 1      # (modules/DistributedTrainer.py sets both)
    data_rank = 0       # the rank's index on the data axis
    distributed = False

    def __init__(self, cfg, output_dir="", run_name="", device=None):
        check_ported_keys(cfg, self.world_size, self.distributed)
        self.output_dir = output_dir
        self.run_name = run_name
        self.summary_writer = summary_writer(cfg, output_dir, run_name) \
            if self.rank == 0 else None
        device = resolve_device(device)
        self.logger = logging.getLogger(
            f"FusionTransformer.{cfg.MODEL.TYPE}.train")
        model = self.build_train_model(cfg, device)
        super().__init__(cfg, model, device, self.logger)
        self.modalities = modalities(cfg)
        self.train_metrics = {m: SegIoU(cfg.MODEL.NUM_CLASSES,
                                        name=f"seg_iou_{m}")
                              for m in self.modalities}
        self.train_dataloader = self.build_loader("train")
        self.val_dataloader = (self.build_loader("val")
                               if cfg.VAL.PERIOD > 0 else None)
        self.steps_per_epoch = max(1, len(self.train_dataloader))
        self.accum_steps = int(cfg.TRAIN.GRAD_ACCUM_STEPS)
        if self.accum_steps > 1 and self.steps_per_epoch % self.accum_steps:
            self.logger.warning(
                "steps_per_epoch (%d) is not a multiple of "
                "TRAIN.GRAD_ACCUM_STEPS (%d): accumulation windows straddle "
                "epoch boundaries — the per-epoch LR change lands mid-window "
                "and the final partial window of the run is discarded",
                self.steps_per_epoch, self.accum_steps)
        self.optimizer, self.lr_schedule = self.build_train_optimizer(
            cfg, self.steps_per_epoch)
        self.logger.info("#Parameters: %.2e",
                         sum(p.numel() for p in self.model.parameters()))
        self.train_step = make_train_step(cfg, self.model, self.optimizer)
        # Dropout's random stream: one generator on the device, seeded from
        # RNG_SEED (and the rank), advanced by every train step (and every
        # replay).
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(cfg.RNG_SEED, self.data_rank))
        self.step = 0
        self.window = 0         # micro-steps of the open accumulation window
        # The card's graphs beside the eval step's: the train step's per
        # signature and the optimizer update (GRAD_ACCUM_STEPS > 1).
        self.train_graphs = StepCache(cfg.TPU.STEP_CACHE_SIZE)
        self.update_graph = None

        self.checkpointer = Checkpointer(
            output_dir, self.logger, cfg.TRAIN.MAX_TO_KEEP,
            async_save=bool(cfg.TRAIN.ASYNC_CHECKPOINT))
        self.checkpoint_data = self._load_checkpoint()
        self.start_epoch = int(self.checkpoint_data.get("epoch", 0))
        self.best_metric_name = f"best_{cfg.VAL.METRIC}"
        self.best_metric = {m: self.checkpoint_data.get(
            f"{m}_{self.best_metric_name}") for m in self.modalities}
        self.best_metric_epoch = {m: -1 for m in self.modalities}

        self.train_metric_logger = MetricLogger(delimiter="  ")
        self.train_metric_logger.add_meters(
            [self.train_metrics[m] for m in ("3d", "2d")
             if m in self.train_metrics])
        self.val_metric_logger = MetricLogger(delimiter="  ")
        self.last_batch = None      # the epoch's last host batch
        self.host_rss_mb = 0.0
        self.preempted = False

    # ------------------------------------------------------------------ #
    def build_train_model(self, cfg, device):
        """The model this process trains: random weights from ``RNG_SEED``,
        the pretrained image weights where the config names them."""
        model = build_model(cfg, device, seed=cfg.RNG_SEED)
        if cfg.MODEL.IMAGE_PRETRAINED_PATH:
            self.logger.info("Loaded %d pretrained image tensors from %s",
                             load_pretrained_image(cfg, model),
                             cfg.MODEL.IMAGE_PRETRAINED_PATH)
        return model

    def build_train_optimizer(self, cfg, steps_per_epoch):
        """``(optimizer, schedule)`` over the trained model's parameters."""
        return build_optimizer(cfg, self.model.parameters(), steps_per_epoch)

    def build_loader(self, mode):
        """The loader of ``mode``'s split for this process."""
        return build_dataloader(self.cfg, mode=mode)

    def canonical_state(self):
        """``(model state_dict, optimizer state_dict)`` in the canonical
        single-device layout that checkpoints hold.  Every rank calls it
        (a sharded subclass gathers here)."""
        return self.model.state_dict(), self.optimizer.state_dict()

    def canonical_model(self):
        """The single-device model with the trained weights (histograms and
        their gradients read it).  Every rank calls it."""
        return self.model

    def load_model_state(self, state):
        """A canonical model ``state_dict`` into the trained model."""
        self.model.load_state_dict(state)

    def load_optimizer(self, state):
        """A canonical optimizer ``state_dict`` into the optimizer."""
        load_optimizer_state(self.optimizer, state)

    def prepare_eval(self):
        """Make the eval step's model current (every rank, before a
        validation or a test: nothing to do on one device)."""

    def _load_checkpoint(self):
        """Restore the newest checkpoint (or ``RESUME_PATH``).  Loading
        replaces the state tensors a captured graph would keep updating, so
        it drops every graph; the trainer loads before its first capture."""
        payload = self.checkpointer.load(self.cfg.RESUME_PATH,
                                         resume=self.cfg.AUTO_RESUME,
                                         resume_states=self.cfg.RESUME_STATES)
        self.clear_graphs()
        if not payload:
            return {}
        if "optimizer" in payload:
            saved_k = payload.get("grad_accum_steps")
            if saved_k is not None and int(saved_k) != self.accum_steps:
                raise ValueError(
                    f"checkpoint was saved with TRAIN.GRAD_ACCUM_STEPS="
                    f"{int(saved_k)} but the run has {self.accum_steps}: the "
                    "optimizer state layout depends on it — set the same "
                    "value, or resume with RESUME_STATES False to drop the "
                    "optimizer state")
        self.load_model_state(payload["model"])
        if "optimizer" in payload:
            self.load_optimizer(payload["optimizer"])
        # The gradients of a window that was open at the save, and how many
        # micro-steps it had taken.
        for g, saved in zip(self.train_step.grads,
                            payload.get("grad_accum", ())):
            g.copy_(saved)
        self.window = int(payload.get("grad_accum_window", 0))
        # A data-parallel checkpoint holds every rank's generator; a rank
        # whose state it lacks keeps its seeded one.
        gens = payload.get("rank_generators")
        if gens is not None and len(gens) == self.world_size:
            self.generator.set_state(gens[self.rank])
        elif "generator" in payload and self.rank == 0:
            self.generator.set_state(payload["generator"])
        elif "generator" in payload:
            self.logger.warning("the checkpoint holds no dropout generator "
                                "of rank %d; it keeps its seeded one",
                                self.rank)
        self.step = int(payload.get("step", 0))
        return {k: v for k, v in payload.items()
                if k not in ("model", "optimizer", "step", "grad_accum",
                             "grad_accum_window", "grad_accum_steps",
                             "generator", "rank_generators")}

    def clear_graphs(self):
        super().clear_graphs()
        self.train_graphs.clear()
        self.update_graph = None

    def run_train_step(self, host_batch):
        """One train step on a collated host batch: its metrics, on their
        way to the host (``Readback``).  With GRAD_ACCUM_STEPS = k, the
        k-th micro-step of a window also runs the optimizer update."""
        caps = self.level_caps(host_batch)
        k = self.accum_steps
        metrics = self._run(
            "train", self.train_graphs,
            lambda batch: self.train_step(batch, self.generator, caps,
                                          update=k == 1),
            host_batch, caps, self.generator)
        self.step += 1
        if k > 1:
            self.window += 1
            if self.window == k:
                self._update()
                self.window = 0
        return metrics

    def _update(self):
        if self.device.type == "cpu":
            self.train_step.update()
        elif self.update_graph is None:
            self.update_graph = self._capture(
                lambda _: self.train_step.update(), {})
            self.captures["update"] += 1
        else:
            self.update_graph.graph.replay()

    def train_for_one_epoch(self, epoch):
        self.train_metric_logger.reset()
        for metric in self.train_metrics.values():
            metric.reset()
        self.train_dataloader.set_epoch(epoch)
        pending = None
        for batch in self.train_dataloader:
            metrics = self.run_train_step(batch)
            self.last_batch = batch
            if pending is not None:
                self._consume_step_metrics(*pending)
            pending = (metrics, int(batch.get("gslot_overflow", 0)))
            if self._should_stop():
                break       # SIGTERM: stop at a step boundary
        if pending is not None:
            self._consume_step_metrics(*pending)
        if self._should_stop():
            return
        # Per-epoch scheduler step.
        set_learning_rate(self.optimizer,
                          self.lr_schedule((epoch + 1) * self.steps_per_epoch))

    def _should_stop(self):
        """Whether training stops after this step (SIGTERM)."""
        return self.preempted

    def _consume_step_metrics(self, readback, slot_overflow):
        metrics = readback.numpy()
        host = {k: float(v) for k, v in metrics.items()
                if not k.startswith("cm_")}
        if not math.isfinite(host["total_loss"]):
            raise FloatingPointError(
                f"non-finite loss at step {self.step}: {host}")
        host["slot_overflow"] = slot_overflow
        if host.get("voxel_overflow", 0) > 0 or slot_overflow > 0:
            self.logger.warning(
                "capacity overflow: %d voxels and %d conv slots dropped this "
                "step — raise TPU.LEVEL_CAPACITY_FRACTIONS",
                int(host.get("voxel_overflow", 0)), slot_overflow)
        if host.get("tap_overflow", 0) > 0:
            self.logger.warning(
                "conv tap-slot overflow: %d live taps dropped this step — "
                "gradients of the binned conv are inconsistent with its "
                "forward under overflow; raise TPU.CONV_TAP_SLOTS",
                int(host["tap_overflow"]))
        self.train_metric_logger.update(**host)
        for m, metric in self.train_metrics.items():
            metric.update_matrix(metrics[f"cm_{m}"])

    def update_log(self, epoch):
        if self.rank != 0:
            return
        lp = self.cfg.TRAIN.LOG_PERIOD
        if epoch == 1 or (lp > 0 and epoch % lp == 0):
            self.logger.info("iter: %4d  %s  lr: %.2e", epoch,
                             str(self.train_metric_logger),
                             get_learning_rate(self.optimizer))
        if not self.output_dir:
            return
        rec = {"epoch": epoch, "lr": get_learning_rate(self.optimizer),
               "host_rss_mb": self.host_rss_mb}
        for prefix, ml in (("train/", self.train_metric_logger),
                           ("val/", self.val_metric_logger)):
            for name, meter in ml.meters.items():
                rec[prefix + name] = float(meter.global_avg)
        with open(osp.join(self.output_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    # ------------------------------------------------------------------ #
    def validate_for_one_epoch(self, epoch):
        """True iff validation ran this epoch."""
        period = self.cfg.VAL.PERIOD
        if self.val_dataloader is None or not (
                epoch % period == 0
                or epoch == self.cfg.SCHEDULER.MAX_EPOCH - 1):
            return False
        self.val_metric_logger.reset()
        self.prepare_eval()
        validate(self.cfg, self.run_eval_batch, self.val_dataloader,
                 self.val_metric_logger, log_tables=self.rank == 0,
                 cm_allreduce=self.cm_allreduce())
        return True

    def cm_allreduce(self):
        """The cross-process sum of a validation's confusion matrices
        (None: one process)."""
        return None

    def update_validation_logging_meters(self, epoch):
        self.logger.info("Epoch[%d]-Val %s", epoch,
                         self.val_metric_logger.summary_str)
        for m in self.modalities:
            name = f"{self.cfg.VAL.METRIC}_{m}"
            if name in self.val_metric_logger.meters:
                cur = self.val_metric_logger.meters[name].global_avg
                if self.best_metric[m] is None or self.best_metric[m] < cur:
                    self.best_metric[m] = cur
                    self.best_metric_epoch[m] = epoch
        for m in self.modalities:
            if self.best_metric[m] is not None:
                self.logger.info("Best val-%s-%s = %.2f at epoch %d",
                                 m.upper(), self.cfg.VAL.METRIC,
                                 self.best_metric[m] * 100,
                                 self.best_metric_epoch[m])

    def update_checkpoint(self, epoch):
        """Checkpoint after ``epoch``; its ``epoch`` field is the next epoch
        to run, so a resumed run continues after it.  It holds the dropout
        generator's state, and with GRAD_ACCUM_STEPS > 1 the gradients of
        the open window, so that a resumed run goes on as the uninterrupted
        one would."""
        self._save(f"model{epoch:06d}", epoch + 1)

    def _save(self, name, next_epoch):
        """Save the trainer's state as checkpoint ``name`` that resumes at
        epoch ``next_epoch`` (the checkpointer copies every tensor to the
        host before it returns).  Every rank calls it; rank 0 writes."""
        extra = {f"{m}_{self.best_metric_name}": float(self.best_metric[m])
                 for m in self.modalities if self.best_metric[m] is not None}
        extra.update(self._rank_states())
        model_state, optimizer_state = self.canonical_state()
        if self.rank != 0:
            return
        if self.accum_steps > 1:
            extra["grad_accum"] = list(self.train_step.grads)
            extra["grad_accum_window"] = self.window
        self.checkpointer.save(
            name, model=model_state, optimizer=optimizer_state,
            step=self.step, epoch=next_epoch,
            grad_accum_steps=self.accum_steps,
            generator=self.generator.get_state(), **extra)

    def _rank_states(self):
        """What a checkpoint holds of every rank (nothing on one device)."""
        return {}

    def _save_preemption_checkpoint(self, epoch):
        """``preempt<epoch>``, which resumes into the interrupted epoch
        (plain checkpoints store ``epoch + 1``); written before returning."""
        self._save(f"preempt{epoch:06d}", epoch)
        self.checkpointer.wait()
        if self.rank == 0:
            self.logger.warning("Preemption checkpoint written for epoch %d",
                                epoch)

    def _install_preemption_handler(self):
        """SIGTERM sets ``preempted``; the current step finishes and the
        epoch loop stops after it.  Returns the handler it replaced (None
        off the main thread, where no handler can be installed)."""
        self.preempted = False
        if threading.current_thread() is not threading.main_thread():
            return None

        def on_sigterm(signum, frame):
            self.preempted = True
            self.logger.warning("SIGTERM received: will checkpoint and stop "
                                "after the current step")

        return signal.signal(signal.SIGTERM, on_sigterm)

    def _log_host_memory(self, epoch):
        """The per-epoch host RSS line (``FTX_MEMDIAG=1``: the whole
        snapshot, and with ``FTX_MEMDIAG_TRACE=1`` the growing allocation
        sites) and the malloc trim (``FTX_MALLOC_TRIM``)."""
        import os
        if os.environ.get("FTX_MEMDIAG", "") == "1":
            snap = memdiag.snapshot()
            self.logger.info("memdiag[%d]: %s", epoch,
                             memdiag.format_snapshot(snap))
            report = memdiag.trace_report()
            if report:
                self.logger.info("memdiag[%d]: %s", epoch, report)
            self.host_rss_mb = snap.get("rss_mb", 0.0)
        else:
            self.host_rss_mb = memdiag.rss_mb()
            self.logger.info("host RSS after epoch %d: %.0f MB", epoch,
                             self.host_rss_mb)
        if memdiag.maybe_trim():
            self.logger.info("malloc_trim released pages; RSS now %.0f MB",
                             memdiag.rss_mb())

    # ------------------------------------------------------------------ #
    def gradient_pass(self, host_batch, model=None):
        """``{parameter name: gradient}`` of the train loss at the current
        weights of ``model`` (the trained one by default) on
        ``host_batch``, with per-voxel maps (its ``gslot_*`` maps stripped,
        the capacities sized from its buffer), as the JAX package's
        ``make_grads_fn``: an eager forward in train mode and
        ``torch.autograd.grad``, so the static ``.grad`` tensors, the
        optimizer and the open window are not touched; the BatchNorm
        statistics and the dropout generator are put back as they were.  A
        parameter the loss does not reach gets zeros."""
        model = self.model if model is None else model
        hb = {k: v for k, v in host_batch.items()
              if not k.startswith(("gslot_src_", "gslot_bin_"))}
        batch = device_batch(hb, self.device)
        named = list(model.named_parameters())
        buffers = list(model.buffers())
        saved = [b.clone() for b in buffers]
        gen_state = self.generator.get_state()
        model.train()
        try:
            out = model(batch, step_hier(self.cfg, batch),
                        generator=self.generator)
            total, _ = losses(self.cfg, out, batch,
                              self.train_step.class_weights)
            grads = torch.autograd.grad(total, [p for _, p in named],
                                        allow_unused=True)
        finally:
            with torch.no_grad():
                for b, s in zip(buffers, saved):
                    b.copy_(s)
            self.generator.set_state(gen_state)
        return {n: torch.zeros_like(p) if g is None else g
                for (n, p), g in zip(named, grads)}

    def update_summary(self, epoch):
        """TensorBoard summaries of ``epoch`` every SUMMARY_PERIOD epochs
        (the JAX trainer's ``update_summary``), written by rank 0; the
        histograms read ``canonical_model``, which every rank calls."""
        period = self.cfg.TRAIN.SUMMARY_PERIOD
        if not self.output_dir or period <= 0 or epoch % period:
            return
        model = self.canonical_model() if self.cfg.TRAIN.LOG_HISTOGRAM \
            else None
        sw = self.summary_writer
        if sw is None:
            return
        for name, meter in self.train_metric_logger.meters.items():
            if any(k in name for k in ("loss", "acc", "iou")):
                sw.add_scalar("train/" + name, meter.avg, global_step=epoch)
        if self.cfg.TRAIN.LOG_HISTOGRAM:
            for name, p in model.named_parameters():
                sw.add_histogram("params/" + "/".join(jax_leaf_path(name)),
                                 p.detach().float().cpu().numpy().ravel(),
                                 global_step=epoch)
            if self.last_batch is not None:
                for name, g in self.gradient_pass(self.last_batch,
                                                  model).items():
                    sw.add_histogram(
                        "grads/" + "/".join(jax_leaf_path(name)),
                        g.float().cpu().numpy().ravel(), global_step=epoch)
        sw.flush()

    def train(self):
        previous = self._install_preemption_handler()
        try:
            for epoch in range(self.start_epoch,
                               int(self.cfg.SCHEDULER.MAX_EPOCH)):
                t0 = time.time()
                self.train_for_one_epoch(epoch)
                if self._should_stop():
                    self._save_preemption_checkpoint(epoch)
                    break
                self.logger.info("Epoch %d took %.1fs", epoch,
                                 time.time() - t0)
                self._log_host_memory(epoch)
                # As in the JAX trainer: the log line first, so epoch e's
                # carries the validation of an earlier epoch (none at 0).
                self.update_log(epoch)
                self.update_summary(epoch)
                if self.validate_for_one_epoch(epoch):
                    self.update_validation_logging_meters(epoch)
                # As in the JAX trainer: a checkpoint on each new best epoch.
                if any(self.best_metric_epoch[m] == epoch
                       for m in self.modalities):
                    self.update_checkpoint(epoch)
            self.checkpointer.wait()    # the write in flight, if any
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
            self.close()
        return self.model

    def close(self):
        """Stop the loaders' worker pools (a later epoch starts them
        again) and flush the summaries."""
        for loader in (self.train_dataloader, self.val_dataloader):
            if loader is not None:
                loader.close()
        if self.summary_writer is not None:
            self.summary_writer.flush()
