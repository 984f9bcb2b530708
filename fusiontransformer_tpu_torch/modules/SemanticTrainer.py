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
DeiT / SimCLR checkpoint into the ViT (``utils/torch_checkpoint.py``).  Not
ported (ROADMAP.md, Queue 1): wandb and TensorBoard, gradient histograms
(``make_grads_fn``), asynchronous checkpoints, the preemption handler, the
ViT's rematerialisation, and more than one device; the keys that would ask
for them raise (``check_ported_keys``).
"""

from __future__ import annotations

import json
import logging
import math
import os.path as osp
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
                                                       make_eval_step,
                                                       make_train_step,
                                                       read_back)
from fusiontransformer_tpu_torch.solver.build import (build_optimizer,
                                                      get_learning_rate,
                                                      load_optimizer_state,
                                                      set_learning_rate)
from fusiontransformer_tpu_torch.utils.checkpoint import Checkpointer
from fusiontransformer_tpu_torch.utils.device import resolve_device
from fusiontransformer_tpu_torch.utils.metric_logger import MetricLogger
from fusiontransformer_tpu_torch.utils.torch_checkpoint import (
    load_pretrained_image)

# Keys the port does not honour yet, the test that a key is set away from
# its default, and the ROADMAP.md item that will port it.
UNPORTED_KEYS = (
    ("TRAIN.SUMMARY_PERIOD", lambda v: v > 0,
     "Queue 1 item 2 (TensorBoard scalars)"),
    ("TRAIN.LOG_HISTOGRAM", bool,
     "Queue 1 item 2 (weight/grad histograms)"),
    ("TPU.REMAT_VIT", bool, "Queue 1 item 2 (ViT rematerialisation)"),
    ("TPU.NUM_DEVICES", lambda v: v > 1, "Queue 1 item 3 (data parallelism)"),
    ("TPU.MODEL_PARALLEL", lambda v: v > 1,
     "Queue 1 item 4 (tensor parallelism)"),
    ("TPU.ZERO_OPTIMIZER", bool, "Queue 1 item 4 (ZeRO)"),
)


def modalities(cfg):
    """The streams the config's model has: ``["2d", "3d"]`` for a fusion
    model, ``["3d"]`` for a lidar-only and ``["2d"]`` for an image-only
    model (the JAX trainer's ``modalities``)."""
    m = cfg.MODEL
    return ["2d", "3d"] if m.USE_FUSION else ["3d"] if m.USE_LIDAR \
        else ["2d"]


def check_ported_keys(cfg):
    """Raise ``NotImplementedError`` for a key of UNPORTED_KEYS that ``cfg``
    sets away from its default: the port would ignore it."""
    for key, is_set, item in UNPORTED_KEYS:
        node = cfg
        for part in key.split("."):
            node = node[part]
        if is_set(node):
            raise NotImplementedError(f"{key} = {node} is not ported yet "
                                      f"(ROADMAP.md, {item})")


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

    def _run(self, kind, cache, step, host_batch, generator=None):
        """``step`` on a collated host batch, read back (``Readback``): on
        the card through the graph of the batch's signature and capacities,
        captured after an eager run of this batch on a miss."""
        if self.device.type == "cpu":
            return read_back(step(device_batch(host_batch, self.device)))
        caps = self.level_caps(host_batch)
        key = (batch_signature(host_batch), caps)
        graph = cache.get(key)
        if graph is not None:
            return graph.replay(host_batch)
        graph = self._capture(step, host_batch, generator)
        cache[key] = graph
        self.captures[kind] += 1
        self.logger.info("captured the %s step for capacities %s in %.2f s",
                         kind, caps, graph.capture_s)
        first, graph.first = graph.first, None
        return read_back(first, graph)

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
                         host_batch)


class SemanticTrainer(StepRunner):
    def __init__(self, cfg, output_dir="", run_name="", device=None):
        check_ported_keys(cfg)
        self.output_dir = output_dir
        self.run_name = run_name
        device = resolve_device(device)
        logger = logging.getLogger(f"FusionTransformer.{cfg.MODEL.TYPE}.train")
        model = build_model(cfg, device, seed=cfg.RNG_SEED)
        super().__init__(cfg, model, device, logger)
        if cfg.MODEL.IMAGE_PRETRAINED_PATH:
            self.logger.info("Loaded %d pretrained image tensors from %s",
                             load_pretrained_image(cfg, self.model),
                             cfg.MODEL.IMAGE_PRETRAINED_PATH)
        self.modalities = modalities(cfg)
        self.train_metrics = {m: SegIoU(cfg.MODEL.NUM_CLASSES,
                                        name=f"seg_iou_{m}")
                              for m in self.modalities}
        self.train_dataloader = build_dataloader(cfg, mode="train")
        self.val_dataloader = (build_dataloader(cfg, mode="val")
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
        self.optimizer, self.lr_schedule = build_optimizer(
            cfg, self.model.parameters(), self.steps_per_epoch)
        self.logger.info("#Parameters: %.2e",
                         sum(p.numel() for p in self.model.parameters()))
        self.train_step = make_train_step(cfg, self.model, self.optimizer)
        # Dropout's random stream: one generator on the device, seeded from
        # RNG_SEED, advanced by every train step (and every replay).
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(cfg.RNG_SEED))
        self.step = 0
        self.window = 0         # micro-steps of the open accumulation window
        # The card's graphs beside the eval step's: the train step's per
        # signature and the optimizer update (GRAD_ACCUM_STEPS > 1).
        self.train_graphs = StepCache(cfg.TPU.STEP_CACHE_SIZE)
        self.update_graph = None

        self.checkpointer = Checkpointer(output_dir, self.logger,
                                         cfg.TRAIN.MAX_TO_KEEP)
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

    # ------------------------------------------------------------------ #
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
        self.model.load_state_dict(payload["model"])
        if "optimizer" in payload:
            load_optimizer_state(self.optimizer, payload["optimizer"])
        # The gradients of a window that was open at the save, and how many
        # micro-steps it had taken.
        for g, saved in zip(self.train_step.grads,
                            payload.get("grad_accum", ())):
            g.copy_(saved)
        self.window = int(payload.get("grad_accum_window", 0))
        if "generator" in payload:
            self.generator.set_state(payload["generator"])
        self.step = int(payload.get("step", 0))
        return {k: v for k, v in payload.items()
                if k not in ("model", "optimizer", "step", "grad_accum",
                             "grad_accum_window", "grad_accum_steps",
                             "generator")}

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
            host_batch, self.generator)
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
            if pending is not None:
                self._consume_step_metrics(*pending)
            pending = (metrics, int(batch.get("gslot_overflow", 0)))
        if pending is not None:
            self._consume_step_metrics(*pending)
        # Per-epoch scheduler step.
        set_learning_rate(self.optimizer,
                          self.lr_schedule((epoch + 1) * self.steps_per_epoch))

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
        lp = self.cfg.TRAIN.LOG_PERIOD
        if epoch == 1 or (lp > 0 and epoch % lp == 0):
            self.logger.info("iter: %4d  %s  lr: %.2e", epoch,
                             str(self.train_metric_logger),
                             get_learning_rate(self.optimizer))
        if not self.output_dir:
            return
        rec = {"epoch": epoch, "lr": get_learning_rate(self.optimizer)}
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
        validate(self.cfg, self.run_eval_batch, self.val_dataloader,
                 self.val_metric_logger)
        return True

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
        extra = {f"{m}_{self.best_metric_name}": float(self.best_metric[m])
                 for m in self.modalities if self.best_metric[m] is not None}
        if self.accum_steps > 1:
            extra["grad_accum"] = [g.cpu() for g in self.train_step.grads]
            extra["grad_accum_window"] = self.window
        self.checkpointer.save(
            f"model{epoch:06d}",
            model={k: v.cpu() for k, v in self.model.state_dict().items()},
            optimizer=self.optimizer.state_dict(), step=self.step,
            epoch=epoch + 1, grad_accum_steps=self.accum_steps,
            generator=self.generator.get_state(), **extra)

    def train(self):
        try:
            for epoch in range(self.start_epoch,
                               int(self.cfg.SCHEDULER.MAX_EPOCH)):
                t0 = time.time()
                self.train_for_one_epoch(epoch)
                self.logger.info("Epoch %d took %.1fs", epoch,
                                 time.time() - t0)
                # As in the JAX trainer: the log line first, so epoch e's
                # carries the validation of an earlier epoch (none at 0).
                self.update_log(epoch)
                if self.validate_for_one_epoch(epoch):
                    self.update_validation_logging_meters(epoch)
                # As in the JAX trainer: a checkpoint on each new best epoch.
                if any(self.best_metric_epoch[m] == epoch
                       for m in self.modalities):
                    self.update_checkpoint(epoch)
        finally:
            self.close()
        return self.model

    def close(self):
        """Stop the loaders' worker pools (a later epoch starts them
        again)."""
        for loader in (self.train_dataloader, self.val_dataloader):
            if loader is not None:
                loader.close()
