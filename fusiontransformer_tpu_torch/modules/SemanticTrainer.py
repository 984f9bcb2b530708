"""Epoch trainer for one device (torch).

Port of ``fusiontransformer_tpu/modules/SemanticTrainer.py``: build the model
(random weights from ``RNG_SEED``) and the train/val loaders, the optimizer
and per-epoch LR schedule, the checkpointer (auto-resume); then per epoch:
train (one ``make_train_step`` call per batch, capacities sized per batch
from its voxel counts when ``TPU.ADAPTIVE_LEVEL_CAPS`` is on), log,
validate (2D, 3D and the 2D+3D softmax-sum ensemble), track the best metric
and checkpoint on it.  A non-finite loss stops the run with
``FloatingPointError``.  Metrics are read one step late, so the host
queues the next step before it waits for the card.

Runs on the card unless it is given ``device="cpu"``; with no CUDA device
and no explicit CPU it raises.  ``MODEL.IMAGE_PRETRAINED_PATH`` loads a
DeiT / SimCLR checkpoint into the ViT (``utils/torch_checkpoint.py``).  Not
ported (ROADMAP.md, Queue 1): wandb and TensorBoard, gradient histograms
(``make_grads_fn``), asynchronous checkpoints, the preemption handler, and
more than one device; the keys that would ask for them raise
(``check_ported_keys``).
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
from fusiontransformer_tpu_torch.modules.steps import (batch_level_caps,
                                                       device_batch,
                                                       make_eval_step,
                                                       make_train_step)
from fusiontransformer_tpu_torch.solver.build import (build_optimizer,
                                                      get_learning_rate,
                                                      set_learning_rate)
from fusiontransformer_tpu_torch.utils.checkpoint import Checkpointer
from fusiontransformer_tpu_torch.utils.device import resolve_device
from fusiontransformer_tpu_torch.utils.metric_logger import MetricLogger
from fusiontransformer_tpu_torch.utils.torch_checkpoint import (
    load_pretrained_image)

MODALITIES = ("2d", "3d")
# Keys the port does not honour yet, the test that a key is set away from
# its default, and the ROADMAP.md item that will port it.
UNPORTED_KEYS = (
    ("TRAIN.SUMMARY_PERIOD", lambda v: v > 0,
     "Queue 1 item 6 (TensorBoard scalars)"),
    ("TRAIN.LOG_HISTOGRAM", bool,
     "Queue 1 item 6 (weight/grad histograms)"),
    ("TPU.NUM_DEVICES", lambda v: v > 1, "Queue 1 item 9 (data parallelism)"),
    ("TPU.MODEL_PARALLEL", lambda v: v > 1,
     "Queue 1 item 10 (tensor parallelism)"),
    ("TPU.ZERO_OPTIMIZER", bool, "Queue 1 item 10 (ZeRO)"),
)


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


class SemanticTrainer:
    def __init__(self, cfg, output_dir="", run_name="", device=None):
        check_ported_keys(cfg)
        self.cfg = cfg
        self.output_dir = output_dir
        self.run_name = run_name
        self.device = resolve_device(device)
        self.logger = logging.getLogger(
            f"FusionTransformer.{cfg.MODEL.TYPE}.train")

        self.model = build_model(cfg, self.device, seed=cfg.RNG_SEED)
        if cfg.MODEL.IMAGE_PRETRAINED_PATH:
            self.logger.info("Loaded %d pretrained image tensors from %s",
                             load_pretrained_image(cfg, self.model),
                             cfg.MODEL.IMAGE_PRETRAINED_PATH)
        n = cfg.MODEL.NUM_CLASSES
        self.train_3d_metric = SegIoU(n, name="seg_iou_3d")
        self.train_2d_metric = SegIoU(n, name="seg_iou_2d")
        self.train_dataloader = build_dataloader(cfg, mode="train")
        self.val_dataloader = (build_dataloader(cfg, mode="val")
                               if cfg.VAL.PERIOD > 0 else None)
        self.steps_per_epoch = max(1, len(self.train_dataloader))
        self.optimizer, self.lr_schedule = build_optimizer(
            cfg, self.model.parameters(), self.steps_per_epoch)
        self.logger.info("#Parameters: %.2e",
                         sum(p.numel() for p in self.model.parameters()))
        self.train_step = make_train_step(cfg, self.model, self.optimizer)
        self.eval_step = make_eval_step(cfg, self.model)
        self.adaptive_caps = bool(cfg.TPU.ADAPTIVE_LEVEL_CAPS)
        # Dropout's random stream: one generator on the device, seeded from
        # RNG_SEED, advanced by every train step.
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(cfg.RNG_SEED))
        self.step = 0

        self.checkpointer = Checkpointer(output_dir, self.logger,
                                         cfg.TRAIN.MAX_TO_KEEP)
        self.checkpoint_data = self._load_checkpoint()
        self.start_epoch = int(self.checkpoint_data.get("epoch", 0))
        self.best_metric_name = f"best_{cfg.VAL.METRIC}"
        self.best_metric = {m: self.checkpoint_data.get(
            f"{m}_{self.best_metric_name}") for m in MODALITIES}
        self.best_metric_epoch = {m: -1 for m in MODALITIES}

        self.train_metric_logger = MetricLogger(delimiter="  ")
        self.train_metric_logger.add_meters([self.train_3d_metric,
                                             self.train_2d_metric])
        self.val_metric_logger = MetricLogger(delimiter="  ")

    # ------------------------------------------------------------------ #
    def _load_checkpoint(self):
        payload = self.checkpointer.load(self.cfg.RESUME_PATH,
                                         resume=self.cfg.AUTO_RESUME,
                                         resume_states=self.cfg.RESUME_STATES)
        if not payload:
            return {}
        self.model.load_state_dict(payload["model"])
        if "optimizer" in payload:
            self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload.get("step", 0))
        return {k: v for k, v in payload.items()
                if k not in ("model", "optimizer", "step")}

    def level_caps(self, host_batch):
        """The batch's voxel capacities (None: sized from its buffer)."""
        if not self.adaptive_caps:
            return None
        return batch_level_caps(self.cfg, host_batch)

    def run_train_step(self, host_batch):
        """One train step on a collated host batch; device metrics."""
        metrics = self.train_step(device_batch(host_batch, self.device),
                                  self.generator, self.level_caps(host_batch))
        self.step += 1
        return metrics

    def train_for_one_epoch(self, epoch):
        self.train_metric_logger.reset()
        self.train_3d_metric.reset()
        self.train_2d_metric.reset()
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

    def _consume_step_metrics(self, metrics, slot_overflow):
        host = {k: v.item() for k, v in metrics.items()
                if not k.startswith("cm_")}
        if not math.isfinite(host["total_loss"]):
            raise FloatingPointError(
                f"non-finite loss at step {self.step}: {host}")
        host["slot_overflow"] = slot_overflow
        if host["voxel_overflow"] > 0 or slot_overflow > 0:
            self.logger.warning(
                "capacity overflow: %d voxels and %d conv slots dropped this "
                "step — raise TPU.LEVEL_CAPACITY_FRACTIONS",
                int(host["voxel_overflow"]), slot_overflow)
        if host.get("tap_overflow", 0) > 0:
            self.logger.warning(
                "conv tap-slot overflow: %d live taps dropped this step — "
                "gradients of the binned conv are inconsistent with its "
                "forward under overflow; raise TPU.CONV_TAP_SLOTS",
                int(host["tap_overflow"]))
        self.train_metric_logger.update(**host)
        self.train_3d_metric.update_matrix(metrics["cm_3d"].cpu().numpy())
        self.train_2d_metric.update_matrix(metrics["cm_2d"].cpu().numpy())

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
    def run_eval_batch(self, host_batch):
        return self.eval_step(device_batch(host_batch, self.device),
                              self.level_caps(host_batch))

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
        for m in MODALITIES:
            name = f"{self.cfg.VAL.METRIC}_{m}"
            if name in self.val_metric_logger.meters:
                cur = self.val_metric_logger.meters[name].global_avg
                if self.best_metric[m] is None or self.best_metric[m] < cur:
                    self.best_metric[m] = cur
                    self.best_metric_epoch[m] = epoch

    def update_checkpoint(self, epoch):
        """Checkpoint after ``epoch``; its ``epoch`` field is the next epoch
        to run, so a resumed run continues after it."""
        extra = {f"{m}_{self.best_metric_name}": float(self.best_metric[m])
                 for m in MODALITIES if self.best_metric[m] is not None}
        self.checkpointer.save(
            f"model{epoch:06d}",
            model={k: v.cpu() for k, v in self.model.state_dict().items()},
            optimizer=self.optimizer.state_dict(), step=self.step,
            epoch=epoch + 1, **extra)

    def train(self):
        for epoch in range(self.start_epoch, int(self.cfg.SCHEDULER.MAX_EPOCH)):
            t0 = time.time()
            self.train_for_one_epoch(epoch)
            self.logger.info("Epoch %d took %.1fs", epoch, time.time() - t0)
            if self.validate_for_one_epoch(epoch):
                self.update_validation_logging_meters(epoch)
            self.update_log(epoch)
            # As in the JAX trainer: a checkpoint on each new best epoch.
            if any(self.best_metric_epoch[m] == epoch for m in MODALITIES):
                self.update_checkpoint(epoch)
        return self.model
