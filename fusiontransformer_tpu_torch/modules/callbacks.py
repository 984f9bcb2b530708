"""Epoch and step callbacks (port of
``fusiontransformer_tpu/modules/callbacks.py``, the reference's
``modules/TorchpackCallbacks.py``).

They take numpy arrays: the cross-rank sums of their counters happen
before them (the train step's summed confusion matrices, the validation's
``cm_allreduce``), where the reference called ``dist.allreduce`` in each
callback.

* ``MeanIoU`` — per-class seen / correct / positive counters and the table;
* ``IoUEval`` / ``AccEval`` — confusion-matrix accumulators;
* ``TFEventWriterExtended`` — per-epoch scalars and, with
  ``TRAIN.LOG_HISTOGRAM``, histograms of a model's parameters by name
  (``write_histograms`` of ``named_parameters()``: the JAX package walks
  tree paths); it raises where ``torch.utils.tensorboard`` cannot be
  imported, as the trainer does;
* ``SummaryExtended`` — scalar forwarding.

The best-IoU saver, the restore of the best checkpoint and the prediction
dumps need the trainer's state and are ``modules/DistributedTrainer.py``'s.
"""

from __future__ import annotations

import numpy as np


class Callback:
    def before_epoch(self):
        pass

    def after_step(self, output_dict):
        pass

    def after_epoch(self):
        pass


class MeanIoU(Callback):
    """Per-class seen / correct / positive mIoU (reference ``:25-121``)."""

    def __init__(self, num_classes, ignore_label, class_names=None,
                 name="iou"):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.name = name
        if class_names is None:
            from fusiontransformer_tpu_torch.data.semantic_kitti.labels import \
                class_names as kitti_names
            class_names = kitti_names()
        self.class_names = class_names
        self.before_epoch()

    def before_epoch(self):
        self.total_seen = np.zeros(self.num_classes)
        self.total_correct = np.zeros(self.num_classes)
        self.total_positive = np.zeros(self.num_classes)

    def after_step(self, output_dict):
        outputs = np.asarray(output_dict["outputs"]).ravel()
        targets = np.asarray(output_dict["targets"]).ravel()
        keep = targets != self.ignore_label
        outputs, targets = outputs[keep], targets[keep]
        seen = np.bincount(targets, minlength=self.num_classes)
        pos = np.bincount(outputs, minlength=self.num_classes)
        corr = np.bincount(targets[outputs == targets],
                           minlength=self.num_classes)
        self.total_seen += seen[:self.num_classes]
        self.total_positive += pos[:self.num_classes]
        self.total_correct += corr[:self.num_classes]

    def update_confusion(self, cm):
        """Accumulate from a [C, C] confusion matrix (summed over ranks)."""
        cm = np.asarray(cm, np.float64)
        self.total_seen += cm.sum(1)
        self.total_positive += cm.sum(0)
        self.total_correct += np.diag(cm)

    @property
    def ious(self):
        out = []
        for i in range(self.num_classes):
            if self.total_seen[i] == 0:
                out.append(0.0)
            else:
                union = (self.total_seen[i] + self.total_positive[i]
                         - self.total_correct[i])
                out.append(float(self.total_correct[i] / union))
        return out

    @property
    def miou(self):
        return float(np.mean(self.ious))

    def after_epoch(self):
        self.print_table(self.ious)
        return self.miou

    def print_table(self, ious):
        from tabulate import tabulate
        table = [["MIoU", float(np.mean(ious))]]
        for name, iou in zip(self.class_names, ious):
            table.append([name, iou])
        print(tabulate(table, headers=["Class", "IOU"], tablefmt="psql",
                       floatfmt=".3f"))


class _ConfusionEval(Callback):
    """Confusion-matrix accumulator (reference InternalEval ``:129-223``)."""

    def __init__(self, n_classes, ignore_label=0, name="eval"):
        self.n_classes = n_classes
        self.ignore_label = ignore_label
        self.name = name
        self.before_epoch()

    def before_epoch(self):
        self.conf_matrix = np.zeros((self.n_classes, self.n_classes),
                                    np.int64)

    def after_step(self, output_dict):
        x = np.asarray(output_dict["outputs"]).ravel()
        y = np.asarray(output_dict["targets"]).ravel()
        idx = y * self.n_classes + x
        self.conf_matrix += np.bincount(
            idx, minlength=self.n_classes ** 2).reshape(self.n_classes,
                                                        self.n_classes)

    def _stats(self):
        conf = self.conf_matrix.astype(np.float64).copy()
        conf[self.ignore_label] = 0
        conf[:, self.ignore_label] = 0
        tp = np.diag(conf)
        fp = conf.sum(0) - tp
        fn = conf.sum(1) - tp
        return tp, fp, fn


class IoUEval(_ConfusionEval):
    def after_epoch(self):
        tp, fp, fn = self._stats()
        intersection = tp
        union = np.maximum(tp + fp + fn, 1e-15)
        iou = intersection / union
        present = np.ones(self.n_classes, bool)
        present[self.ignore_label] = False
        return float(iou[present].mean()), iou


class AccEval(_ConfusionEval):
    def after_epoch(self):
        tp, fp, fn = self._stats()
        total = np.maximum(tp.sum() + fp.sum(), 1e-15)
        return float(tp.sum() / total)


class TFEventWriterExtended(Callback):
    """Per-epoch TensorBoard scalars, and with ``log_histogram`` weight (and
    gradient) histograms by parameter name (``:277-304``)."""

    def __init__(self, log_dir, log_histogram=False):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                f"TFEventWriterExtended needs the tensorboard package "
                f"(torch.utils.tensorboard): {e}") from e
        self.writer = SummaryWriter(str(log_dir))
        self.log_histogram = log_histogram
        self.epoch = 0

    def add_scalar(self, name, value, step=None):
        self.writer.add_scalar(name, value,
                               step if step is not None else self.epoch)

    def write_scalars(self, scalars, step=None):
        for k, v in scalars.items():
            self.add_scalar(k, float(v), step)

    def write_histograms(self, named_tensors, prefix="params", step=None):
        """One histogram per ``(name, tensor)`` (a module's
        ``named_parameters()``, or its gradients by name), under
        ``prefix/<name with '.' as '/'>``."""
        if not self.log_histogram:
            return
        for name, t in named_tensors:
            self.writer.add_histogram(
                prefix + "/" + name.replace(".", "/"),
                t.detach().float().cpu().numpy().ravel(),
                step if step is not None else self.epoch)

    def after_epoch(self):
        self.epoch += 1
        self.writer.flush()


class SummaryExtended(Callback):
    """Scalar forwarding shim (reference ``:307-316``)."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, name, value):
        self.scalars.setdefault(name, []).append(float(value))
