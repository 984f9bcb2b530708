"""Training metrics (torch).

Port of ``confusion_matrix_from_logits``, ``SegAccuracy`` and ``SegIoU``
of ``fusiontransformer_tpu/models/metric.py``: the confusion matrix of one
step is computed on the device (argmax, then a count into a fixed number of
bins, class 0 ignored) and accumulated on the host in a numpy matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from fusiontransformer_tpu_torch.utils.metric_logger import AverageMeter


def confusion_matrix_from_logits(logits, labels, valid, num_classes: int,
                                 ignore_index: int = 0):
    """[C, C] int64 confusion matrix (rows = gt, cols = pred) of the valid
    points whose label is not ``ignore_index``.

    The counts go into C*C + 1 bins whose number is fixed by ``num_classes``
    (the last one takes the ignored points): ``torch.bincount`` would read
    the largest index back to size its output, a host sync that a CUDA-graph
    capture refuses."""
    pred = torch.argmax(logits, dim=-1)
    labels = labels.long()
    mask = valid & (labels != ignore_index)
    idx = torch.where(mask, labels * num_classes + pred,
                      num_classes * num_classes)
    counts = torch.zeros(num_classes * num_classes + 1, dtype=torch.int64,
                         device=idx.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts[:-1].reshape(num_classes, num_classes)


class SegAccuracy(AverageMeter):
    """Segmentation accuracy of host logits and labels, points labelled
    ``ignore_index`` left out (reference ``models/metric.py:5-23``)."""

    name = "seg_acc"

    def __init__(self, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def update_dict(self, preds, labels):
        pred = np.asarray(preds["seg_logit"]).argmax(-1)
        label = np.asarray(labels["seg_label"])
        mask = label != self.ignore_index
        self.update(float((pred[mask] == label[mask]).sum()), int(mask.sum()))


class SegIoU:
    """Confusion-matrix mean-IoU meter (class 0 ignored upstream)."""

    def __init__(self, num_classes, name="seg_iou"):
        self.num_classes = num_classes
        self.name = name
        self.mat = None

    def update_matrix(self, cm):
        if self.mat is None:
            self.mat = np.zeros((self.num_classes, self.num_classes),
                                np.int64)
        self.mat += np.asarray(cm, np.int64)

    def reset(self):
        self.mat = None

    @property
    def iou(self):
        h = self.mat.astype(np.float64)
        diag = np.diag(h)
        denom = h.sum(1) + h.sum(0) - diag
        with np.errstate(divide="ignore", invalid="ignore"):
            return diag / denom

    @property
    def global_avg(self):
        return float(np.nanmean(self.iou)) if self.mat is not None else 0.0

    @property
    def avg(self):
        return self.global_avg

    def __str__(self):
        return "{:.4f}".format(self.global_avg)

    @property
    def summary_str(self):
        return str(self)
