"""Eval-time confusion-matrix Evaluator (a copy of
``fusiontransformer_tpu/data/utils/evaluate.py``; the tables are plain text,
written without ``tabulate``).

Keeps the reference's exact conventions, including the ``gt==0 ->
num_classes`` ignore trick (``evaluate.py:22``): ignored points fall outside
the label set passed to the confusion matrix and are dropped.
"""

from __future__ import annotations

import numpy as np


class Evaluator:
    def __init__(self, class_names, labels=None):
        self.class_names = tuple(class_names)
        self.num_classes = len(class_names)
        self.labels = (np.arange(self.num_classes) if labels is None
                       else np.array(labels))
        assert self.labels.shape[0] == self.num_classes
        self.confusion_matrix = np.zeros(
            (self.num_classes, self.num_classes), np.float64)

    def _cm(self, gt, pred):
        """sklearn-free confusion matrix over self.labels (rows gt, cols pred)."""
        lut = np.full(int(self.labels.max()) + 2, -1, np.int64)
        lut[self.labels] = np.arange(self.num_classes)
        gt = np.asarray(gt).ravel()
        pred = np.asarray(pred).ravel()
        gt_i = lut[np.clip(gt, 0, len(lut) - 1)]
        pr_i = lut[np.clip(pred, 0, len(lut) - 1)]
        m = (gt_i >= 0) & (pr_i >= 0) & (gt == np.clip(gt, 0, len(lut) - 1)) \
            & (pred == np.clip(pred, 0, len(lut) - 1))
        idx = gt_i[m] * self.num_classes + pr_i[m]
        return np.bincount(idx, minlength=self.num_classes ** 2).reshape(
            self.num_classes, self.num_classes)

    def update(self, pred_label, gt_label):
        gt_label = np.array(gt_label, copy=True)
        # Ignore class 0 by mapping it outside the label set.  The reference
        # maps to ``num_classes`` (evaluate.py:22), which for SemanticKITTI
        # raw-id labels collides with raw id 20 ("other-vehicle") and silently
        # counts ignored points as that class — a reference bug.  We map to -1
        # (guaranteed outside any label set) to implement the stated intent.
        gt_label[gt_label == 0] = -1
        self.confusion_matrix += self._cm(gt_label, pred_label)

    def batch_update(self, pred_labels, gt_labels):
        assert len(pred_labels) == len(gt_labels)
        for p, g in zip(pred_labels, gt_labels):
            self.update(p, g)

    @property
    def overall_acc(self):
        total = np.sum(self.confusion_matrix)
        return np.sum(np.diag(self.confusion_matrix)) / total if total else 0.0

    @property
    def overall_iou(self):
        class_iou = np.array(self.class_iou, np.float64)
        class_iou[np.isnan(class_iou)] = 0
        return float(np.mean(class_iou))

    @property
    def class_seg_acc(self):
        return [self.confusion_matrix[i, i] /
                max(np.sum(self.confusion_matrix[i]), 1e-12)
                for i in range(self.num_classes)]

    @property
    def class_iou(self):
        out = []
        for i in range(self.num_classes):
            tp = self.confusion_matrix[i, i]
            union = (self.confusion_matrix[:, i].sum()
                     + self.confusion_matrix[i, :].sum() - tp)
            out.append(float("nan") if union == 0 else tp / union)
        return out

    def print_table(self):
        """Per-class accuracy and IoU, one row per class (plain text)."""
        lines = [f"{'Class':<16}{'Accuracy':>10}{'IOU':>10}{'Total':>10}"]
        for i, (name, acc, iou) in enumerate(
                zip(self.class_names, self.class_seg_acc, self.class_iou)):
            lines.append(f"{name:<16}{acc * 100:>10.2f}{iou * 100:>10.2f}"
                         f"{int(self.confusion_matrix[i].sum()):>10d}")
        return "\n".join(lines)

    def save_table(self, filename):
        """Overall accuracy, overall IoU and each class's IoU as two
        tab-separated lines (names, then values to 5 decimals): the file the
        JAX package's ``save_table`` writes."""
        header = ("overall acc", "overall iou") + self.class_names
        values = [self.overall_acc, self.overall_iou] + self.class_iou
        with open(filename, "w") as f:
            f.write("\t".join(header) + "\n"
                    + "\t".join(f"{v:.5f}" for v in values))
