"""Losses of the train step (torch).

Port of ``weighted_cross_entropy`` and ``kl_divergence`` of
``fusiontransformer_tpu/models/losses.py``.  Both are padding-aware: a
``valid`` mask selects live points.  The weighted CE keeps torch's
``F.cross_entropy(weight=...)`` normalisation (weighted sum over the sum of
the per-point weights); the KL teacher is detached.
"""

from __future__ import annotations

import torch


def weighted_cross_entropy(logits, labels, valid, class_weights=None):
    """sum_i w[y_i] * ce_i / sum_i w[y_i] over the valid points (w = 1
    without class weights)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    per = -logp.gather(1, labels[:, None])[:, 0]
    m = valid.float()
    w = class_weights[labels] * m if class_weights is not None else m
    return (per * w).sum() / w.sum().clamp(min=1e-12)


def kl_divergence(student_logits, teacher_logits, valid):
    """``F.kl_div(log_softmax(s), softmax(t.detach())).sum(1)``, averaged
    over the valid points."""
    logp = torch.log_softmax(student_logits.float(), dim=-1)
    t = teacher_logits.detach().float()
    per = (torch.softmax(t, -1) * (torch.log_softmax(t, -1) - logp)).sum(-1)
    m = valid.float()
    return (per * m).sum() / m.sum().clamp(min=1.0)
