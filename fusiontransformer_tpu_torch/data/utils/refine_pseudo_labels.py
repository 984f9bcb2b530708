"""Pseudo-label refinement (reference ``data/utils/refine_pseudo_labels.py``;
a copy of ``fusiontransformer_tpu/data/utils/refine_pseudo_labels.py``).

Per class, labels whose confidence is below min(class median, 0.9) are set to
the ignore label.  Pure numpy (the reference used torch tensors for the same
arithmetic).
"""

from __future__ import annotations

import numpy as np


def refine_pseudo_labels(probs, pseudo_label, ignore_label=-100):
    probs = np.asarray(probs)
    pseudo_label = np.array(pseudo_label, copy=True)
    for cls_idx in np.unique(pseudo_label):
        curr_idx = np.nonzero(pseudo_label == cls_idx)[0]
        thresh = min(float(np.median(probs[curr_idx])), 0.9)
        ignore_idx = curr_idx[probs[curr_idx] < thresh]
        pseudo_label[ignore_idx] = ignore_label
    return pseudo_label
