"""Meter->voxel scaling of a scan (reference ``data/utils/augmentation_3d.py``).

The eval path of ``fusiontransformer_tpu/data/utils/augmentation_3d.py``:
no rotation, flip or translation (those are training-time augmentations
and arrive with the training slice).  Scale by 1/voxel-size and shift to
the positive octant.
"""

from __future__ import annotations


def augment_and_scale_3d(points, scale):
    coords = points * scale
    return coords - coords.min(0)
