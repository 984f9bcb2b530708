"""3D augmentation and meter->voxel scaling (a copy of
``fusiontransformer_tpu/data/utils/augmentation_3d.py``).

Host-side numpy: noisy rotation matrix, axis flips (x for nuScenes, y for
KITTI), z rotation, scale by 1/voxel-size, shift to the positive octant,
optional random translation inside the receptive field.  The training split
turns the augmentations on; the draws come from ``rng`` (numpy's global
generator when None), in the JAX package's order.
"""

from __future__ import annotations

import numpy as np


def augment_and_scale_3d(points, scale, full_scale=None, noisy_rot=0.0,
                         flip_x=0.0, flip_y=0.0, rot_z=0.0, transl=False,
                         rng=None):
    rng = rng or np.random
    if noisy_rot > 0 or flip_x > 0 or flip_y > 0 or rot_z > 0:
        rot = np.eye(3, dtype=np.float32)
        if noisy_rot > 0:
            rot += rng.randn(3, 3) * noisy_rot
        if flip_x > 0:
            rot[0][0] *= rng.randint(0, 2) * 2 - 1
        if flip_y > 0:
            rot[1][1] *= rng.randint(0, 2) * 2 - 1
        if rot_z > 0:
            theta = rng.rand() * rot_z
            zrot = np.array([[np.cos(theta), -np.sin(theta), 0],
                             [np.sin(theta), np.cos(theta), 0],
                             [0, 0, 1]], dtype=np.float32)
            rot = rot.dot(zrot)
        points = points.dot(rot)

    coords = points * scale
    coords = coords - coords.min(0)

    if transl:
        offset = np.clip(full_scale - coords.max(0) - 0.001,
                         a_min=0, a_max=None) * rng.rand(3)
        coords = coords + offset

    return coords
