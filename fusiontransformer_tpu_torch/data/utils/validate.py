"""Devoxelization of per-voxel predictions back to raw points.

``map_sparse_to_org`` of ``fusiontransformer_tpu/data/utils/validate.py``; the
validation loop itself belongs to the training slice.
"""

from __future__ import annotations

import numpy as np


def map_sparse_to_org(x, inverse_map):
    """Devoxelize per-voxel values back to original points.

    Voxels beyond ``len(x)`` were dropped by the static point capacity; their
    points get class 0, the ignore id, and are counted.
    """
    oob = inverse_map >= len(x)
    n_oob = int(oob.sum())
    if n_oob:
        out = x[np.where(oob, 0, inverse_map)]
        out[oob] = 0
        return out, n_oob
    return x[inverse_map], 0
