"""Host-side voxel quantization (torchsparse ``sparse_quantize`` equivalent).

The numpy path of ``fusiontransformer_tpu/data/quantize.py``: a stable
lexicographic sort-unique, so the representative of each voxel is its first
point, as in the JAX package's native C++ build.
"""

from __future__ import annotations

import numpy as np


def sparse_quantize(coords: np.ndarray):
    """Args: int voxel coords [N, 3].  Returns (unique_idx [U], inverse [N])."""
    _, unique_idx, inverse = np.unique(
        coords, axis=0, return_index=True, return_inverse=True)
    return unique_idx.astype(np.int64), inverse.reshape(-1).astype(np.int64)
