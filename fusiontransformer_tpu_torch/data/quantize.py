"""Host-side voxel quantization (torchsparse ``sparse_quantize`` equivalent).

``sparse_quantize`` runs the port's native C++ sort-unique
(``native.quantize``), as ``fusiontransformer_tpu/data/quantize.py`` runs
the JAX package's; ``sparse_quantize_ref`` is its numpy version, the plain
reference the tests hold it against.  Both return the same arrays: voxels
in lexicographic order, each represented by its first point.
"""

from __future__ import annotations

import numpy as np

from fusiontransformer_tpu_torch import native


def sparse_quantize(coords: np.ndarray):
    """Args: int voxel coords [N, 3] in [0, 2^20) (others raise).
    Returns (unique_idx [U], inverse [N]) int64."""
    return native.quantize(coords)


def sparse_quantize_ref(coords: np.ndarray):
    """The numpy version of ``sparse_quantize`` (stable lexicographic
    sort-unique)."""
    _, unique_idx, inverse = np.unique(
        coords, axis=0, return_index=True, return_inverse=True)
    return unique_idx.astype(np.int64), inverse.reshape(-1).astype(np.int64)
