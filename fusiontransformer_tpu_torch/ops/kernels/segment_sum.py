"""Sorted-segment weighted sum: CUDA kernel (``csrc/segment_sum.cu``) and
its plain PyTorch version.

    T[u, e*C:(e+1)*C] = sum_{n: ids[n] == u} w[n, e] * g[n, :]

Port of ``fusiontransformer_tpu/ops/pallas/segment_sum.py``.  The point
stream is sorted: ids are nondecreasing over the whole array, gapless on
``[0, nvalid)``, and padding ids (>= ``num_out``) sit at the tail.  Rows no
point reaches come back 0.  Unless ``precise``, each product ``w * g`` is
rounded to bf16 before the f32 sum, as on the TPU.  The TPU wrapper pads N
to its block size and ``E*C`` to a multiple of 128 for Mosaic; the CUDA
kernel needs neither.
"""

from __future__ import annotations

import ctypes

import torch

from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES
from fusiontransformer_tpu_torch.ops.kernels.build import load

NAME = "sorted_segment_weighted_sum"


def sorted_segment_weighted_sum_ref(g, w, ids, num_out, precise=False):
    """Plain version: per-point products, then a sorted ``index_add``."""
    n, c = g.shape
    e = w.shape[1]
    contrib = (w.float()[:, :, None] * g.float()[:, None, :]).reshape(n, e * c)
    if not precise:
        contrib = contrib.to(torch.bfloat16).float()
    ids = ids.long().clamp(max=num_out)
    out = contrib.new_zeros((num_out + 1, e * c))
    out.index_add_(0, ids, contrib)
    return out[:num_out]


def _check(g, w, ids, num_out):
    if g.dim() != 2 or w.dim() != 2 or ids.dim() != 1:
        raise ValueError("expected g [N, C], w [N, E], ids [N]")
    n = g.shape[0]
    if w.shape[0] != n or ids.shape[0] != n:
        raise ValueError(f"row counts differ: g {tuple(g.shape)}, "
                         f"w {tuple(w.shape)}, ids {tuple(ids.shape)}")
    if num_out < 0:
        raise ValueError(f"num_out must be >= 0, got {num_out}")
    if not (g.device == w.device == ids.device):
        raise ValueError("g, w and ids must be on one device")


def sorted_segment_weighted_sum(g, w, ids, num_out: int, precise=False):
    """[num_out, E*C] float32 (see the module docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which needs g and w float32, ids int32, all contiguous.
    """
    _check(g, w, ids, num_out)
    if g.device.type == "cpu":
        return sorted_segment_weighted_sum_ref(g, w, ids, num_out, precise)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    if g.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"g and w must be float32, got {g.dtype}, {w.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if not (g.is_contiguous() and w.is_contiguous() and ids.is_contiguous()):
        raise ValueError("g, w and ids must be contiguous")
    n, c = g.shape
    e = w.shape[1]
    out = torch.empty((num_out, e * c), dtype=torch.float32, device=g.device)
    fn = load("segment_sum").ftx_sorted_segment_weighted_sum
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = fn(g.data_ptr(), w.data_ptr(), ids.data_ptr(), out.data_ptr(),
            n, c, e, num_out, int(bool(precise)), stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {rc}")
    LAUNCHES[NAME] += 1
    return out
