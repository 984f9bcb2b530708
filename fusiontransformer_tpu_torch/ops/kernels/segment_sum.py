"""Sorted-segment weighted sum: CUDA kernel (``csrc/segment_sum.cu``) and
its plain PyTorch version.

    T[u, e*C:(e+1)*C] = sum_{n: ids[n] == u} w[n, e] * g[n, :]

Port of ``fusiontransformer_tpu/ops/pallas/segment_sum.py``.  The point
stream is sorted: ids are nondecreasing over the whole array, gapless on
``[0, nvalid)``, and padding ids (>= ``num_out``) sit at the tail.  Rows no
point reaches come back 0.  Unless ``precise``, each product ``w * g`` is
rounded to bf16 before the f32 sum, as on the TPU.  The TPU wrapper pads N
to its block size and ``E*C`` to a multiple of 128 for Mosaic; the CUDA
kernel needs neither.  It splits the point stream into chunks of
``points_per_chunk`` points, which the blocks of one cooperative launch
take in turn; a row that crosses a chunk's edge is summed in pieces that
the same launch adds in chunk order after a grid barrier, so the result is
the same bits on every launch (design in ``csrc/segment_sum.cu``).  The
wrapper reaches its plain version or its launch through the custom op
``torch.ops.ftx.sorted_segment_weighted_sum``.
"""

from __future__ import annotations

import ctypes
import functools

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
    # The op's fake kernel would answer on another device (meta).
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {g.device}")
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
    """[num_out, E*C] float32 (see the module docstring), through the op
    ``torch.ops.ftx.sorted_segment_weighted_sum``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which needs g and w float32, ids int32, all contiguous.
    """
    _check(g, w, ids, num_out)
    return torch.ops.ftx.sorted_segment_weighted_sum(g, w, ids, int(num_out),
                                                     bool(precise))


def _launch(g, w, ids, num_out, precise):
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
    chunk = points_per_chunk(n)
    nchunks = -(-n // chunk)
    # Header (the live row count) and each chunk's share of a row begun in
    # an earlier chunk.
    scratch = torch.empty(4 + nchunks * e * c, dtype=torch.float32,
                          device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = _kernel()(g.data_ptr(), w.data_ptr(), ids.data_ptr(),
                   out.data_ptr(), scratch.data_ptr(), n, c, e, num_out,
                   chunk, int(precise), stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {rc}")
    LAUNCHES[launch_name(e)] += 1
    return out


# The custom op: the plain version on the CPU (its result a copy of its
# own, not a view of the sums' padded buffer), the launch on the card, and
# the result's shape for ``torch.export``'s fake tensors.  The scratch
# buffer is allocated inside; no input is written.
_op = torch.library.custom_op(
    f"ftx::{NAME}",
    lambda g, w, ids, num_out, precise: sorted_segment_weighted_sum_ref(
        g, w, ids, num_out, precise).clone(),
    mutates_args=(), device_types="cpu",
    schema="(Tensor g, Tensor w, Tensor ids, int num_out, bool precise) "
           "-> Tensor")
_op.register_kernel("cuda")(_launch)
_op.register_fake(lambda g, w, ids, num_out, precise: g.new_empty(
    (num_out, w.shape[1] * g.shape[1]), dtype=torch.float32))


@functools.cache
def _kernel():
    fn = load("segment_sum").ftx_sorted_segment_weighted_sum
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def points_per_chunk(n: int) -> int:
    """Points each block of the kernel owns: a power of two in [32, 128],
    about n / 1024, so that a batch-1 stream (~20k points) still spreads over
    ~600 blocks and a batch-10 one (~200k) keeps its blocks long."""
    return max(32, min(128, 1 << max(n // 1024, 1).bit_length() - 1))


def launch_name(e: int) -> str:
    """The ``LAUNCHES`` key of a launch with E weight columns: the E=1 use
    (``voxelize_mean``) and the E=8 use (the devoxelize adjoint) are counted
    apart."""
    return NAME if e == 1 else f"{NAME}[E={e}]"
