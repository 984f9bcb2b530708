"""Row-gather probes: CUDA kernels (``csrc/row_gather.cu``) and their plain
PyTorch versions.

A bf16 feature table ``feats [R, C]`` is gathered by int32 row indices
``idx [n]``, as the sparse convs gather rows by their slot maps:

* T1 ``gather_blocks8``: output rows ``8i .. 8i+7`` are table rows
  ``8*(idx[i]//8) .. +7`` for ``i < n/8`` (``n % 8 == 0``), ``[n, C]``
  bf16.  Rows past the table's end are zero.
* T2 ``gather_rows_sum_pipelined`` and T3 ``gather_rows_sum_smem``:
  ``sum_i f32(feats[idx[i]])``, ``[1, C]`` float32; T2 streams the rows
  through a ring of asynchronous copies, T3 holds the table on chip (a
  column slice per block, ``smem_column_slice``).

Port of the three Pallas probes of ``tools/microbench_dma_gather.py``
(``mosaic_bs_gather``, ``dma_chain_gather``, ``vmem_dyn_gather``).  The TPU
leaves T1's rows past the table undefined and casts T2's table to f32 padded
to 128 lanes (a Mosaic DMA rule); here the rows are zero and the bf16 rows
are read as they are.  Both devices take the same arguments: ``C % 8 == 0``
for T1 and T2 (16-byte row chunks), ``C <= 2048`` for T2, and for T3 a
table whose narrowest column slice fits in a block's shared memory.

An index outside ``[0, R)`` raises ``IndexError``.  On the card the kernels
never read such a row and set a flag that the wrapper reads back when
``check`` is true (one synchronisation); with ``check=False`` the caller
promises valid indices, and an invalid one reads as a zero row.
"""

from __future__ import annotations

import ctypes

import torch

from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES
from fusiontransformer_tpu_torch.ops.kernels.build import load

BLOCKS8 = "gather_blocks8"
PIPELINED = "gather_rows_sum_pipelined"
SMEM = "gather_rows_sum_smem"
# A block's dynamic shared memory on an H100 (227 KB) and T3's threads.
SMEM_BYTES = 232448
_THREADS = 256
# T2/T3 run at most this many blocks (two per H100 SM), each writing one
# row of f32 partial sums that a second pass adds in block order.
MAX_BLOCKS = 264


def _check_indices(feats, idx):
    if not idx.numel():
        return
    lo, hi = int(idx.min()), int(idx.max())
    if lo < 0 or hi >= feats.shape[0]:
        raise IndexError(f"row index out of [0, {feats.shape[0]}): min {lo}, "
                         f"max {hi}")


def gather_blocks8_ref(feats, idx):
    """Plain T1: index_select of 8-row blocks of the table padded with zero
    rows to a multiple of 8."""
    _check_indices(feats, idx[:idx.shape[0] // 8])
    r, c = feats.shape
    pad = feats.new_zeros(((-r) % 8, c))
    blocks = torch.cat([feats, pad]).view(-1, 8, c)
    groups = idx[:idx.shape[0] // 8].long() // 8
    return blocks.index_select(0, groups).reshape(-1, c)


def gather_rows_sum_ref(feats, idx):
    """Plain T2/T3: the gathered rows summed in f32."""
    _check_indices(feats, idx)
    return feats.index_select(0, idx.long()).float().sum(0, keepdim=True)


def smem_column_slice(rows: int, c: int) -> int:
    """T3's columns per block: the widest of 8, 4, 2, 1 dividing ``c`` whose
    ``[rows, slice]`` bf16 table fits in a block's shared memory."""
    for cs in (8, 4, 2, 1):
        need = max(rows * cs * 2, _THREADS * cs * 4)
        if c % cs == 0 and need <= SMEM_BYTES:
            return cs
    raise ValueError(f"a table of {rows} rows does not fit in one block's "
                     f"shared memory ({SMEM_BYTES} B) even one column wide")


def _check(feats, idx, kind):
    if feats.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected feats [R, C] and idx [n], got "
                         f"{tuple(feats.shape)} and {tuple(idx.shape)}")
    if feats.dtype != torch.bfloat16:
        raise TypeError(f"feats must be bfloat16, got {feats.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if feats.device != idx.device:
        raise ValueError(f"feats on {feats.device}, idx on {idx.device}")
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feats.device}")
    r, c = feats.shape
    if r == 0:
        raise ValueError("the table has no rows")
    if kind == BLOCKS8 and idx.shape[0] % 8:
        raise ValueError(f"n = {idx.shape[0]} is not a multiple of 8")
    if kind in (BLOCKS8, PIPELINED) and (c % 8 or c > 2048):
        raise ValueError(f"C = {c}: the kernel reads rows in 16-byte chunks "
                         "and needs C % 8 == 0 and C <= 2048")
    if kind == SMEM:
        smem_column_slice(r, c)
    if feats.device.type == "cuda":
        if not (feats.is_contiguous() and idx.is_contiguous()):
            raise ValueError("feats and idx must be contiguous")
        if feats.data_ptr() % 16:
            raise ValueError("feats must be 16-byte aligned")


def _fn(symbol, nargs_ptr, nargs_int):
    fn = getattr(load("row_gather"), symbol)
    fn.argtypes = ([ctypes.c_void_p] * nargs_ptr + [ctypes.c_int] * nargs_int
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name, feats, idx, check, call):
    """Run ``call(err_ptr, stream)``, count the launch, read the flag."""
    err = (torch.zeros(1, dtype=torch.int32, device=feats.device)
           if check else None)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    rc = call(0 if err is None else err.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    if err is not None and int(err.item()):
        raise IndexError(f"{name}: a row index is outside [0, "
                         f"{feats.shape[0]})")


def gather_blocks8(feats, idx, check=True):
    """T1: ``[n, C]`` bf16 (see the module docstring)."""
    _check(feats, idx, BLOCKS8)
    if feats.device.type == "cpu":
        return gather_blocks8_ref(feats, idx)
    r, c = feats.shape
    n = idx.shape[0]
    out = torch.empty((n, c), dtype=feats.dtype, device=feats.device)
    fn = _fn("ftx_gather_blocks8", 3, 3)
    _launch(BLOCKS8, feats, idx, check, lambda err, s: fn(
        feats.data_ptr(), idx.data_ptr(), out.data_ptr(), r, c, n, err, s))
    return out


def gather_rows_sum_pipelined(feats, idx, check=True):
    """T2: ``[1, C]`` float32 (see the module docstring)."""
    _check(feats, idx, PIPELINED)
    if feats.device.type == "cpu":
        return gather_rows_sum_ref(feats, idx)
    r, c = feats.shape
    n = idx.shape[0]
    partial = torch.empty((MAX_BLOCKS, c), dtype=torch.float32,
                          device=feats.device)
    out = torch.empty((1, c), dtype=torch.float32, device=feats.device)
    fn = _fn("ftx_gather_rows_sum_pipelined", 4, 4)
    _launch(PIPELINED, feats, idx, check, lambda err, s: fn(
        feats.data_ptr(), idx.data_ptr(), partial.data_ptr(), out.data_ptr(),
        r, c, n, MAX_BLOCKS, err, s))
    return out


def gather_rows_sum_smem(feats, idx, check=True):
    """T3: ``[1, C]`` float32 (see the module docstring)."""
    _check(feats, idx, SMEM)
    if feats.device.type == "cpu":
        return gather_rows_sum_ref(feats, idx)
    r, c = feats.shape
    n = idx.shape[0]
    partial = torch.empty((MAX_BLOCKS, c), dtype=torch.float32,
                          device=feats.device)
    out = torch.empty((1, c), dtype=torch.float32, device=feats.device)
    fn = _fn("ftx_gather_rows_sum_smem", 4, 5)
    _launch(SMEM, feats, idx, check, lambda err, s: fn(
        feats.data_ptr(), idx.data_ptr(), partial.data_ptr(), out.data_ptr(),
        r, c, smem_column_slice(r, c), n, MAX_BLOCKS, err, s))
    return out
