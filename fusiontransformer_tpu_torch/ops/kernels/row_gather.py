"""Row-gather probes: CUDA kernels (``csrc/row_gather.cu``) and their plain
PyTorch versions.

A bf16 feature table ``feats [R, C]`` is gathered by int32 row indices
``idx [n]``, as the sparse convs gather rows by their slot maps:

* T1 ``gather_blocks8``: output rows ``8i .. 8i+7`` are table rows
  ``8*(idx[i]//8) .. +7`` for ``i < n/8`` (``n % 8 == 0``), ``[n, C]``
  bf16.  Rows past the table's end are zero.
* T2 ``gather_rows_sum_pipelined`` and T3 ``gather_rows_sum_smem``:
  ``sum_i f32(feats[idx[i]])``, ``[1, C]`` float32; T2 streams the rows
  through a ring of asynchronous copies, T3 holds the whole table in the
  shared memory of a thread-block cluster (``smem_plan``).  Each is one
  launch a call (the blocks' sums are added in the same launch, in a fixed
  order, by the last block to take a ticket; each (device, stream) has a
  ticket of its own, ``ticket_slot``) and bitwise repeatable; ``grid_plan``
  cuts the indices.

Port of the three Pallas probes of ``tools/microbench_dma_gather.py``
(``mosaic_bs_gather``, ``dma_chain_gather``, ``vmem_dyn_gather``).  The TPU
leaves T1's rows past the table undefined and casts T2's table to f32 padded
to 128 lanes (a Mosaic DMA rule); here the rows are zero and the bf16 rows
are read as they are.  Both devices take the same arguments: ``C % 8 == 0``
for T1 and T2 (16-byte row chunks), ``C <= 2048`` for T2, and for T3 any C
of a table that the shared memory of a cluster of 16 blocks holds.

An index outside ``[0, R)`` raises ``IndexError``.  On the card the kernels
never read such a row and set a flag that the wrapper reads back when
``check`` is true (one synchronisation); with ``check=False`` the caller
promises valid indices, and an invalid one reads as a zero row.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES
from fusiontransformer_tpu_torch.ops.kernels.build import load

BLOCKS8 = "gather_blocks8"
PIPELINED = "gather_rows_sum_pipelined"
SMEM = "gather_rows_sum_smem"
# A block's dynamic shared memory on an H100 (227 KB); what T3 keeps there
# beside its rows (each ceil(C / 8) 16-byte chunks): the index tile, the
# copy of the last row, at least the block sum's scratch (512 threads), and
# for rows of more than 512 chunks (summed in column windows) the block sum;
# its cluster sizes (16 is a non-portable size).
SMEM_BYTES = 232448
INDEX_TILE_BYTES = 2048 * 4
T3_THREADS = 512
SUM_BYTES = 3 * 8 * T3_THREADS * 4
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# Tickets a card holds (the kernels' g_tickets), one per (device, stream).
TICKET_SLOTS = 1024
# The grid: T2 runs clusters of 8 blocks, two blocks an SM's worth of them;
# T3 as many clusters as fit on the card at once; a block takes at least
# MIN_SLICE indices.
PIPELINED_CLUSTER = 8
PIPELINED_BLOCKS_PER_SM = 2
MIN_SLICE = 1024


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


def smem_plan(rows: int, c: int) -> tuple[int, int]:
    """T3's cluster for a bf16 table ``[rows, c]``: ``(blocks, rows a
    block)``, the fewest blocks of ``CLUSTER_SIZES`` whose shared memory
    holds the table, row ``r`` in block ``r % blocks`` (the flagship's L0
    table, 17409 x 32, 1.11 MB: 8 blocks of 2177 rows; L2, 7809 x 128, 2.0
    MB: 16 of 489).  A row takes ``16 * ceil(c / 8)`` bytes."""
    chunks = -(-c // 8)
    room = (SMEM_BYTES - INDEX_TILE_BYTES - 16 * chunks
            - (32 * chunks if chunks > T3_THREADS else 0))
    for size in CLUSTER_SIZES:
        rpb = -(-rows // size)
        if max(rpb * 16 * chunks, SUM_BYTES) <= room:
            return size, rpb
    raise ValueError(f"a table of {rows} rows of {c} bf16 columns does not "
                     f"fit in the shared memory of a cluster of "
                     f"{CLUSTER_SIZES[-1]} blocks ({max(room, 0)} B a "
                     "block)")


def grid_plan(n: int, size: int, max_clusters: int) -> tuple[int, int]:
    """One launch's cut of ``n`` indices: ``(clusters, slice)``, clusters of
    ``size`` blocks, as many as give each block ``MIN_SLICE`` indices but at
    most ``max_clusters`` and at least one.  Block ``b`` takes indices
    ``[b * slice, (b + 1) * slice)`` of ``[0, n)``, in block order; ``slice``
    is a multiple of 4 (the index tile is read in 16-byte loads)."""
    clusters = max(1, min(max_clusters, -(-n // (MIN_SLICE * size))))
    per_block = -(-max(n, 1) // (clusters * size))
    return clusters, -(-per_block // 4) * 4


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
    if feats.device.type == "cuda":
        if not (feats.is_contiguous() and idx.is_contiguous()):
            raise ValueError("feats and idx must be contiguous")
        if feats.data_ptr() % 16:
            raise ValueError("feats must be 16-byte aligned")
    if kind == BLOCKS8 and idx.shape[0] % 8:
        raise ValueError(f"n = {idx.shape[0]} is not a multiple of 8")
    if (kind == BLOCKS8 and c % 8) or (kind == PIPELINED
                                       and (c % 8 or c > 2048)):
        raise ValueError(f"C = {c}: the kernel reads rows in 16-byte chunks "
                         "and needs C % 8 == 0" + (
                             " and C <= 2048" if kind == PIPELINED else ""))
    if kind == SMEM:
        smem_plan(r, c)


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


@functools.cache
def _smem_clusters(device_index, c, size, rpb):
    """T3's clusters that fit on card ``device_index`` at once (its
    occupancy, asked once per card and plan)."""
    fn = getattr(load("row_gather"), "ftx_gather_rows_sum_smem_clusters")
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(device_index):
        clusters = fn(c, size, rpb)
    if clusters <= 0:
        raise RuntimeError(f"{SMEM}: no cluster of {size} blocks of {rpb} "
                           f"rows x {c} columns fits on "
                           f"{torch.cuda.get_device_name(device_index)}")
    return clusters


_ticket_slots: dict[tuple[int, int], int] = {}
_next_slot = itertools.count()


def ticket_slot(device_index: int, stream: int) -> int:
    """The ticket of T2 / T3 calls on ``stream`` of card ``device_index``:
    calls on one stream run in turn, so they may share one; calls on two
    streams may overlap, so they get two.  A CUDA graph keeps the ticket of
    the stream it was captured on."""
    key = (device_index, stream)
    slot = _ticket_slots.get(key)
    if slot is None:
        slot = _ticket_slots.setdefault(key, next(_next_slot))
    if slot >= TICKET_SLOTS:
        raise RuntimeError(f"more than {TICKET_SLOTS} CUDA streams called "
                           "the row-gather sums")
    return slot


def _rows_sum(name, feats, idx, check, plan, max_clusters):
    """Launch T2 (``plan`` empty) or T3 (``plan`` = its cluster size and
    rows a block) over at most ``max_clusters`` clusters."""
    r, c = feats.shape
    n = idx.shape[0]
    clusters, slice_ = grid_plan(n, plan[0] if plan else PIPELINED_CLUSTER,
                                 max_clusters)
    partial = torch.empty((clusters, -(-c // 8) * 8), dtype=torch.float32,
                          device=feats.device)
    out = torch.empty((1, c), dtype=torch.float32, device=feats.device)
    fn = _fn(f"ftx_{name}", 4, 6 + len(plan))
    _launch(name, feats, idx, check, lambda err, s: fn(
        feats.data_ptr(), idx.data_ptr(), partial.data_ptr(), out.data_ptr(),
        r, c, *plan, n, clusters, slice_,
        ticket_slot(feats.device.index, s), err, s))
    return out


def gather_rows_sum_pipelined(feats, idx, check=True):
    """T2: ``[1, C]`` float32 (see the module docstring)."""
    _check(feats, idx, PIPELINED)
    if feats.device.type == "cpu":
        return gather_rows_sum_ref(feats, idx)
    sms = torch.cuda.get_device_properties(feats.device).multi_processor_count
    return _rows_sum(PIPELINED, feats, idx, check, (), max(
        1, sms * PIPELINED_BLOCKS_PER_SM // PIPELINED_CLUSTER))


def gather_rows_sum_smem(feats, idx, check=True):
    """T3: ``[1, C]`` float32 (see the module docstring)."""
    _check(feats, idx, SMEM)
    if feats.device.type == "cpu":
        return gather_rows_sum_ref(feats, idx)
    plan = smem_plan(*feats.shape)
    return _rows_sum(SMEM, feats, idx, check, plan, _smem_clusters(
        feats.device.index, feats.shape[1], *plan))
