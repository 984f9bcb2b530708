"""Binned submanifold conv, forward and backward: CUDA kernels
(``csrc/binned_conv.cu``) and their plain PyTorch versions.

    out[v] = sum_t feats[nbr(v, t)] @ w[t]      (over the live taps the maps
                                                 hold)

Port of ``binned_conv_fwd`` / ``binned_conv_bwd`` in
``fusiontransformer_tpu/ops/pallas/binned_conv.py`` together with the row
gathers their callers run first, for both kinds of slot map:

* group-pooled maps, K1 / K2 (``grouped=True``; the JAX package's
  ``sparse_conv._subm3gp_impl`` / ``_subm3gp_bwd``): slot j of 8-voxel group
  g carries a source row ``src_pack[g, j]`` (sentinel ``V``) and a bin id
  ``bin_pack[g, j] = t*8 + vo`` (sentinel >= 216), at most one slot per bin;
* per-voxel K-slot maps, K1' / K2' (``grouped=False``; ``_subm3p_impl`` /
  ``_subm3p_bwd``): ``src[v, k]`` (sentinel ``V``) and ``tap[v, k]``
  (sentinel 27), each voxel's live taps distinct, as
  ``ops.hierarchy.tap_slot_maps`` builds them.  The kernels read these maps
  themselves as the grouped layout ``[V/8, 8K]``.

``w`` is ``[27, Cin, Cout]`` in the JAX tap order (x-slowest).  Operands are
bf16 (the production path) or f32; products and sums are f32; the results
are float32.  The backward's dW routes on the operand dtype
(``dw_schedule``): bf16 on the tensor cores, f32 (the precise path) on the
CUDA cores.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES
from fusiontransformer_tpu_torch.ops.kernels.build import load

NAME = "binned_conv_grouped_fwd"
BWD_NAME = "binned_conv_grouped_bwd"
SLOTS_NAME = "binned_conv_slots_fwd"
SLOTS_BWD_NAME = "binned_conv_slots_bwd"
# The tensor-core dW kernel inside K2 / K2' (bf16 operands): counted beside
# the backward's own count, once per backward launch that runs it.
DW_MMA_NAME = "binned_conv_dw_mma"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fwd_from_tap_major(b, w):
    """out = sum_t b[:, t] @ w[t] for a tap-major b [V, 27, Cin], f32."""
    return b.reshape(b.shape[0], -1).float() @ w.float().reshape(
        -1, w.shape[2])


def _bwd_from_tap_major(bd, feats, w):
    """(dX, dW) from the binned dout bd[u, t] = dout[nbr(u, t)] [V, 27,
    Cout] (mirror symmetry): dX = sum_t bd[:, t] @ W[26-t]^T,
    dW[26-t] = feats^T @ bd[:, t], f32 products and sums."""
    v, cin = feats.shape
    cout = w.shape[2]
    bd = bd.float().reshape(v, 27 * cout)
    dx = bd @ w.float().flip(0).transpose(1, 2).reshape(27 * cout, cin)
    dw = (feats.float().t() @ bd).reshape(cin, 27, cout).transpose(0, 1)
    return dx, dw.flip(0).contiguous()


def _slot_tap_major(x, src, tap):
    """[V, 27, C] tap-major neighbor tensor of ``x`` [V, C] from per-voxel
    K-slot maps (the JAX package's ``_binned_tap_major``; exact: a voxel's
    taps are distinct, empty taps zero)."""
    v, c = x.shape
    g = torch.cat([x, x.new_zeros((1, c))])[src.long()]      # [V, K, C]
    row = torch.arange(v, device=x.device)[:, None]
    flat = torch.where((tap >= 0) & (tap < 27), row * 27 + tap.long(), v * 27)
    b = x.new_zeros((v * 27 + 1, c))
    b[flat.reshape(-1)] = g.reshape(-1, c)
    return b[:v * 27].reshape(v, 27, c)


def _tap_major(x, src_pack, bin_pack):
    """[V, 27, C] tap-major neighbor tensor of ``x`` [V, C] from the
    group-pooled maps (the JAX package's ``_grouped_tap_major``; exact: at
    most one row per bin, empty bins zero)."""
    v, c = x.shape
    ng, s = src_pack.shape
    g = torch.cat([x, x.new_zeros((1, c))])[src_pack.long()].reshape(ng * s, c)
    live = (bin_pack >= 0) & (bin_pack < 216)
    grp = torch.arange(ng, device=x.device)[:, None].expand(ng, s)
    flat = torch.where(live, grp * 216 + bin_pack.long(), ng * 216)
    b = x.new_zeros((ng * 216 + 1, c))
    b[flat.reshape(-1)] = g
    return b[:ng * 216].reshape(ng, 27, 8, c).transpose(1, 2).reshape(
        v, 27, c)


def binned_conv_grouped_ref(feats, src_pack, bin_pack, w):
    """Plain version, the ``_grouped_tap_major`` formulation of the JAX
    package: bin the gathered slot rows into a tap-major [V, 27, Cin] tensor,
    then one weight contraction with f32 products and sums."""
    return _fwd_from_tap_major(_tap_major(feats, src_pack, bin_pack), w)


def binned_conv_grouped_bwd_ref(dout, feats, src_pack, bin_pack, w):
    """Plain version of the backward, the ``_subm3gs_bwd`` formulation of
    the JAX package: bd[u, t] = dout[nbr(u, t)] from the same maps (mirror
    symmetry), dX = sum_t bd[:, t] @ W[26-t]^T, dW[26-t] = feats^T @ bd[:, t],
    f32 products and sums."""
    return _bwd_from_tap_major(_tap_major(dout, src_pack, bin_pack), feats, w)


def binned_conv_slots_ref(feats, src, tap, w):
    """Plain version of K1', the ``_binned_tap_major`` / ``_subm3s``
    formulation of the JAX package: bin the K slot rows of each voxel into a
    tap-major [V, 27, Cin] tensor, then one weight contraction with f32
    products and sums."""
    return _fwd_from_tap_major(_slot_tap_major(feats, src, tap), w)


def binned_conv_slots_bwd_ref(dout, feats, src, tap, w):
    """Plain version of K2', the ``_subm3s_bwd`` formulation of the JAX
    package: bd[u, t] = dout[src[u, k]] where tap[u, k] = t, from u's own
    maps, then as ``binned_conv_grouped_bwd_ref``.  Under tap overflow this
    is JAX's backward (taps dropped by the source's slot budget), not the
    exact gradient of the lossy forward."""
    return _bwd_from_tap_major(_slot_tap_major(dout, src, tap), feats, w)


def _check_operands(feats, w):
    if feats.dim() != 2 or w.dim() != 3 or w.shape[0] != 27:
        raise ValueError(f"expected feats [V, Cin], w [27, Cin, Cout]; got "
                         f"{tuple(feats.shape)}, {tuple(w.shape)}")
    if w.shape[1] != feats.shape[1]:
        raise ValueError(f"w has Cin {w.shape[1]}, feats have "
                         f"{feats.shape[1]}")


def _check(feats, src_pack, bin_pack, w):
    _check_operands(feats, w)
    v = feats.shape[0]
    if v % 8 or src_pack.shape != (v // 8, src_pack.shape[1]) \
            or bin_pack.shape != src_pack.shape:
        raise ValueError(f"maps must be [V/8, S] with V % 8 == 0; got V {v}, "
                         f"src {tuple(src_pack.shape)}, "
                         f"bin {tuple(bin_pack.shape)}")
    if not (feats.device == src_pack.device == bin_pack.device == w.device):
        raise ValueError("feats, maps and w must be on one device")


def _check_slots(feats, src, tap, w):
    """Per-voxel maps: src and tap [V, K] int32 with 1 <= K <= 27, on the
    operands' device."""
    _check_operands(feats, w)
    v = feats.shape[0]
    if src.dim() != 2 or src.shape[0] != v or tap.shape != src.shape \
            or not 1 <= src.shape[1] <= 27:
        raise ValueError(f"maps must be [V, K] with 1 <= K <= 27; got V {v}, "
                         f"src {tuple(src.shape)}, tap {tuple(tap.shape)}")
    if src.dtype != torch.int32 or tap.dtype != torch.int32:
        raise TypeError(f"maps must be int32, got {src.dtype}, {tap.dtype}")
    if not (feats.device == src.device == tap.device == w.device):
        raise ValueError("feats, maps and w must be on one device")


def _check_cuda(feats, src, codes, w, *more):
    """What the CUDA kernels take: one operand dtype (bf16 or f32), int32
    maps, everything contiguous, V % 8 == 0, Cin and Cout at most 1024."""
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if feats.dtype not in _DTYPES or any(t.dtype != feats.dtype
                                         for t in (w, *more)):
        raise TypeError(f"operands must all be bf16 or all f32, got "
                        f"{[t.dtype for t in (feats, w, *more)]}")
    if src.dtype != torch.int32 or codes.dtype != torch.int32:
        raise TypeError("maps must be int32")
    if not all(t.is_contiguous() for t in (feats, src, codes, w, *more)):
        raise ValueError("operands and maps must be contiguous")
    if feats.shape[0] % 8:
        raise ValueError(f"the kernels take V % 8 == 0, got V "
                         f"{feats.shape[0]}")
    if feats.shape[1] > 1024 or w.shape[2] > 1024:
        raise ValueError(f"channels above 1024 are not supported "
                         f"(Cin {feats.shape[1]}, Cout {w.shape[2]})")


def _check_dout(dout, feats, w):
    if dout.shape != (feats.shape[0], w.shape[2]) or \
            dout.device != feats.device:
        raise ValueError(f"dout must be [V, Cout] on {feats.device}, got "
                         f"{tuple(dout.shape)} on {dout.device}")


def _launch_fwd(name, symbol, feats, src, codes, w):
    """One forward kernel launch; the maps' second dimension (S or K) is the
    C function's width argument."""
    _check_cuda(feats, src, codes, w)
    v, cin = feats.shape
    cout = w.shape[2]
    out = torch.empty((v, cout), dtype=torch.float32, device=feats.device)
    fn = getattr(load("binned_conv"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    rc = fn(feats.data_ptr(), src.data_ptr(), codes.data_ptr(),
            w.data_ptr(), out.data_ptr(), v, src.shape[1], cin, cout,
            _DTYPES[feats.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


# The dW reduction's schedule on an H100: 132 SMs, 228 KB of shared memory
# an SM, at most 2048 threads an SM.  The tensor-core kernel runs blocks of
# DW_THREADS threads over k-steps of DW_STEP voxels in a DW_STAGES-deep ring.
SMS = 132
SMEM_PER_SM = 228 * 1024
DW_THREADS = 128
DW_STEP = 64
DW_STAGES = 3
DW_WAVES = 4            # waves the chunk count aims at
DW_SCRATCH = 64 << 20   # partials + row table, bytes


class DwSchedule(NamedTuple):
    """How one dW launch runs (``dw_schedule``)."""
    route: int          # 0 CUDA cores (f32 operands), 1 tensor cores (bf16)
    tile_m: int         # (Cin, Cout) tile of a block
    tile_n: int
    nchunks: int        # consecutive chunks of chunk_groups groups
    chunk_groups: int   # (the last chunk shorter, none empty)
    scratch_bytes: int  # f32 partials, and the int32 row table of route 1


def _tile(width: int) -> int:
    """32 or 64, whichever pads ``width`` less; 64 on a tie."""
    return min((64, 32), key=lambda b: -(-width // b) * b)


def dw_resident_blocks(tile_m: int, tile_n: int) -> int:
    """Blocks of the tensor-core dW kernel that fit on one SM by shared
    memory (its ring plus 1 KB the card reserves per block) and by threads:
    the most that can run at once; registers may allow fewer."""
    smem = DW_STAGES * DW_STEP * (tile_m + tile_n) * 2
    return min(2048 // DW_THREADS, SMEM_PER_SM // (smem + 1024))


def dw_schedule(v: int, cin: int, cout: int, dtype) -> DwSchedule:
    """The route, tiles and chunks of the dW reduction of one backward call.

    bf16 operands take the tensor-core kernel (route 1): (Cin, Cout) tiles
    of 32 or 64, one block per (tile, tap, chunk), chunks whole k-steps of
    8 groups, enough of them for DW_WAVES waves at the most blocks an SM
    can hold, within DW_SCRATCH with the [27, V] row table.  f32 operands
    (the precise path) keep the CUDA-core kernel (route 0): 32x32 tiles,
    about four waves of one block an SM, at most one chunk per group.
    """
    ng = max(1, v // 8)
    per_chunk = 27 * cin * cout * 4
    if dtype == torch.bfloat16:
        tm, tn = _tile(cin), _tile(cout)
        blocks = 27 * -(-cin // tm) * -(-cout // tn)
        table = 27 * v * 4
        step = DW_STEP // 8
        want = -(-DW_WAVES * SMS * dw_resident_blocks(tm, tn) // blocks)
        n = max(1, min(want, (DW_SCRATCH - table) // per_chunk,
                       -(-ng // step)))
        cg = -(-ng // n)
        cg = -(-cg // step) * step      # whole k-steps
        route = 1
    else:
        tm = tn = 32
        tiles = -(-cin // 32) * -(-cout // 32)
        n = max(1, min(ng, -(-4 * SMS // tiles), DW_SCRATCH // per_chunk))
        cg = -(-ng // n)
        table, route = 0, 0
    n = -(-ng // cg)
    return DwSchedule(route, tm, tn, n, cg, n * per_chunk + table)


def _launch_bwd(name, symbol, dout, feats, src, codes, w, sched=None):
    """One backward launch (dX, dW), as ``_launch_fwd``; ``sched`` defaults
    to ``dw_schedule`` for the operands' dtype."""
    _check_cuda(feats, src, codes, w, dout)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    return _run_bwd(name, symbol, dout, feats, src, codes, w, stream, sched)


def _run_bwd(name, symbol, dout, feats, src, codes, w, stream, sched=None):
    v, cin = feats.shape
    cout = w.shape[2]
    if sched is None:
        sched = dw_schedule(v, cin, cout, feats.dtype)
    dev = feats.device
    dx = torch.empty((v, cin), dtype=torch.float32, device=dev)
    dw = torch.empty((27, cin, cout), dtype=torch.float32, device=dev)
    wt = torch.empty_like(w)
    partial = torch.empty((sched.nchunks, 27, cin, cout),
                          dtype=torch.float32, device=dev)
    rows = (torch.empty((27, v), dtype=torch.int32, device=dev)
            if sched.route == 1 else None)
    fn = getattr(load("binned_conv"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(dout.data_ptr(), feats.data_ptr(), src.data_ptr(),
            codes.data_ptr(), w.data_ptr(), wt.data_ptr(),
            None if rows is None else rows.data_ptr(), partial.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), v, src.shape[1], cin, cout,
            sched.route, sched.tile_m, sched.tile_n, sched.nchunks,
            sched.chunk_groups, _DTYPES[feats.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    if sched.route == 1:
        LAUNCHES[DW_MMA_NAME] += 1
    return dx, dw


def binned_conv_grouped_fwd(feats, src_pack, bin_pack, w):
    """[V, Cout] float32 from group-pooled maps (K1; see the module
    docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which needs feats and w of one dtype (bf16 or f32), int32 maps, all
    contiguous, Cin and Cout at most 1024.
    """
    _check(feats, src_pack, bin_pack, w)
    if feats.device.type == "cpu":
        return binned_conv_grouped_ref(feats, src_pack, bin_pack, w)
    return _launch_fwd(NAME, "ftx_binned_conv_grouped_fwd", feats, src_pack,
                       bin_pack, w)


def binned_conv_grouped_bwd(dout, feats, src_pack, bin_pack, w):
    """Backward of ``binned_conv_grouped_fwd``: ``(dX [V, Cin], dW [27, Cin,
    Cout])``, float32 (K2; see ``binned_conv_grouped_bwd_ref`` for the math).

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    needs dout, feats and w of one dtype (bf16 or f32), int32 maps, all
    contiguous.  dW is summed over chunks of groups in a fixed order, with
    no atomics, so it is bitwise repeatable.
    """
    _check(feats, src_pack, bin_pack, w)
    _check_dout(dout, feats, w)
    if feats.device.type == "cpu":
        return binned_conv_grouped_bwd_ref(dout, feats, src_pack, bin_pack, w)
    return _launch_bwd(BWD_NAME, "ftx_binned_conv_grouped_bwd", dout, feats,
                       src_pack, bin_pack, w)


def binned_conv_slots_fwd(feats, src, tap, w):
    """[V, Cout] float32 from per-voxel K-slot maps src, tap [V, K] int32
    (K1'; see ``binned_conv_slots_ref`` for the math).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which reads the maps as [V/8, 8K] and so needs V % 8 == 0, feats and w
    of one dtype (bf16 or f32), all contiguous, Cin and Cout at most 1024.
    """
    _check_slots(feats, src, tap, w)
    if feats.device.type == "cpu":
        return binned_conv_slots_ref(feats, src, tap, w)
    return _launch_fwd(SLOTS_NAME, "ftx_binned_conv_slots_fwd", feats, src,
                       tap, w)


def binned_conv_slots_bwd(dout, feats, src, tap, w):
    """Backward of ``binned_conv_slots_fwd`` as the JAX package computes it:
    ``(dX [V, Cin], dW [27, Cin, Cout])``, float32 (K2'; see
    ``binned_conv_slots_bwd_ref``).  Takes what ``binned_conv_slots_fwd``
    takes, dout in the operands' dtype; dW is bitwise repeatable."""
    _check_slots(feats, src, tap, w)
    _check_dout(dout, feats, w)
    if feats.device.type == "cpu":
        return binned_conv_slots_bwd_ref(dout, feats, src, tap, w)
    return _launch_bwd(SLOTS_BWD_NAME, "ftx_binned_conv_slots_bwd", dout,
                       feats, src, tap, w)
