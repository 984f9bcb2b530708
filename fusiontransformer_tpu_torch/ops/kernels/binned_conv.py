"""Grouped binned submanifold conv, forward (K1) and backward (K2): CUDA
kernels (``csrc/binned_conv.cu``) and their plain PyTorch versions.

    out[8*g + vo] = sum_t feats[src(g, t*8 + vo)] @ w[t]

Port of ``binned_conv_fwd`` / ``binned_conv_bwd(..., grouped=True)`` in
``fusiontransformer_tpu/ops/pallas/binned_conv.py`` together with the row
gathers their callers run first (``sparse_conv._subm3gp_impl`` /
``_subm3gp_bwd`` of the JAX package).  Group-pooled maps: slot j of 8-voxel
group g carries a source row
``src_pack[g, j]`` (sentinel ``V``) and a bin id ``bin_pack[g, j] = t*8 + vo``
(sentinel >= 216), at most one slot per bin.  ``w`` is ``[27, Cin, Cout]`` in
the JAX tap order (x-slowest).  Operands are bf16 (the production path) or
f32; products and sums are f32; the result is ``[V, Cout]`` float32.
"""

from __future__ import annotations

import ctypes

import torch

from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES
from fusiontransformer_tpu_torch.ops.kernels.build import load

NAME = "binned_conv_grouped_fwd"
BWD_NAME = "binned_conv_grouped_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    v, cin = feats.shape
    b = _tap_major(feats, src_pack, bin_pack)
    return b.reshape(v, 27 * cin).float() @ w.float().reshape(27 * cin, -1)


def binned_conv_grouped_bwd_ref(dout, feats, src_pack, bin_pack, w):
    """Plain version of the backward, the ``_subm3gs_bwd`` formulation of
    the JAX package: bd[u, t] = dout[nbr(u, t)] from the same maps (mirror
    symmetry), dX = sum_t bd[:, t] @ W[26-t]^T, dW[26-t] = feats^T @ bd[:, t],
    f32 products and sums."""
    v, cin = feats.shape
    cout = w.shape[2]
    bd = _tap_major(dout, src_pack, bin_pack).float()           # [V, 27, Cout]
    wrev = w.float().flip(0)
    dx = bd.reshape(v, 27 * cout) @ wrev.transpose(1, 2).reshape(27 * cout,
                                                                 cin)
    dw = (feats.float().t() @ bd.reshape(v, 27 * cout)).reshape(
        cin, 27, cout).transpose(0, 1).flip(0)
    return dx, dw.contiguous()


def _check(feats, src_pack, bin_pack, w):
    if feats.dim() != 2 or w.dim() != 3 or w.shape[0] != 27:
        raise ValueError(f"expected feats [V, Cin], w [27, Cin, Cout]; got "
                         f"{tuple(feats.shape)}, {tuple(w.shape)}")
    v, cin = feats.shape
    if w.shape[1] != cin:
        raise ValueError(f"w has Cin {w.shape[1]}, feats have {cin}")
    if v % 8 or src_pack.shape != (v // 8, src_pack.shape[1]) \
            or bin_pack.shape != src_pack.shape:
        raise ValueError(f"maps must be [V/8, S] with V % 8 == 0; got V {v}, "
                         f"src {tuple(src_pack.shape)}, "
                         f"bin {tuple(bin_pack.shape)}")
    if not (feats.device == src_pack.device == bin_pack.device == w.device):
        raise ValueError("feats, maps and w must be on one device")


def _check_cuda(feats, src_pack, bin_pack, w, *more):
    """What the CUDA kernels take: one operand dtype (bf16 or f32), int32
    maps, everything contiguous, Cin and Cout at most 1024."""
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if feats.dtype not in _DTYPES or any(t.dtype != feats.dtype
                                         for t in (w, *more)):
        raise TypeError(f"operands must all be bf16 or all f32, got "
                        f"{[t.dtype for t in (feats, w, *more)]}")
    if src_pack.dtype != torch.int32 or bin_pack.dtype != torch.int32:
        raise TypeError("maps must be int32")
    if not all(t.is_contiguous()
               for t in (feats, src_pack, bin_pack, w, *more)):
        raise ValueError("operands and maps must be contiguous")
    if feats.shape[1] > 1024 or w.shape[2] > 1024:
        raise ValueError(f"channels above 1024 are not supported "
                         f"(Cin {feats.shape[1]}, Cout {w.shape[2]})")


def binned_conv_grouped_fwd(feats, src_pack, bin_pack, w):
    """[V, Cout] float32 (see the module docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which needs feats and w of one dtype (bf16 or f32), int32 maps, all
    contiguous, Cin and Cout at most 1024.
    """
    _check(feats, src_pack, bin_pack, w)
    if feats.device.type == "cpu":
        return binned_conv_grouped_ref(feats, src_pack, bin_pack, w)
    _check_cuda(feats, src_pack, bin_pack, w)
    v, cin = feats.shape
    cout = w.shape[2]
    out = torch.empty((v, cout), dtype=torch.float32, device=feats.device)
    fn = load("binned_conv").ftx_binned_conv_grouped_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    rc = fn(feats.data_ptr(), src_pack.data_ptr(), bin_pack.data_ptr(),
            w.data_ptr(), out.data_ptr(), v, src_pack.shape[1], cin, cout,
            _DTYPES[feats.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {rc}")
    LAUNCHES[NAME] += 1
    return out


def bwd_chunks(v: int, cin: int, cout: int) -> int:
    """How many consecutive chunks of groups the dW reduction splits into:
    about four waves of (chunk x 32x32-tile) blocks over the 132 SMs of an
    H100 (one block fits an SM), at most one chunk per group.  Each chunk
    costs a 27*Cin*Cout f32 partial: at most about 60 MB in all."""
    tiles = -(-cin // 32) * -(-cout // 32)
    return max(1, min(v // 8, -(-4 * 132 // tiles)))


def binned_conv_grouped_bwd(dout, feats, src_pack, bin_pack, w):
    """Backward of ``binned_conv_grouped_fwd``: ``(dX [V, Cin], dW [27, Cin,
    Cout])``, float32 (K2; see ``binned_conv_grouped_bwd_ref`` for the math).

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    needs dout, feats and w of one dtype (bf16 or f32), int32 maps, all
    contiguous.  dW is summed over chunks of groups in a fixed order, with
    no atomics, so it is bitwise repeatable.
    """
    _check(feats, src_pack, bin_pack, w)
    if dout.shape != (feats.shape[0], w.shape[2]) or \
            dout.device != feats.device:
        raise ValueError(f"dout must be [V, Cout] on {feats.device}, got "
                         f"{tuple(dout.shape)} on {dout.device}")
    if feats.device.type == "cpu":
        return binned_conv_grouped_bwd_ref(dout, feats, src_pack, bin_pack, w)
    _check_cuda(feats, src_pack, bin_pack, w, dout)
    v, cin = feats.shape
    cout = w.shape[2]
    nchunks = bwd_chunks(v, cin, cout)
    dev = feats.device
    dx = torch.empty((v, cin), dtype=torch.float32, device=dev)
    dw = torch.empty((27, cin, cout), dtype=torch.float32, device=dev)
    wt = torch.empty_like(w)
    partial = torch.empty((nchunks, 27, cin, cout), dtype=torch.float32,
                          device=dev)
    fn = load("binned_conv").ftx_binned_conv_grouped_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(dout.data_ptr(), feats.data_ptr(), src_pack.data_ptr(),
            bin_pack.data_ptr(), w.data_ptr(), wt.data_ptr(),
            partial.data_ptr(), dx.data_ptr(), dw.data_ptr(), v,
            src_pack.shape[1], cin, cout, nchunks, _DTYPES[feats.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"{BWD_NAME} launch failed: CUDA error {rc}")
    LAUNCHES[BWD_NAME] += 1
    return dx, dw
