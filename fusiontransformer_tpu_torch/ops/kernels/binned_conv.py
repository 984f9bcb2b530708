"""Grouped binned submanifold conv, forward: CUDA kernel
(``csrc/binned_conv.cu``) and its plain PyTorch version.

    out[8*g + vo] = sum_t feats[src(g, t*8 + vo)] @ w[t]

Port of ``binned_conv_fwd(..., grouped=True)`` in
``fusiontransformer_tpu/ops/pallas/binned_conv.py`` together with the row
gather its caller runs first (``sparse_conv._subm3gp_impl`` of the JAX
package).  Group-pooled maps: slot j of 8-voxel group g carries a source row
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
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def binned_conv_grouped_ref(feats, src_pack, bin_pack, w):
    """Plain version, the ``_grouped_tap_major`` formulation of the JAX
    package: bin the gathered slot rows into a tap-major [V, 27, Cin] tensor
    (exact: at most one row per bin), then one weight contraction with f32
    products and sums."""
    v, cin = feats.shape
    ng, s = src_pack.shape
    x = torch.cat([feats, feats.new_zeros((1, cin))])           # zero pad row
    g = x[src_pack.long()].reshape(ng * s, cin)                  # [NG*S, Cin]
    live = (bin_pack >= 0) & (bin_pack < 216)
    grp = torch.arange(ng, device=feats.device)[:, None].expand(ng, s)
    flat = torch.where(live, grp * 216 + bin_pack.long(), ng * 216)
    b = feats.new_zeros((ng * 216 + 1, cin))
    b[flat.reshape(-1)] = g
    b = b[:ng * 216].reshape(ng, 27, 8, cin).transpose(1, 2)     # [NG, 8, 27, Cin]
    return b.reshape(v, 27 * cin).float() @ w.float().reshape(27 * cin, -1)


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


def binned_conv_grouped_fwd(feats, src_pack, bin_pack, w):
    """[V, Cout] float32 (see the module docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which needs feats and w of one dtype (bf16 or f32), int32 maps, all
    contiguous, Cin and Cout at most 1024.
    """
    _check(feats, src_pack, bin_pack, w)
    if feats.device.type == "cpu":
        return binned_conv_grouped_ref(feats, src_pack, bin_pack, w)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if feats.dtype not in _DTYPES or w.dtype != feats.dtype:
        raise TypeError(f"feats and w must both be bf16 or f32, got "
                        f"{feats.dtype}, {w.dtype}")
    if src_pack.dtype != torch.int32 or bin_pack.dtype != torch.int32:
        raise TypeError("maps must be int32")
    if not all(t.is_contiguous() for t in (feats, src_pack, bin_pack, w)):
        raise ValueError("feats, maps and w must be contiguous")
    v, cin = feats.shape
    cout = w.shape[2]
    if cin > 1024 or cout > 1024:
        raise ValueError(f"channels above 1024 are not supported "
                         f"(Cin {cin}, Cout {cout})")
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
