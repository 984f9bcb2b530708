"""Flash attention forward: CUDA kernel (``csrc/flash_attention.cu``) and its
plain PyTorch version.

    out = softmax(q @ k^T * sm_scale) @ v        q, k, v: [B, H, N, 64] bf16

Port of the Pallas TPU flash attention that ``tools/microbench_attention.py``
calls (JAX's ``pallas.ops.tpu.flash_attention``), non-causal, forward only:
f32 scores of bf16 operands, an f32 softmax, the probabilities rounded to
bf16 for the product with ``v`` (f32 sums), the result in bf16.  The kernel
rounds the unnormalised probabilities of its online softmax and divides by
the row sum at the end, as the TPU kernel does; the plain version rounds the
normalised ones.  Each bf16 rounding moves a value by at most 2^-8 of it, so
the two differ by at most 2^-7 of ``sum_j p_ij |v_j|`` through the
probabilities and 2^-7 of it through the outputs' own rounding:
``ATTN_TOL`` (2^-6 and a margin for the f32 sums) times
``attention_error_scale``.  Any sequence length is taken, where the TPU
kernel needs a multiple of 128.  The head dim is 64 and the type bf16 on
both devices.  The kernel runs both products on ``wgmma``, fed by TMA, with
the softmax of each key tile under the tensor cores' PV product of the tile
before (design in its source note).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES
from fusiontransformer_tpu_torch.ops.kernels.build import load

NAME = "flash_attention"
HEAD_DIM = 64
ATTN_TOL = 1.6e-2


def flash_attention_ref(q, k, v, sm_scale):
    """Plain version: f32 scores, ``x sm_scale``, softmax, ``bf16(p) @ v`` in
    f32, bf16."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    return torch.matmul(p, v.float()).to(torch.bfloat16)


def attention_error_scale(q, k, v, sm_scale):
    """``sum_j p_ij |v_j|`` per output element, float32: what each output's
    difference between two roundings of the same attention is held to."""
    return flash_attention_ref(q, k, v.abs(), sm_scale).float()


def _check(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(f"{name} must be [B, H, N, D], got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
        if x.shape[-1] != HEAD_DIM:
            raise ValueError(f"head dim must be {HEAD_DIM}, {name} has "
                             f"{x.shape[-1]}")
        if x.shape[2] == 0:
            raise ValueError(f"{name} has no tokens")
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2]:
        raise ValueError(f"shapes differ: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


@functools.cache
def _kernel():
    fn = load("flash_attention").ftx_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, sm_scale: float):
    """``[B, H, Nq, 64]`` bf16 (see the module docstring); k and v are
    ``[B, H, Nk, 64]``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, which needs them contiguous."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, sm_scale)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b * h, nq, nk, d, float(sm_scale) * math.log2(math.e),
                   stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {rc}")
    LAUNCHES[NAME] += 1
    return out
