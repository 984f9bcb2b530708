"""Attention formulation sweep at DeiT-B/384 shapes across batch sizes.

    python -m fusiontransformer_tpu_torch.tools.microbench_attention [B ...]
    python -m fusiontransformer_tpu_torch.tools.microbench_attention \\
        --device cpu --heads 2 --tokens 70 --depth 2 1

Port of ``tools/microbench_attention.py``: q, k, v ``[B, 12, 578, 64]`` bf16
(unit normal, ``RandomState(0..2)``), ``DEPTH`` = 12 attention calls chained
(each output is the next query), as the ViT's blocks run back to back.
Variants:

  einsum_f32sm   the port's ViT arithmetic (``models/vit.py``): bf16 scores
                 with f32 products (``cdt_matmul``), x D^-0.5, an f32
                 softmax, ``cdt_matmul`` with v, the result in bf16
  flash          the hand-written flash attention kernel (T4)
  sdpa           ``F.scaled_dot_product_attention`` with scale D^-0.5, the
                 counterpart of the JAX tool's ``dot_product_attention``
                 variant (``jax.nn.dot_product_attention``): PyTorch's own
                 fused attention, a yardstick for T4

It prints ms per DEPTH calls and us per call for each variant and batch, and
flash's largest difference from einsum_f32sm on one call over its stated
bound.  On the card each time is a CUDA-event median over CUDA-graph replays
of the chain; ``--device cpu`` runs the plain versions on the host clock.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from fusiontransformer_tpu_torch.ops.kernels.flash_attention import (
    ATTN_TOL, attention_error_scale, flash_attention)
from fusiontransformer_tpu_torch.ops.sparse_conv import cdt_matmul
from fusiontransformer_tpu_torch.utils.device import resolve_device
from fusiontransformer_tpu_torch.utils.profiler import time_cuda, time_host

H, N, D = 12, 578, 64
DEPTH = 12


def einsum_f32sm(q, k, v):
    """The ViT's attention (``models/vit.py``) on [B, H, N, D] bf16."""
    attn = cdt_matmul(q, k.transpose(-1, -2), torch.bfloat16) * D ** -0.5
    attn = torch.softmax(attn, dim=-1)
    return cdt_matmul(attn, v, torch.bfloat16).to(torch.bfloat16)


def flash(q, k, v):
    return flash_attention(q, k, v, D ** -0.5)


def sdpa(q, k, v):
    return F.scaled_dot_product_attention(q, k, v, scale=D ** -0.5)


VARIANTS = {"einsum_f32sm": einsum_f32sm, "flash": flash, "sdpa": sdpa}


def inputs(b, heads, tokens, device):
    """q, k, v [b, heads, tokens, D] bf16 from RandomState(0), (1), (2)."""
    return [torch.as_tensor(np.random.RandomState(i).randn(
        b, heads, tokens, D).astype(np.float32)).to(device, torch.bfloat16)
        for i in range(3)]


def chain(fn, q, k, v, depth):
    x = q
    for _ in range(depth):
        x = fn(x, k, v)
    return x


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", nargs="*", type=int, default=[1, 2, 8])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions, host times)")
    ap.add_argument("--heads", type=int, default=H)
    ap.add_argument("--tokens", type=int, default=N)
    ap.add_argument("--depth", type=int, default=DEPTH)
    ap.add_argument("--iters", type=int, default=5, help="timing windows")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu (plain versions, host times)",
          flush=True)
    rows = []
    for b in args.batches:
        q, k, v = inputs(b, args.heads, args.tokens, device)
        diff = (flash(q, k, v).float() - einsum_f32sm(q, k, v).float()).abs()
        share = (diff / (ATTN_TOL * attention_error_scale(
            q, k, v, D ** -0.5) + 1e-30)).max().item()
        for name, fn in VARIANTS.items():
            def run(fn=fn):
                return chain(fn, q, k, v, args.depth)

            if device.type == "cuda":
                ms = time_cuda(run, iters=args.iters, graph=True)[0]
            else:
                ms = time_host(run, iters=args.iters)[0]
            rows.append({"batch": b, "variant": name, "ms": ms})
            print(f"b={b:2d} {name:14s} {ms:8.3f} ms/{args.depth}blk "
                  f"({ms / args.depth * 1e3:8.1f} us/block)", flush=True)
        rows.append({"batch": b, "flash_vs_einsum_share_of_bound": share})
        print(f"b={b:2d} flash vs einsum_f32sm: largest difference "
              f"{share:.3g} of its bound", flush=True)
    return rows


if __name__ == "__main__":
    main()
