"""Row-gather width sweep at the L0 slot-map shape.

    python -m fusiontransformer_tpu_torch.tools.microbench_gather
    python -m fusiontransformer_tpu_torch.tools.microbench_gather --device cpu

Port of ``tools/microbench_gather.py``: the plain gather ``feats[idx]`` of a
``[V, C]`` table by ``idx [V/8, 8K]`` (V = 17408, K = 16, random rows; then
each index row sorted), at C = 32 ... 256 in bf16 and at C = 32 and 128 in
f32.  It reports the useful rate, the gathered bytes ``V * K * C * itemsize``
over the time, so that the row-gather kernels' rates
(``microbench_dma_gather``) have the plain gather's curve beside them.  On
the card each time is a CUDA-event median over CUDA-graph replays;
``--device cpu`` times on the host clock.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fusiontransformer_tpu_torch.utils.device import resolve_device
from fusiontransformer_tpu_torch.utils.profiler import time_cuda, time_host

V = 17408
K = 16
CALLS = 10                    # calls per CUDA graph


def bench(feats, idx, iters):
    """ms per gather of ``feats`` by ``idx`` ([V/8, 8K] -> [V/8, 8K, C])."""
    flat = idx.reshape(-1)

    def fn():
        return feats.index_select(0, flat).view(*idx.shape, feats.shape[1])

    if feats.device.type == "cuda":
        return time_cuda(fn, iters=iters, calls=CALLS, graph=True)[0]
    return time_host(fn, iters=iters)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (host times)")
    ap.add_argument("--rows", type=int, default=V, help="table rows V")
    ap.add_argument("--iters", type=int, default=5, help="timing windows")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    v = args.rows
    if v <= 0 or v % 8:
        raise ValueError(f"--rows {v} is not a positive multiple of 8")
    rng = np.random.RandomState(0)
    idx = torch.as_tensor(rng.randint(0, v, size=(v // 8, 8 * K)),
                          device=device)
    idx_sorted = idx.sort(dim=1).values
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu (host times)", flush=True)
    print(f"gather [V={v}, C] rows with idx [{v // 8}, {8 * K}] (the L0 "
          "slot-map shape)", flush=True)
    rows = []
    for label, ix, widths, dtype in (
            ("random", idx, (32, 64, 128, 256), torch.bfloat16),
            ("sorted per row", idx_sorted, (32, 128), torch.bfloat16),
            ("random", idx, (32, 128), torch.float32)):
        for c in widths:
            feats = torch.as_tensor(rng.randn(v, c).astype(np.float32)).to(
                device, dtype)
            ms = bench(feats, ix, args.iters)
            useful = v * K * c * feats.element_size()
            gbs = useful / (ms * 1e-3) / 1e9
            rows.append({"idx": label, "C": c, "dtype": str(dtype)[6:],
                         "ms": ms, "useful_GBps": gbs})
            print(f"{label:14s} C={c:4d} {str(dtype)[6:]:8s}: {ms:8.4f} ms  "
                  f"useful {gbs:7.1f} GB/s", flush=True)
    return rows


if __name__ == "__main__":
    main()
