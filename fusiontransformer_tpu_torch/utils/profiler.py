"""Profiling utilities.

Port of ``fusiontransformer_tpu/utils/profiler.py``: the host-side cProfile
decorator as it is, a ``torch.profiler`` trace context in place of
``jax.profiler.trace``, and timers: ``time_cuda`` (CUDA events on the card)
in place of the one-element readback of ``time_jitted``, and ``time_host``
(the host clock, for the CPU path).
"""

from __future__ import annotations

import contextlib
import cProfile
import io
import os
import pstats
import statistics
import time
from functools import wraps


def profile(fnc):
    """cProfile decorator printing cumulative stats (reference parity)."""

    @wraps(fnc)
    def inner(*args, **kwargs):
        pr = cProfile.Profile()
        pr.enable()
        retval = fnc(*args, **kwargs)
        pr.disable()
        s = io.StringIO()
        ps = pstats.Stats(pr, stream=s).sort_stats("cumulative")
        ps.print_stats()
        print(s.getvalue())
        return retval

    return inner


@contextlib.contextmanager
def device_trace(log_dir):
    """``torch.profiler`` trace of the host and, where there is a card, the
    card; writes ``trace.json`` (Chrome trace format) into ``log_dir`` and
    yields the profiler (``key_averages()`` for sums by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))


def time_cuda(fn, iters=10, warmup=1, calls=1, graph=False):
    """Median ms per call of ``fn`` on the card, and each window's ms.

    Each of ``iters`` windows times ``calls`` calls between two CUDA events,
    after ``warmup`` calls.  With ``graph`` the ``calls`` calls are captured
    once in a CUDA graph (after a warm-up on a side stream) and each window
    replays it, so the host's launch overhead drops out of kernels shorter
    than it; ``fn`` must then be capturable (no host synchronisation).
    """
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        run = g.replay
        run()
    else:
        for _ in range(warmup):
            fn()

        def run():
            for _ in range(calls):
                fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), times


def time_host(fn, iters=10, warmup=1):
    """Median ms per call of ``fn`` on the host clock, and each call's ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times
