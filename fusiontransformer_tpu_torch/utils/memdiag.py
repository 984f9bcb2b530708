"""Host-memory diagnostics for long training runs (the port of
``fusiontransformer_tpu/utils/memdiag.py``).

The trainer logs the process's resident set after every epoch and writes
it to ``metrics.jsonl`` (``host_rss_mb``).  ``FTX_MEMDIAG=1`` logs a
snapshot that tells the suspects of a growing RSS apart instead:

* ``rss_mb`` / ``hwm_mb``   the symptom (``/proc/self/status``);
* ``heap_mb``, ``anon_mb``, ``file_mb``  RSS of the ``[heap]`` segment,
  of anonymous and of file-backed mappings (``/proc/self/smaps``);
* glibc's ``mallinfo2``: ``uord_mb`` (live malloc'd bytes; grows with a
  real allocation leak), ``ford_mb`` + ``keep_mb`` (freed but held: arena
  fragmentation), ``hblk_mb`` (mmap'd by malloc), ``arena_mb``;
* torch's CUDA caching allocator, in the JAX package's ``live_arrays``
  place: ``cuda_allocated_mb`` (live tensors) and ``cuda_reserved_mb``
  (held by the allocator), when CUDA is initialised.

``maybe_trim`` runs ``malloc_trim(0)`` after each epoch unless
``FTX_MALLOC_TRIM=0``; ``trace_report`` (``FTX_MEMDIAG_TRACE=1``) names
the Python allocation sites that grew since its last call.
"""

from __future__ import annotations

import ctypes
import os


class _MallInfo2(ctypes.Structure):
    _fields_ = [(n, ctypes.c_size_t) for n in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd",
        "usmblks", "fsmblks", "uordblks", "fordblks", "keepcost")]


def _libc():
    try:
        return ctypes.CDLL("libc.so.6", use_errno=True)
    except OSError:              # not glibc
        return None


def _mb(value, unit="kB"):
    return round(value / (1024.0 if unit == "kB" else 1024.0 ** 2), 1)


def rss_mb():
    """Current VmRSS in MB (0.0 where /proc is unavailable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return _mb(int(line.split()[1]))
    except OSError:
        pass
    return 0.0


def _smaps():
    heap = anon = filem = 0
    with open("/proc/self/smaps") as f:
        is_heap = is_file = False
        for line in f:
            first = line.split(" ", 1)[0]
            if "-" in first and not first.endswith(":"):     # a region
                fields = line.split()
                path = fields[5] if len(fields) >= 6 else ""
                is_heap, is_file = path == "[heap]", path.startswith("/")
            elif line.startswith("Rss:"):
                kb = int(line.split()[1])
                if is_heap:
                    heap += kb
                elif is_file:
                    filem += kb
                else:
                    anon += kb
    return {"heap_mb": _mb(heap), "anon_mb": _mb(anon),
            "file_mb": _mb(filem)}


def snapshot(include_cuda=True):
    """One diagnostic snapshot as a flat dict of MB values."""
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss_mb"] = _mb(int(line.split()[1]))
                elif line.startswith("VmHWM:"):
                    out["hwm_mb"] = _mb(int(line.split()[1]))
        out.update(_smaps())
    except OSError:
        pass
    libc = _libc()
    if libc is not None and hasattr(libc, "mallinfo2"):
        fn = libc.mallinfo2
        fn.restype = _MallInfo2
        mi = fn()
        out.update(uord_mb=_mb(mi.uordblks, "B"), ford_mb=_mb(mi.fordblks, "B"),
                   keep_mb=_mb(mi.keepcost, "B"), hblk_mb=_mb(mi.hblkhd, "B"),
                   arena_mb=_mb(mi.arena, "B"))
    if include_cuda:
        import torch
        if torch.cuda.is_initialized():
            out["cuda_allocated_mb"] = _mb(torch.cuda.memory_allocated(), "B")
            out["cuda_reserved_mb"] = _mb(torch.cuda.memory_reserved(), "B")
    return out


def format_snapshot(snap):
    return "  ".join(f"{k}={v}" for k, v in snap.items())


def trim():
    """malloc_trim(0): hand freed arena pages back to the OS; True if any
    were released."""
    libc = _libc()
    if libc is None or not hasattr(libc, "malloc_trim"):
        return False
    return bool(libc.malloc_trim(0))


def maybe_trim():
    """The per-epoch trim, on unless ``FTX_MALLOC_TRIM=0``."""
    if os.environ.get("FTX_MALLOC_TRIM", "1") != "0":
        return trim()
    return False


class _Trace:
    last = None


def trace_report(top=5):
    """A one-line tracemalloc report of the growth since the last call, or
    "" unless ``FTX_MEMDIAG_TRACE=1``.  The first call starts tracing."""
    if os.environ.get("FTX_MEMDIAG_TRACE", "") != "1":
        return ""
    import tracemalloc
    if not tracemalloc.is_tracing():
        tracemalloc.start(8)
        _Trace.last = tracemalloc.take_snapshot()
        cur, _ = tracemalloc.get_traced_memory()
        return f"pytrace started (current {cur / 1e6:.0f} MB)"
    snap = tracemalloc.take_snapshot()
    cur, _ = tracemalloc.get_traced_memory()
    stats = snap.compare_to(_Trace.last, "lineno")[:top]
    _Trace.last = snap
    tops = "; ".join(
        f"{s.traceback[0].filename.split('/')[-1]}:"
        f"{s.traceback[0].lineno} {s.size_diff / 1e6:+.1f}MB" for s in stats)
    return f"pytrace current {cur / 1e6:.0f} MB, top growth: {tops}"
