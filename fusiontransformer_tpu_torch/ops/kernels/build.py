"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Libraries
are built at first use into ``fusiontransformer_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of their source so an edited source is
rebuilt.  ``build()`` starts one ``nvcc`` per missing library, all at once,
and raises if any of them fails.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading
import time

_PKG = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
SRC_DIR = osp.join(_PKG, "csrc")
BUILD_DIR = osp.join(_PKG, "_build")
SOURCES = ("binned_conv", "segment_sum")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(osp.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if osp.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def lib_path(name: str) -> str:
    with open(osp.join(SRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return osp.join(BUILD_DIR, f"libftx_{name}_{digest.hexdigest()[:12]}.so")


def build(names=SOURCES) -> dict:
    """Compile the missing libraries in parallel.

    Returns ``{name: {"seconds": wall time, "log": nvcc's stderr}}`` for
    each library built by this call (``-Xptxas -v`` puts registers, shared
    memory and spills in the log).
    """
    todo = [n for n in names if not osp.exists(lib_path(n))]
    if not todo:
        return {}
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in todo:
        out = lib_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, osp.join(SRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.time())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.time() - t0, "log": stderr}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(lib_path(name))
            _libs[name] = lib
        return lib
