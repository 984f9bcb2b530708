"""ctypes bindings of the port's native host code (``ftx_host.cpp``).

The library is built at first use with ``g++ -O3 -shared -fPIC`` into
``fusiontransformer_tpu_torch/_build/`` (listed in ``.gitignore``), named by
a hash of its source and flags, as ``ops/kernels/build.py`` names the CUDA
libraries.  Each build writes a name of its own and then ``os.replace``s it
into place, so processes that build at once (test workers, a server and its
loader) all load one complete library.  There is no numpy fallback: a
failed build raises.  Nothing here runs at import time.

Entry points (each the counterpart of the JAX package's ``native``):

* ``quantize`` — sort-unique of [N, 3] voxel coords, the representative of
  each voxel its first point, voxels in lexicographic order: the same
  ``(unique_idx, inverse)`` as ``np.unique(axis=0, return_index=True,
  return_inverse=True)``.  Coordinates must lie in [0, 2^20); others raise;
* ``slot_triples`` — the live ks3 ``(dst, tap, src)`` triples of one level's
  sorted unique Morton keys, voxel-major with taps ascending;
* ``map_labels``, ``project_frustum``, ``inbounds_mask`` — the label lookup,
  KITTI frustum projection and range filter of the dataset preprocessing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import threading

import numpy as np

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
SRC = osp.join(_PKG, "native", "ftx_host.cpp")
BUILD_DIR = osp.join(_PKG, "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
# ftx_quantize packs (x << 40) | (y << 20) | z into one int64 key.
QUANTIZE_LIMIT = 1 << 20

_lock = threading.Lock()
_lib = None


def lib_path(build_dir: str = BUILD_DIR) -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(GXX_FLAGS).encode())
    return osp.join(build_dir, f"libftx_host_{digest.hexdigest()[:12]}.so")


def build(build_dir: str = BUILD_DIR) -> str:
    """Compile the library into ``build_dir`` unless it is there; returns
    its path.  Raises if ``g++`` fails or is missing."""
    out = lib_path(build_dir)
    if osp.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp],
                             capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the port's native host code "
                           "cannot be built") from e
    if res.returncode != 0:
        if osp.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ exited {res.returncode} building {SRC}:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib):
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32, f32 = ctypes.c_int32, ctypes.c_float
    sigs = {
        "ftx_quantize": (i32, [i32p, i32, i32p, i32p]),
        "ftx_map_labels": (None, [i64p, i32, i64p, i32, i64p]),
        "ftx_project_frustum": (i32, [f32p, i32, f32p, f32, f32, u8p, f32p]),
        "ftx_inbounds_mask": (i32, [f32p, i32, f32, u8p]),
        "ftx_slot_triples": (i32, [i64p, i32, i32, i32p, i32p, i32p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def get_lib():
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()))
        return _lib


def quantize(coords: np.ndarray):
    """(unique_idx [U] int64, inverse [N] int64) of int voxel coords
    [N, 3] in [0, 2^20)."""
    coords = np.asarray(coords)
    if coords.ndim != 2 or coords.shape[1] != 3:
        raise ValueError(f"expected coords [N, 3], got {coords.shape}")
    n = len(coords)
    if n and (coords.min() < 0 or coords.max() >= QUANTIZE_LIMIT):
        raise ValueError(f"voxel coords must lie in [0, {QUANTIZE_LIMIT}), "
                         f"got [{coords.min()}, {coords.max()}]")
    lib = get_lib()
    c = np.ascontiguousarray(coords, np.int32)
    unique_idx = np.empty(n, np.int32)
    inverse = np.empty(n, np.int32)
    n_unique = lib.ftx_quantize(c, n, unique_idx, inverse)
    return unique_idx[:n_unique].astype(np.int64), inverse.astype(np.int64)


def slot_triples(keys: np.ndarray, limit: int):
    """(dst, tap, src) int32 triples of one level's sorted unique Morton
    keys; neighbours at or past ``limit`` along an axis do not exist."""
    lib = get_lib()
    keys = np.ascontiguousarray(keys, np.int64)
    n = len(keys)
    dst = np.empty(27 * n, np.int32)
    tap = np.empty(27 * n, np.int32)
    src = np.empty(27 * n, np.int32)
    m = lib.ftx_slot_triples(keys, n, int(limit), dst, tap, src)
    return dst[:m], tap[:m], src[:m]


def map_labels(labels: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """``lut[labels]``, 0 for a label outside the table."""
    lib = get_lib()
    labels = np.ascontiguousarray(labels, np.int64)
    lut = np.ascontiguousarray(lut, np.int64)
    out = np.empty_like(labels)
    lib.ftx_map_labels(labels, len(labels), lut, len(lut), out)
    return out


def project_frustum(points: np.ndarray, proj: np.ndarray, img_w: float,
                    img_h: float):
    """(keep [N] bool, rowcol [n_keep, 2] float32) of a KITTI pinhole
    projection ``proj`` [3, 4] of ``points`` [N, >=3]."""
    lib = get_lib()
    points = np.ascontiguousarray(points[:, :3], np.float32)
    proj = np.ascontiguousarray(proj, np.float32)
    n = len(points)
    keep = np.empty(n, np.uint8)
    rowcol = np.empty((n, 2), np.float32)
    lib.ftx_project_frustum(points, n, proj, float(img_w), float(img_h),
                            keep, rowcol)
    keep = keep.astype(bool)
    return keep, rowcol[keep]


def inbounds_mask(coords: np.ndarray, full_scale: float) -> np.ndarray:
    """[N] bool: every coordinate of the row in [0, full_scale)."""
    lib = get_lib()
    coords = np.ascontiguousarray(coords, np.float32)
    keep = np.empty(len(coords), np.uint8)
    lib.ftx_inbounds_mask(coords, len(coords), float(full_scale), keep)
    return keep.astype(bool)
