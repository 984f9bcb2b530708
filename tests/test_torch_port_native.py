"""The port's native host code (``fusiontransformer_tpu_torch/native``)
against the JAX package's and against the port's numpy versions, bit for
bit, on seeded inputs; its build (g++, hash-named, raced by two processes,
a failed build raises)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from fusiontransformer_tpu import native as jax_native
from fusiontransformer_tpu_torch import native
from fusiontransformer_tpu_torch.data import collate as collate_mod
from fusiontransformer_tpu_torch.data.collate import collate_padded
from fusiontransformer_tpu_torch.data.quantize import (sparse_quantize,
                                                       sparse_quantize_ref)
from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
from fusiontransformer_tpu_torch.ops.host_slots import (SlotPoolSpec,
                                                        morton36, scan_levels,
                                                        scan_slot_triples,
                                                        scan_slot_triples_ref)

LIMIT = native.QUANTIZE_LIMIT


@pytest.fixture(scope="module")
def jax_lib():
    assert jax_native.available(), "the JAX package's native library"
    return jax_native


def _flagship_coords(seed=0, n_points=18000):
    """One SyntheticSCN scan of the flagship's serving size, voxelised."""
    ds = SyntheticSCN(split=("test",), num_scans=1, num_points=n_points,
                      seed=seed)
    return np.asarray(ds[0]["coords"])


def _quantize_case(case):
    rng = np.random.RandomState(7)
    if case == "empty":
        return np.zeros((0, 3), np.int64)
    if case == "one point":
        return np.array([[5, 9, 2]])
    if case == "one voxel":
        return np.repeat([[3, 1, 4]], 17, axis=0)
    if case == "duplicates":
        base = rng.randint(0, 50, (300, 3))
        return base[rng.randint(0, 300, 4000)]
    if case == "edges":
        vals = np.array([0, 1, LIMIT - 2, LIMIT - 1])
        grid = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"),
                        -1).reshape(-1, 3)
        return np.concatenate([grid, grid[::-1], grid[:5]])
    if case == "flagship scan":
        return _flagship_coords(1)[rng.permutation(15000) % 12000]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["empty", "one point", "one voxel",
                                  "duplicates", "edges", "flagship scan"])
def test_quantize_bit_exact(jax_lib, case):
    coords = _quantize_case(case)
    got = sparse_quantize(coords)
    for want in (sparse_quantize_ref(coords), jax_lib.quantize(coords)):
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
    uniq, inv = got
    assert len(inv) == len(coords)
    if len(coords):
        np.testing.assert_array_equal(inv[uniq], np.arange(len(uniq)))


@pytest.mark.parametrize("bad", [[0, 0, LIMIT], [LIMIT + 5, 1, 1], [-1, 0, 0],
                                 [0, 1 << 40, 0]])
def test_quantize_raises_outside_the_key_range(bad):
    coords = np.array([[1, 2, 3], bad], np.int64)
    with pytest.raises(ValueError, match="must lie in"):
        sparse_quantize(coords)


def _level_keys(case):
    """(levels, slot levels) of one scan."""
    if case == "flagship L0-L3":
        return scan_levels(_flagship_coords(), 5), (0, 1, 2, 3)
    if case == "one voxel":
        return scan_levels(np.array([[7, 7, 7]]), 5), (0, 1, 2, 3)
    if case == "empty":
        return [{"key": np.zeros(0, np.int64), "level": l}
                for l in range(4)], (0, 1, 2, 3)
    if case == "edges":
        # Every level: the corners at 0 and at the level's limit - 1 and
        # their neighbours, so taps fall off both sides at each level.
        out = []
        for l in range(4):
            lim = 1 << (12 - l)
            vals = np.array([0, 1, 2, lim - 3, lim - 2, lim - 1])
            grid = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"),
                            -1).reshape(-1, 3)
            out.append({"key": np.unique(morton36(grid)), "level": l})
        return out, (0, 1, 2, 3)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["empty", "one voxel", "edges",
                                  "flagship L0-L3"])
def test_slot_triples_bit_exact(jax_lib, case):
    levels, slot_levels = _level_keys(case)
    got = scan_slot_triples(levels, slot_levels)
    ref = scan_slot_triples_ref(levels, slot_levels)
    for l in slot_levels:
        lim = 1 << (12 - l)
        want_jax = jax_lib.slot_triples(levels[l]["key"], lim)
        for g, r, j in zip(got[l], ref[l], want_jax):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(g, j)
        dst, tap, _ = got[l]
        # Voxel-major, taps ascending within a voxel.
        order = dst.astype(np.int64) * 27 + tap
        assert (np.diff(order) > 0).all()
        if case == "edges":
            assert len(dst) < 27 * len(levels[l]["key"])


@pytest.mark.parametrize("batch_size", [1, 3])
def test_collate_maps_native_equal_numpy(monkeypatch, batch_size):
    """Group-pooled maps assembled from native triples equal those from the
    numpy join, array for array (L0-L3 at the collate's static caps)."""
    ds = SyntheticSCN(split=("train",), num_scans=batch_size,
                      num_points=3000, seed=4)
    samples = [ds[i] for i in range(batch_size)]
    spec = SlotPoolSpec((0, 1, 2, 3), 1.0, (0.894, 0.642, 0.51, 0.409))
    kw = dict(batch_size=batch_size, point_capacity=3072, image_height=40,
              image_width=60, slot_pool=spec)
    samples = [dict(s, img=s["img"][:40, :60]) for s in samples]
    got = collate_padded(samples, **kw)
    monkeypatch.setattr(collate_mod, "scan_slot_triples",
                        scan_slot_triples_ref)
    want = collate_padded(samples, **kw)
    keys = [k for k in want if k.startswith("gslot_")]
    assert len(keys) == 9        # src and bin at four levels, the overflow
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k])


def test_map_labels_projection_and_bounds_match_jax(jax_lib):
    rng = np.random.RandomState(11)
    labels = rng.randint(-3, 300, 5000)
    lut = rng.randint(0, 20, 260)
    np.testing.assert_array_equal(native.map_labels(labels, lut),
                                  jax_lib.map_labels(labels, lut))
    pts = rng.randn(3000, 3).astype(np.float32) * 10
    pts[:, 0] += 5
    proj = np.array([[200.0, -300, 0, 10], [0, -5, -300, 4],
                     [1.0, 0, 0, 0]], np.float32)
    for g, w in zip(native.project_frustum(pts, proj, 640.0, 480.0),
                    jax_lib.project_frustum(pts, proj, 640.0, 480.0)):
        np.testing.assert_array_equal(g, w)
    coords = rng.uniform(-10, 4200, (4000, 3)).astype(np.float32)
    keep = native.inbounds_mask(coords, 4096.0)
    np.testing.assert_array_equal(
        keep, ((coords >= 0) & (coords < 4096.0)).all(1))


def test_two_processes_building_at_once_load_one_library(tmp_path):
    code = (
        "import ctypes, sys\n"
        "import numpy as np\n"
        "from fusiontransformer_tpu_torch import native\n"
        "path = native.build(sys.argv[1])\n"
        "lib = native._bind(ctypes.CDLL(path))\n"
        "c = np.array([[1, 2, 3], [1, 2, 3], [0, 0, 0]], np.int32)\n"
        "u, i = np.empty(3, np.int32), np.empty(3, np.int32)\n"
        "assert lib.ftx_quantize(c, 3, u, i) == 2\n"
        "print(path)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=root)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert paths == {native.lib_path(str(tmp_path))}
    assert os.listdir(tmp_path) == [os.path.basename(paths.pop())]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "ftx_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        native.build(str(tmp_path / "build"))
    assert not os.listdir(tmp_path / "build")
