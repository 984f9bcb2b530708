"""The port's sparse ops against the JAX package's, forward, in f32, at the
L0-L4 shapes of a small hierarchy built from SyntheticSCN scans.

Tolerance: 1e-5 (rtol and atol) — both sides compute true f32 products and
sums (the JAX side at ``Precision.HIGHEST``), in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusiontransformer_tpu.ops import sparse_conv as jsc
from fusiontransformer_tpu.ops.hierarchy import build_hierarchy as j_build
from fusiontransformer_tpu_torch.data.collate import collate_padded
from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
from fusiontransformer_tpu_torch.ops import sparse_conv as tsc
from fusiontransformer_tpu_torch.ops.hierarchy import build_hierarchy
from fusiontransformer_tpu_torch.ops.host_slots import build_batch_slot_maps

CAPS = (2048, 2048, 2048, 1536, 1024)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def hiers():
    ds = SyntheticSCN(split=("train",), num_scans=2, num_points=1100,
                      image_height=37, image_width=61)
    samples = [ds[i] for i in range(2)]
    batch = collate_padded(samples, 2, 1024, 37, 61)
    args = (batch["coords"], batch["pt_batch"], batch["pt_valid"])
    jh = jax.jit(lambda c, b, v: j_build(c, b, v, CAPS))(*args)
    th = build_hierarchy(*(torch.as_tensor(a) for a in args), CAPS)
    for l, lvl in enumerate(th.levels):
        assert int(lvl.nvalid_raw) <= CAPS[l], f"test caps overflow at L{l}"
    maps, overflow = build_batch_slot_maps(
        [np.asarray(s["coords"][:1024]) for s in samples], CAPS,
        slot_levels=[0, 1, 2, 3])
    assert overflow == 0
    return jh, th, maps


def _pair(x):
    return jnp.asarray(x), torch.as_tensor(x)


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_subm_conv3_matches_jax(hiers, level):
    """Dense 27-tap path at every level; the grouped path (K1's plain
    version on the CPU) where the level has slot maps."""
    jh, th, maps = hiers
    rs = np.random.RandomState(level)
    cap = CAPS[level]
    jf, tf = _pair(rs.randn(cap, 24).astype(np.float32))
    jw, tw = _pair((0.1 * rs.randn(27, 24, 40)).astype(np.float32))
    jnbr = jh.levels[level].nbr_idx
    want = jsc.subm_conv3(jf, jw, jnbr, jnp.float32)
    _close(want, tsc.subm_conv3(tf, tw, th.levels[level].nbr_idx,
                                torch.float32))
    if level in maps:
        src, binp = maps[level]
        jg = jsc.subm_conv3(jf, jw, jnbr, jnp.float32,
                            slot_idx=(jnp.asarray(src), jnp.asarray(binp)))
        tg = tsc.subm_conv3(tf, tw, th.levels[level].nbr_idx, torch.float32,
                            slot_idx=(torch.as_tensor(src),
                                      torch.as_tensor(binp)))
        _close(jg, tg)
        _close(want, tg)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_down_and_up_conv2_match_jax(hiers, level):
    jh, th, _ = hiers
    rs = np.random.RandomState(10 + level)
    fine, coarse = CAPS[level], CAPS[level + 1]
    jf, tf = _pair(rs.randn(fine, 16).astype(np.float32))
    jc, tc = _pair(rs.randn(coarse, 16).astype(np.float32))
    jw, tw = _pair((0.2 * rs.randn(8, 16, 24)).astype(np.float32))
    jl, tl = jh.levels, th.levels
    _close(jsc.down_conv2(jf, jw, jl[level + 1].child_idx,
                          compute_dtype=jnp.float32),
           tsc.down_conv2(tf, tw, tl[level + 1].child_idx, torch.float32))
    _close(jsc.up_conv2(jc, jw, jl[level].parent_idx, jl[level].child_kidx,
                        compute_dtype=jnp.float32),
           tsc.up_conv2(tc, tw, tl[level].parent_idx, tl[level].child_kidx,
                        torch.float32))


@pytest.mark.parametrize("level", [2, 4])
def test_voxelize_mean_matches_jax(hiers, level):
    """The plain (index_add) path and the plan path (K3's plain version on
    the CPU; the JAX side runs its Pallas kernel in interpret mode)."""
    jh, th, _ = hiers
    rs = np.random.RandomState(20 + level)
    n = len(th.pt_valid)
    jp, tp = _pair(rs.randn(n, 12).astype(np.float32))
    v = CAPS[level]
    plain = tsc.voxelize_mean(tp, th.pt_voxel_idx[level], th.pt_valid, v)
    _close(jsc.voxelize_mean(jp, jh.pt_voxel_idx[level], jh.pt_valid, v),
           plain)
    planned = tsc.voxelize_mean(tp, th.pt_voxel_idx[level], th.pt_valid, v,
                                plan=tsc.devox_plan(th, level),
                                compute_dtype=torch.float32)
    _close(jsc.voxelize_mean(jp, jh.pt_voxel_idx[level], jh.pt_valid, v,
                             plan=jsc.devox_plan(jh, level),
                             compute_dtype=jnp.float32), planned)
    for a, b in zip(jsc.devox_plan(jh, level), tsc.devox_plan(th, level)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("level", [2, 4])
def test_devoxelize_trilinear_matches_jax(hiers, level):
    jh, th, _ = hiers
    rs = np.random.RandomState(30 + level)
    jv, tv = _pair(rs.randn(CAPS[level], 20).astype(np.float32))
    _close(jsc.devoxelize_trilinear(jv, jh.pt_corner_idx[level],
                                    jh.pt_corner_w[level],
                                    compute_dtype=jnp.float32),
           tsc.devoxelize_trilinear(tv, th.pt_corner_idx[level],
                                    th.pt_corner_w[level]))


def test_conv1x1_and_gather_rows_match_jax(hiers):
    jh, th, _ = hiers
    rs = np.random.RandomState(40)
    jx, tx = _pair(rs.randn(CAPS[0], 16).astype(np.float32))
    jw, tw = _pair(rs.randn(16, 8).astype(np.float32))
    _close(jsc.conv1x1(jx, jw, jnp.float32),
           tsc.conv1x1(tx, tw, torch.float32))
    np.testing.assert_array_equal(
        np.asarray(jsc.gather_rows(jx, jh.pt_sorted_pos)),
        tsc.gather_rows(tx, th.pt_sorted_pos).numpy())
