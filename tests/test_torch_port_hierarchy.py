"""Port index maps against the JAX package: keys, hierarchy, host slot maps
and collation, all bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusiontransformer_tpu.data.collate import collate_padded as j_collate
from fusiontransformer_tpu.data.synthetic import SyntheticSCN as JSynthetic
from fusiontransformer_tpu.ops import keys as JK
from fusiontransformer_tpu.ops.hierarchy import build_hierarchy as j_build
from fusiontransformer_tpu.ops.host_slots import SlotPoolSpec as JSpec
from fusiontransformer_tpu_torch.data.collate import (collate_padded as
                                                      t_collate)
from fusiontransformer_tpu_torch.data.synthetic import (SyntheticSCN as
                                                        TSynthetic)
from fusiontransformer_tpu_torch.ops import keys as TK
from fusiontransformer_tpu_torch.ops.hierarchy import (build_hierarchy as
                                                       t_build)
from fusiontransformer_tpu_torch.ops.host_slots import SlotPoolSpec as TSpec


def _samples(cls, n_scans, n_points):
    # The port's dataset always carries the eval fields; the JAX package's
    # emits them with output_orig=True.
    kw = {"output_orig": True} if cls is JSynthetic else {}
    ds = cls(split=("train",), num_scans=n_scans, num_points=n_points,
             image_height=37, image_width=61, **kw)
    return [ds[i] for i in range(n_scans)]


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
        assert a.dtype == b.dtype, what
    else:
        assert a == b, what


def test_synthetic_scans_match_jax():
    _assert_same(_samples(JSynthetic, 2, 700), _samples(TSynthetic, 2, 700),
                 "samples")


def test_keys_match_jax():
    rs = np.random.RandomState(0)
    n = 500
    coords = rs.randint(0, 4096, size=(n, 3)).astype(np.int32)
    batch = rs.randint(0, 3, size=n).astype(np.int32)
    valid = rs.rand(n) < 0.9
    jhi, jlo = JK.pack_keys(jnp.asarray(batch), jnp.asarray(coords),
                            jnp.asarray(valid))
    thi, tlo = TK.pack_keys(torch.as_tensor(batch), torch.as_tensor(coords),
                            torch.as_tensor(valid))
    np.testing.assert_array_equal(np.asarray(jhi), thi.numpy())
    np.testing.assert_array_equal(np.asarray(jlo), tlo.numpy())
    _, c = TK.unpack_keys(thi, tlo)
    np.testing.assert_array_equal(c.numpy()[valid], coords[valid])
    jp = JK.parent_keys(jhi, jlo, jnp.asarray(valid))
    tp = TK.parent_keys(thi, tlo, torch.as_tensor(valid))
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # Stable sort, unique flags and the exact-match join.
    js = JK.sort_by_key(jhi, jlo, jnp.arange(n, dtype=jnp.int32))
    ts = TK.sort_by_key(thi, tlo, torch.arange(n, dtype=torch.int32))
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ju = JK.unique_sorted(js[0], js[1])
    tu = TK.unique_sorted(ts[0], ts[1])
    for a, b in zip(ju, tu):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    first = tu[0].numpy()
    tab_hi = np.full(n, JK.INVALID_KEY, np.int32)
    tab_lo = np.full(n, JK.INVALID_KEY, np.int32)
    tab_hi[:first.sum()] = ts[0].numpy()[first]
    tab_lo[:first.sum()] = ts[1].numpy()[first]
    q = rs.randint(0, n, size=300)
    q_hi, q_lo = thi.numpy()[q].copy(), tlo.numpy()[q].copy()
    q_lo[::3] += 1                                   # some absent keys
    jj = JK.sorted_join(jnp.asarray(tab_hi), jnp.asarray(tab_lo),
                        jnp.asarray(q_hi), jnp.asarray(q_lo))
    tj = TK.sorted_join(torch.as_tensor(tab_hi), torch.as_tensor(tab_lo),
                        torch.as_tensor(q_hi), torch.as_tensor(q_lo))
    np.testing.assert_array_equal(np.asarray(jj), tj.numpy())


@pytest.mark.parametrize("n_scans,n_points,caps,overflows", [
    # roomy at every level
    (2, 1200, (2048, 2048, 2048, 2048, 2048), False),
    # tight: capacity overflow, clamped maps and nvalid_raw > cap
    (3, 900, (1792, 1024, 512, 256, 128), True),
])
def test_build_hierarchy_matches_jax(n_scans, n_points, caps, overflows):
    samples = _samples(TSynthetic, n_scans, n_points)
    batch = t_collate(samples, n_scans, 1024, 37, 61)
    args = (batch["coords"], batch["pt_batch"], batch["pt_valid"])
    jh = jax.jit(lambda c, b, v: j_build(c, b, v, caps))(*args)
    th = t_build(*(torch.as_tensor(a) for a in args), caps)
    overflow = 0
    for l, (jl, tl) in enumerate(zip(jh.levels, th.levels)):
        overflow += max(int(jl.nvalid_raw) - caps[l], 0)
        for f in jl._fields:
            a, b = getattr(jl, f), getattr(tl, f)
            if a is None:
                assert b is None, (l, f)
                continue
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"level {l} {f}")
            assert np.asarray(a).dtype == b.numpy().dtype, (l, f)
    for f in ("pt_sorted_pos", "vox0_point_idx", "pt_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jh, f)),
                                      getattr(th, f).numpy(), err_msg=f)
    for f in ("pt_corner_idx", "pt_voxel_idx", "pt_corner_w"):
        for l, (a, b) in enumerate(zip(getattr(jh, f), getattr(th, f))):
            if a is None:
                assert b is None, (f, l)
                continue
            # Corner weights: the same f32 arithmetic, compared exactly too.
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{f} level {l}")
    assert (overflow > 0) == overflows, overflow


@pytest.mark.parametrize("n_points,bucket", [(500, 640), (1100, 1280)])
def test_collate_with_slot_maps_matches_jax(n_points, bucket):
    """collate_padded with group-pooled slot maps and capacity buckets
    (each case picks its own bucket): every array equal to the JAX
    package's, slot for slot."""
    from fusiontransformer_tpu import native

    levels = [0, 1, 2, 3]
    jspec = JSpec(levels, 1.0, (1.0, 0.9, 0.8, 0.7), adaptive=False)
    tspec = TSpec(levels, 1.0, (1.0, 0.9, 0.8, 0.7))
    buckets = (640, 1280)
    jb = j_collate(_samples(JSynthetic, 2, n_points), 2, 1280, 37, 61,
                   output_orig=True, capacity_buckets=buckets,
                   slot_pool=jspec)
    tb = t_collate(_samples(TSynthetic, 2, n_points), 2, 1280, 37, 61,
                   capacity_buckets=buckets, slot_pool=tspec)
    assert tb["gslot_overflow"] == 0
    assert len(tb["pt_valid"]) == 2 * bucket
    if not native.available():
        # The JAX package's numpy join orders slots tap-major; compare the
        # per-group (bin, src) sets instead of the slot order.
        for l in levels:
            for k in (f"gslot_src_{l}", f"gslot_bin_{l}"):
                jb[k] = np.sort(jb[k], axis=1)
                tb[k] = np.sort(tb[k], axis=1)
    _assert_same(jb, tb, "batch")
