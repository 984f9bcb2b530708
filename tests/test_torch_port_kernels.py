"""The port's kernel modules on the CPU: each plain version against the JAX
package's Pallas kernel (interpret mode) and XLA formulation, and the
wrappers' device routing.

Tolerances: the plain versions form the same f32 products as the TPU
kernels (bf16 operands or bf16-rounded products where the kernels round)
and sum them in another order, so they agree to f32 rounding: rtol 1e-5
with an atol of 1e-5 (1e-6 for the segment sums of O(1) values).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusiontransformer_tpu.ops import sparse_conv as jsc
from fusiontransformer_tpu.ops.host_slots import build_batch_slot_maps
from fusiontransformer_tpu.ops.pallas.binned_conv import binned_conv_fwd
from fusiontransformer_tpu.ops.pallas.segment_sum import (
    sorted_segment_weighted_sum as j_segsum)
from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES
from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
    binned_conv_grouped_fwd, binned_conv_grouped_ref, binned_conv_slots_bwd,
    binned_conv_slots_bwd_ref, binned_conv_slots_fwd, binned_conv_slots_ref)
from fusiontransformer_tpu_torch.ops.kernels.segment_sum import (
    sorted_segment_weighted_sum, sorted_segment_weighted_sum_ref)


def _segment_inputs(e, c, seed):
    """A gapless, nondecreasing id stream with a sentinel tail (zero
    weights), as the Morton-sorted point stream gives."""
    rs = np.random.RandomState(seed)
    n, v, nvalid = 256, 120, 110
    extra = rs.multinomial(n - 30 - nvalid, np.ones(nvalid) / nvalid)
    ids = np.repeat(np.arange(nvalid), extra + 1)
    ids = np.concatenate([ids, np.full(n - len(ids), v)]).astype(np.int32)
    g = rs.randn(n, c).astype(np.float32)
    w = rs.rand(n, e).astype(np.float32)
    w[ids >= v] = 0.0
    return g, w, ids, v


@pytest.mark.parametrize("e,c,precise", [(1, 33, True), (1, 33, False),
                                         (8, 16, True), (8, 16, False)])
def test_segment_sum_plain_matches_pallas(e, c, precise):
    g, w, ids, v = _segment_inputs(e, c, seed=e + c)
    want = np.asarray(j_segsum(jnp.asarray(g), jnp.asarray(w),
                               jnp.asarray(ids), v, precise=precise))
    got = sorted_segment_weighted_sum_ref(
        torch.as_tensor(g), torch.as_tensor(w), torch.as_tensor(ids), v,
        precise=precise).numpy()
    assert got.shape == (v, e * c)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not got[110:].any()          # rows the stream never reaches


def _grouped_maps(level=1, cap=2560):
    from fusiontransformer_tpu.data.synthetic import SyntheticSCN
    ds = SyntheticSCN(split=("train",), num_scans=2, num_points=1000)
    coords = [np.asarray(ds[i]["coords"]) for i in range(2)]
    maps, overflow = build_batch_slot_maps(coords, (cap,) * 5,
                                           slot_levels=[level])
    assert overflow == 0
    return maps[level], cap


@pytest.mark.parametrize("cin,cout,precise", [(32, 32, True), (4, 48, True),
                                              (32, 16, False)])
def test_binned_conv_plain_matches_pallas_and_xla(cin, cout, precise):
    (src, binp), v = _grouped_maps()
    rs = np.random.RandomState(cin + cout)
    feats = rs.randn(v, cin).astype(np.float32)
    w = (0.1 * rs.randn(27, cin, cout)).astype(np.float32)
    cdt = jnp.float32 if precise else jnp.bfloat16
    f_c, w_c = jnp.asarray(feats).astype(cdt), jnp.asarray(w).astype(cdt)
    g = jsc.pad_row(f_c)[jnp.asarray(src)]
    pallas = np.asarray(binned_conv_fwd(
        g, jnp.asarray(binp), w_c.reshape(27 * cin, cout), precise=precise,
        grouped=True, interpret=True))
    xla = np.asarray(jsc._subm3gs(jnp.asarray(feats), jnp.asarray(w),
                                  jnp.asarray(src), jnp.asarray(binp), cdt))
    tdt = torch.float32 if precise else torch.bfloat16
    got = binned_conv_grouped_ref(torch.as_tensor(feats).to(tdt),
                                  torch.as_tensor(src), torch.as_tensor(binp),
                                  torch.as_tensor(w).to(tdt)).numpy()
    assert got.dtype == np.float32 and got.shape == (v, cout)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)


def test_wrappers_take_the_plain_path_on_cpu():
    (src, binp), v = _grouped_maps(level=2)
    rs = np.random.RandomState(0)
    feats = torch.as_tensor(rs.randn(v, 8).astype(np.float32))
    w = torch.as_tensor(rs.randn(27, 8, 8).astype(np.float32))
    src_t, bin_t = torch.as_tensor(src), torch.as_tensor(binp)
    before = dict(LAUNCHES)
    out = binned_conv_grouped_fwd(feats, src_t, bin_t, w)
    assert torch.equal(out, binned_conv_grouped_ref(feats, src_t, bin_t, w))
    # Per-voxel K-slot maps (K1', K2'): 3 slots per voxel, sentinels mixed in.
    slot_src = torch.as_tensor(rs.randint(0, v + 1, (v, 3)), dtype=torch.int32)
    slot_tap = torch.as_tensor(np.stack([rs.permutation(28)[:3]
                                         for _ in range(v)]), dtype=torch.int32)
    dout = torch.as_tensor(rs.randn(v, 8).astype(np.float32))
    assert torch.equal(binned_conv_slots_fwd(feats, slot_src, slot_tap, w),
                       binned_conv_slots_ref(feats, slot_src, slot_tap, w))
    for a, b in zip(binned_conv_slots_bwd(dout, feats, slot_src, slot_tap, w),
                    binned_conv_slots_bwd_ref(dout, feats, slot_src, slot_tap,
                                              w)):
        assert torch.equal(a, b)
    g, wt, ids, nv = _segment_inputs(2, 5, seed=1)
    args = (torch.as_tensor(g), torch.as_tensor(wt), torch.as_tensor(ids), nv)
    assert torch.equal(sorted_segment_weighted_sum(*args),
                       sorted_segment_weighted_sum_ref(*args))
    assert dict(LAUNCHES) == before     # no kernel launch was counted


def test_wrappers_reject_other_devices_and_bad_shapes():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        binned_conv_grouped_fwd(torch.empty(16, 4, **meta),
                                torch.empty(2, 8, dtype=torch.int32, **meta),
                                torch.empty(2, 8, dtype=torch.int32, **meta),
                                torch.empty(27, 4, 8, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        sorted_segment_weighted_sum(
            torch.empty(4, 3, **meta), torch.empty(4, 1, **meta),
            torch.empty(4, dtype=torch.int32, **meta), 2)
    with pytest.raises(ValueError, match="V % 8"):
        binned_conv_grouped_fwd(torch.zeros(12, 4),
                                torch.zeros(1, 8, dtype=torch.int32),
                                torch.zeros(1, 8, dtype=torch.int32),
                                torch.zeros(27, 4, 8))
    i32 = dict(dtype=torch.int32)
    for fn, pre in ((binned_conv_slots_fwd, ()),
                    (binned_conv_slots_bwd, (torch.zeros(16, 8),))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*(t.to("meta") for t in pre), torch.empty(16, 4, **meta),
               torch.empty(16, 2, **i32, **meta),
               torch.empty(16, 2, **i32, **meta),
               torch.empty(27, 4, 8, **meta))
        for k in (0, 28):                                    # a bad K
            with pytest.raises(ValueError, match="1 <= K <= 27"):
                fn(*pre, torch.zeros(16, 4), torch.zeros(16, k, **i32),
                   torch.zeros(16, k, **i32), torch.zeros(27, 4, 8))
        with pytest.raises(TypeError, match="int32"):       # int64 maps
            fn(*pre, torch.zeros(16, 4), torch.zeros(16, 2, dtype=torch.long),
               torch.zeros(16, 2, **i32), torch.zeros(27, 4, 8))
        with pytest.raises(ValueError, match="one device"):  # mixed devices
            fn(*pre, torch.zeros(16, 4), torch.zeros(16, 2, **i32),
               torch.zeros(16, 2, **i32, **meta), torch.zeros(27, 4, 8))
    with pytest.raises(ValueError, match="row counts"):
        sorted_segment_weighted_sum(torch.zeros(4, 3), torch.zeros(5, 1),
                                    torch.zeros(4, dtype=torch.int32), 2)


def test_kernel_modules_import_without_nvcc(monkeypatch):
    """Importing builds nothing; a build with no nvcc raises a clear error."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = "/nonexistent"
    code = ("import fusiontransformer_tpu_torch.ops.sparse_conv, "
            "fusiontransformer_tpu_torch.ops.kernels.build as b; "
            "print(b.SOURCES)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

    from fusiontransformer_tpu_torch.ops.kernels import build
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.osp, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
