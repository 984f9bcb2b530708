"""Gradients of the port's sparse ops against ``jax.vjp`` of the JAX
package's ops, in f32, at the L0-L4 shapes of a small hierarchy built from
SyntheticSCN scans (padded rows, sentinel neighbours and empty bins
included).  The JAX side runs on the CPU as its own tests run it: the
grouped conv through ``_subm3gs`` (the XLA formulation), the sorted-segment
kernel in Pallas interpret mode.  On the CPU the port's K1/K2/K3 wrappers
take their plain versions.

Tolerance: 1e-4 (rtol and atol), the bound of the JAX package's own
``tests/test_custom_vjp.py``; both sides sum true f32 products in other
orders.
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
from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
    binned_conv_grouped_bwd, binned_conv_grouped_bwd_ref)

CAPS = (2048, 2048, 2048, 1536, 1024)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def hiers():
    ds = SyntheticSCN(split=("train",), num_scans=2, num_points=1100,
                      image_height=37, image_width=61)
    samples = [ds[i] for i in range(2)]
    batch = collate_padded(samples, 2, 1024, 37, 61)
    args = (batch["coords"], batch["pt_batch"], batch["pt_valid"])
    jh = jax.jit(lambda c, b, v: j_build(c, b, v, CAPS))(*args)
    th = build_hierarchy(*(torch.as_tensor(a) for a in args), CAPS)
    maps, overflow = build_batch_slot_maps(
        [np.asarray(s["coords"][:1024]) for s in samples], CAPS,
        slot_levels=[0, 1, 2, 3])
    assert overflow == 0
    return jh, th, maps


def _grads(t_fn, j_fn, inputs, cot):
    """(port grads, JAX grads) of <fn(inputs), cot> for numpy inputs."""
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    t_fn(*ts).backward(torch.as_tensor(cot))
    _, vjp = jax.vjp(j_fn, *(jnp.asarray(x) for x in inputs))
    return [t.grad.numpy() for t in ts], [np.asarray(g)
                                          for g in vjp(jnp.asarray(cot))]


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_subm_conv3_grads_match_jax(hiers, level):
    """Dense path at every level (the L4 route); grouped path (K1 forward,
    K2 backward) at L0-L3 against ``_subm3gs``."""
    jh, th, maps = hiers
    rs = np.random.RandomState(level)
    cap = CAPS[level]
    x = rs.randn(cap, 24).astype(np.float32)
    w = (0.1 * rs.randn(27, 24, 40)).astype(np.float32)
    cot = rs.randn(cap, 40).astype(np.float32)
    jnbr, tnbr = jh.levels[level].nbr_idx, th.levels[level].nbr_idx
    _check(*_grads(lambda f, k: tsc.subm_conv3(f, k, tnbr, torch.float32),
                   lambda f, k: jsc.subm_conv3(f, k, jnbr, jnp.float32),
                   (x, w), cot))
    if level in maps:
        src, binp = maps[level]
        ts = (torch.as_tensor(src), torch.as_tensor(binp))
        js = (jnp.asarray(src), jnp.asarray(binp))
        _check(*_grads(
            lambda f, k: tsc.subm_conv3(f, k, tnbr, torch.float32,
                                        slot_idx=ts),
            lambda f, k: jsc.subm_conv3(f, k, jnbr, jnp.float32, slot_idx=js),
            (x, w), cot))


@pytest.mark.parametrize("level", [0, 3])
def test_k2_plain_version_matches_subm3gs_bwd(hiers, level):
    """``binned_conv_grouped_bwd_ref`` (and the CPU wrapper) against the JAX
    package's ``_subm3gs_bwd`` directly, f32."""
    _, _, maps = hiers
    src, binp = maps[level]
    rs = np.random.RandomState(50 + level)
    cap = CAPS[level]
    feats = rs.randn(cap, 16).astype(np.float32)
    w = (0.2 * rs.randn(27, 16, 12)).astype(np.float32)
    dout = rs.randn(cap, 12).astype(np.float32)
    jdx, jdw, _, _ = jsc._subm3gs_bwd(
        jnp.float32, tuple(jnp.asarray(a) for a in (feats, w, src, binp)),
        jnp.asarray(dout))
    args = [torch.as_tensor(a) for a in (dout, feats, src, binp, w)]
    for fn in (binned_conv_grouped_bwd_ref, binned_conv_grouped_bwd):
        dx, dw = fn(*args)
        assert dx.dtype == dw.dtype == torch.float32
        _check((dx.numpy(), dw.numpy()), (np.asarray(jdx), np.asarray(jdw)))


@pytest.mark.parametrize("level", [0, 3])
def test_down_and_up_conv2_grads_match_jax(hiers, level):
    jh, th, _ = hiers
    rs = np.random.RandomState(10 + level)
    fine, coarse = CAPS[level], CAPS[level + 1]
    xf = rs.randn(fine, 16).astype(np.float32)
    xc = rs.randn(coarse, 16).astype(np.float32)
    w = (0.2 * rs.randn(8, 16, 24)).astype(np.float32)
    jl, tl = jh.levels, th.levels
    _check(*_grads(
        lambda f, k: tsc.down_conv2(f, k, tl[level + 1].child_idx,
                                    tl[level].parent_idx,
                                    tl[level].child_kidx, torch.float32),
        lambda f, k: jsc.down_conv2(f, k, jl[level + 1].child_idx,
                                    jl[level].parent_idx,
                                    jl[level].child_kidx, jnp.float32),
        (xf, w), rs.randn(coarse, 24).astype(np.float32)))
    _check(*_grads(
        lambda f, k: tsc.up_conv2(f, k, tl[level].parent_idx,
                                  tl[level].child_kidx,
                                  tl[level + 1].child_idx, torch.float32),
        lambda f, k: jsc.up_conv2(f, k, jl[level].parent_idx,
                                  jl[level].child_kidx,
                                  jl[level + 1].child_idx, jnp.float32),
        (xc, w), rs.randn(fine, 24).astype(np.float32)))


@pytest.mark.parametrize("level", [2, 4])
def test_voxelize_mean_and_devoxelize_grads_match_jax(hiers, level):
    """The plan paths: voxelize_mean (K3, E=1, forward; gather backward) and
    devoxelize_trilinear (K3 with E=8 over the sorted stream in backward)."""
    jh, th, _ = hiers
    rs = np.random.RandomState(20 + level)
    n = len(th.pt_valid)
    v = CAPS[level]
    jplan, tplan = jsc.devox_plan(jh, level), tsc.devox_plan(th, level)
    _check(*_grads(
        lambda p: tsc.voxelize_mean(p, th.pt_voxel_idx[level], th.pt_valid,
                                    v, plan=tplan,
                                    compute_dtype=torch.float32),
        lambda p: jsc.voxelize_mean(p, jh.pt_voxel_idx[level], jh.pt_valid,
                                    v, plan=jplan, compute_dtype=jnp.float32),
        (rs.randn(n, 12).astype(np.float32),),
        rs.randn(v, 12).astype(np.float32)))
    tw, jw = th.pt_corner_w[level], jh.pt_corner_w[level]
    _check(*_grads(
        lambda x: tsc.devoxelize_trilinear(x, th.pt_corner_idx[level], tw,
                                           plan=tplan,
                                           compute_dtype=torch.float32),
        lambda x: jsc.devoxelize_trilinear(x, jh.pt_corner_idx[level], jw,
                                           plan=jplan,
                                           compute_dtype=jnp.float32),
        (rs.randn(v, 20).astype(np.float32),),
        rs.randn(n, 20).astype(np.float32)))
