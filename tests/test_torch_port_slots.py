"""The device-built per-voxel K-slot conv path (``TPU.CONV_SLOT_POOL``
off) against the JAX package, on the CPU: the hierarchy's slot maps and
``tap_overflow``, the plain versions of K1' / K2', ``subm_conv3`` with
per-voxel maps, one train step, the engine, and the per-voxel path against
the port's own group-pooled path.

The JAX side runs as its own tests run it on the CPU: ``build_hierarchy``
under ``jax.jit``, the per-voxel conv through ``_subm3s`` (its XLA
formulation; the CPU route of ``subm_conv3``), the Pallas kernels in
interpret mode (which takes only ``8K % 128 == 0``, so K=16 there).  K=4 on
these scans drops live taps: the forward keeps each voxel's first 4, and
the backward is JAX's mirrored one (taps dropped by the source's budget),
which the port reproduces.

Tolerances:
* index maps and overflow counts: bit-exact;
* the plain versions, f32: 1e-5 of each output's largest |value| (the same
  f32 products summed in another order); bf16 operands: 1e-4 of it (the
  products of bf16 operands are exact in f32 on both sides; the bound
  leaves room for f32 summation order over the wider bf16 spread);
* ``subm_conv3`` forward and gradients: 1e-4 rtol and atol, as
  ``tests/test_torch_port_backward.py``;
* the train step: the bounds of ``tests/test_torch_port_train.py``;
* engine labels: >= 99.9% of points equal (ties to f32 rounding);
* per-voxel against group-pooled logits (the same function): 1e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.models.build import build_model as j_build_model
from fusiontransformer_tpu.modules import steps as js
from fusiontransformer_tpu.ops import sparse_conv as jsc
from fusiontransformer_tpu.ops.hierarchy import build_hierarchy as j_build
from fusiontransformer_tpu.ops.pallas.binned_conv import (binned_conv_bwd,
                                                          binned_conv_fwd)
from fusiontransformer_tpu.serving import InferenceEngine as JEngine
from fusiontransformer_tpu.solver.build import build_optimizer as j_opt
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data.build import (build_dataloader,
                                                    slot_pool_spec)
from fusiontransformer_tpu_torch.data.collate import collate_padded
from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
from fusiontransformer_tpu_torch.models import spvcnn
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.modules import steps as ts
from fusiontransformer_tpu_torch.ops import sparse_conv as tsc
from fusiontransformer_tpu_torch.ops.hierarchy import build_hierarchy
from fusiontransformer_tpu_torch.ops.host_slots import SlotPoolSpec
from fusiontransformer_tpu_torch.ops.kernels import LAUNCHES
from fusiontransformer_tpu_torch.ops.kernels.binned_conv import (
    binned_conv_slots_bwd, binned_conv_slots_bwd_ref, binned_conv_slots_fwd,
    binned_conv_slots_ref)
from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
from fusiontransformer_tpu_torch.solver.build import build_optimizer
from fusiontransformer_tpu_torch.utils.convert_jax import (jax_leaf_paths,
                                                           load_jax_variables)

from test_torch_port_common import (LEAF_ATOL, LEAF_RTOL, MEDIAN_RTOL, H, W,
                                    jax_variables, record, tiny_cfg,
                                    train_cfg)

CAPS = (2048, 2048, 2048, 1536, 1024)
LOSSLESS, LOSSY = (16, 16, 16, 16, 0), (4, 4, 4, 4, 0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def batch():
    ds = SyntheticSCN(split=("train",), num_scans=2, num_points=1100,
                      image_height=37, image_width=61)
    b = collate_padded([ds[0], ds[1]], 2, 1024, 37, 61)
    return b["coords"], b["pt_batch"], b["pt_valid"]


@pytest.fixture(scope="module")
def hiers(batch):
    """{tap_slots: (JAX hierarchy, port hierarchy)} at CAPS."""
    out = {}
    for slots in (LOSSLESS, LOSSY):
        jh = jax.jit(lambda c, b, v, s=slots: j_build(c, b, v, CAPS,
                                                      tap_slots=s))(*batch)
        th = build_hierarchy(*(torch.as_tensor(a) for a in batch), CAPS,
                             tap_slots=slots)
        out[slots] = (jh, th)
    return out


def _maps(hiers, slots, level):
    jh, th = hiers[slots]
    return [np.asarray(a) for a in jh.levels[level].slot_idx], \
        th.levels[level].slot_idx


@pytest.mark.parametrize("slots", [LOSSLESS, LOSSY])
def test_slot_maps_and_tap_overflow_match_jax(hiers, slots):
    jh, th = hiers[slots]
    for l, (jl, tl) in enumerate(zip(jh.levels, th.levels)):
        if not slots[l]:
            assert jl.slot_idx is None and tl.slot_idx is None, l
            continue
        for a, b in zip(jl.slot_idx, tl.slot_idx):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"level {l}")
            assert b.dtype == torch.int32 and b.shape == (CAPS[l], slots[l])
    want = int(js.tap_overflow(jh, slots))
    assert int(ts.tap_overflow(th, slots)) == want
    assert (want > 0) == (slots == LOSSY), want


def _operands(v, cin, cout, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(v, cin).astype(np.float32),
            (0.1 * rs.randn(27, cin, cout)).astype(np.float32),
            rs.randn(v, cout).astype(np.float32))


def _close(got, want, rtol):
    """Within ``rtol`` of the largest |want|."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("slots,level,cin,cout,precise", [
    (LOSSLESS, 0, 4, 32, True), (LOSSLESS, 1, 32, 48, True),
    (LOSSLESS, 1, 32, 48, False), (LOSSY, 2, 24, 16, True),
    (LOSSY, 3, 16, 24, False)])
def test_k1_k2_slots_plain_versions_match_jax(hiers, slots, level, cin, cout,
                                              precise):
    """``binned_conv_slots_ref`` / ``_bwd_ref`` (and the CPU wrappers)
    against ``_subm3s`` and ``jax.vjp`` of it, and at K=16 against the Pallas
    kernels ``binned_conv_fwd`` / ``binned_conv_bwd(grouped=False)``."""
    (jsrc, jtap), (tsrc, ttap) = _maps(hiers, slots, level)
    v, k = jsrc.shape
    feats, w, dout = _operands(v, cin, cout, seed=level + cin)
    cdt, tdt, rtol = ((jnp.float32, torch.float32, 1e-5) if precise else
                      (jnp.bfloat16, torch.bfloat16, 1e-4))
    # _subm3s rounds its f32 inputs to cdt itself and returns f32.
    out, vjp = jax.vjp(lambda f, kk: jsc._subm3s(f, kk, jnp.asarray(jsrc),
                                                 jnp.asarray(jtap), cdt),
                       jnp.asarray(feats), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dout))
    jf, jw, jd = (jnp.asarray(a).astype(cdt) for a in (feats, w, dout))
    want = {"out": [out], "dx": [jdx], "dw": [jdw]}
    if k * 8 % 128 == 0:
        pack = lambda a: jnp.asarray(a).reshape(v // 8, 8 * k)   # noqa: E731
        g = jsc.pad_row(jf)[pack(jsrc)]
        gd = jsc.pad_row(jd)[pack(jsrc)]
        want["out"].append(binned_conv_fwd(
            g, pack(jtap), jw.reshape(27 * cin, cout), precise=precise,
            interpret=True))
        pdx, pdw = binned_conv_bwd(gd, pack(jtap), jf, jw, precise=precise,
                                   interpret=True)
        want["dx"].append(pdx)
        want["dw"].append(pdw)
    tf, tw, td = (torch.as_tensor(a).to(tdt) for a in (feats, w, dout))
    before = dict(LAUNCHES)
    for fwd, bwd in ((binned_conv_slots_ref, binned_conv_slots_bwd_ref),
                     (binned_conv_slots_fwd, binned_conv_slots_bwd)):
        got = {"out": fwd(tf, tsrc, ttap, tw)}
        got["dx"], got["dw"] = bwd(td, tf, tsrc, ttap, tw)
        for key, ws in want.items():
            assert got[key].dtype == torch.float32
            for wv in ws:
                _close(got[key].numpy(), wv, rtol)
    assert dict(LAUNCHES) == before     # the CPU takes the plain versions


@pytest.mark.parametrize("slots,level", [(LOSSLESS, 0), (LOSSLESS, 3),
                                         (LOSSY, 1), (LOSSY, 3)])
def test_subm_conv3_with_per_voxel_maps_matches_jax(hiers, slots, level):
    """Forward and both gradients against the JAX package's ``subm_conv3``
    with the same per-voxel maps (its CPU route, ``_subm3s``); at K=4 the
    backward is JAX's mirrored one, not the lossy forward's gradient."""
    jh, th = hiers[slots]
    rs = np.random.RandomState(level)
    cap = CAPS[level]
    x = rs.randn(cap, 24).astype(np.float32)
    w = (0.1 * rs.randn(27, 24, 40)).astype(np.float32)
    cot = rs.randn(cap, 40).astype(np.float32)
    jl, tl = jh.levels[level], th.levels[level]
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    out = tsc.subm_conv3(tx, tw, tl.nbr_idx, torch.float32,
                         slot_idx=tl.slot_idx)
    out.backward(torch.as_tensor(cot))
    want, vjp = jax.vjp(lambda f, k: jsc.subm_conv3(
        f, k, jl.nbr_idx, jnp.float32, slot_idx=jl.slot_idx),
        jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **GRAD_TOL)
    for got, g in zip((tx.grad, tw.grad), vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(got.numpy(), np.asarray(g), **GRAD_TOL)
    if slots == LOSSY:
        # The lossy forward differs from the dense conv: taps were dropped.
        dense = tsc.subm_conv3(torch.as_tensor(x), torch.as_tensor(w),
                               tl.nbr_idx, torch.float32)
        assert not torch.allclose(out.detach(), dense, atol=1e-3)


# --------------------------------------------------------------------------- #
def _per_voxel_cfg(get_cfg, slots=LOSSLESS, train=True):
    cfg = train_cfg(get_cfg) if train else tiny_cfg(get_cfg)
    cfg.defrost()
    cfg.TPU.CONV_SLOT_POOL = False
    cfg.TPU.CONV_TAP_SLOTS = slots
    cfg.freeze()
    return cfg


class _NoDropout(fnn.Module):
    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


@pytest.fixture(scope="module")
def weights():
    return jax_variables(tiny_cfg(jcfg), seed=5)


@pytest.fixture(scope="module")
def one_step(weights):
    """One train step of each package with CONV_SLOT_POOL off, from the
    same weights and batch, dropout off."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn, "Dropout", _NoDropout)
    mp.setattr(spvcnn, "DROPOUT", 0.0)
    try:
        yield _one_step(*weights)
    finally:
        mp.undo()


def _one_step(params, stats):
    cfg_j, cfg_t = _per_voxel_cfg(jcfg), _per_voxel_cfg(get_default_cfg)
    assert slot_pool_spec(cfg_t, adaptive=True) is None
    batch = next(iter(build_dataloader(cfg_t, "train")))
    assert not any(k.startswith("gslot_") for k in batch)
    caps = ts.batch_level_caps(cfg_t, batch)

    model = j_build_model(cfg_j)[0]
    tx, _ = j_opt(cfg_j)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = js.TrainState(jparams, jax.tree_util.tree_map(jnp.asarray, stats),
                          tx.init(jparams), jnp.zeros((), jnp.int32))
    jb = js._device_batch(batch)
    step, _ = js.make_train_step(cfg_j, model, tx, 2, level_caps=caps)
    _, jmetrics = jax.jit(step)(state, jb, jax.random.PRNGKey(0))
    cw = jnp.asarray(cfg_j.TRAIN.CLASS_WEIGHTS, jnp.float32)

    def loss_fn(p):
        hier = js._hier_from_cfg(cfg_j, jb, caps)
        out, _ = model.apply({"params": p, "batch_stats": state.batch_stats},
                             jb, hier, train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(0)})
        return js._losses(cfg_j, out, jb, cw)[0]

    jgrads = jax.jit(jax.grad(loss_fn))(state.params)

    tmodel = load_jax_variables(build_model(cfg_t, "cpu"), params, stats)
    opt, _ = build_optimizer(cfg_t, tmodel.parameters())
    tgrads = {}
    names = {id(p): n for n, p in tmodel.named_parameters()}
    opt.register_step_pre_hook(lambda o, a, k: tgrads.update(
        {names[id(p)]: p.grad.clone() for g in o.param_groups
         for p in g["params"]}))
    calls = []
    orig = tsc.binned_conv_slots_bwd
    tsc.binned_conv_slots_bwd = lambda *a: calls.append(1) or orig(*a)
    try:
        tmetrics = ts.make_train_step(cfg_t, tmodel, opt)(
            ts.device_batch(batch, "cpu"), torch.Generator(), caps)
    finally:
        tsc.binned_conv_slots_bwd = orig
    return (jmetrics, jax.tree_util.tree_map(np.asarray, jgrads), tmetrics,
            tgrads, tmodel, len(calls))


def test_per_voxel_train_step_matches_jax(one_step):
    """Losses, confusion matrices, overflow counters and every gradient
    (leaf by leaf), K1' forward and K2' backward at every ks3 conv of
    L0-L3 (30 of them at cr 1), dense L4."""
    jmetrics, jgrads, tmetrics, tgrads, tmodel, n_k2 = one_step
    assert n_k2 == 30
    for k in ("total_loss", "seg_loss_2d", "seg_loss_3d", "xm_loss_2d",
              "xm_loss_3d"):
        np.testing.assert_allclose(tmetrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("voxel_overflow", "tap_overflow"):
        assert int(tmetrics[k]) == int(jmetrics[k]) == 0, k
    for k in ("cm_2d", "cm_3d"):
        np.testing.assert_array_equal(tmetrics[k].numpy(),
                                      np.asarray(jmetrics[k]))
    paths = jax_leaf_paths(tmodel)
    shares = []
    for name, g in tgrads.items():
        want = jgrads
        for key in paths[name][1]:
            want = want[key]
        scale = float(np.abs(want).max())
        err = float(np.abs(g.numpy() - want).max())
        if scale == 0.0:
            assert err == 0.0, name
            continue
        assert err <= LEAF_RTOL * scale + LEAF_ATOL, (name, err, scale)
        shares.append(err / scale)
    assert np.median(shares) <= MEDIAN_RTOL, np.median(shares)


# --------------------------------------------------------------------------- #
def test_per_voxel_engine_matches_jax_under_tap_overflow(weights):
    """InferenceEngine with CONV_SLOT_POOL off at K=4 (lossy) against the
    JAX engine: the same labels, and voxel_overflow counting the dropped
    live taps."""
    params, stats = weights
    jax_engine = JEngine(_per_voxel_cfg(jcfg, LOSSY, train=False),
                         params=params, batch_stats=stats)
    cfg = _per_voxel_cfg(get_default_cfg, LOSSY, train=False)
    port = InferenceEngine(cfg, model=load_jax_variables(
        build_model(cfg, device="cpu"), params, stats), device="cpu")
    assert port._slot_pool is None
    for i in range(2):
        rec = record(i)
        want, got = jax_engine.predict(rec), port.predict(rec)
        for key in ("labels", "labels_2d", "labels_3d"):
            agree = np.mean(got[key] == want[key])
            assert agree >= 0.999, (key, agree)
    jst, tst = jax_engine.stats(), port.stats()
    assert tst["voxel_overflow"] == jst["voxel_overflow"] > 0


def test_per_voxel_and_group_pooled_paths_give_the_same_logits(weights):
    """With lossless maps the two kinds of slot map compute one function:
    the same model and scan through both engines, f32, within 1e-5.
    ``TPU.CONV_PALLAS`` has no meaning in the port: the per-voxel logits
    are bitwise equal with it off."""
    outs = {}
    for pool, pallas in ((True, True), (False, True), (False, False)):
        cfg = tiny_cfg(get_default_cfg)
        cfg.defrost()
        cfg.TPU.CONV_SLOT_POOL = pool
        cfg.TPU.CONV_PALLAS = pallas
        cfg.freeze()
        eng = InferenceEngine(cfg, model=load_jax_variables(
            build_model(cfg, device="cpu"), *weights), device="cpu")
        sample = eng.preprocess(record(7))
        batch, outs[pool, pallas] = eng.forward([sample])
        assert ("gslot_src_0" in batch) == pool
        hier = ts.hier_from_cfg(cfg, ts.device_batch(batch, "cpu"))
        kinds = [None if l.slot_idx is None else l.slot_idx[0].shape[0]
                 == l.valid.shape[0] for l in hier.levels]
        assert kinds == [not pool] * 4 + [None]
        if not pool:
            assert int(ts.tap_overflow(hier, LOSSLESS)) == 0
    for k, got in outs[False, True].items():
        want = outs[True, True][k]
        assert float(want.abs().max()) > 1e-2, k
        _close(got.numpy(), want.numpy(), 1e-5)
        assert torch.equal(outs[False, False][k], got), k
