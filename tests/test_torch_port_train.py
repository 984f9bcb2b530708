"""The port's train step, losses, metrics, optimizer and data path against
the JAX package's, on the CPU, at the small config of
``test_torch_port_common.tiny_cfg`` (ViT 32 px / width 64 / depth 2, SPVCNN
cr 1, 40x60 images, ~900-point SyntheticSCN scans with group-pooled slot
maps at adaptive capacities).

Tolerances (all f32, true f32 on both sides):
* losses: 1e-5 relative — the same arithmetic summed in other orders;
* gradients: each leaf within 2e-2 of that leaf's largest |g| plus 1e-7,
  and the median leaf within 1e-4 (measured: median 1.7e-6, worst 6.7e-3
  on a BatchNorm bias at L3).  Gradients cross up to ~40 train-mode
  BatchNorms, which divide by a batch std over a few hundred voxels at L3,
  and ReLU masks flip at ties: JAX's own gradients move by up to 4e-3 of a
  leaf's largest |g| when its parameters move by 1e-7 relative.  A bias
  right before a BatchNorm has a true gradient of 0 (both sides give
  ~1e-9 of roundoff): the 1e-7 absolute term covers it.  A leaf JAX gives an
  exact zero gradient must be exactly zero here too;
* BatchNorm running statistics: 1e-5;
* confusion matrices: exactly equal;
* optimizer: params within 1e-6 after 3 steps from the same gradients.
Dropout is neutralised on both sides inside the whole-step test only.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.data.collate import collate_padded as j_collate
from fusiontransformer_tpu.data.loader import DataLoader as JLoader
from fusiontransformer_tpu.data.synthetic import SyntheticSCN as JSynthetic
from fusiontransformer_tpu.models import losses as jl
from fusiontransformer_tpu.models import metric as jm
from fusiontransformer_tpu.models.build import build_model as j_build
from fusiontransformer_tpu.modules import steps as js
from fusiontransformer_tpu.modules.SemanticTrainer import init_train_state
from fusiontransformer_tpu.ops.host_slots import SlotPoolSpec as JSpec
from fusiontransformer_tpu.solver.build import build_optimizer as j_opt
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data.build import build_dataloader
from fusiontransformer_tpu_torch.data.collate import collate_padded
from fusiontransformer_tpu_torch.data.loader import DataLoader, batch_seed
from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
from fusiontransformer_tpu_torch.models import losses as tl
from fusiontransformer_tpu_torch.models import metric as tm
from fusiontransformer_tpu_torch.models import spvcnn
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.modules import steps as ts
from fusiontransformer_tpu_torch.ops.host_slots import SlotPoolSpec
from fusiontransformer_tpu_torch.solver.build import build_optimizer
from fusiontransformer_tpu_torch.utils.convert_jax import (jax_leaf_paths,
                                                           load_jax_variables)

from test_torch_port_common import (CLASS_WEIGHTS, LEAF_ATOL, LEAF_RTOL,
                                    MEDIAN_RTOL, H, W, train_cfg)

AUG = dict(noisy_rot=0.1, flip_y=0.5, rot_z=6.2831, transl=True)


# --------------------------------------------------------------------------- #
def test_losses_and_confusion_matrix_match_jax():
    rs = np.random.RandomState(0)
    n, c = 500, 20
    s, t = (rs.randn(n, c).astype(np.float32) * 3 for _ in range(2))
    labels = rs.randint(0, c, n).astype(np.int32)
    valid = rs.rand(n) < 0.8
    cw = np.asarray(CLASS_WEIGHTS, np.float32)
    j = [jnp.asarray(a) for a in (s, t, labels, valid, cw)]
    p = [torch.as_tensor(a) for a in (s, t, labels, valid, cw)]
    for weights in (True, False):
        want = jl.weighted_cross_entropy(j[0], j[2], j[3],
                                         j[4] if weights else None)
        got = tl.weighted_cross_entropy(p[0], p[2], p[3],
                                        p[4] if weights else None)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        tl.kl_divergence(p[0], p[1], p[3]).item(),
        float(jl.kl_divergence(j[0], j[1], j[3])), rtol=1e-5)
    # The teacher is detached: no gradient reaches it.
    tt = p[1].clone().requires_grad_(True)
    ss = p[0].clone().requires_grad_(True)
    tl.kl_divergence(ss, tt, p[3]).backward()
    assert tt.grad is None and ss.grad.abs().max() > 0
    want_cm = np.asarray(jm.confusion_matrix_from_logits(j[0], j[2], j[3],
                                                         c))
    got_cm = tm.confusion_matrix_from_logits(p[0], p[2], p[3], c).numpy()
    np.testing.assert_array_equal(got_cm, want_cm)
    ji, ti = jm.SegIoU(c), tm.SegIoU(c)
    for cm in (want_cm, want_cm.T):
        ji.update_matrix(cm)
        ti.update_matrix(cm)
    np.testing.assert_array_equal(ti.iou, ji.iou)
    assert ti.global_avg == ji.global_avg


@pytest.mark.parametrize("opt", ["Adam", "SGD"])
def test_optimizer_matches_optax(opt):
    """The same numpy gradients into optax's chain and the port's torch
    optimizer, 3 steps with coupled weight decay."""
    rs = np.random.RandomState(1)
    shapes = {"a": (5, 3), "b": (7,)}
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) * 0.1
              for k, s in shapes.items()} for _ in range(3)]
    tx, _ = j_opt(train_cfg(jcfg, opt))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    topt, _ = build_optimizer(train_cfg(get_default_cfg, opt), tp.values())
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.tensor(g[k])
        topt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


def test_grad_accumulation_is_not_ported():
    """Accumulation is ported now (held against ``optax.MultiSteps`` in
    ``test_torch_port_grad_accum.py``): k > 1 builds the optimizer, and a
    k below 1 is refused."""
    cfg = train_cfg(get_default_cfg)
    cfg.defrost()
    cfg.TRAIN.GRAD_ACCUM_STEPS = 2
    opt, _ = build_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, torch.optim.Optimizer)
    cfg.TRAIN.GRAD_ACCUM_STEPS = 0
    with pytest.raises(ValueError, match="GRAD_ACCUM_STEPS"):
        build_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])


def test_lr_schedules_match_jax():
    from fusiontransformer_tpu.solver.build import make_lr_schedule as jsched
    from fusiontransformer_tpu_torch.solver.build import make_lr_schedule
    for name, key, val in (("StepLR", "step_size", 2),
                           ("MultiStepLR", "milestones", (1, 3))):
        cfgs = []
        for get in (jcfg, get_default_cfg):
            cfg = train_cfg(get)
            cfg.defrost()
            cfg.SCHEDULER.TYPE = name
            cfg.SCHEDULER[name][key] = val
            cfg.SCHEDULER.CLIP_LR = 2e-3
            cfgs.append(cfg)
        a, b = jsched(cfgs[0], 3), make_lr_schedule(cfgs[1], 3)
        assert [a(s) for s in range(20)] == [b(s) for s in range(20)]


# --------------------------------------------------------------------------- #
def test_training_data_path_matches_jax():
    """Augmented train items, level counts, adaptive capacities, slot maps
    and the loader's batch order and per-batch seeds."""
    jds = JSynthetic(split=("train",), num_scans=3, num_points=900,
                     image_height=H, image_width=W, output_orig=True, **AUG)
    tds = SyntheticSCN(split=("train",), num_scans=3, num_points=900,
                       image_height=H, image_width=W, **AUG)
    for i in range(3):
        a, b = jds[i], tds[i]
        for k in ("coords", "feats", "seg_label", "img_indices", "img",
                  "inverse_map"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    fr = (1.0, 0.9, 0.8, 0.7)
    jspec = JSpec([0, 1, 2, 3], 1.0, fr, adaptive=True)
    tspec = SlotPoolSpec([0, 1, 2, 3], 1.0, fr, adaptive=True)
    samples = [jds[0], jds[1]]
    jb = j_collate(samples, 2, 1024, H, W, output_orig=True,
                   level_counts=5, slot_pool=jspec)
    tb = collate_padded([tds[0], tds[1]], 2, 1024, H, W, level_counts=5,
                        slot_pool=tspec)
    for k in ("level_counts", "level_counts_per_scan", "coords",
              *(f"gslot_{m}_{l}" for m in ("src", "bin") for l in range(4))):
        np.testing.assert_array_equal(np.sort(jb[k], axis=-1)
                                      if k.startswith("gslot") else jb[k],
                                      np.sort(tb[k], axis=-1)
                                      if k.startswith("gslot") else tb[k],
                                      err_msg=k)
    cfg_j, cfg_t = train_cfg(jcfg), train_cfg(get_default_cfg)
    assert js.adaptive_level_caps(cfg_j, 2048, jb["level_counts"]) == \
        ts.adaptive_level_caps(cfg_t, 2048, tb["level_counts"])
    for n_levels in (5,):
        counts = tb["level_counts"][:n_levels]
        assert tspec.caps_for(2048, counts) == jspec.caps_for(2048, counts)
    jload = JLoader(list(range(11)), 3, list, shuffle=True, seed=4)
    tload = DataLoader(list(range(11)), 3, list, shuffle=True, seed=4)
    for epoch in (0, 2):
        jload.set_epoch(epoch)
        tload.set_epoch(epoch)
        assert [list(b) for b in jload._index_batches()] == \
            [list(b) for b in tload._index_batches()]
        assert batch_seed(4, epoch, 3) == ((4 + epoch) * 100003 + 3) % (
            2 ** 31 - 1)


# --------------------------------------------------------------------------- #
class _NoDropout(fnn.Module):
    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


@pytest.fixture(scope="module")
def one_step():
    """One train step of each package from the same weights and batch."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn, "Dropout", _NoDropout)
    mp.setattr(spvcnn, "DROPOUT", 0.0)
    try:
        yield _one_step()
    finally:
        mp.undo()


def _one_step():
    cfg_j, cfg_t = train_cfg(jcfg), train_cfg(get_default_cfg)
    loader = build_dataloader(cfg_t, "train")
    batch = next(iter(loader))
    assert batch["gslot_overflow"] == 0
    caps = ts.batch_level_caps(cfg_t, batch)

    # JAX: make_train_step, and jax.grad of its loss for the gradients.
    model = j_build(cfg_j)[0]
    tx, _ = j_opt(cfg_j)
    state = init_train_state(cfg_j, model, tx, 2, rng_seed=5)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    jb = js._device_batch(batch)
    step, _ = js.make_train_step(cfg_j, model, tx, 2, level_caps=caps)
    new_state, jmetrics = jax.jit(step)(state, jb, jax.random.PRNGKey(0))
    cw = jnp.asarray(cfg_j.TRAIN.CLASS_WEIGHTS, jnp.float32)

    def loss_fn(p):
        hier = js._hier_from_cfg(cfg_j, jb, caps)
        out, _ = model.apply({"params": p, "batch_stats": state.batch_stats},
                             jb, hier, train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(0)})
        return js._losses(cfg_j, out, jb, cw)[0]

    jgrads = jax.jit(jax.grad(loss_fn))(state.params)

    # Port: the same weights through make_train_step on the CPU.
    tmodel = load_jax_variables(build_model(cfg_t, "cpu"), params, stats)
    opt, _ = build_optimizer(cfg_t, tmodel.parameters())
    tgrads = {}
    names = {id(p): n for n, p in tmodel.named_parameters()}
    opt.register_step_pre_hook(lambda o, a, k: tgrads.update(
        {names[id(p)]: p.grad.clone() for g in o.param_groups
         for p in g["params"]}))
    tstep = ts.make_train_step(cfg_t, tmodel, opt)
    tmetrics = tstep(ts.device_batch(batch, "cpu"), torch.Generator(), caps)
    return (jmetrics, jax.tree_util.tree_map(np.asarray, jgrads),
            jax.tree_util.tree_map(np.asarray, new_state.batch_stats),
            tmetrics, tgrads, tmodel)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_train_step_losses_and_confusions_match_jax(one_step):
    jmetrics, _, _, tmetrics, _, _ = one_step
    for k in ("total_loss", "seg_loss_2d", "seg_loss_3d", "xm_loss_2d",
              "xm_loss_3d"):
        np.testing.assert_allclose(tmetrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)
    assert int(tmetrics["voxel_overflow"]) == int(jmetrics["voxel_overflow"])
    assert int(tmetrics["voxel_overflow"]) == 0
    for k in ("cm_2d", "cm_3d"):
        np.testing.assert_array_equal(tmetrics[k].numpy(),
                                      np.asarray(jmetrics[k]))


def test_train_step_gradients_match_jax(one_step):
    """Every parameter's gradient, leaf by leaf through the port->JAX name
    map, including the K1/K2 conv kernels at L0-L3 and the dense L4 path."""
    _, jgrads, _, _, tgrads, tmodel = one_step
    paths = jax_leaf_paths(tmodel)
    assert len(tgrads) == sum(1 for c, _ in paths.values() if c == "params")
    shares = []
    for name, g in tgrads.items():
        coll, path = paths[name]
        want = _leaf(jgrads, path)
        scale = float(np.abs(want).max())
        err = float(np.abs(g.numpy() - want).max())
        if scale == 0.0:
            assert err == 0.0, name
            continue
        assert err <= LEAF_RTOL * scale + LEAF_ATOL, (name, err, scale)
        shares.append(err / scale)
    assert np.median(shares) <= MEDIAN_RTOL, np.median(shares)


def test_train_step_batchnorm_stats_match_jax(one_step):
    _, _, jstats, _, _, tmodel = one_step
    for name, buf in tmodel.named_buffers():
        _, path = jax_leaf_paths(tmodel)[name]
        np.testing.assert_allclose(buf.numpy(), _leaf(jstats, path),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_lidar_losses_send_no_gradient_into_the_image_stream(one_step):
    """Image features are detached before fusion: the middle-block tap that
    feeds only the lidar stream gets an exactly zero gradient."""
    _, jgrads, _, _, tgrads, _ = one_step
    taps = [n for n in tgrads if n.startswith("image_backbone.up_0.")]
    assert taps
    for n in taps:
        assert not tgrads[n].any(), n
    assert any(tgrads[n].abs().max() > 0 for n in tgrads
               if n.startswith("image_backbone.up_1."))
