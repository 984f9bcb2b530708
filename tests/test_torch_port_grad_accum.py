"""``TRAIN.GRAD_ACCUM_STEPS > 1`` in the port against ``optax.MultiSteps``
and the JAX package's trainer step, on the CPU, at the small config of
``test_torch_port_common.train_cfg``.

Tolerances:
* the optimizer's update after k micro-batches against MultiSteps': 1e-6
  relative (as ``tests/test_grad_accum.py``: MultiSteps keeps a running
  mean, the port the sum divided by k, the same up to f32 rounding);
* a trainer step pair against JAX's: losses 1e-5 relative, BatchNorm
  statistics 1e-5, each parameter's update within the per-leaf gradient
  bound of ``tests/test_torch_port_train.py`` (``LEAF_RTOL`` of the leaf's
  largest update plus lr x ``LEAF_ATOL``; a sum in place of the mean is off
  by the whole update).  Its median bound is not held here: on these two
  small batches train-mode BatchNorm amplifies f32 order differences so
  that even one plain step's median leaf reads 4e-4 to 1e-3 (on the batch
  of that file 2e-6).  The pair runs SGD: Adam's first update hardly
  depends on the gradient's scale, so it would not tell a mean from a sum;
* parameters between updates, and a resumed run against an uninterrupted
  one: bit for bit.
"""

import logging

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.models.build import build_model as j_build
from fusiontransformer_tpu.modules import steps as js
from fusiontransformer_tpu.modules.SemanticTrainer import init_train_state
from fusiontransformer_tpu.solver.build import build_optimizer as j_opt
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.models import spvcnn
from fusiontransformer_tpu_torch.modules import steps as ts
from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
    SemanticTrainer)
from fusiontransformer_tpu_torch.solver.build import build_optimizer
from fusiontransformer_tpu_torch.utils.convert_jax import (jax_leaf_paths,
                                                           load_jax_variables)

from test_torch_port_common import (LEAF_ATOL, LEAF_RTOL,  # noqa: F401
                                   one_thread, train_cfg)
from test_torch_port_trainer import trainer_cfg


def _opt_cfg(get_cfg, accum):
    cfg = get_cfg()
    cfg.OPTIMIZER.TYPE = "Adam"
    cfg.OPTIMIZER.BASE_LR = 1e-2
    cfg.OPTIMIZER.WEIGHT_DECAY = 5e-4
    cfg.TRAIN.GRAD_ACCUM_STEPS = accum
    return cfg


def test_accumulated_update_matches_multisteps():
    """Two windows of two micro-batches: the parameters do not move inside
    a window, and each window's update is MultiSteps'."""
    rs = np.random.RandomState(0)
    p0 = rs.randn(4, 3).astype(np.float32)
    grads = [rs.randn(4, 3).astype(np.float32) for _ in range(4)]
    tx, _ = j_opt(_opt_cfg(jcfg, 2))
    jp = {"w": jnp.asarray(p0)}
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.tensor(p0))
    opt, _ = build_optimizer(_opt_cfg(get_default_cfg, 2), [p])
    p.grad = torch.zeros_like(p)
    for i, g in enumerate(grads):
        j_before = np.asarray(jp["w"])
        upd, state = tx.update({"w": jnp.asarray(g)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        before = p.detach().clone()
        p.grad += torch.tensor(g)             # what the backward adds
        if i % 2:
            ts.apply_gradients(opt, [p.grad], 2)
            assert not p.grad.any()
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp["w"]), rtol=1e-6,
                                       atol=1e-7)
        else:
            assert torch.equal(p.detach(), before)
            assert np.array_equal(np.asarray(jp["w"]), j_before)


class _NoDropout(fnn.Module):
    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture
def no_dropout():
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn, "Dropout", _NoDropout)
    mp.setattr(spvcnn, "DROPOUT", 0.0)
    yield
    mp.undo()


def test_trainer_accumulates_like_jax(tmp_path, no_dropout):
    """Two micro-batches through the port's trainer and JAX's train step
    (``optax.MultiSteps``) from the same weights: the odd micro-step leaves
    the parameters bitwise unchanged on both sides, the even one applies
    the mean gradient.  The large rate keeps each parameter's update far
    above the f32 rounding of the parameter."""
    lr = 100.0

    def cfg_of(get_cfg):
        cfg = train_cfg(get_cfg, opt="SGD")
        cfg.defrost()
        cfg.OPTIMIZER.BASE_LR = lr
        cfg.TRAIN.GRAD_ACCUM_STEPS = 2
        cfg.TPU.ADAPTIVE_LEVEL_CAPS = False
        cfg.DATASET.SyntheticSCN.num_scans = 4
        cfg.VAL.PERIOD = 0
        cfg.OUTPUT_DIR = ""
        cfg.freeze()
        return cfg

    cfg_j, cfg_t = cfg_of(jcfg), cfg_of(get_default_cfg)
    model = j_build(cfg_j)[0]
    tx, _ = j_opt(cfg_j)
    state = init_train_state(cfg_j, model, tx, 2, rng_seed=5)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)

    tr = SemanticTrainer(cfg_t, "", device="cpu")
    load_jax_variables(tr.model, params, stats)
    batches = list(tr.train_dataloader)
    assert len(batches) == 2
    caps = ts.level_caps_for_n(cfg_t, len(batches[0]["pt_valid"]))
    assert caps == ts.level_caps_for_n(cfg_t, len(batches[1]["pt_valid"]))
    step = jax.jit(js.make_train_step(cfg_j, model, tx, 2,
                                      level_caps=caps)[0])

    p0 = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    jm, tm = [], []
    for i, batch in enumerate(batches):
        state, m = step(state, js._device_batch(batch),
                        jax.random.PRNGKey(i))
        jm.append(m)
        tm.append(tr.run_train_step(batch).numpy())
        if i == 0:
            for n, p in tr.model.named_parameters():
                assert torch.equal(p.detach(), p0[n]), n
            assert all(np.array_equal(a, b) for a, b in zip(
                jax.tree_util.tree_leaves(state.params),
                jax.tree_util.tree_leaves(params)))
    for a, b in zip(jm, tm):
        for k in ("total_loss", "seg_loss_2d", "seg_loss_3d"):
            np.testing.assert_allclose(b[k], float(a[k]), rtol=1e-5,
                                       err_msg=k)
    paths = jax_leaf_paths(tr.model)
    for name, buf in tr.model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), _leaf(
            state.batch_stats, paths[name][1]), rtol=1e-5, atol=1e-5,
            err_msg=name)
    for name, p in tr.model.named_parameters():
        want = np.asarray(_leaf(state.params, paths[name][1])) \
            - p0[name].numpy()
        got = (p.detach() - p0[name]).numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= LEAF_RTOL * scale + lr * LEAF_ATOL, (name, err, scale)


def _accum_cfg(tmp_path, accum, epochs):
    tmp_path.mkdir(parents=True, exist_ok=True)
    return trainer_cfg(tmp_path, **{"TRAIN.GRAD_ACCUM_STEPS": accum,
                                    "SCHEDULER.MAX_EPOCH": epochs,
                                    "DATASET.SyntheticSCN.num_scans": 6})


def _state(tr):
    return ({k: v.clone() for k, v in tr.model.state_dict().items()},
            [g.clone() for g in tr.train_step.grads])


def test_a_resumed_run_matches_an_uninterrupted_one(tmp_path, caplog):
    """3 steps an epoch with GRAD_ACCUM_STEPS 2: the first epoch ends inside
    a window, whose gradients (and the dropout generator) its checkpoint
    keeps; a run resumed from that checkpoint ends the second epoch where
    the uninterrupted run does, bit for bit."""
    with caplog.at_level(logging.WARNING):
        whole = SemanticTrainer(_accum_cfg(tmp_path / "a", 2, 2),
                                str(tmp_path / "a"), device="cpu")
    assert "not a multiple of TRAIN.GRAD_ACCUM_STEPS" in caplog.text
    whole.train()
    assert whole.step == 6
    cfg = _accum_cfg(tmp_path / "b", 2, 2)
    cfg.defrost()
    cfg.RESUME_PATH = str(tmp_path / "a" / "model000000.pth")
    cfg.freeze()
    resumed = SemanticTrainer(cfg, str(tmp_path / "b"), device="cpu")
    assert resumed.step == 3 and resumed.start_epoch == 1
    assert any(g.any() for g in resumed.train_step.grads)   # the open window
    resumed.train()
    (ma, ga), (mb, gb) = _state(whole), _state(resumed)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


def test_resume_with_another_accumulation_raises(tmp_path):
    SemanticTrainer(_accum_cfg(tmp_path, 2, 1), str(tmp_path),
                    device="cpu").train()
    with pytest.raises(ValueError, match="GRAD_ACCUM_STEPS=2 but the run "
                       "has 1"):
        SemanticTrainer(_accum_cfg(tmp_path, 1, 2), str(tmp_path),
                        device="cpu")
    cfg = _accum_cfg(tmp_path, 1, 2)
    cfg.defrost()
    cfg.RESUME_STATES = False            # the optimizer state is dropped
    cfg.freeze()
    tr = SemanticTrainer(cfg, str(tmp_path), device="cpu")
    assert not any(g.any() for g in tr.train_step.grads)


def test_a_resume_without_states_opens_a_fresh_window(tmp_path):
    """RESUME_STATES False drops the open window's gradients and its count
    with the optimizer state, as JAX drops ``optax.MultiSteps``' state:
    after a resume from a checkpoint saved mid-window (step 3 of k = 2),
    one micro-step leaves every parameter bitwise unchanged, the second
    moves them."""
    SemanticTrainer(_accum_cfg(tmp_path / "a", 2, 1), str(tmp_path / "a"),
                    device="cpu").train()
    cfg = _accum_cfg(tmp_path / "b", 2, 2)
    cfg.defrost()
    cfg.RESUME_PATH = str(tmp_path / "a" / "model000000.pth")
    cfg.RESUME_STATES = False
    cfg.freeze()
    tr = SemanticTrainer(cfg, str(tmp_path / "b"), device="cpu")
    assert tr.step == 3 and tr.window == 0
    assert not any(g.any() for g in tr.train_step.grads)
    batches = list(tr.train_dataloader)
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    tr.run_train_step(batches[0])
    for n, p in tr.model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    assert tr.window == 1
    tr.run_train_step(batches[1])
    moved = [n for n, p in tr.model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    assert len(moved) > 0.9 * len(before) and tr.window == 0

