"""What the trainer's CUDA graphs need from the train and eval steps, on the
CPU, against the JAX package where it has a counterpart:

* the confusion matrix counted into a fixed number of bins (no bincount,
  which reads its size back from the card) equals JAX's
  ``confusion_matrix_from_logits`` exactly;
* Adam with its learning rate in a tensor, changed in place between steps
  (what a replay reads), equals optax's chain with the injected rate
  changed by the JAX package's ``set_learning_rate``: params within 1e-6
  after 3 steps;
* ``index_rows``' gradient (``index_put_`` with ``accumulate`` on the card)
  equals ``index_select``'s on the CPU, bitwise;
* the train step's gradient part and the eval step take no host data and
  read nothing back to the host after their first run (a capture records
  the second run); the optimizer's part is held on the card
  (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``), since Adam on the
  CPU is not capturable and reads its step count on the host;
* a checkpoint load drops every captured graph.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.models import metric as jm
from fusiontransformer_tpu.solver.build import build_optimizer as j_opt
from fusiontransformer_tpu.solver.build import \
    set_learning_rate as j_set_lr
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data.build import build_dataloader
from fusiontransformer_tpu_torch.models import metric as tm
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.modules import steps as ts
from fusiontransformer_tpu_torch.ops.sparse_conv import index_rows
from fusiontransformer_tpu_torch.solver.build import (build_optimizer,
                                                      get_learning_rate,
                                                      set_learning_rate)

from test_torch_port_common import (one_thread,  # noqa: F401
                                   refuse_host_data, train_cfg)


@pytest.mark.parametrize("seed,valid_share", [(0, 0.8), (1, 0.0), (2, 1.0)])
def test_fixed_bin_confusion_matrix_equals_jax(seed, valid_share):
    rs = np.random.RandomState(seed)
    n, c = 3000, 20
    logits = rs.randn(n, c).astype(np.float32)
    labels = rs.randint(0, c, n).astype(np.int32)
    valid = rs.rand(n) < valid_share
    want = np.asarray(jm.confusion_matrix_from_logits(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid), c))
    got = tm.confusion_matrix_from_logits(
        torch.as_tensor(logits), torch.as_tensor(labels),
        torch.as_tensor(valid), c)
    assert got.dtype == torch.int64 and got.shape == (c, c)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tensor_lr_adam_with_an_lr_change_matches_optax():
    rs = np.random.RandomState(1)
    shapes = {"a": (5, 3), "b": (7,)}
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) * 0.1
              for k, s in shapes.items()} for _ in range(3)]
    rates = [1e-2, 3e-3, 3e-3]
    tx, _ = j_opt(train_cfg(jcfg))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    topt, _ = build_optimizer(train_cfg(get_default_cfg), tp.values())
    lr_tensor = topt.param_groups[0]["lr"]
    assert torch.is_tensor(lr_tensor)
    for g, lr in zip(grads, rates):
        state = j_set_lr(state, lr)
        set_learning_rate(topt, lr)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.tensor(g[k])
        topt.step()
    # The rate was changed in place: the optimizer holds the same tensor.
    assert topt.param_groups[0]["lr"] is lr_tensor
    assert get_learning_rate(topt) == pytest.approx(rates[-1])
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


def test_index_rows_gradient_equals_index_select_bitwise():
    rs = np.random.RandomState(3)
    table = torch.tensor(rs.randn(50, 7).astype(np.float32),
                         requires_grad=True)
    idx = torch.tensor(rs.randint(0, 50, (400, 2)))
    g = torch.tensor(rs.randn(400, 2, 7).astype(np.float32))
    (index_rows(table, idx) * g).sum().backward()
    ref = table.detach().clone().requires_grad_(True)
    (ref.index_select(0, idx.reshape(-1)).reshape(400, 2, 7) * g).sum() \
        .backward()
    assert torch.equal(table.grad, ref.grad)


@pytest.fixture(scope="module")
def step_parts():
    cfg = train_cfg(get_default_cfg)
    batch = next(iter(build_dataloader(cfg, "train")))
    model = build_model(cfg, "cpu", seed=4)
    opt, _ = build_optimizer(cfg, model.parameters())
    return (cfg, ts.make_train_step(cfg, model, opt),
            ts.make_eval_step(cfg, model), ts.device_batch(batch, "cpu"),
            ts.batch_level_caps(cfg, batch))


@pytest.mark.parametrize("slot_pool", [True, False],
                         ids=["group-pooled", "per-voxel"])
def test_train_and_eval_steps_read_nothing_back_after_their_first_run(
        monkeypatch, step_parts, slot_pool):
    cfg, train_step, eval_step, db, caps = step_parts
    if not slot_pool:
        db = {k: v for k, v in db.items() if not k.startswith("gslot_")}
    gen = torch.Generator().manual_seed(0)
    train_step(db, gen, caps, update=False)
    eval_step(db, caps)
    grads = [g.clone() for g in train_step.grads]
    refuse_host_data(monkeypatch, reads=True)
    metrics = train_step(db, gen, caps, update=False)
    out = eval_step(db, caps)
    monkeypatch.undo()
    assert int(metrics["voxel_overflow"]) == 0
    assert ("tap_overflow" in metrics) == (not slot_pool)
    assert set(out) == {"pred_3d", "pred_2d", "pred_ensemble", "seg_loss_3d",
                        "seg_loss_2d"}
    # Without an update the second run added its gradients to the first's.
    assert any(not torch.equal(g, h) for g, h in zip(train_step.grads,
                                                     grads))
    torch._foreach_zero_(train_step.grads)


def test_a_checkpoint_load_drops_the_graphs(tmp_path):
    from test_torch_port_trainer import trainer_cfg

    from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
        SemanticTrainer)
    cfg = trainer_cfg(tmp_path, **{"VAL.PERIOD": 0})
    tr = SemanticTrainer(cfg, str(tmp_path), device="cpu")
    tr.update_checkpoint(0)
    for cache in (tr.train_graphs, tr.eval_graphs):
        cache["signature"] = object()
    tr.update_graph = object()
    tr._load_checkpoint()
    assert len(tr.train_graphs) == len(tr.eval_graphs) == 0
    assert tr.update_graph is None
