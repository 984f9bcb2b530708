"""The port's data parallelism on the CPU: two gloo ranks, each a spawned
process (``torch_dp_ranks.py``) joined over a ``FileStore`` in
``tmp_path``, against the JAX package's 2-device ``shard_train_step`` on
two of the test session's CPU devices, at the small config of
``test_torch_port_common.train_cfg`` (Adam, f32, global batch 4, per-voxel
maps, the image stream included, dropout off on both sides as in
``tests/test_torch_port_train.py``).

Each of the two train steps starts from JAX's state: the first from its
initial weights, the second from its state after the first step (weights,
BatchNorm statistics, Adam's moments), so that each step is compared from
the same inputs: one Adam step moves every element of a leaf by ~lr
whatever its gradient's size, so an element whose gradient is f32
roundoff (a bias right before a BatchNorm) moves either way, and train-mode
BatchNorm over 2-scan shards turns that into gradients a median 1.5e-2 of
their leaf's largest apart at the next step (measured), far beyond any
bound below.  Tolerances, per step, those of ``test_torch_port_train.py``:
* losses 1e-5 relative (``pmean``); confusion matrices (``psum``) exactly
  equal; BatchNorm running statistics (``pmean``) 1e-5;
* the averaged gradients, read through Adam's first moment (linear in
  them): each leaf within 0.1 x (2e-2 of the mean of its two shards'
  largest |g| plus 1e-7), the per-leaf gradient bound held on each shard
  and averaged: the averaged gradient's own largest |g| can be far below
  its shards' where they cancel;
* the parameters after the step: each leaf's update within 2e-2 of the
  leaf's largest update plus 1e-7, but for the elements whose first moment
  is within the bound above of zero, which may move up to 2 lr either way
  (the bound does not fix their gradient's sign, which Adam's update
  follows).
The median leaf is not held: on these 2-scan shards train-mode BatchNorm
amplifies f32 order differences (as in ``test_torch_port_grad_accum.py``).

Of the port alone, bit for bit: the two ranks' states after each step, each
equal to one process running the two shards' eager steps from the same
state and averaging their gradients and BatchNorm buffers before one
update (``pmean``), and to a bare ``TrainStep`` with the reduce hook
(``update=True``); the validation's summed matrices against JAX's
``validate`` on each rank's ``ShardedView`` summed.  The ranks' run is
joined with a timeout: a hang fails the tests.  The trainer's resume,
``test()`` and keys are ``test_torch_port_dp_trainer.py``'s.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.data.build import build_dataloader as j_loader
from fusiontransformer_tpu.data.utils.validate import validate as j_validate
from fusiontransformer_tpu.models.build import build_model as j_build
from fusiontransformer_tpu.modules import steps as js
from fusiontransformer_tpu.modules.SemanticTrainer import init_train_state
from fusiontransformer_tpu.parallel.data_parallel import (make_mesh,
                                                          replicate,
                                                          shard_train_step)
from fusiontransformer_tpu.solver.build import build_optimizer as j_opt
from fusiontransformer_tpu.utils.metric_logger import MetricLogger as JML
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data.build import build_dataloader
from fusiontransformer_tpu_torch.utils.convert_jax import jax_leaf_paths

import torch_dp_ranks as ranks
from test_torch_port_common import (LEAF_ATOL, LEAF_RTOL,  # noqa: F401
                                    one_thread, train_cfg)

WORLD = 2
GLOBAL_BATCH = 4
LR = 1e-2


def dp_cfg(get_cfg):
    cfg = train_cfg(get_cfg)
    cfg.defrost()
    cfg.TRAIN.BATCH_SIZE = GLOBAL_BATCH
    cfg.OPTIMIZER.BASE_LR = LR
    cfg.TPU.CONV_SLOT_POOL = False
    cfg.TPU.ADAPTIVE_LEVEL_CAPS = False
    cfg.DATASET.SyntheticSCN.num_scans = 2 * GLOBAL_BATCH
    cfg.VAL.BATCH_SIZE = 2
    cfg.VAL.PERIOD = 1
    cfg.OUTPUT_DIR = ""
    cfg.freeze()
    return cfg


class _NoDropout(fnn.Module):
    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _adam(opt_state, field):
    return _tree(next(getattr(part, field) for part in opt_state.inner_state
                      if hasattr(part, field)))


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """JAX's two sharded train steps on a 2-device mesh, its state before
    and after each; the port's two ranks on the same global batches, each
    step from JAX's state before it."""
    cfg_j, cfg_t = dp_cfg(jcfg), dp_cfg(get_default_cfg)
    batches = list(build_dataloader(cfg_t, "train"))
    assert len(batches) == 2 and all(len(b["scan_count"]) == GLOBAL_BATCH
                                     for b in batches)
    assert not any(k.startswith("gslot_") for k in batches[0])

    mp_ = pytest.MonkeyPatch()
    mp_.setattr(fnn, "Dropout", _NoDropout)
    try:
        model = j_build(cfg_j)[0]
        tx, _ = j_opt(cfg_j)
        state = init_train_state(cfg_j, model, tx, 1, rng_seed=5)
        spd = GLOBAL_BATCH // WORLD
        step, _ = js.make_train_step(cfg_j, model, tx, spd, axis_name="data")
        mesh = make_mesh(WORLD)
        sharded = shard_train_step(step, mesh, spd)
        states = [{"params": _tree(state.params),
                   "stats": _tree(state.batch_stats)}]
        state = replicate(state, mesh)
        for i, b in enumerate(batches):
            state, m = sharded(state, js._device_batch(b),
                               jax.random.PRNGKey(i))
            states.append({"params": _tree(state.params),
                           "stats": _tree(state.batch_stats),
                           "mu": _adam(state.opt_state, "mu"),
                           "nu": _adam(state.opt_state, "nu"),
                           "metrics": _tree(m)})
    finally:
        mp_.undo()
    s1 = states[1]
    port = ranks.spawn(tmp_path_factory.mktemp("dp"), "steps", cfg_t,
                       states[0]["params"], states[0]["stats"], batches,
                       (s1["params"], s1["stats"], s1["mu"], s1["nu"]))
    return states, port


def _paths():
    """The port->JAX name map of the tiny model."""
    from fusiontransformer_tpu_torch.models.build import build_model
    return jax_leaf_paths(build_model(dp_cfg(get_default_cfg), "cpu"))


@pytest.mark.parametrize("i", [0, 1])
def test_dp_step_losses_and_confusions_match_jax(dp_run, i):
    states, port = dp_run
    jm = states[i + 1]["metrics"]
    for r in range(WORLD):
        tm = port[r]["metrics"][i]
        for k in ("total_loss", "seg_loss_2d", "seg_loss_3d", "xm_loss_2d",
                  "xm_loss_3d"):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        assert float(tm["voxel_overflow"]) == float(jm["voxel_overflow"])
        assert float(tm["tap_overflow"]) == float(jm["tap_overflow"]) == 0
        for k in ("cm_2d", "cm_3d"):
            np.testing.assert_array_equal(tm[k], np.asarray(jm[k]))


@pytest.mark.parametrize("i", [0, 1])
def test_dp_step_batchnorm_stats_match_jax(dp_run, i):
    states, port = dp_run
    paths = _paths()
    for name, buf in port[0]["trainer"][i]["buffers"].items():
        np.testing.assert_allclose(
            buf.numpy(), _leaf(states[i + 1]["stats"], paths[name][1]),
            rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("i", [0, 1])
def test_dp_step_averages_gradients_as_jax_pmeans(dp_run, i):
    """Adam's first moment after the step, leaf by leaf: 0.1 g (step 1),
    0.9 m + 0.1 g from the same m (step 2)."""
    states, port = dp_run
    paths = _paths()
    moments = port[0]["trainer"][i]["moments"]
    shard_max = port[0]["shard_grad_max"][i]
    assert len(moments) > 100
    for name, m in moments.items():
        want = _leaf(states[i + 1]["mu"], paths[name][1])
        err = float(np.abs(m.numpy() - want).max())
        bound = 0.1 * (LEAF_RTOL * np.mean(shard_max[name]) + LEAF_ATOL)
        assert err <= bound + 1e-7 * float(np.abs(want).max()), \
            (name, err, bound)


@pytest.mark.parametrize("i", [0, 1])
def test_dp_adam_step_updates_the_parameters_as_jax(dp_run, i):
    """Each leaf's update within 2e-2 of its largest plus 1e-7, but for the
    elements whose first moment (JAX's) is within the moment bound of
    ``test_dp_step_averages_gradients_as_jax_pmeans`` of zero: the bound
    does not fix the sign of their gradient, which sets Adam's update."""
    states, port = dp_run
    paths = _paths()
    trainer = port[0]["trainer"][i]
    shard_max = port[0]["shard_grad_max"][i]
    free = 0
    for name, p in trainer["params"].items():
        path = paths[name][1]
        start = _leaf(states[i]["params"], path)
        want = _leaf(states[i + 1]["params"], path) - start
        got = p.numpy() - start
        mu = np.abs(_leaf(states[i + 1]["mu"], path))
        unsigned = mu <= 0.1 * (LEAF_RTOL * np.mean(shard_max[name])
                                + LEAF_ATOL)
        free += int(unsigned.sum())
        err = np.abs(got - want)
        assert (err[unsigned] <= 2 * 2 * LR).all(), name
        held = err[~unsigned]
        if held.size:
            scale = float(np.abs(want).max())
            assert held.max() <= LEAF_RTOL * scale + LEAF_ATOL, \
                (name, float(held.max()), scale)
    total = sum(p.numel() for p in trainer["params"].values())
    assert free < total


def test_dp_steps_are_one_process_averaging_the_shards(dp_run):
    """On both ranks, after each step, bit for bit: the parameters,
    BatchNorm buffers and Adam moments of the trainer, of one process
    running both shards' steps from the same state and averaging before
    one update, and (first step) of a bare ``TrainStep`` with the reduce
    hook; and the trainer's reduced metrics those of the hook."""
    _, port = dp_run
    for r in range(WORLD):
        out = port[r]
        for i in range(2):
            for other in ("ref", "hooked")[:2 - i]:
                for kind in ("params", "buffers", "moments"):
                    a, b = out["trainer"][i][kind], out[other][i][kind]
                    assert a.keys() == b.keys()
                    bad = [n for n in a if not torch.equal(a[n], b[n])]
                    assert not bad, (r, i, other, kind, bad[:5])
                    same = port[0]["trainer"][i][kind]
                    assert all(torch.equal(a[n], same[n]) for n in a)
            for k, v in out["metrics"][i].items():
                np.testing.assert_array_equal(v, port[0]["metrics"][i][k],
                                              err_msg=k)
        for k, v in out["metrics"][0].items():
            np.testing.assert_array_equal(v, out["hooked_metrics"][0][k],
                                          err_msg=k)


def test_scan_ids_are_rebased_for_the_image_lift(dp_run):
    """Rank 1 steps scans 2, 3 of each global batch with ids 0, 1."""
    _, port = dp_run
    for r in range(WORLD):
        for pb in port[r]["pt_batch"]:
            assert set(np.unique(pb)) == {0, 1}


def test_validation_sums_the_ranks_matrices_as_jax(dp_run):
    """``validate(..., cm_allreduce=...)`` on each rank's shard of the val
    split: JAX's ``validate`` on each of its ``_ShardedView``s, summed
    (what its ``cm_allreduce`` does across processes); and the model's
    own matrices summed are the global ones on both ranks."""
    _, port = dp_run
    cfg_j = dp_cfg(jcfg)
    want = {}
    for r in range(WORLD):
        loader = j_loader(cfg_j, "val", use_distributed=True, rank=r,
                          world_size=WORLD)
        for m, ev in j_validate(cfg_j,
                                lambda s, b: ranks.fake_predictions(b),
                                None, loader, JML()):
            want[m] = want.get(m, 0) + ev.confusion_matrix
    assert set(want) == {"2D", "3D", "2D+3D"}
    for r in range(WORLD):
        for m in want:
            np.testing.assert_array_equal(port[r]["fake"][m], want[m],
                                          err_msg=m)
            assert port[r]["fake"][m].sum() > 0
            np.testing.assert_array_equal(
                port[r]["summed"][m],
                port[0]["own"][m] + port[1]["own"][m], err_msg=m)
    assert not np.array_equal(port[0]["own"]["3D"], port[1]["own"]["3D"])
