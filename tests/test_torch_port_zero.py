"""ZeRO-1 in the port (``parallel/zero.py``) on the CPU: the chunking
against JAX's ``split_opt_state`` / ``merge_opt_state`` element for
element; two gloo ranks, each a spawned process (``torch_dp_ranks.py``)
over a ``FileStore`` in ``tmp_path``, at the small config of
``test_torch_port_trainer.trainer_cfg`` (ViT depth 2, 4 heads, 32 px;
per-voxel maps, dropout on, global batch 4, two steps an epoch):

* the ZeRO trainer bit for bit the replicated trainer after each update
  and after the epoch (parameters, BatchNorm buffers, the canonical
  moments), with half the optimizer state's bytes a rank;
* its updates against JAX's ``zero1`` optimizer on a 2-device mesh
  (``split_opt_state``, ``shard_map`` over ``data``) on the same
  parameters and gradients, to JAX's own 1e-6 (``tests/test_zero.py``);
* a ZeRO checkpoint resumed without ZeRO, and a replicated one with it,
  each bit for bit an uninterrupted 2-epoch run (the learning rate halved
  after each epoch: ``set_learning_rate`` reaches the ZeRO optimizer's
  shared rate); the checkpoint holds ``torch.optim``'s canonical layout.

The ranks' run is joined with a timeout: a hang fails the tests.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.parallel import zero as jzero
from fusiontransformer_tpu.parallel.data_parallel import make_mesh
from fusiontransformer_tpu.solver.build import build_optimizer as j_opt
from fusiontransformer_tpu_torch.parallel import zero
from fusiontransformer_tpu_torch.solver.build import build_optimizer

import torch_dp_ranks as ranks
from test_torch_port_common import one_thread  # noqa: F401
from test_torch_port_trainer import trainer_cfg

WORLD = 2
ZERO_TOL = 1e-6           # tests/test_zero.py: ZeRO against replicated


def _cfg(root, epochs=1, **over):
    if root:
        root.mkdir(parents=True, exist_ok=True)
    return trainer_cfg(root or "", **{
        "MODEL.VIT_HEADS": 4, "TRAIN.BATCH_SIZE": 4,
        "SCHEDULER.MAX_EPOCH": epochs, "DATASET.SyntheticSCN.num_scans": 8,
        "DATASET.SyntheticSCN.num_points": 400, "TPU.POINT_CAPACITY": 512,
        "TPU.CONV_SLOT_POOL": False, "TPU.NUM_DEVICES": WORLD,
        "SCHEDULER.TYPE": "StepLR", "SCHEDULER.StepLR.step_size": 1,
        "SCHEDULER.StepLR.gamma": 0.5, **over})


@pytest.fixture(scope="module")
def zero_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero")
    dirs = {k: str(root / k) for k in ("dp", "zero", "whole",
                                       "zero_then_dp", "dp_then_zero")}
    cfgs = {
        "dp": _cfg(root / "dp"),
        "zero": _cfg(root / "zero", **{"TPU.ZERO_OPTIMIZER": True}),
        "whole": _cfg(root / "whole", 2),
        "zero_then_dp": _cfg(root / "zero_then_dp", 2, RESUME_PATH=str(
            root / "zero" / "max-MeanIoU-000000.pth")),
        "dp_then_zero": _cfg(root / "dp_then_zero", 2, RESUME_PATH=str(
            root / "dp" / "max-MeanIoU-000000.pth"),
            **{"TPU.ZERO_OPTIMIZER": True})}
    return ranks.spawn(root, "zero", cfgs, dirs, timeout=420)


def _adam_state(params):
    """A torch Adam state after one step on random gradients."""
    ps = [torch.nn.Parameter(p) for p in params]
    opt, _ = build_optimizer(_cfg(None), ps)
    for p in ps:
        p.grad = torch.randn(p.shape, generator=torch.Generator()
                             .manual_seed(p.numel()))
    opt.step()
    return opt.state_dict()


@pytest.mark.parametrize("n", [2, 3, 4])
def test_split_and_merge_are_jaxs_element_for_element(n):
    """Each moment of a canonical state cut into rank r's chunk is row r of
    JAX's ``split_opt_state`` (flattened, zero-padded to n * c); the step
    count stays whole; merging the ranks' states gives the canonical one
    back, as JAX's ``merge_opt_state`` does."""
    rs = np.random.RandomState(n)
    shapes = [(10,), (3, 5), (1, 1, 7), (64, 192), (1,)]
    params = [torch.tensor(rs.randn(*s).astype(np.float32)) for s in shapes]
    canonical = _adam_state(params)
    tree = {"mu": {str(i): canonical["state"][i]["exp_avg"].numpy()
                   for i in range(len(shapes))},
            "nu": {str(i): canonical["state"][i]["exp_avg_sq"].numpy()
                   for i in range(len(shapes))},
            "count": np.int32(1)}
    stacked = jzero.split_opt_state(tree, n)
    mine = [zero.split_opt_state(canonical, n, r) for r in range(n)]
    for i, s in enumerate(shapes):
        for key, field in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            rows = np.asarray(stacked[field][str(i)])
            assert rows.shape == (n, zero.chunk_size(int(np.prod(s)), n))
            for r in range(n):
                np.testing.assert_array_equal(
                    mine[r]["state"][i][key].numpy(), rows[r])
        for r in range(n):
            assert torch.equal(mine[r]["state"][i]["step"],
                               canonical["state"][i]["step"])
    merged = zero.merge_opt_state(mine, dict(enumerate(shapes)))
    back = jzero.merge_opt_state(stacked, tree)
    for i in range(len(shapes)):
        for key, field in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            assert torch.equal(merged["state"][i][key],
                               canonical["state"][i][key])
            np.testing.assert_array_equal(np.asarray(back[field][str(i)]),
                                          canonical["state"][i][key].numpy())


def test_the_zero_trainer_is_the_replicated_one_bit_for_bit(zero_run):
    """After each of the two updates and after the epoch (its validation
    included), on both ranks: the same parameters, buffers and canonical
    moments (and step counts) as the replicated trainer."""
    for r in range(WORLD):
        dp, z = zero_run[r]["dp"], zero_run[r]["zero"]
        assert dp["step"] == z["step"] == 2
        assert len(dp["updates"]) == len(z["updates"]) == 2
        for a, b in zip(dp["updates"], z["updates"]):
            for kind in ("after", "moments"):
                assert a[kind].keys() == b[kind].keys()
                bad = [k for k in a[kind]
                       if not torch.equal(a[kind][k], b[kind][k])]
                assert not bad, (r, kind, bad[:5])
        for kind in ("params", "buffers", "moments"):
            a, b = dp["final"][kind], z["final"][kind]
            assert a.keys() == b.keys() and len(a) > 0
            assert all(torch.equal(a[k], b[k]) for k in a), (r, kind)
    a, b = zero_run[0]["zero"]["final"], zero_run[1]["zero"]["final"]
    assert all(torch.equal(a["params"][k], b["params"][k])
               for k in a["params"])


def test_each_rank_keeps_half_the_optimizer_state(zero_run):
    """Adam's two moments a rank: each parameter's chunk of ceil(size / 2)
    elements (the step counts whole): about half the replicated bytes."""
    for r in range(WORLD):
        dp, z = zero_run[r]["dp"], zero_run[r]["zero"]
        sizes = [int(np.prod(v.shape))
                 for v in dp["final"]["params"].values()]
        assert [c[0] for c in z["chunks"]] == [-(-s // WORLD) for s in sizes]
        share = z["state_bytes"] / dp["state_bytes"]
        assert 0.5 <= share < 0.52, share


def _jax_tree(named):
    """A port ``{name: tensor}`` as the JAX params tree (names are flax
    paths)."""
    tree = {}
    for name, v in named.items():
        node = tree
        *head, last = name.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = np.asarray(v.numpy())
    return tree


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return np.asarray(tree)


def test_zero_updates_match_jaxs_zero1(zero_run):
    """JAX's ``zero1``-wrapped optimizer on a 2-device ``data`` mesh, its
    state in ``split_opt_state``'s layout, run on the port's parameters
    before the first update and the port's averaged gradients of each
    update: its parameters and moments after each update within 1e-6 of
    the port ZeRO run's, which holds each rank 1/2 of the moments."""
    tx, _ = j_opt(_jax_cfg())
    port = zero_run[0]["zero"]["updates"]
    params = _jax_tree(port[0]["before"])
    canonical = tx.init(params)
    flags = jzero.shard_flags(canonical)
    specs = jzero.opt_state_specs(canonical)
    ztx = jzero.zero1(tx, "data", WORLD)

    def per_device(p, g, s):
        s = jzero.unstack_local_opt(flags, s)
        updates, s = ztx.update(g, s, p)
        return optax.apply_updates(p, updates), \
            jzero.restack_local_opt(flags, s)

    step = jax.jit(jax.shard_map(per_device, mesh=make_mesh(WORLD),
                                 in_specs=(P(), P(), specs),
                                 out_specs=(P(), specs), check_vma=False))
    state = jzero.split_opt_state(canonical, WORLD)
    for k, rec in enumerate(port):
        params, state = step(params, _jax_tree(rec["grads"]), state)
        merged = jzero.merge_opt_state(state, canonical)
        adam = next(p for p in merged.inner_state if hasattr(p, "mu"))
        for name, v in rec["after"].items():
            np.testing.assert_allclose(v.numpy(), _leaf(params, name),
                                       rtol=ZERO_TOL, atol=ZERO_TOL,
                                       err_msg=f"{k} {name}")
        for (name, key), v in rec["moments"].items():
            if key == "step":
                assert int(v) == k + 1
                continue
            want = _leaf(adam.mu if key == "exp_avg" else adam.nu, name)
            np.testing.assert_allclose(v.numpy(), want, rtol=ZERO_TOL,
                                       atol=ZERO_TOL, err_msg=f"{k} {name}")


def _jax_cfg():
    """The JAX config of the port run's optimizer (Adam, lr 1e-3, wd
    5e-4)."""
    cfg = jcfg()
    cfg.OPTIMIZER.TYPE = "Adam"
    cfg.OPTIMIZER.BASE_LR = 1e-3
    cfg.OPTIMIZER.WEIGHT_DECAY = 5e-4
    cfg.freeze()
    return cfg


@pytest.mark.parametrize("run", ["zero_then_dp", "dp_then_zero"])
def test_a_checkpoint_resumes_across_zero_bit_for_bit(zero_run, run):
    """A ZeRO run's first-epoch checkpoint resumed by a replicated run (and
    the reverse) ends its second epoch bit for bit where an uninterrupted
    replicated 2-epoch run does; the checkpoint's moments have their
    parameters' shapes (``torch.optim``'s own layout)."""
    for r in range(WORLD):
        got, want = zero_run[r][run], zero_run[r]["whole"]
        assert got["start"] == {"epoch": 1, "step": 2}
        for kind in ("params", "buffers", "moments"):
            a, b = got["final"][kind], want["final"][kind]
            assert a.keys() == b.keys()
            bad = [k for k in a if not torch.equal(a[k], b[k])]
            assert not bad, (r, run, kind, bad[:5])
    params = list(zero_run[0]["dp"]["final"]["params"].values())
    shapes = zero_run[0]["saved_shapes"]
    assert len(shapes) == len(params)
    for i, p in enumerate(params):
        assert shapes[i]["exp_avg"] == shapes[i]["exp_avg_sq"] == \
            tuple(p.shape)
        assert shapes[i]["step"] == ()
