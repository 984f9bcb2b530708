"""Tensor parallelism in the port (``parallel/tensor_parallel.py``,
``TPU.MODEL_PARALLEL``) on the CPU, against the JAX package's
``tensor_parallel.py``: four gloo ranks, each a spawned process
(``torch_dp_ranks.py``) over a ``FileStore`` in ``tmp_path``; the ViT at
depth 2, width 64, 4 heads, 32 px.

* The split rules against JAX's ``tp_rule_for_path`` on every leaf of the
  flagship, and the shards and merges against ``split_params_for_tp`` /
  ``merge_params_from_tp`` at tp = 2 and 4, bit for bit.
* The TP ViT (each rank its shard of JAX's weights) at tp = 2 and 4
  against JAX's TP ViT under ``shard_map`` (``test_tensor_parallel.py``):
  its taps within 2e-5, its gradients within 1e-4.
* One (data 2, model 2) train step of the trainer from JAX's initial
  weights against JAX's ``shard_train_step_2d`` on its 4-device mesh
  (dropout off on both sides), with ``test_torch_port_data_parallel.py``'s
  tolerances: losses 1e-5 relative, confusion matrices equal, BatchNorm
  statistics 1e-5, the gradients through Adam's first moment within 0.1 x
  (2e-2 of the data shards' mean largest |g| plus 1e-7), the update within
  2e-2 of the leaf's largest but where the moment bound leaves the sign
  free; every replicated parameter bit for bit the same on the four ranks,
  each shard on the two ranks that hold it; the same step with
  ``REMAT_VIT`` bit for bit.
* A trainer cycle at (data 2, model 2) with ``ADAPTIVE_LEVEL_CAPS``:
  train, validate on the merged weights, a canonical checkpoint, resumed
  by a tp = 1 run of 4 data ranks, then ``test()``.

The ranks' runs are joined with a timeout: a hang fails the tests.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.models.build import build_model as j_build
from fusiontransformer_tpu.models.vit import VisionTransformer2D as JViT
from fusiontransformer_tpu.modules import steps as js
from fusiontransformer_tpu.modules.SemanticTrainer import init_train_state
from fusiontransformer_tpu.parallel import tensor_parallel as jtp
from fusiontransformer_tpu.solver.build import build_optimizer as j_opt
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data.build import build_dataloader
from fusiontransformer_tpu_torch.modules.steps import level_caps_for_n
from fusiontransformer_tpu_torch.parallel import tensor_parallel as tp
from fusiontransformer_tpu_torch.utils.convert_jax import jax_leaf_paths

import torch_dp_ranks as ranks
from test_torch_port_common import (LEAF_ATOL, LEAF_RTOL,  # noqa: F401
                                    one_thread, train_cfg)
from test_torch_port_data_parallel import _NoDropout, _adam, _leaf, _tree

WORLD = 4
MODEL = 2
DATA = WORLD // MODEL
HEADS = 4
GLOBAL_BATCH = 4
LR = 1e-2
FWD_TOL, GRAD_TOL = 2e-5, 1e-4     # tests/test_tensor_parallel.py


def tp_cfg(get_cfg, **over):
    """``train_cfg`` (Adam, lr 1e-2, f32) at 4 heads, global batch 4 over a
    (data 2, model 2) mesh, per-voxel maps, the JAX test's capacities."""
    cfg = train_cfg(get_cfg)
    cfg.defrost()
    cfg.MODEL.VIT_HEADS = HEADS
    cfg.TRAIN.BATCH_SIZE = GLOBAL_BATCH
    cfg.OPTIMIZER.BASE_LR = LR
    cfg.TPU.CONV_SLOT_POOL = False
    cfg.TPU.ADAPTIVE_LEVEL_CAPS = False
    cfg.TPU.NUM_DEVICES = WORLD
    cfg.TPU.MODEL_PARALLEL = MODEL
    cfg.DATASET.SyntheticSCN.num_scans = 2 * GLOBAL_BATCH
    cfg.VAL.BATCH_SIZE = 2
    cfg.VAL.PERIOD = 0
    cfg.OUTPUT_DIR = ""
    for k, v in over.items():
        node = cfg
        *head, last = k.split(".")
        for h in head:
            node = node[h]
        node[last] = v
    cfg.freeze()
    return cfg


# --------------------------------------------------------------------------- #
def _jax_vit(tp=1):
    return JViT(img_size=32, patch_size=16, embed_dim=64, depth=2,
                num_heads=HEADS, compute_dtype=jnp.float32, tp=tp,
                tp_axis="model" if tp > 1 else None)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _vit_params():
    imgs = jnp.zeros((1, 32, 32, 3))
    return jax.tree_util.tree_map(
        np.asarray, _jax_vit().init(jax.random.PRNGKey(0), imgs)["params"])


def test_split_rules_match_jax_on_every_leaf_of_the_flagship():
    """Every parameter and buffer of the flagship (middlefusion.yaml):
    the port's rule of its name is JAX's ``tp_rule_for_path`` of its flax
    path; the ViT blocks' four GEMMs are split, nothing else is."""
    from fusiontransformer_tpu_torch.models.build import _construct
    cfg = get_default_cfg()
    cfg.merge_from_file("configs/semantic_kitti/middlefusion.yaml")
    with torch.device("meta"):
        model = _construct(cfg)
    paths = jax_leaf_paths(model)
    assert len(paths) > 400
    rules = {}
    for name, (_, path) in paths.items():
        rules[name] = tp.tp_rule_for_path(name)
        assert rules[name] == jtp.tp_rule_for_path(path), name
        assert tp.tp_rule_for_path(path) == rules[name]
    split = [n for n, r in rules.items() if r is not None]
    assert len(split) == 12 * 6        # qkv kernel / bias, proj, fc1 x2, fc2
    assert all(".backbone.block" in n for n in split)


@pytest.mark.parametrize("n", [2, 4])
def test_shards_and_merges_are_jaxs(n):
    """Rank r's shard of each leaf is row r of JAX's ``split_params_for_tp``
    (parameters and an optimizer state of their shapes); the merge of the
    ranks' shards is the canonical leaf, as ``merge_params_from_tp``
    gives it."""
    params = _vit_params()
    stacked = _flat(jtp.split_params_for_tp(params, n, HEADS))
    flat = {k: torch.tensor(v) for k, v in _flat(params).items()}
    shards = [tp.shard_state(flat, n, r, HEADS) for r in range(n)]
    for name, want in stacked.items():
        for r in range(n):
            np.testing.assert_array_equal(shards[r][name].numpy(),
                                          want[r] if tp.tp_rule_for_path(
                                              name) else want, err_msg=name)
    merged = _flat(jtp.merge_params_from_tp(
        jtp.split_params_for_tp(params, n, HEADS), HEADS))
    for name, x in flat.items():
        rule = tp.tp_rule_for_path(name)
        got = x if rule is None else tp.merge_leaf(
            rule, [s[name] for s in shards], HEADS)
        assert torch.equal(got, x), name
        np.testing.assert_array_equal(merged[name], x.numpy())
    # An optimizer state of the parameters' shapes, by index.
    names = list(flat)
    opt = {"state": {i: {"step": torch.tensor(3.0), "exp_avg": flat[k] * 2,
                         "exp_avg_sq": flat[k] ** 2}
                     for i, k in enumerate(names)}, "param_groups": []}
    cut = [tp.shard_opt_state(opt, names, n, r, HEADS) for r in range(n)]
    for i, k in enumerate(names):
        assert torch.equal(cut[0]["state"][i]["step"], torch.tensor(3.0))
        for r in range(n):
            assert torch.equal(cut[r]["state"][i]["exp_avg"],
                               shards[r][k] * 2), k


@pytest.fixture(scope="module")
def tp_vit(tmp_path_factory):
    """JAX's TP ViT forward and gradients at tp = 2 and 4 under shard_map
    on (1, tp) meshes; the port's four ranks at the same degrees."""
    rs = np.random.RandomState(0)
    imgs = rs.standard_normal((2, 32, 32, 3)).astype(np.float32)
    params = _vit_params()
    want = {}
    for n in (2, 4):
        local = _jax_vit(n)
        stacked = jtp.split_params_for_tp(params, n, HEADS)
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(1, n),
                    ("data", "model"))
        specs = jtp.specs_for_tp(stacked)

        def fwd(p, x, _local=local):
            return _local.apply({"params": jtp.unstack_local(p)}, x)

        def loss(p, _local=local):
            out = _local.apply({"params": jtp.unstack_local(p)}, imgs)
            return sum(jnp.sum(v ** 2) for v in out.values())

        taps = jax.jit(jax.shard_map(fwd, mesh=mesh, in_specs=(specs, P()),
                                     out_specs=P(), check_vma=False))(
            stacked, imgs)
        grads = jax.jit(jax.shard_map(jax.grad(loss), mesh=mesh,
                                      in_specs=(specs,), out_specs=specs,
                                      check_vma=False))(stacked)
        want[n] = {"taps": jax.tree_util.tree_map(np.asarray, taps),
                   "grads": _flat(grads)}
    port = ranks.spawn(tmp_path_factory.mktemp("tp_vit"), "tp_vit", params,
                       imgs, (2, 4), world=WORLD, timeout=300)
    return want, port


@pytest.mark.parametrize("n", [2, 4])
def test_tp_vit_forward_matches_jax(tp_vit, n):
    want, port = tp_vit
    for r in range(WORLD):
        got = port[r][n]["taps"]
        assert set(got) == set(want[n]["taps"]) == {"0", "1"}
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[n]["taps"][k],
                                       rtol=FWD_TOL, atol=FWD_TOL,
                                       err_msg=f"rank {r} tap {k}")


@pytest.mark.parametrize("n", [2, 4])
def test_tp_vit_gradients_match_jax(tp_vit, n):
    """Each rank's gradient of a sharded leaf is JAX's rank m of it; of a
    replicated leaf, JAX's full one (the f / g pair)."""
    want, port = tp_vit
    for r in range(WORLD):
        m = port[r][n]["m"]
        assert m == r % n
        for name, g in port[r][n]["grads"].items():
            w = want[n]["grads"][name]
            w = w[m] if tp.tp_rule_for_path(name) else w
            np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                       atol=GRAD_TOL,
                                       err_msg=f"rank {r} {name}")


# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tp_step(tmp_path_factory):
    """JAX's (data 2, model 2) ``shard_train_step_2d`` from its initial
    state; the port's four ranks: the same step (and with REMAT_VIT) from
    JAX's initial weights, then the trainer cycle."""
    cfg_j, cfg_t = tp_cfg(jcfg), tp_cfg(get_default_cfg)
    batch = next(iter(build_dataloader(cfg_t, "train")))
    assert len(batch["scan_count"]) == GLOBAL_BATCH
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(fnn, "Dropout", _NoDropout)
    try:
        model = j_build(cfg_j)[0]
        model_tp = j_build(cfg_j, vit_tp=MODEL, vit_tp_axis="model")[0]
        tx, _ = j_opt(cfg_j)
        state = init_train_state(cfg_j, model, tx, 1, rng_seed=5)
        init = {"params": _tree(state.params),
                "stats": _tree(state.batch_stats)}
        spd = GLOBAL_BATCH // DATA
        step, _ = js.make_train_step(cfg_j, model_tp, tx, spd,
                                     axis_name="data")
        sharded = jtp.shard_train_step_2d(step, jtp.make_mesh_2d(DATA, MODEL),
                                          spd)
        state = state._replace(
            params=jtp.split_params_for_tp(state.params, MODEL, HEADS),
            opt_state=jtp.split_params_for_tp(state.opt_state, MODEL, HEADS))
        state, metrics = sharded(state, js._device_batch(batch),
                                 jax.random.PRNGKey(0))
        after = {"params": _tree(jtp.merge_params_from_tp(state.params,
                                                          HEADS)),
                 "stats": _tree(state.batch_stats),
                 "mu": _tree(jtp.merge_params_from_tp(
                     _adam(state.opt_state, "mu"), HEADS)),
                 "metrics": _tree(metrics)}
    finally:
        mp_.undo()
    root = tmp_path_factory.mktemp("tp_trainer")
    (root / "cycle").mkdir()
    common = {"TPU.ADAPTIVE_LEVEL_CAPS": True, "VAL.PERIOD": 1,
              "OUTPUT_DIR": str(root / "cycle"), "DATASET.TEST": ("test",),
              "TEST.BATCH_SIZE": 1, "DATASET.SyntheticSCN.num_points": 250,
              "TPU.POINT_CAPACITY": 512}
    cfgs = {"step": cfg_t,
            "remat": tp_cfg(get_default_cfg, **{"TPU.REMAT_VIT": True}),
            "cycle": tp_cfg(get_default_cfg, **common),
            "resume": tp_cfg(get_default_cfg, **common, **{
                "TPU.MODEL_PARALLEL": 1, "SCHEDULER.MAX_EPOCH": 2,
                "AUTO_RESUME": True})}
    port = ranks.spawn(root, "tp_trainer", cfgs, init["params"],
                       init["stats"], batch, {"cycle": str(root / "cycle")},
                       world=WORLD, timeout=600)
    return init, after, port, cfgs


def _names():
    from fusiontransformer_tpu_torch.models.build import build_model
    return jax_leaf_paths(build_model(tp_cfg(get_default_cfg), "cpu"))


def test_the_rank_layout_is_make_mesh_2ds(tp_step):
    """rank = d * 2 + m; each data rank steps its own 2 scans, ids
    re-based; the loader shard and the dropout generator are keyed on the
    data index: the two model ranks of a data row step the same scans with
    the same generator, the two rows differ."""
    _, _, port, _ = tp_step
    for r in range(WORLD):
        o = port[r]["step"]
        assert (o["d"], o["m"]) == divmod(r, MODEL)
        assert set(np.unique(o["pt_batch"])) == {0, 1}
    for d in range(DATA):
        a, b = port[d * MODEL]["step"], port[d * MODEL + 1]["step"]
        assert np.array_equal(a["pt_batch"], b["pt_batch"])
        assert torch.equal(a["generator"], b["generator"])
    assert not torch.equal(port[0]["step"]["generator"],
                           port[MODEL]["step"]["generator"])


def test_the_tp_train_step_runs_eagerly(tp_step):
    """Under tensor parallelism the train step does not go through the
    trainer's graph cache (``_launch``): its all-reduces sit inside every
    ViT block, which gloo cannot capture."""
    _, _, port, _ = tp_step
    for r in range(WORLD):
        assert port[r]["step"]["launched"] == []


def test_tp_step_losses_and_confusions_match_jax(tp_step):
    _, after, port, _ = tp_step
    jm = after["metrics"]
    for r in range(WORLD):
        tm = port[r]["step"]["metrics"]
        for k in ("total_loss", "seg_loss_2d", "seg_loss_3d", "xm_loss_2d",
                  "xm_loss_3d"):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        assert float(tm["voxel_overflow"]) == float(jm["voxel_overflow"])
        for k in ("cm_2d", "cm_3d"):
            np.testing.assert_array_equal(tm[k], np.asarray(jm[k]))


def test_tp_step_batchnorm_stats_match_jax(tp_step):
    _, after, port, _ = tp_step
    paths = _names()
    for r in range(WORLD):
        for name, buf in port[r]["step"]["state"]["buffers"].items():
            np.testing.assert_allclose(
                buf.numpy(), _leaf(after["stats"], paths[name][1]),
                rtol=1e-5, atol=1e-5, err_msg=name)


def _shard_max(port):
    """Each leaf's largest |g| a data shard (over the model ranks that
    hold its pieces), per data rank."""
    out = {}
    for r in range(WORLD):
        o = port[r]["step"]
        for name, v in o["shard_max"].items():
            per = out.setdefault(name, [0.0] * DATA)
            per[o["d"]] = max(per[o["d"]], v)
    return out


def test_tp_step_averages_gradients_as_jax(tp_step):
    """Adam's first moment after the step (0.1 g), merged, leaf by leaf."""
    _, after, port, _ = tp_step
    paths, shard_max = _names(), _shard_max(port)
    moments = port[0]["step"]["state"]["moments"]
    assert len(moments) > 200
    for (name, key), m in moments.items():
        if key != "exp_avg":
            continue
        want = _leaf(after["mu"], paths[name][1])
        err = float(np.abs(m.numpy() - want).max())
        bound = 0.1 * (LEAF_RTOL * np.mean(shard_max[name]) + LEAF_ATOL)
        assert err <= bound + 1e-7 * float(np.abs(want).max()), \
            (name, err, bound)


def test_tp_step_updates_the_parameters_as_jax(tp_step):
    """Each leaf's update within 2e-2 of its largest plus 1e-7, but for the
    elements whose first moment is within the moment bound of zero (their
    gradient's sign, which Adam's update follows, is not fixed)."""
    init, after, port, _ = tp_step
    paths, shard_max = _names(), _shard_max(port)
    free = total = 0
    for name, p in port[0]["step"]["state"]["params"].items():
        path = paths[name][1]
        start = _leaf(init["params"], path)
        want = _leaf(after["params"], path) - start
        err = np.abs(p.numpy() - start - want)
        mu = np.abs(_leaf(after["mu"], path))
        unsigned = mu <= 0.1 * (LEAF_RTOL * np.mean(shard_max[name])
                                + LEAF_ATOL)
        free += int(unsigned.sum())
        total += err.size
        assert (err[unsigned] <= 2 * 2 * LR).all(), name
        held = err[~unsigned]
        if held.size:
            scale = float(np.abs(want).max())
            assert held.max() <= LEAF_RTOL * scale + LEAF_ATOL, \
                (name, float(held.max()), scale)
    assert free < total


def test_replicated_parameters_are_bitwise_equal_across_the_ranks(tp_step):
    """After the step: every replicated parameter the same on all four
    ranks; each shard the same on the two data ranks that hold it, and the
    two model ranks' shards different."""
    _, _, port, _ = tp_step
    digests = port[0]["step"]["digests"]
    for r in range(WORLD):
        assert port[r]["step"]["digests"] == digests
    sharded = 0
    for name in digests[0]:
        seen = [d[name] for d in digests]
        if tp.tp_rule_for_path(name) is None:
            assert len(set(seen)) == 1, name
        else:
            sharded += 1
            assert seen[0] == seen[2] and seen[1] == seen[3], name
            assert seen[0] != seen[1], name
    assert sharded == 2 * 6


def test_remat_vit_under_tp_is_bitwise(tp_step):
    """The same step with ``TPU.REMAT_VIT``: the blocks' forwards, their
    all-reduces included, run again in the backward, with the same values:
    the merged state after the step bit for bit."""
    _, _, port, _ = tp_step
    for r in range(WORLD):
        a, b = port[r]["step"]["state"], port[r]["remat"]["state"]
        for kind in ("params", "buffers", "moments"):
            assert a[kind].keys() == b[kind].keys()
            bad = [k for k in a[kind] if not torch.equal(a[kind][k],
                                                         b[kind][k])]
            assert not bad, (r, kind, bad[:5])


def test_a_tp_cycle_checkpoints_canonically_and_resumes_at_tp_1(tp_step):
    """Train an epoch at (data 2, model 2), validate on the merged weights,
    checkpoint: the file holds the canonical tp=1 layout (qkv 64 x 192
    where a rank holds 64 x 96), equal to the merged state bit for bit,
    moments included.  A tp = 1 run of four data ranks resumes from it
    with those weights and moments, trains its second epoch and tests."""
    _, _, port, _ = tp_step
    for r in range(WORLD):
        c, res = port[r]["cycle"], port[r]["resume"]
        assert c["local_qkv"] == (64, 3 * 64 // MODEL)
        key = "image_backbone.backbone.block0.attn.qkv.kernel"
        assert tuple(c["saved_model"][key].shape) == (64, 3 * 64)
        for kind in ("params", "buffers"):
            for k, v in c["merged"][kind].items():
                assert torch.equal(c["saved_model"][k], v), k
                assert torch.equal(res["loaded"][kind][k], v), k
        assert c["merged"]["moments"].keys() == c["saved_moments"].keys()
        for k, v in c["merged"]["moments"].items():
            assert torch.equal(c["saved_moments"][k], v), k
            assert torch.equal(res["loaded"]["moments"][k], v), k
        assert "seg_iou_3d" in c["val"] and "seg_iou_2d" in c["val"]
        assert res["start_epoch"] == 1
        assert res["test_iou"] == port[0]["resume"]["test_iou"]
        assert 0.0 <= res["test_iou"]["seg_iou_3d"] <= 1.0


def test_adaptive_caps_with_tp(tp_step):
    """``TPU.ADAPTIVE_LEVEL_CAPS`` at (data 2, model 2) (the JAX package's
    ``test_adaptive_caps_with_tensor_parallel``): every rank steps with the
    same capacities, below the static ceiling somewhere, and nothing
    overflows."""
    _, _, port, cfgs = tp_step
    caps = port[0]["cycle"]["caps"]
    assert len(caps) == 2
    for r in range(WORLD):
        assert port[r]["cycle"]["caps"] == caps
        assert port[r]["cycle"]["overflow"] == 0.0
    cfg = cfgs["cycle"]
    below = False
    for n, c in caps:
        static = level_caps_for_n(cfg, n)
        assert c is not None and all(a <= s for a, s in zip(c, static))
        below |= tuple(c) != tuple(static)
    assert below
