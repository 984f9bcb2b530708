"""The trainer's last single-device keys on the CPU: TensorBoard summaries
(``TRAIN.SUMMARY_PERIOD``, ``TRAIN.LOG_HISTOGRAM``) against the names and
the gradients of the JAX trainer, asynchronous checkpoints
(``TRAIN.ASYNC_CHECKPOINT``), the SIGTERM handler, the host-memory line,
``TPU.REMAT_VIT`` and the port's SGD.

Tolerances: the gradient pass against JAX's ``make_grads_fn`` is held leaf
by leaf as a train step's gradients are (``LEAF_RTOL`` of the leaf's
largest |g| plus ``LEAF_ATOL``, median ``MEDIAN_RTOL``; the reasons are in
``tests/test_torch_port_train.py``); the port's SGD against torch's to f32
rounding (1e-6 relative); everything else bit for bit.
"""

import glob
import hashlib
import json
import logging
import os
import os.path as osp
import signal
import subprocess
import sys
import time

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.models.build import build_model as j_build
from fusiontransformer_tpu.modules import steps as js
from fusiontransformer_tpu.modules.SemanticTrainer import init_train_state
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.models import spvcnn
from fusiontransformer_tpu_torch.models import vit as tvit
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.modules import steps as ts
from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
    UNPORTED_KEYS, SemanticTrainer)
from fusiontransformer_tpu_torch.solver.build import (SGD,
                                                      build_optimizer,
                                                      load_optimizer_state)
from fusiontransformer_tpu_torch.utils import checkpoint as ckpt
from fusiontransformer_tpu_torch.utils.convert_jax import (jax_leaf_paths,
                                                           load_jax_variables)

from test_torch_port_common import (LEAF_ATOL, LEAF_RTOL,  # noqa: F401
                                    MEDIAN_RTOL, one_thread, train_cfg)
from test_torch_port_trainer import trainer_cfg

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
# The scalars the JAX trainer writes for a fusion model: its train meters
# whose names hold loss, acc or iou.
JAX_SCALARS = {"train/" + n for n in (
    "total_loss", "seg_loss_2d", "seg_loss_3d", "xm_loss_2d", "xm_loss_3d",
    "seg_iou_2d", "seg_iou_3d")}


class _NoDropout(fnn.Module):
    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


@pytest.fixture
def no_dropout():
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn, "Dropout", _NoDropout)
    mp.setattr(spvcnn, "DROPOUT", 0.0)
    yield
    mp.undo()


def _jax_paths(tree, prefix=()):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out += _jax_paths(v, prefix + (k,))
        else:
            out.append("/".join(prefix + (k,)))
    return out


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def summarised(tmp_path_factory):
    """One epoch of a trainer with summaries and histograms on."""
    out = tmp_path_factory.mktemp("summaries")
    cfg = trainer_cfg(out, **{"TRAIN.SUMMARY_PERIOD": 1,
                              "TRAIN.LOG_HISTOGRAM": True, "VAL.PERIOD": 0})
    tr = SemanticTrainer(cfg, str(out), run_name="tb_run", device="cpu")
    tr.train()
    return cfg, out, tr


def test_summaries_carry_the_jax_trainers_names(summarised):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    cfg, out, tr = summarised
    runs = glob.glob(str(out / "tb.tb_run" / "events.out.tfevents.*"))
    assert len(runs) == 1
    acc = EventAccumulator(runs[0], size_guidance={"histograms": 0,
                                                   "scalars": 0})
    acc.Reload()
    tags = acc.Tags()
    assert set(tags["scalars"]) == JAX_SCALARS
    params, _ = _jax_variables()
    want = _jax_paths(params)
    assert set(tags["histograms"]) == {f"{c}/{p}" for c in ("params",
                                                             "grads")
                                       for p in want}
    for tag in tags["scalars"]:
        (event,) = acc.Scalars(tag)
        assert event.step == 0 and np.isfinite(event.value)
    name = "image_backbone/backbone/block0/attn/qkv/kernel"
    hist = acc.Histograms("params/" + name)[0].histogram_value
    p = dict(tr.model.named_parameters())[name.replace("/", ".")]
    assert hist.num == p.numel()
    np.testing.assert_allclose(hist.sum, float(p.detach().double().sum()),
                               rtol=1e-5)


def test_host_rss_is_logged_each_epoch(summarised):
    _, out, tr = summarised
    with open(out / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert rec["host_rss_mb"] > 0 and rec["host_rss_mb"] == tr.host_rss_mb


def test_a_summary_without_tensorboard_raises(tmp_path, monkeypatch):
    """A deliberate difference: the JAX trainer goes on without a writer."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = trainer_cfg(tmp_path, **{"TRAIN.SUMMARY_PERIOD": 1})
    with pytest.raises(ImportError, match="tensorboard"):
        SemanticTrainer(cfg, str(tmp_path), device="cpu")
    # No summary asked for: no writer, no import.
    tr = SemanticTrainer(trainer_cfg(tmp_path), str(tmp_path), device="cpu")
    assert tr.summary_writer is None


def _jax_variables():
    cfg_j = train_cfg(jcfg)
    state = init_train_state(cfg_j, j_build(cfg_j)[0], None, 2, rng_seed=5)
    return (jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats))


def test_gradient_pass_matches_jax_and_touches_nothing(no_dropout):
    """On the first batch of ``train_cfg``, the batch the train step's
    gradient bounds were set on (``tests/test_torch_port_train.py``)."""
    cfg = train_cfg(get_default_cfg)
    cfg.defrost()
    cfg.VAL.PERIOD = 0
    cfg.TRAIN.GRAD_ACCUM_STEPS = 2
    cfg.freeze()
    cfg_j = train_cfg(jcfg)
    params, stats = _jax_variables()
    tr = SemanticTrainer(cfg, "", device="cpu")
    load_jax_variables(tr.model, params, stats)
    batch = next(iter(tr.train_dataloader))
    assert "gslot_src_0" in batch
    # An open accumulation window: one micro-step's gradients, no update.
    tr.run_train_step(batch)
    assert tr.window == 1
    before = {
        "buffers": [b.clone() for b in tr.model.buffers()],
        "grads": [g.clone() for g in tr.train_step.grads],
        "params": [p.detach().clone() for p in tr.model.parameters()],
        "opt": ckpt.host_snapshot(tr.optimizer.state_dict()),
        "generator": tr.generator.get_state()}
    got = tr.gradient_pass(batch)
    assert tr.window == 1
    for key, now in (("buffers", list(tr.model.buffers())),
                     ("grads", tr.train_step.grads),
                     ("params", list(tr.model.parameters()))):
        assert all(torch.equal(a, b) for a, b in zip(before[key], now)), key
    assert torch.equal(before["generator"], tr.generator.get_state())
    opt = ckpt.host_snapshot(tr.optimizer.state_dict())
    for i, st in before["opt"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, opt["state"][i][k]), (i, k)

    # JAX's make_grads_fn on the same weights: the state after the step,
    # the batch without its group-pooled maps.
    state = js.TrainState(
        {k: v for k, v in _to_jax_tree(tr, "params").items()},
        _to_jax_tree(tr, "batch_stats"), None, jax.numpy.zeros((), "int32"))
    gb = {k: v for k, v in js._device_batch(batch).items()
          if not k.startswith(("gslot_src_", "gslot_bin_"))}
    jgrads = jax.jit(js.make_grads_fn(cfg_j, j_build(cfg_j)[0], 2))(
        state, gb, jax.random.PRNGKey(0))
    paths = jax_leaf_paths(tr.model)
    assert set(got) == {n for n, (c, _) in paths.items() if c == "params"}
    shares = []
    for name, g in got.items():
        want = _leaf(jgrads, paths[name][1])
        scale = float(np.abs(want).max())
        err = float(np.abs(g.numpy() - want).max())
        if scale == 0.0:
            assert err == 0.0, name
            continue
        assert err <= LEAF_RTOL * scale + LEAF_ATOL, (name, err, scale)
        shares.append(err / scale)
    assert np.median(shares) <= MEDIAN_RTOL, np.median(shares)


def _to_jax_tree(tr, collection):
    tree = {}
    sources = dict(tr.model.named_parameters()) if collection == "params" \
        else dict(tr.model.named_buffers())
    for name, (coll, path) in jax_leaf_paths(tr.model).items():
        if coll != collection:
            continue
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = sources[name].detach().numpy().copy()
    return tree


# --------------------------------------------------------------------- #
class _SlowSave:
    """``torch.save`` that starts writing only when released."""

    def __init__(self, real):
        self.real, self.go = real, __import__("threading").Event()

    def __call__(self, obj, f):
        assert self.go.wait(30)
        self.real(obj, f)


@pytest.mark.parametrize("async_save", [True, False],
                         ids=["async", "sync"])
def test_a_save_holds_the_tensors_of_its_call(tmp_path, monkeypatch,
                                              async_save):
    w = torch.arange(6, dtype=torch.float32)
    want = w.clone()
    slow = _SlowSave(torch.save)
    monkeypatch.setattr(ckpt.torch, "save", slow)
    c = ckpt.Checkpointer(str(tmp_path), max_to_keep=2,
                          async_save=async_save)
    if not async_save:
        slow.go.set()
    path = c.save("model000000", model={"w": w}, step=3)
    w.add_(1.0)                 # the next step, before the write runs
    slow.go.set()
    c.wait()
    payload = c.load()
    assert torch.equal(payload["model"]["w"], want) and payload["step"] == 3
    assert osp.exists(path) and c._saved == [path]
    for i in (1, 2):
        c.save(f"model{i:06d}", model={"w": w})
    c.wait()
    assert [osp.basename(p) for p in c._saved] == ["model000001.pth",
                                                   "model000002.pth"]
    assert not osp.exists(path)


def test_a_failed_write_raises_at_the_next_wait_or_save(tmp_path,
                                                        monkeypatch):
    def broken(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", broken)
    c = ckpt.Checkpointer(str(tmp_path), async_save=True)
    c.save("a", x=torch.zeros(1))
    with pytest.raises(RuntimeError, match="disk full"):
        c.wait()
    c.save("b", x=torch.zeros(1))
    with pytest.raises(RuntimeError, match="disk full"):
        c.save("c", x=torch.zeros(1))
    sync = ckpt.Checkpointer(str(tmp_path))
    with pytest.raises(RuntimeError, match="disk full"):
        sync.save("d", x=torch.zeros(1))


def test_the_load_line_carries_the_md5(tmp_path, caplog):
    c = ckpt.Checkpointer(str(tmp_path), async_save=True)
    path = c.save("m", x=torch.ones(3))
    with caplog.at_level(logging.INFO):
        c.load()
    with open(path, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    assert f"Loading checkpoint from {path}, MD5: {md5}" in caplog.text


def test_the_trainer_saves_asynchronously_by_default(tmp_path):
    tr = SemanticTrainer(trainer_cfg(tmp_path), str(tmp_path), device="cpu")
    assert tr.cfg.TRAIN.ASYNC_CHECKPOINT and tr.checkpointer.async_save
    want = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.update_checkpoint(0)
    with torch.no_grad():
        for p in tr.model.parameters():
            p.add_(1.0)
    payload = tr.checkpointer.load()
    for k, v in want.items():
        assert torch.equal(payload["model"][k], v), k


# --------------------------------------------------------------------- #
_TINY = ["MODEL.VIT_IMG_SIZE", "32", "MODEL.VIT_EMBED_DIM", "64",
         "MODEL.VIT_DEPTH", "2", "MODEL.VIT_HEADS", "2",
         "MODEL.middle_feat_block_number", "0",
         "MODEL.late_feat_block_number", "1",
         "DATASET.SyntheticSCN.num_scans", "2",
         "DATASET.SyntheticSCN.num_points", "600",
         "DATASET.SyntheticSCN.image_height", "40",
         "DATASET.SyntheticSCN.image_width", "60",
         "TPU.POINT_CAPACITY", "1024", "TRAIN.BATCH_SIZE", "2",
         "VAL.PERIOD", "0", "SCHEDULER.MAX_EPOCH", "1000"]


@pytest.mark.skipif(sys.platform != "linux", reason="POSIX signals")
def test_sigterm_checkpoints_and_resumes(tmp_path):
    """``tests/test_preemption.py`` for the port's ``train.py``: a SIGTERM
    after two epochs stops the run at a step boundary with exit code 0 and
    a ``preempt*.pth`` that runs the interrupted epoch again."""
    cmd = [sys.executable, "-u", "-m", "fusiontransformer_tpu_torch.train",
           "--cfg", "configs/semantic_kitti/synthetic.yaml", "--device",
           "cpu", "--run_name", "r", "OUTPUT_DIR", str(tmp_path), *_TINY]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    lines = []
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "Epoch 1 took" in line:
                break
        assert any("Epoch 1 took" in ln for ln in lines), "".join(lines[-20:])
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines) + out
    assert proc.returncode == 0, out[-3000:]
    assert "Preemption checkpoint written" in out
    saved = glob.glob(str(tmp_path / "r" / "preempt*.pth"))
    assert len(saved) == 1, os.listdir(tmp_path / "r")
    payload = torch.load(saved[0], weights_only=True)
    assert int(payload["epoch"]) >= 2
    assert osp.basename(saved[0]) == f"preempt{int(payload['epoch']):06d}.pth"
    assert {"model", "optimizer", "generator"} <= set(payload)

    from fusiontransformer_tpu_torch.train import load_cfg
    cfg = load_cfg("configs/semantic_kitti/synthetic.yaml",
                   [*_TINY, "OUTPUT_DIR", str(tmp_path), "AUTO_RESUME",
                    "True"])
    resumed = SemanticTrainer(cfg, str(tmp_path / "r"), device="cpu")
    assert resumed.start_epoch == int(payload["epoch"])
    assert resumed.step == int(payload["step"])
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, payload["model"][k]), k


# --------------------------------------------------------------------- #
def test_remat_vit_gradients_are_bitwise_those_without(monkeypatch):
    calls = []
    real = tvit.checkpoint
    monkeypatch.setattr(tvit, "checkpoint", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    cfg = train_cfg(get_default_cfg)
    from fusiontransformer_tpu_torch.data.build import build_dataloader
    host = next(iter(build_dataloader(cfg, "train")))
    caps = ts.batch_level_caps(cfg, host)
    batch = ts.device_batch(host, "cpu")
    grads = []
    for remat in (False, True):
        c = cfg.clone()
        c.TPU.REMAT_VIT = remat
        c.freeze()
        model = build_model(c, "cpu").train()
        out = model(batch, ts.step_hier(c, batch, caps),
                    generator=torch.Generator().manual_seed(0))
        loss, _ = ts.losses(c, out, batch, ts.class_weights_of(c, "cpu"))
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        model.eval()
        with torch.no_grad():
            model(batch, ts.step_hier(c, batch, caps))   # no remat in eval
    assert len(calls) == cfg.MODEL.VIT_DEPTH
    assert grads[0].keys() == grads[1].keys()
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


def test_only_the_parallelism_keys_remain_unported():
    """Data parallelism (TPU.NUM_DEVICES), tensor parallelism and ZeRO are
    ported: no key remains unported, and the two sharding keys are the
    distributed trainer's."""
    from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
        DISTRIBUTED_KEYS)
    assert UNPORTED_KEYS == ()
    assert {k for k, _ in DISTRIBUTED_KEYS} == {
        "TPU.MODEL_PARALLEL", "TPU.ZERO_OPTIMIZER"}


def test_sgd_matches_torch_and_resumes_bitwise(tmp_path):
    cfg = train_cfg(get_default_cfg, "SGD")
    rs = np.random.RandomState(2)
    p0 = [rs.randn(5, 3).astype(np.float32), rs.randn(7).astype(np.float32)]
    grads = [[rs.randn(*p.shape).astype(np.float32) for p in p0]
             for _ in range(4)]

    def run(opt_of, steps, params=None, state=None):
        ps = params or [torch.nn.Parameter(torch.tensor(p)) for p in p0]
        opt = opt_of(ps)
        if state is not None:
            load_optimizer_state(opt, state)
        for g in steps:
            for p, gi in zip(ps, g):
                p.grad = torch.tensor(gi)
            opt.step()
        return ps, opt

    ours, opt = run(lambda ps: build_optimizer(cfg, ps)[0], grads)
    assert isinstance(opt, SGD)
    theirs, _ = run(lambda ps: torch.optim.SGD(
        ps, lr=cfg.OPTIMIZER.BASE_LR, momentum=cfg.OPTIMIZER.SGD.momentum,
        weight_decay=cfg.OPTIMIZER.WEIGHT_DECAY), grads)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    half, opt = run(lambda ps: build_optimizer(cfg, ps)[0], grads[:2])
    path = ckpt.Checkpointer(str(tmp_path)).save(
        "m", optimizer=opt.state_dict(),
        params=[p.detach() for p in half])
    payload = torch.load(path, weights_only=True)
    resumed, _ = run(lambda ps: build_optimizer(cfg, ps)[0], grads[2:],
                     params=[torch.nn.Parameter(p.clone())
                             for p in payload["params"]],
                     state=payload["optimizer"])
    for a, b in zip(resumed, ours):
        assert torch.equal(a, b)
