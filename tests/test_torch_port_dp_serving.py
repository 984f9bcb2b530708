"""The port's data-parallel pieces that need no process group, on the CPU:
the sharded inference engine (two replicas) against JAX's
``shard_predict_step`` on a 2-device mesh, the ranks' loaders against the
JAX package's bit for bit, ``IterationBasedBatchSampler`` and the
callbacks against JAX's, ``shard_of`` / ``repad``, ``resolve_device``
under torchrun's environment, the slot maps switched off past one device,
and ``train.py --distributed 1`` / ``--use_torchpack_test 1`` at world 1
over gloo.

Engine tolerance: labels may differ only where two classes tie to f32
rounding, >= 99.9% of points agree (``test_torch_port_engine.py``); the
summed overflow exactly JAX's ``psum``; the port's two replicas against
its one replica bit for bit where no voxel is dropped (with overflow each
replica's capacities are its own shard's, as each JAX device's are).
"""

import os
import socket

import numpy as np
import pytest
import torch

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.data.build import build_dataloader as j_loader
from fusiontransformer_tpu.modules import callbacks as jcb
from fusiontransformer_tpu.serving import InferenceEngine as JEngine
from fusiontransformer_tpu.utils.sampler import (
    IterationBasedBatchSampler as JSampler)
from fusiontransformer_tpu_torch import train as train_cli
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data.build import (build_dataloader,
                                                    slot_pool_spec)
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.modules import callbacks as tcb
from fusiontransformer_tpu_torch.parallel.data_parallel import (repad,
                                                                shard_of)
from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
from fusiontransformer_tpu_torch.utils import device as device_mod
from fusiontransformer_tpu_torch.utils.convert_jax import load_jax_variables
from fusiontransformer_tpu_torch.utils.sampler import (
    IterationBasedBatchSampler)

from test_torch_port_common import (jax_variables, one_thread,  # noqa: F401
                                    record, tiny_cfg, train_cfg)
from test_torch_port_loader_workers import AUG, assert_batches_equal

KEYS = ("labels", "labels_2d", "labels_3d")


def engine_cfg(get_cfg):
    """``tiny_cfg`` with an L1 capacity a quarter of L0's: each replica's
    scan drops voxels there, so the overflow counts are not 0."""
    cfg = tiny_cfg(get_cfg)
    cfg.defrost()
    cfg.TPU.LEVEL_CAPACITY_FRACTIONS = (0.25, 0.9, 0.8, 0.7)
    cfg.freeze()
    return cfg


def test_sharded_engine_matches_jax_shard_predict_step():
    params, stats = jax_variables(engine_cfg(jcfg))
    jeng = JEngine(engine_cfg(jcfg), params=params, batch_stats=stats,
                   batch_size=2, num_devices=2)
    cfg = engine_cfg(get_default_cfg)
    model = load_jax_variables(build_model(cfg, "cpu"), params, stats)
    sharded = InferenceEngine(cfg, model=model, batch_size=2, device="cpu",
                              num_devices=2)
    named = InferenceEngine(cfg, model=model, batch_size=2,
                            devices=["cpu", "cpu"])
    assert len(sharded.replicas) == 2 and sharded._slot_pool is None
    assert sharded.replicas[1].model is model        # one device: shared
    recs = [record(20 + i) for i in range(4)]
    for pair in (recs[:2], recs[2:]):
        want = jeng.predict_batch(pair)
        got = sharded.predict_batch(pair)
        for a, b in zip(got, named.predict_batch(pair)):
            for key in KEYS:
                np.testing.assert_array_equal(a[key], b[key])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["in_frustum"], b["in_frustum"])
            for key in KEYS:
                assert np.mean(a[key] == b[key]) >= 0.999, key
    over = sharded.stats()["voxel_overflow"]
    assert over > 0 and over == jeng.stats()["voxel_overflow"]
    # A pair's count is its two replicas' counts, each not 0, summed.
    handle = sharded.dispatch_samples([sharded.preprocess(r)
                                       for r in recs[:2]])
    col = sharded._pred_keys.index("voxel_overflow")
    parts = [int(p.numpy()[0, col]) for p in handle[2]]
    sharded.complete(handle)
    assert all(parts)
    assert sharded.stats()["voxel_overflow"] - over == sum(parts)


def test_two_replicas_predict_what_one_does_without_overflow():
    """Lossless capacities: a scan's prediction does not depend on the
    replica or the batch it rides in."""
    cfg = tiny_cfg(get_default_cfg)
    model = build_model(cfg, "cpu", seed=4)
    sharded = InferenceEngine(cfg, model=model, batch_size=2, device="cpu",
                              num_devices=2)
    single = InferenceEngine(cfg, model=model, batch_size=2, device="cpu")
    recs = [record(30), record(31)]
    for a, b in zip(sharded.predict_batch(recs), single.predict_batch(recs)):
        for key in KEYS:
            np.testing.assert_array_equal(a[key], b[key])
    assert sharded.stats()["voxel_overflow"] == 0


def test_engine_replicas_need_a_dividing_batch_and_a_live_model(tmp_path):
    cfg = tiny_cfg(get_default_cfg)
    with pytest.raises(ValueError, match="does not divide"):
        InferenceEngine(cfg, batch_size=3, device="cpu", num_devices=2)
    with pytest.raises(ValueError, match="single-device"):
        InferenceEngine(cfg, batch_size=2, device="cpu", num_devices=2,
                        exported_dir=str(tmp_path))


@pytest.mark.parametrize("mode", ["train", "val"])
def test_each_ranks_loader_is_jaxs(mode):
    """``build_dataloader(use_distributed=True, rank, world_size,
    seed=rank, batch_size=bs // world)`` for each of 2 ranks, two epochs
    (train: augmented, shuffled per rank's seed), bit for bit the JAX
    package's; no group-pooled maps past one device."""
    def cfg_of(get_cfg):
        cfg = train_cfg(get_cfg)
        cfg.defrost()
        cfg.TRAIN.BATCH_SIZE = 4
        cfg.DATASET.SyntheticSCN.num_scans = 7
        for k, v in AUG.items():
            cfg.DATASET.SyntheticSCN.augmentation[k] = v
        cfg.freeze()
        return cfg

    for rank in range(2):
        kw = dict(use_distributed=True, rank=rank, world_size=2)
        if mode == "train":
            kw.update(seed=rank, batch_size=2)
        got = build_dataloader(cfg_of(get_default_cfg), mode, **kw)
        want = j_loader(cfg_of(jcfg), mode, **kw)
        assert len(got.dataset) == len(want.dataset) == 4
        assert len(got) == len(want) == (2 if mode == "train" else 4)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            a, b = list(got), list(want)
            assert not any(k.startswith("gslot_") for k in a[0])
            assert_batches_equal(a, b, keys=[k for k in a[0]
                                             if isinstance(a[0][k],
                                                           np.ndarray)])
            for x, y in zip(a, b):
                assert x["filename"] == y["filename"]


def test_slot_maps_are_off_past_one_device():
    cfg = tiny_cfg(get_default_cfg)
    assert slot_pool_spec(cfg, False) is not None
    assert slot_pool_spec(cfg, False, world_size=2) is None
    cfg.defrost()
    cfg.TPU.NUM_DEVICES = 2
    assert slot_pool_spec(cfg, False) is None


def test_shard_of_cuts_whole_scans_and_rebases_their_ids():
    cfg = tiny_cfg(get_default_cfg)
    cfg.defrost()
    cfg.TPU.CONV_SLOT_POOL = False
    cfg.TRAIN.BATCH_SIZE = 4
    cfg.DATASET.SyntheticSCN.num_scans = 4
    cfg.DATASET.TRAIN = ("train",)
    cfg.freeze()
    batch = next(iter(build_dataloader(cfg, "train")))
    cap = len(batch["pt_valid"]) // 4
    for rank in range(2):
        s = shard_of(batch, rank, 2)
        rows = slice(rank * 2 * cap, (rank + 1) * 2 * cap)
        for k in ("coords", "feats", "seg_label", "pt_valid",
                  "img_indices"):
            np.testing.assert_array_equal(s[k], batch[k][rows])
        valid = batch["pt_valid"][rows]
        np.testing.assert_array_equal(
            s["pt_batch"][valid], batch["pt_batch"][rows][valid] - 2 * rank)
        assert set(np.unique(s["pt_batch"])) == {0, 1}
        np.testing.assert_array_equal(s["img"], batch["img"][2 * rank:
                                                             2 * rank + 2])
        assert s["filename"] == batch["filename"][2 * rank:2 * rank + 2]
        np.testing.assert_array_equal(
            s["level_counts"], batch["level_counts_per_scan"][
                2 * rank:2 * rank + 2].sum(0))
    with pytest.raises(ValueError, match="divide"):
        shard_of(batch, 0, 3)
    with pytest.raises(ValueError, match="gslot"):
        shard_of({**batch, "gslot_src_0": None}, 0, 2)
    wide = repad(batch, cap, cap + 128)
    assert len(wide["pt_valid"]) == 4 * (cap + 128)
    for i in range(4):
        got = wide["coords"][i * (cap + 128):i * (cap + 128) + cap]
        np.testing.assert_array_equal(got, batch["coords"][i * cap:
                                                           (i + 1) * cap])
        assert not wide["pt_valid"][i * (cap + 128) + cap:
                                    (i + 1) * (cap + 128)].any()
    assert repad(batch, cap, cap) is batch


def test_resolve_device_takes_the_local_rank(monkeypatch):
    """Under torchrun (``LOCAL_RANK`` set) ``None`` / ``"cuda"`` is
    ``cuda:LOCAL_RANK``, made current; ``"cpu"`` stays the CPU; with no
    card it raises."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device(None)
    made_current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", made_current.append)
    for asked in (None, "cuda"):
        assert device_mod.resolve_device(asked) == torch.device("cuda", 1)
    assert made_current == [torch.device("cuda", 1)] * 2
    assert device_mod.resolve_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.delenv("LOCAL_RANK")
    assert device_mod.resolve_device(None) == torch.device("cuda")
    assert len(made_current) == 2


def test_iteration_sampler_matches_jax():
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False),
               dict(drop_last=False, seed=1), dict(start_iter=4)):
        a = IterationBasedBatchSampler(10, 3, 11, **kw)
        b = JSampler(10, 3, 11, **kw)
        for epoch in (0, 2):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            got, want = [list(x) for x in a], [list(x) for x in b]
            assert got == want and len(a) == len(b) == len(got)


def test_callbacks_match_jax(capsys):
    rs = np.random.RandomState(0)
    out = {"outputs": rs.randint(0, 20, 500), "targets": rs.randint(0, 20,
                                                                   500)}
    cm = rs.randint(0, 50, (20, 20))
    t, j = tcb.MeanIoU(20, 0), jcb.MeanIoU(20, 0)
    for cb in (t, j):
        cb.after_step(out)
        cb.update_confusion(cm)
    assert t.ious == j.ious and t.miou == j.miou
    assert t.class_names == j.class_names
    assert t.after_epoch() == j.after_epoch()
    text = capsys.readouterr().out
    half = len(text) // 2
    assert text[:half] == text[half:] and "MIoU" in text
    for name in ("IoUEval", "AccEval"):
        a, b = getattr(tcb, name)(20), getattr(jcb, name)(20)
        for cb in (a, b):
            cb.after_step(out)
            cb.after_step({"outputs": out["targets"],
                           "targets": out["targets"]})
        np.testing.assert_array_equal(a.conf_matrix, b.conf_matrix)
        ra, rb = a.after_epoch(), b.after_epoch()
        if name == "IoUEval":
            assert ra[0] == rb[0]
            np.testing.assert_array_equal(ra[1], rb[1])
        else:
            assert ra == rb
    s = tcb.SummaryExtended()
    s.add_scalar("x", np.float32(2.5))
    assert s.scalars == {"x": [2.5]}


def test_event_writer_histograms_by_parameter_name(tmp_path, monkeypatch):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    w = tcb.TFEventWriterExtended(tmp_path, log_histogram=True)
    model = torch.nn.Sequential(torch.nn.Linear(3, 2))
    w.write_scalars({"train/loss": np.float32(1.5)})
    w.write_histograms(model.named_parameters())
    w.after_epoch()
    ev = EventAccumulator(str(tmp_path))
    ev.Reload()
    assert ev.Tags()["histograms"] == ["params/0/weight", "params/0/bias"]
    assert ev.Scalars("train/loss")[0].value == 1.5
    import builtins
    real = builtins.__import__

    def no_tensorboard(name, *a, **k):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with pytest.raises(ImportError, match="tensorboard package"):
        tcb.TFEventWriterExtended(tmp_path / "x")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_cli_distributed_then_test_at_world_one(tmp_path, monkeypatch):
    """``train.py --distributed 1 --device cpu`` as torchrun would start
    its one process (gloo, world 1): the best-IoU checkpoint under
    MaxSaver's name; then ``--use_torchpack_test 1`` restores it and
    dumps each test scan."""
    import torch.distributed as dist
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"),
                 ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(k, v)
    small = ["OUTPUT_DIR", str(tmp_path), "MODEL.VIT_IMG_SIZE", "32",
             "MODEL.VIT_EMBED_DIM", "64", "MODEL.VIT_DEPTH", "2",
             "MODEL.VIT_HEADS", "2", "MODEL.middle_feat_block_number", "0",
             "MODEL.late_feat_block_number", "1",
             "DATASET.SyntheticSCN.num_points", "400",
             "DATASET.SyntheticSCN.num_scans", "2",
             "DATASET.SyntheticSCN.image_height", "40",
             "DATASET.SyntheticSCN.image_width", "60",
             "DATASET.TEST", "('test',)", "TPU.POINT_CAPACITY", "512",
             "TPU.CAPACITY_BUCKETS", "()", "TRAIN.BATCH_SIZE", "2",
             "VAL.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "2",
             "SCHEDULER.MAX_EPOCH", "1", "VAL.PERIOD", "1"]
    argv = ["--cfg", "configs/semantic_kitti/synthetic.yaml", "--device",
            "cpu", "--run_name", "r"]
    root = os.path.join(os.path.dirname(__file__), "..")
    monkeypatch.chdir(root)
    tr = train_cli.main(argv + ["--distributed", "1"] + small)
    assert not dist.is_initialized()
    assert (tr.rank, tr.world_size, tr.step) == (0, 1, 1)
    run = tmp_path / "r"
    assert (run / "max-MeanIoU-000000.pth").exists()
    tested = train_cli.main(argv + ["--use_torchpack_test", "1"] + small)
    assert not dist.is_initialized()
    assert tested.best_checkpoint().endswith("max-MeanIoU-000000.pth")
    assert sorted(os.listdir(run / "predictions")) == [
        "synthetic_000000.npz", "synthetic_000001.npz"]
