"""The port's data-parallel trainer on the CPU, port only: two gloo ranks,
each a spawned process (``torch_dp_ranks.py``) joined over a
``FileStore`` in ``tmp_path``, at the small config of
``test_torch_port_trainer.trainer_cfg`` (400-point scans, dropout on): a
resumed 2-rank run bit for bit an uninterrupted one, ``test()`` and its
dumps, the rank guards on what is written, ``TPU.NUM_DEVICES`` against
the world size; the combinations of the other parallelism keys that the
JAX trainer refuses raising before any process group is joined.  The
spawned run is joined with a timeout: a hang fails its test."""

import pytest
import torch

from fusiontransformer_tpu_torch.modules.DistributedTrainer import (
    DistributedTrainer)
from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
    SemanticTrainer)

import torch_dp_ranks as ranks
from test_torch_port_common import one_thread  # noqa: F401
from test_torch_port_trainer import trainer_cfg

WORLD = 2


def _resume_cfg(root, epochs, **over):
    root.mkdir(parents=True, exist_ok=True)
    return trainer_cfg(root, **{"TRAIN.BATCH_SIZE": 2,
                                "TRAIN.GRAD_ACCUM_STEPS": 3,
                                "SCHEDULER.MAX_EPOCH": epochs,
                                "DATASET.SyntheticSCN.num_scans": 4,
                                "DATASET.SyntheticSCN.num_points": 400,
                                "TPU.POINT_CAPACITY": 512,
                                "TPU.CONV_SLOT_POOL": False,
                                "DATASET.TEST": ("test",),
                                "TEST.BATCH_SIZE": 2, **over})


def test_a_resumed_two_rank_run_matches_an_uninterrupted_one(tmp_path):
    """Two ranks, 2 steps an epoch of global batch 2 with GRAD_ACCUM_STEPS
    3 and dropout on: the first epoch ends inside a window, and its
    best-IoU checkpoint keeps the window's (averaged) gradients and both
    ranks' generators; a run resumed from it ends the second epoch where
    the uninterrupted run does, bit for bit on both ranks.  Then ``test()``
    of that run restores its newest ``max-MeanIoU-*`` checkpoint and each
    rank dumps its scans; and a ``TPU.NUM_DEVICES`` that is not the world
    size raises."""
    a, b = tmp_path / "a", tmp_path / "b"
    whole = _resume_cfg(a, 2)
    half = _resume_cfg(b, 1)
    resume = _resume_cfg(b, 2, AUTO_RESUME=True)
    bad = _resume_cfg(tmp_path / "bad", 1, **{"TPU.NUM_DEVICES": 4})
    out = ranks.spawn(tmp_path, "resume", whole, half, resume, bad,
                      (str(a), str(b)))
    for r in range(WORLD):
        o = out[r]
        assert o["whole_step"] == 4 and o["half_step"] == 2
        assert o["start"] == {"epoch": 1, "step": 2, "window": 2,
                              "open_window": True}
        assert o["diffs"] == [], o["diffs"]
        assert "TPU.NUM_DEVICES = 4" in o["bad"] and "2 process" in o["bad"]
    # Both ranks hold the same weights; each its own dropout stream.
    for k, v in out[0]["params"].items():
        assert torch.equal(v, out[1]["params"][k]), k
    assert not torch.equal(out[0]["generator"], out[1]["generator"])
    # Only rank 0 writes; the best-IoU checkpoints carry MaxSaver's names.
    saved = out[0]["saved"]
    assert "max-MeanIoU-000000.pth" in saved and "metrics.jsonl" in saved
    assert not any(n.startswith("model") for n in saved)
    assert out[0]["restored"] == sorted(
        n for n in saved if n.startswith("max-MeanIoU-"))[-1]
    assert out[0]["files"] == [f"synthetic_{i:06d}.npz" for i in range(4)]
    assert out[0]["keys"] == sorted(["targets", "coords", "predictions_3d",
                                     "predictions_2d", "img_indices", "img"])
    assert out[0]["test_iou"] == out[1]["test_iou"]
    assert 0.0 <= out[0]["test_iou"]["seg_iou_3d"] <= 1.0


def test_other_parallelism_keys_raise_before_the_group_is_joined():
    """Tensor parallelism and ZeRO are ported (``test_torch_port_zero.py``,
    ``_tensor_parallel.py``); what the JAX trainer asserts about them
    raises in the data-parallel trainer before any process group is
    joined, and the single-device trainer, which runs one device, refuses
    both keys and names ``--distributed 1``."""
    bad = (
        ({"TPU.MODEL_PARALLEL": 2, "TPU.ZERO_OPTIMIZER": True,
          "TPU.NUM_DEVICES": 2}, "composes with data parallelism only"),
        ({"TPU.MODEL_PARALLEL": 2, "TRAIN.GRAD_ACCUM_STEPS": 2,
          "TPU.NUM_DEVICES": 2}, "TRAIN.GRAD_ACCUM_STEPS"),
        ({"TPU.ZERO_OPTIMIZER": True, "TRAIN.GRAD_ACCUM_STEPS": 2,
          "TPU.NUM_DEVICES": 2}, "TRAIN.GRAD_ACCUM_STEPS"),
        ({"TPU.MODEL_PARALLEL": 4, "TPU.NUM_DEVICES": 4},
         "VIT_HEADS = 2 must divide"),
        ({"TPU.MODEL_PARALLEL": 2, "TPU.NUM_DEVICES": 3},
         "must be a multiple of TPU.MODEL_PARALLEL"),
        ({"TPU.MODEL_PARALLEL": 2, "TPU.NUM_DEVICES": 6},
         "must divide over the data axis of 3"),
        ({"TPU.MODEL_PARALLEL": 2}, "must be a multiple"),    # one process
        ({"TPU.MODEL_PARALLEL": 2, "TPU.NUM_DEVICES": 2, "MODEL.TYPE":
          "LidarSeg", "MODEL.USE_FUSION": False, "MODEL.USE_IMAGE": False},
         "has none that it splits"))
    for over, message in bad:
        cfg = trainer_cfg("", **{"TRAIN.BATCH_SIZE": 4, **over})
        with pytest.raises(ValueError, match=message):
            DistributedTrainer(cfg, "", device="cpu")
    for key, value in (("TPU.MODEL_PARALLEL", 2), ("TPU.ZERO_OPTIMIZER",
                                                   True)):
        cfg = trainer_cfg("", **{"TRAIN.BATCH_SIZE": 4, key: value})
        with pytest.raises(ValueError, match=f"{key}.*--distributed 1"):
            SemanticTrainer(cfg, "", device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank gloo group in this process (a ``FileStore`` in
    ``tmp_path``), destroyed after the test."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_the_collectives_run_outside_the_captured_step(world_of_one,
                                                       monkeypatch):
    """What ``_launch`` runs, and on the card captures, is the local step
    alone, with ``update=False``: every collective of the step (the
    agreement, the reductions) runs outside it, eagerly."""
    import torch.distributed as dist
    tr = DistributedTrainer(trainer_cfg("", **{"VAL.PERIOD": 0}), "",
                            device="cpu")
    calls, inside = [], []
    for name in ("all_reduce", "all_gather", "broadcast"):
        real = getattr(dist, name)

        def counted(*a, _real=real, _name=name, **k):
            calls.append(_name)
            if inside:
                raise AssertionError(f"{_name} inside the captured step")
            return _real(*a, **k)

        monkeypatch.setattr(dist, name, counted)
    launch = tr._launch

    def guarded(kind, cache, step, *a, **k):
        def local(batch):
            inside.append(1)
            try:
                return step(batch)
            finally:
                inside.pop()
        return launch(kind, cache, local, *a, **k)

    monkeypatch.setattr(tr, "_launch", guarded)
    updates = []
    monkeypatch.setattr(tr.train_step, "update",
                        lambda: updates.append(1))
    tr.run_train_step(next(iter(tr.train_dataloader))).numpy()
    assert calls.count("all_gather") == 1          # the agreement
    assert calls.count("all_reduce") == 3          # metrics, buffers, grads
    assert updates == [1]                          # one update, outside


def test_each_rank_draws_from_a_generator_of_its_own(world_of_one):
    """Rank 0's dropout generator is the single-device trainer's (seeded
    RNG_SEED); rank r's is seeded ``rank_seed(RNG_SEED, r)`` (JAX folds the
    device index into one key)."""
    from fusiontransformer_tpu_torch.parallel.data_parallel import rank_seed
    cfg = trainer_cfg("", **{"VAL.PERIOD": 0})
    dp = DistributedTrainer(cfg, "", device="cpu")
    one = SemanticTrainer(cfg, "", device="cpu")
    assert torch.equal(dp.generator.get_state(), one.generator.get_state())
    assert rank_seed(cfg.RNG_SEED, 0) == cfg.RNG_SEED
    seeds = {rank_seed(cfg.RNG_SEED, r) for r in range(8)}
    assert len(seeds) == 8


def test_gloo_keeps_its_integers_on_the_host_and_no_backend_switches(
        world_of_one):
    """The gloo group (the CPU tests, and the two ranks sharing one card in
    ``chip_smoke.py``) gathers its small ints in host memory; a group of
    another backend than the one asked for raises."""
    from fusiontransformer_tpu_torch.parallel.data_parallel import (
        Reducer, init_distributed)
    r = Reducer(torch.device("cpu"))
    assert r.backend == "gloo" and r.comm_device == torch.device("cpu")
    assert r.all_gather_ints([3, 4]).tolist() == [[3, 4]]
    assert init_distributed(torch.device("cuda"), "gloo") == (0, 1)
    with pytest.raises(ValueError, match="runs gloo, not the requested nccl"):
        init_distributed(torch.device("cpu"), "nccl")


def test_a_rank_whose_collective_fails_exits_non_zero(tmp_path):
    """A rank that loses its peer raises from the collective (gloo: the
    connection closed) and its process exits non-zero: nothing goes on
    with a partial reduction."""
    (code0, err0), (code1, _) = ranks.spawn(tmp_path, "abandoned",
                                            timeout=60, check=False)
    assert code1 == 3
    assert code0 != 0 and "mean_" in err0 and "all_reduce" in err0
