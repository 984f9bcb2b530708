"""The port's single-device trainer and CLI on the CPU (port only), at the
small config of ``test_torch_port_common.tiny_cfg``: 4 SyntheticSCN scans
of ~900 points, batch 2, f32."""

import json
import math

import numpy as np
import pytest
import torch

from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data.loader import DataLoader, batch_seed
from fusiontransformer_tpu_torch.models import spvcnn
from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
    SemanticTrainer)

from test_torch_port_common import tiny_cfg


def trainer_cfg(out_dir, **over):
    cfg = tiny_cfg(get_default_cfg)
    cfg.defrost()
    cfg.OPTIMIZER.TYPE = "Adam"
    cfg.OPTIMIZER.BASE_LR = 1e-3
    cfg.OPTIMIZER.WEIGHT_DECAY = 5e-4
    cfg.TRAIN.FusionTransformer.lambda_xm = 0.1
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.VAL.BATCH_SIZE = 2
    cfg.VAL.PERIOD = 1
    cfg.SCHEDULER.MAX_EPOCH = 1
    cfg.DATASET.TRAIN = ("train",)
    cfg.DATASET.VAL = ("val",)
    cfg.DATASET.SyntheticSCN.num_scans = 4
    cfg.OUTPUT_DIR = str(out_dir)
    for k, v in over.items():
        node = cfg
        *head, last = k.split(".")
        for h in head:
            node = node[h]
        node[last] = v
    cfg.freeze()
    return cfg


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_train_validate_checkpoint_resume(tmp_path):
    cfg = trainer_cfg(tmp_path)
    tr = SemanticTrainer(cfg, str(tmp_path), device="cpu")
    before = _params(tr.model)
    tr.train()
    assert tr.step == 2                      # 4 scans / batch 2
    after = _params(tr.model)
    assert any(not torch.equal(before[k], after[k]) for k in before)
    iou = tr.val_metric_logger.meters["seg_iou_3d"].global_avg
    assert 0.0 <= iou <= 1.0
    assert tr.best_metric_epoch["3d"] == 0
    assert (tmp_path / "model000000.pth").exists()
    assert (tmp_path / "metrics.jsonl").exists()

    # Resume: the newest checkpoint's params, BN buffers, optimizer state
    # and step come back, and the next epoch is the one after it.
    cfg2 = trainer_cfg(tmp_path, **{"SCHEDULER.MAX_EPOCH": 2})
    tr2 = SemanticTrainer(cfg2, str(tmp_path), device="cpu")
    assert tr2.step == 2 and tr2.start_epoch == 1
    for k, v in _params(tr2.model).items():
        assert torch.equal(v, after[k]), k
    st1, st2 = tr.optimizer.state_dict(), tr2.optimizer.state_dict()
    for i, s in st1["state"].items():
        assert torch.equal(s["exp_avg"], st2["state"][i]["exp_avg"])
    tr2.train()
    assert tr2.step == 4


def test_each_epochs_log_line_carries_the_previous_validation(tmp_path):
    """As the JAX trainer: ``metrics.jsonl``'s line for epoch e is written
    before epoch e validates, so epoch 0's has no ``val/`` meter and epoch
    1's carries epoch 0's validation."""
    cfg = trainer_cfg(tmp_path, **{"SCHEDULER.MAX_EPOCH": 2})
    tr = SemanticTrainer(cfg, str(tmp_path), device="cpu")
    seen = []
    validate = tr.validate_for_one_epoch

    def recording(epoch):
        ran = validate(epoch)
        seen.append({k: float(m.global_avg)
                     for k, m in tr.val_metric_logger.meters.items()})
        return ran

    tr.validate_for_one_epoch = recording
    tr.train()
    lines = [json.loads(x) for x in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [x["epoch"] for x in lines] == [0, 1]
    assert not [k for k in lines[0] if k.startswith("val/")]
    assert {k[4:]: v for k, v in lines[1].items()
            if k.startswith("val/")} == seen[0]
    assert seen[0] and seen[0] != seen[1]
    assert "train/total_loss" in lines[0]


def test_non_finite_loss_stops_the_run(tmp_path):
    cfg = trainer_cfg(tmp_path, **{"VAL.PERIOD": 0})
    tr = SemanticTrainer(cfg, "", device="cpu")
    with torch.no_grad():
        tr.model.lidar_backbone.linear.kernel.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        tr.train()


def test_two_runs_from_one_seed_are_bitwise_equal(tmp_path):
    """Same RNG_SEED: same weights, batch order, dropout masks, updates."""
    ends = []
    for run in range(2):
        cfg = trainer_cfg(tmp_path / str(run), **{"VAL.PERIOD": 0,
                                                  "SCHEDULER.MAX_EPOCH": 2})
        tr = SemanticTrainer(cfg, "", device="cpu")
        tr.train()
        ends.append(_params(tr.model))
    for k in ends[0]:
        assert torch.equal(ends[0][k], ends[1][k]), k


def test_dropout_draws_from_the_step_generator():
    """Training-mode decoder dropout: ~30% zeros, survivors scaled by 1/0.7,
    the same mask from the same generator seed; identity in eval mode."""
    net = spvcnn.SPVCNN(cr=0.25, compute_dtype=torch.float32).train()
    x = torch.rand(20000, 16) + 0.5
    a = net._drop(x, torch.Generator().manual_seed(3))
    b = net._drop(x, torch.Generator().manual_seed(3))
    c = net._drop(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    zero = (a == 0).float().mean().item()
    assert abs(zero - spvcnn.DROPOUT) < 0.01, zero
    kept = a != 0
    torch.testing.assert_close(a[kept], x[kept] / (1 - spvcnn.DROPOUT))
    with pytest.raises(ValueError, match="Generator"):
        net._drop(x, None)
    assert torch.equal(net.eval()._drop(x, None), x)


class _Draws:
    """Scan i is (i, a draw from numpy's global generator)."""

    def __len__(self):
        return 7

    def __getitem__(self, i):
        return i, int(np.random.randint(1 << 30))


def test_loader_prefetch_thread_keeps_order_and_seeds():
    """The loader's prefetch thread yields the epoch's batches in order, each
    made after seeding numpy from (seed, epoch, ordinal); an error while a
    batch is made reaches the consumer."""
    load = DataLoader(_Draws(), 3, list, shuffle=True, seed=5)
    load.set_epoch(2)
    got = list(load)
    assert [[i for i, _ in b] for b in got] == \
        [list(b) for b in load._index_batches()]
    assert [len(b) for b in got] == [3, 3, 1]
    for ordinal, b in enumerate(got):
        rs = np.random.RandomState(batch_seed(5, 2, ordinal))
        assert [d for _, d in b] == [int(rs.randint(1 << 30)) for _ in b]

    def broken(items):
        raise ValueError("bad scan")

    with pytest.raises(ValueError, match="bad scan"):
        list(DataLoader(_Draws(), 3, broken))


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from fusiontransformer_tpu_torch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = trainer_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SemanticTrainer(cfg, "")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--cfg", "configs/semantic_kitti/synthetic.yaml",
                    "--run_name", "r", "OUTPUT_DIR", str(tmp_path)])


def test_cli_trains_on_the_cpu(tmp_path):
    from fusiontransformer_tpu_torch import train

    tr = train.main([
        "--cfg", "configs/semantic_kitti/synthetic.yaml", "--device", "cpu",
        "--run_name", "r", "OUTPUT_DIR", str(tmp_path),
        "MODEL.VIT_IMG_SIZE", "32", "MODEL.VIT_EMBED_DIM", "64",
        "MODEL.VIT_DEPTH", "2", "MODEL.VIT_HEADS", "2",
        "MODEL.middle_feat_block_number", "0",
        "MODEL.late_feat_block_number", "1",
        "DATASET.SyntheticSCN.image_height", "40",
        "DATASET.SyntheticSCN.image_width", "60",
        "DATASET.SyntheticSCN.num_scans", "2",
        "DATASET.SyntheticSCN.num_points", "900", "TPU.POINT_CAPACITY", "1024",
        "TRAIN.BATCH_SIZE", "2", "VAL.BATCH_SIZE", "2",
        "SCHEDULER.MAX_EPOCH", "1", "TPU.COMPUTE_DTYPE", "float32"])
    assert tr.step == 1
    losses = tr.train_metric_logger.meters["total_loss"]
    assert math.isfinite(losses.global_avg)
    assert (tmp_path / "r" / "last_checkpoint").exists()
    assert np.isfinite(tr.val_metric_logger.meters["seg_iou_2d"].global_avg)
