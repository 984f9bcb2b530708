"""Validation and the eval CLI of the port on SemanticKITTI-format data, on
the CPU: ``validate`` through the inverse label map (oracle predictions
score IoU 1; the same per-voxel predictions give the JAX ``validate``'s
confusion matrices, with a scan truncated by the capacity and its lost
points scored as class 0; each batch read back after the next one is
enqueued), ``Evaluator.save_table`` and ``SegAccuracy`` against JAX's; the
whole slice against JAX at tiny widths with converted weights; and one
tiny end-to-end drive of the CLIs: fabricated raw tree -> preprocess ->
train -> ``test.py``.

Tolerance of the slice: the confusion matrices are equal, leaving out each
voxel whose two largest scores are within 2e-3 of each other (``PARITY.md``'s
bound on full-model logits): the logits of either stream, and for the
ensemble the log of the summed softmaxes (which moves no more than twice
the logits do).  Both sides score such a voxel with the port's class, and
the test reports how many there were.
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.data.build import build_dataloader as j_loader
from fusiontransformer_tpu.data.utils.evaluate import Evaluator as JEvaluator
from fusiontransformer_tpu.data.utils.validate import validate as j_validate
from fusiontransformer_tpu.models.build import build_model as j_build
from fusiontransformer_tpu.models.metric import SegAccuracy as JSegAccuracy
from fusiontransformer_tpu.modules import steps as js
from fusiontransformer_tpu.utils.metric_logger import MetricLogger as JML
from fusiontransformer_tpu_torch import test as test_cli
from fusiontransformer_tpu_torch import train as train_cli
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data.build import build_dataloader
from fusiontransformer_tpu_torch.data.semantic_kitti import labels as L
from fusiontransformer_tpu_torch.data.semantic_kitti import preprocess as TP
from fusiontransformer_tpu_torch.data.utils.evaluate import Evaluator
from fusiontransformer_tpu_torch.data.utils.validate import validate
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.models.metric import SegAccuracy
from fusiontransformer_tpu_torch.modules.SemanticTrainer import StepRunner
from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                       hier_from_cfg,
                                                       read_back)
from fusiontransformer_tpu_torch.tools.fabricate import make_kitti
from fusiontransformer_tpu_torch.utils.convert_jax import load_jax_variables
from fusiontransformer_tpu_torch.utils.metric_logger import MetricLogger

from test_torch_port_common import (jax_variables, one_thread,  # noqa: F401
                                    tiny_cfg)
from test_torch_port_kitti import kitti  # noqa: F401
from tests.test_kitti_pipeline import H, W

TIE = 2e-3
KEYS = ("pred_2d", "pred_3d", "pred_ensemble")


def eval_cfg(get_cfg, root, out, capacity=512):
    """``tiny_cfg`` on the debug splits of the fabricated KITTI tree."""
    cfg = tiny_cfg(get_cfg, point_capacity=capacity)
    cfg.defrost()
    cfg.DATASET.TYPE = "SemanticKITTISCN"
    cfg.DATASET.TRAIN, cfg.DATASET.VAL = ("train",), ("val",)
    cfg.DATASET.TEST = ("test",)
    ds = cfg.DATASET.SemanticKITTISCN
    ds.preprocess_dir, ds.semantic_kitti_dir = out, root
    ds.image_width, ds.image_height = W, H
    ds.debug = True
    cfg.TEST.BATCH_SIZE = cfg.VAL.BATCH_SIZE = 2
    cfg.TPU.NUM_DEVICES = 1
    cfg.TPU.ADAPTIVE_LEVEL_CAPS = False
    cfg.freeze()
    return cfg


def fake_predictions(batch):
    """Per-voxel predictions made from the batch alone, so both packages'
    loops can be handed the same ones."""
    c = np.asarray(batch["coords"]).astype(np.int64)
    base = (c[:, 0] * 7 + c[:, 1] * 3 + c[:, 2]) % 20
    return {"pred_2d": base, "pred_3d": (base + 3) % 20,
            "pred_ensemble": np.where(base % 3 == 0,
                                      np.asarray(batch["seg_label"]), base),
            "seg_loss_2d": np.float32(base.mean()),
            "seg_loss_3d": np.float32(1.5)}


def matrices(eval_list):
    return {m: ev.confusion_matrix for m, ev in eval_list}


def test_oracle_predictions_score_iou_1_through_the_inverse_map(kitti):
    root, out = kitti
    cfg = eval_cfg(get_default_cfg, root, out)
    loader = build_dataloader(cfg, "val")
    assert loader.dataset.map_inverse_label is not None

    def oracle(batch):
        label = torch.as_tensor(batch["seg_label"]).long()
        return read_back({"pred_2d": label, "pred_3d": label,
                          "pred_ensemble": label,
                          "seg_loss_2d": torch.zeros(()),
                          "seg_loss_3d": torch.zeros(())})

    ml = MetricLogger()
    evals = dict(validate(cfg, oracle, loader, ml))
    for ev in evals.values():
        assert ev.overall_acc > 0.98
        iou = np.array(ev.class_iou)
        present = ~np.isnan(iou)
        assert present.sum() >= 5 and (iou[present] > 0.95).all()
        # Rows and columns are raw SemanticKITTI ids in train-id order.
        assert list(ev.labels) == L.class_labels()
    assert ml.meters["collate_dropped"].global_avg == 0


@pytest.mark.parametrize("capacity", [512, 384])
def test_validate_gives_the_confusion_matrices_of_jax(kitti, capacity):
    """At capacity 384 the scans (~450 voxels) are truncated: their lost
    points come back as class 0 in both packages."""
    root, out = kitti
    cfg_t = eval_cfg(get_default_cfg, root, out, capacity)
    cfg_j = eval_cfg(jcfg, root, out, capacity)
    order = []

    class Pending:
        def __init__(self, res):
            self.res = res

        def numpy(self):
            order.append("read")
            return read_back(self.res).numpy()

    def run_batch(batch):
        order.append("enqueue")
        return Pending({k: torch.as_tensor(v)
                        for k, v in fake_predictions(batch).items()})

    tml, jml = MetricLogger(), JML()
    got = matrices(validate(cfg_t, run_batch, build_dataloader(cfg_t, "val"),
                            tml))
    want = matrices(j_validate(cfg_j, lambda s, b: fake_predictions(b), None,
                               j_loader(cfg_j, "val"), jml))
    assert got.keys() == want.keys() == {"2D", "3D", "2D+3D"}
    for m in got:
        np.testing.assert_array_equal(got[m], want[m], err_msg=m)
        assert got[m].sum() > 0
    for name in ("collate_dropped", "oob_points", "seg_iou_2d", "seg_iou_3d",
                 "seg_loss_2d"):
        assert tml.meters[name].global_avg == jml.meters[name].global_avg
    lost = tml.meters["oob_points"].global_avg
    assert (lost > 0) == (capacity == 384)
    # Two batches: the first is read after the second was enqueued.
    assert order == ["enqueue", "enqueue", "read", "read"]


def test_save_table_and_seg_accuracy_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    names, labels = L.class_names(), L.class_labels()
    ev, jev = Evaluator(names, labels), JEvaluator(names, labels)
    for _ in range(3):
        gt = rng.choice(labels, 500)
        pred = np.where(rng.rand(500) < 0.6, gt, rng.choice(labels, 500))
        ev.update(pred, gt)
        jev.update(pred, gt)
    ev.save_table(tmp_path / "port.tsv")
    jev.save_table(tmp_path / "jax.tsv")
    assert (tmp_path / "port.tsv").read_text() == \
        (tmp_path / "jax.tsv").read_text()
    acc, jacc = SegAccuracy(), JSegAccuracy()
    for _ in range(2):
        logit = rng.randn(300, 20).astype(np.float32)
        label = rng.randint(-1, 20, 300)
        label[label == -1] = -100
        acc.update_dict({"seg_logit": torch.from_numpy(logit)},
                        {"seg_label": torch.from_numpy(label)})
        jacc.update_dict({"seg_logit": logit}, {"seg_label": label})
    assert acc.global_avg == jacc.global_avg and acc.count == jacc.count


def test_the_slice_scores_the_test_split_as_jax_does(kitti, caplog):
    """Converted weights, the test split through each package's own eval
    step and validate loop (the port's through ``StepRunner``, as
    ``test.py`` runs it): equal confusion matrices for 2D, 3D and 2D+3D."""
    root, out = kitti
    cfg_t = eval_cfg(get_default_cfg, root, out)
    cfg_j = eval_cfg(jcfg, root, out)
    params, stats = jax_variables(cfg_j)
    jmodel = j_build(cfg_j)[0]
    state = js.TrainState(params, stats, None, 0)
    j_eval = jax.jit(js.make_eval_step(cfg_j, jmodel, 2)[0])
    model = load_jax_variables(build_model(cfg_t, "cpu"), params, stats)
    runner = StepRunner(cfg_t, model, torch.device("cpu"),
                        logging.getLogger("test"))
    ties = {k: 0 for k in KEYS}

    def jax_step(state, jb):
        """JAX's predictions, with each near tie given the port's class."""
        res = {k: np.asarray(v) for k, v in j_eval(state, jb).items()}
        tb = device_batch({k: np.asarray(v) for k, v in jb.items()}, "cpu")
        with torch.no_grad():
            o = model.eval()(tb, hier_from_cfg(cfg_t, tb))
        scores = {"pred_2d": o["img_seg_logit"],
                  "pred_3d": o["lidar_seg_logit"],
                  "pred_ensemble": torch.log(
                      torch.softmax(o["img_seg_logit"], -1)
                      + torch.softmax(o["lidar_seg_logit"], -1))}
        valid = tb["pt_valid"].numpy()
        for k, s in scores.items():
            top = torch.topk(s, 2).values
            tie = ((top[:, 0] - top[:, 1]) < TIE).numpy() & valid
            ties[k] += int(tie.sum())
            res[k] = np.where(tie, s.argmax(-1).numpy(), res[k])
        return res

    got = matrices(validate(cfg_t, runner.run_eval_batch,
                            build_dataloader(cfg_t, "test"), MetricLogger()))
    want = matrices(j_validate(cfg_j, jax_step, state,
                               j_loader(cfg_j, "test"), JML()))
    for m, key in zip(("2D", "3D", "2D+3D"), KEYS):
        np.testing.assert_array_equal(got[m], want[m], err_msg=m)
        assert got[m].sum() > 500
    n = int(got["3D"].sum())
    print(f"near ties left out (voxels): {ties} of ~{n} points")
    assert sum(ties.values()) < 0.05 * n


def _cli_overrides(root, pre, out):
    return ["OUTPUT_DIR", str(out),
            "DATASET.SemanticKITTISCN.preprocess_dir", str(pre),
            "DATASET.SemanticKITTISCN.semantic_kitti_dir", str(root),
            "DATASET.SemanticKITTISCN.image_width", "120",
            "DATASET.SemanticKITTISCN.image_height", "40",
            "MODEL.VIT_IMG_SIZE", "32", "MODEL.VIT_EMBED_DIM", "64",
            "MODEL.VIT_DEPTH", "2", "MODEL.VIT_HEADS", "2",
            "MODEL.middle_feat_block_number", "0",
            "MODEL.late_feat_block_number", "1",
            "TPU.POINT_CAPACITY", "1024", "TPU.CAPACITY_BUCKETS", "(1024,)",
            "TPU.COMPUTE_DTYPE", "float32", "VAL.BATCH_SIZE", "2"]


def test_the_clis_preprocess_train_and_test_a_fabricated_tree(tmp_path):
    """``middlefusion.yaml`` at tiny widths: the preprocess CLI over a raw
    tree in the regular splits' sequences, ``train`` for one epoch with
    validation, then ``test.py`` on its checkpoint."""
    root, pre, out = tmp_path / "raw", tmp_path / "pre", tmp_path / "out"
    make_kitti(str(root), {"00": 4, "07": 2, "08": 2}, rays=1400, width=120,
               height=40)
    TP.main(["--root", str(root), "--out", str(pre), "--workers", "2"])
    cfg = "configs/semantic_kitti/middlefusion.yaml"
    tr = train_cli.main(["--cfg", cfg, "--device", "cpu", "--run_name", "r",
                         *_cli_overrides(root, pre, out),
                         "TRAIN.BATCH_SIZE", "2", "VAL.PERIOD", "1",
                         "SCHEDULER.MAX_EPOCH", "1"])
    assert tr.step == 2
    val = tr.val_metric_logger.meters
    assert val["collate_dropped"].global_avg == 0
    assert val["oob_points"].global_avg == 0
    ckpt = out / "r" / "model000000.pth"
    assert ckpt.exists()
    res = test_cli.main(["--cfg", cfg, "--device", "cpu", "--ckpt",
                         "@/r/model000000.pth",
                         *_cli_overrides(root, pre, out)])
    meters = res["meters"].meters
    assert meters["collate_dropped"].global_avg == 0
    assert meters["oob_points"].global_avg == 0
    for m in ("2D", "3D", "2D+3D"):
        ev = res["evaluators"][m]
        assert 0.0 <= ev.overall_iou <= 1.0
        assert ev.confusion_matrix.sum() > 500
        table = (out / f"test_{m.replace('+', '_')}.tsv").read_text()
        assert table.startswith("overall acc\toverall iou\tunlabeled")
    assert res["captures"] == 0                 # no graphs on the CPU
    # test.py scored the checkpoint: the trained model, validated in this
    # process on the same split, gives the same matrices.
    cfg_t = train_cli.load_cfg(cfg, [*_cli_overrides(root, pre, out)])
    again = dict(validate(cfg_t, StepRunner(
        cfg_t, tr.model, torch.device("cpu"),
        logging.getLogger("test")).run_eval_batch,
        build_dataloader(cfg_t, "test"), MetricLogger()))
    for m, ev in again.items():
        np.testing.assert_array_equal(ev.confusion_matrix,
                                      res["evaluators"][m].confusion_matrix)
    lines = [json.loads(x) for x in
             (out / "r" / "metrics.jsonl").read_text().splitlines()]
    assert [x["epoch"] for x in lines] == [0]
