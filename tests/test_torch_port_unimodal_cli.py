"""``train.py --device cpu`` then ``test.py`` for each uni-modal config, on
the CPU, on fabricated raw trees in the real formats
(``tools/fabricate.py``): ``semantic_kitti/lidar.yaml`` (LidarSeg),
``imageBilinear.yaml`` (ImageSegBilinear), ``image.yaml`` (the STN
``ImageSeg``) and ``nuscenes/lidar.yaml`` (LidarSeg, 5 merged classes).

The configs run as shipped but for their directories and these cuts:
batch 2, one epoch over 2 frames, a 1024-point buffer (2048 for NuScenes),
f32, 120 x 40 SemanticKITTI images, and for ``imageBilinear.yaml`` the tiny
ViT of ``test_torch_port_common.tiny_cfg`` (``image.yaml`` builds its
DeiT-B/384 whatever the config says).  Each run must train its one stream
(its loss and IoU meters only), validate it, checkpoint its own best
metric, and ``test.py`` must write the table of that modality only, with
the matrices an in-process ``validate`` of the checkpoint gives.  Then
``tools/serve.py --selftest`` for a lidar-only and an image-only model.
"""

import logging
import os.path as osp

import numpy as np
import pytest
import torch

from fusiontransformer_tpu_torch import test as test_cli
from fusiontransformer_tpu_torch import train as train_cli
from fusiontransformer_tpu_torch.data.build import build_dataloader
from fusiontransformer_tpu_torch.data.nuscenes.preprocess import preprocess
from fusiontransformer_tpu_torch.data.semantic_kitti import preprocess as TP
from fusiontransformer_tpu_torch.data.utils.validate import validate
from fusiontransformer_tpu_torch.modules.SemanticTrainer import StepRunner
from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
from fusiontransformer_tpu_torch.tools import serve
from fusiontransformer_tpu_torch.tools.fabricate import (FakeNuScenes,
                                                         make_kitti)
from fusiontransformer_tpu_torch.utils.metric_logger import MetricLogger

from test_torch_port_common import one_thread  # noqa: F401

CONFIGS = {"semantic_kitti/lidar.yaml": "3d",
           "semantic_kitti/imageBilinear.yaml": "2d",
           "semantic_kitti/image.yaml": "2d",
           "nuscenes/lidar.yaml": "3d"}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A SemanticKITTI tree (train 00: 2 frames, val 07: 1, test 08: 1) and
    a NuScenes database (a USA train scene of 2 samples, Singapore val and
    test scenes of 1), each through the port's preprocessor."""
    tmp = tmp_path_factory.mktemp("unimodal_trees")
    kitti, kitti_pre = str(tmp / "kitti"), str(tmp / "kitti_pre")
    make_kitti(kitti, {"00": 2, "07": 1, "08": 1}, rays=1400, width=120,
               height=40)
    TP.main(["--root", kitti, "--out", kitti_pre, "--workers", "2"])
    nus, nus_out = str(tmp / "nusc"), str(tmp / "nusc_pre")
    nusc = FakeNuScenes(nus, [("scene-0001", "day", "boston-seaport", 2),
                              ("scene-0004", "day", "singapore-onenorth", 1),
                              ("scene-0003", "day", "singapore-onenorth", 1)],
                        rays=1500)
    preprocess(nusc, ["train", "test"], nus, nus_out, location="boston",
               subset_name="usa")
    preprocess(nusc, ["train", "val", "test"], nus, nus_out,
               location="singapore", subset_name="singapore")
    return {"kitti": (kitti, kitti_pre),
            "nuscenes": (nus, osp.join(nus_out, "preprocess"))}


def overrides(config, trees, out):
    run = ["OUTPUT_DIR", str(out), "TPU.COMPUTE_DTYPE", "float32",
           "TRAIN.BATCH_SIZE", "2", "VAL.BATCH_SIZE", "2"]
    if config.startswith("nuscenes"):
        root, pre = trees["nuscenes"]
        return run + ["DATASET.NuScenesSCN.preprocess_dir", pre,
                      "DATASET.NuScenesSCN.nuscenes_dir", root,
                      "TPU.POINT_CAPACITY", "2048",
                      "TPU.CAPACITY_BUCKETS", "(2048,)"]
    root, pre = trees["kitti"]
    return run + ["DATASET.SemanticKITTISCN.preprocess_dir", pre,
                  "DATASET.SemanticKITTISCN.semantic_kitti_dir", root,
                  "DATASET.SemanticKITTISCN.image_width", "120",
                  "DATASET.SemanticKITTISCN.image_height", "40",
                  "MODEL.VIT_IMG_SIZE", "32", "MODEL.VIT_EMBED_DIM", "64",
                  "MODEL.VIT_DEPTH", "2", "MODEL.VIT_HEADS", "2",
                  "MODEL.late_feat_block_number", "1",
                  "TPU.POINT_CAPACITY", "1024",
                  "TPU.CAPACITY_BUCKETS", "(1024,)"]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_train_then_test_a_unimodal_config(config, trees, tmp_path):
    dim = CONFIGS[config]
    other = {"3d": "2d", "2d": "3d"}[dim]
    mod = dim.upper()
    path = f"configs/{config}"
    over = overrides(config, trees, tmp_path / "out")
    tr = train_cli.main(["--cfg", path, "--device", "cpu", "--run_name",
                         "r", *over, "VAL.PERIOD", "1",
                         "SCHEDULER.MAX_EPOCH", "1"])
    assert tr.step == 1
    assert tr.modalities == [dim]
    train_meters = tr.train_metric_logger.meters
    assert np.isfinite(train_meters[f"seg_loss_{dim}"].global_avg)
    assert f"seg_iou_{dim}" in train_meters
    assert not {f"seg_loss_{other}", f"seg_iou_{other}", "xm_loss_2d",
                "xm_loss_3d"} & set(train_meters)
    assert ("voxel_overflow" in train_meters) == (dim == "3d")
    val = tr.val_metric_logger.meters
    assert val["collate_dropped"].global_avg == 0
    assert val["oob_points"].global_avg == 0
    assert f"seg_iou_{dim}" in val and f"seg_iou_{other}" not in val
    ckpt = tmp_path / "out" / "r" / "model000000.pth"
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    best = [k for k in payload if k.endswith(f"_best_{tr.cfg.VAL.METRIC}")]
    assert best == [f"{dim}_best_{tr.cfg.VAL.METRIC}"]

    res = test_cli.main(["--cfg", path, "--device", "cpu", "--ckpt",
                         "@/r/model000000.pth", *over])
    assert set(res["evaluators"]) == {mod}
    ev = res["evaluators"][mod]
    assert ev.confusion_matrix.sum() > 300
    assert res["meters"].meters["oob_points"].global_avg == 0
    tables = {p.name for p in (tmp_path / "out").glob("test_*.tsv")}
    assert tables == {f"test_{mod}.tsv"}
    # The checkpoint test.py scored: the trained model validated in this
    # process gives the same matrix.
    cfg = train_cli.load_cfg(path, over)
    again = dict(validate(cfg, StepRunner(
        cfg, tr.model, torch.device("cpu"),
        logging.getLogger("test")).run_eval_batch,
        build_dataloader(cfg, "test"), MetricLogger()))
    np.testing.assert_array_equal(again[mod].confusion_matrix,
                                  ev.confusion_matrix)


@pytest.mark.parametrize("config,labels", [
    ("semantic_kitti/lidar.yaml", {"labels", "labels_3d"}),
    ("semantic_kitti/imageBilinear.yaml", {"labels", "labels_2d"})])
def test_serve_selftest_of_a_unimodal_config(config, labels):
    """``tools/serve.py --selftest`` over HTTP (responses equal to the
    serial prediction, key for key), and the engine's label keys: the
    model's one stream and ``labels``, which is that stream's."""
    over = ["DATASET.SemanticKITTISCN.image_height", "40",
            "DATASET.SemanticKITTISCN.image_width", "120",
            "MODEL.VIT_IMG_SIZE", "32", "MODEL.VIT_EMBED_DIM", "64",
            "MODEL.VIT_DEPTH", "2", "MODEL.VIT_HEADS", "2",
            "MODEL.late_feat_block_number", "1",
            "TPU.POINT_CAPACITY", "1024", "TPU.CAPACITY_BUCKETS", "(1024,)"]
    report = serve.main(["--cfg", f"configs/{config}", "--device", "cpu",
                         "--selftest", "2", "--clients", "2", "--points",
                         "900", "--port", "0", *over])
    assert report["selftest_scans_ok"] == 4 and report["matches_serial"]
    assert report["stats"]["collate_dropped_points"] == 0
    cfg = train_cli.load_cfg(f"configs/{config}", over)
    got = InferenceEngine(cfg, device="cpu").predict(
        serve.selftest_records(cfg, 1, 900)[0])
    assert {k for k in got if k.startswith("labels")} == labels
    np.testing.assert_array_equal(got["labels"], got[max(labels)])
