"""Ahead-of-time serving of the port (``serving/export.py``) on the CPU.

One artifact of the tiny middle-fusion config (f32, buckets 512 and 1024)
is exported once for the module and served by one engine; the live engine
it is held against runs the per-voxel path (``TPU.CONV_SLOT_POOL False``),
which is the path a program runs, so their labels agree bit for bit.
Against the JAX engine on the same weights >= 99.9% of points agree, as
the live engine's do (``test_torch_port_engine.py``).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from fusiontransformer_tpu.config.defaults import get_default_cfg as j_cfg
from fusiontransformer_tpu.serving import InferenceEngine as JEngine
from fusiontransformer_tpu_torch.config.defaults import (get_default_cfg as
                                                         t_cfg)
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
from fusiontransformer_tpu_torch.serving.export import (MANIFEST,
                                                        ExportedPredict,
                                                        example_batch,
                                                        export_predict)
from fusiontransformer_tpu_torch.utils.convert_jax import load_jax_variables

from test_torch_port_common import one_thread  # noqa: F401
from test_torch_port_common import jax_variables, record, tiny_cfg

KEYS = ("labels", "labels_2d", "labels_3d")
BUCKETS = (512, 1024)
# The manifest of the JAX package's export_predict, jax_version in torch's
# place, and the compute dtype beside it.
JAX_MANIFEST = {"model_type", "num_classes", "batch_size", "buckets",
                "image_height", "image_width", "platforms", "jax_version",
                "pred_keys", "artifacts"}


def per_voxel(cfg):
    cfg = cfg.clone()
    cfg.TPU.CONV_SLOT_POOL = False
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def weights():
    return jax_variables(tiny_cfg(j_cfg, buckets=BUCKETS))


@pytest.fixture(scope="module")
def artifact(weights, tmp_path_factory):
    """(cfg, export dir, manifest, exported engine, its model's first
    state): exported from a model of other weights than the engine
    serves, which must not matter."""
    cfg = tiny_cfg(t_cfg, buckets=BUCKETS)
    out = str(tmp_path_factory.mktemp("export"))
    manifest = export_predict(cfg, build_model(cfg, "cpu", seed=7), out,
                              device="cpu")
    model = load_jax_variables(build_model(cfg, "cpu"), *weights)
    engine = InferenceEngine(cfg, model=model, device="cpu",
                             exported_dir=out)
    return cfg, out, manifest, engine


def _live(cfg, state):
    cfg = per_voxel(cfg)
    model = build_model(cfg, "cpu")
    model.load_state_dict(state)
    return InferenceEngine(cfg, model=model, device="cpu")


def test_exported_engine_equals_the_live_per_voxel_engine(artifact):
    cfg, _, _, engine = artifact
    assert engine._slot_pool is None and engine.buckets == BUCKETS
    live = _live(cfg, engine.model.state_dict())
    for rec, bucket in ((record(3, n_points=420), 512), (record(4), 1024)):
        got, want = engine.predict(rec), live.predict(rec)
        assert set(got) == set(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert engine.stats()["bucket_hits"][bucket] >= 1
    assert engine.stats()["voxel_overflow"] == 0


def test_exported_engine_agrees_with_jax(artifact, weights):
    cfg, _, _, engine = artifact
    jax_engine = JEngine(tiny_cfg(j_cfg), params=weights[0],
                         batch_stats=weights[1])
    for rec in (record(0), record(1, n_points=420)):
        want, got = jax_engine.predict(rec), engine.predict(rec)
        np.testing.assert_array_equal(got["in_frustum"], want["in_frustum"])
        for key in KEYS:
            agree = np.mean(got[key] == want[key])
            assert agree >= 0.999, (key, agree)


def test_one_artifact_serves_any_weights(artifact):
    """JAX's ``test_exported_artifact_is_weight_agnostic``: the program
    follows the engine's weights; the live engine under each set agrees."""
    cfg, _, _, engine = artifact
    rec = record(2)
    first = {k: v.clone() for k, v in engine.model.state_dict().items()}
    other = build_model(cfg, "cpu", seed=11).state_dict()
    got = []
    try:
        for state in (first, other):
            engine.model.load_state_dict(state)
            out = engine.predict(rec)
            want = _live(cfg, state).predict(rec)
            for key in KEYS:
                np.testing.assert_array_equal(out[key], want[key])
            got.append(out["labels"])
    finally:
        engine.model.load_state_dict(first)
    assert not np.array_equal(*got)


def test_artifacts_hold_no_weights(artifact):
    cfg, out, manifest, engine = artifact
    state_bytes = sum(t.numel() * t.element_size()
                      for t in engine.model.state_dict().values())
    for cap in BUCKETS:
        size = os.path.getsize(os.path.join(out, f"predict_{cap}.pt2"))
        assert size == manifest["stats"][cap]["bytes"]
        assert size < 0.01 * state_bytes, (cap, size, state_bytes)


def test_the_programs_reach_the_kernels_through_the_ftx_ops(artifact):
    """K1' at every slot-mapped conv and K3 at L4 and L2, as custom ops
    (on the card their CUDA kernels launch); no group-pooled op."""
    _, _, _, engine = artifact
    for cap in BUCKETS:
        targets = [str(n.target) for n in
                   engine.exported._fns[cap].graph.nodes
                   if n.op == "call_function"]
        ftx = {t for t in targets if t.startswith("ftx.")}
        assert ftx == {"ftx.binned_conv_slots_fwd.default",
                       "ftx.sorted_segment_weighted_sum.default"}, ftx
        assert targets.count("ftx.sorted_segment_weighted_sum.default") == 2


def test_manifest_has_the_jax_fields(artifact):
    cfg, out, manifest, _ = artifact
    with open(os.path.join(out, MANIFEST)) as f:
        saved = json.load(f)
    assert set(saved) == (JAX_MANIFEST - {"jax_version"}) | {
        "torch_version", "compute_dtype"}
    assert saved["platforms"] == ["cpu"]
    assert saved["torch_version"] == torch.__version__
    assert saved["buckets"] == list(BUCKETS)
    assert saved["pred_keys"] == ["pred", "pred_2d", "pred_3d",
                                  "voxel_overflow"]
    assert saved["artifacts"] == {str(b): f"predict_{b}.pt2"
                                  for b in BUCKETS}
    assert (saved["image_height"], saved["image_width"]) == (40, 60)
    assert saved["compute_dtype"] == "float32"


def test_a_missing_bucket_or_device_type_raises(artifact, tmp_path):
    cfg, out, _, engine = artifact
    state = dict(engine.model.state_dict())
    batch = example_batch(cfg, 2048, 1, 40, 60, "cpu")
    with pytest.raises(KeyError, match="no exported program for bucket "
                       "2048"):
        engine.exported(state, batch)
    other = tmp_path / "cuda"
    other.mkdir()
    with open(os.path.join(out, MANIFEST)) as f:
        manifest = json.load(f)
    manifest["platforms"] = ["cuda"]
    (other / MANIFEST).write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="exported for"):
        ExportedPredict(str(other), "cpu")
    with pytest.raises(ValueError, match="exported at batch 1"):
        InferenceEngine(cfg, model=engine.model, device="cpu", batch_size=2,
                        exported_dir=out)
    shutil.rmtree(other)


def test_export_and_serve_tools_on_the_cpu(tmp_path, capsys):
    from fusiontransformer_tpu_torch.tools import export_model, serve

    tiny = ["MODEL.VIT_IMG_SIZE", "32", "MODEL.VIT_EMBED_DIM", "64",
            "MODEL.VIT_DEPTH", "2", "MODEL.VIT_HEADS", "2",
            "MODEL.middle_feat_block_number", "0",
            "MODEL.late_feat_block_number", "1",
            "DATASET.SyntheticSCN.image_height", "40",
            "DATASET.SyntheticSCN.image_width", "60",
            "TPU.POINT_CAPACITY", "1024"]
    cfg_file = "configs/semantic_kitti/synthetic.yaml"
    out = str(tmp_path / "artifact")
    manifest = export_model.main(["--cfg", cfg_file, "--out", out,
                                  "--device", "cpu", *tiny])
    assert manifest["buckets"] == [1024] and manifest["platforms"] == ["cpu"]
    assert "random weights" in capsys.readouterr().err
    report = serve.main([
        "--cfg", cfg_file, "--device", "cpu", "--exported-dir", out,
        "--selftest", "2", "--points", "900", "--port", "0", *tiny])
    assert report["selftest_scans_ok"] == 4 and report["matches_serial"]
    assert report["stats"]["voxel_overflow"] == 0
    assert sorted(report["warmup_s"]) == [1024]
