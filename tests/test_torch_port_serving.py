"""The port's serving stack on the CPU: ``StepCache``, the step signature,
``InferenceServer``, the HTTP front end (its payloads read by the JAX
package's and the other way round), ``tools/serve.py --selftest``, and a
step that takes no host data after its first run (what a CUDA-graph capture
of it needs).  Tiny middle-fusion model (ViT depth 2, width 64), ~900-ray
scans; the graph path itself needs the card
(``tests/test_torch_port_cuda.py``)."""

import threading
import urllib.request

import numpy as np
import pytest
import torch

from fusiontransformer_tpu.serving.server import decode_npz as jax_decode
from fusiontransformer_tpu.serving.server import encode_record as jax_encode
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.modules.steps import (StepCache,
                                                       batch_signature,
                                                       device_batch)
from fusiontransformer_tpu_torch.serving import (InferenceEngine,
                                                 InferenceServer)
from fusiontransformer_tpu_torch.serving.server import (HTTPFrontend,
                                                        decode_npz,
                                                        encode_record)
from fusiontransformer_tpu_torch.utils.checkpoint import Checkpointer

from test_torch_port_common import record, refuse_host_data, tiny_cfg

KEYS = ("labels", "labels_2d", "labels_3d")


def _engine(batch_size=1, **cfg_kw):
    cfg = tiny_cfg(get_default_cfg, **cfg_kw)
    return InferenceEngine(cfg, model=build_model(cfg, device="cpu", seed=1),
                           batch_size=batch_size, device="cpu")


@pytest.fixture(scope="module")
def engine():
    return _engine()


# --------------------------------------------------------------------- #
def _evicts_lru(c):
    for k in "abc":
        c[k] = k.upper()
    assert len(c) == 3
    c["d"] = "D"
    assert c.get("a") is None and list(c) == ["b", "c", "d"]


def _get_refreshes(c):
    c["a"], c["b"] = 1, 2
    assert c.get("a") == 1
    c["c"] = 3
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3


def _set_refreshes(c):
    c["a"], c["b"] = 1, 2
    c["a"] = 10
    c["c"] = 3
    assert c.get("b") is None and c.get("a") == 10


def _never_evicts(c):
    for i in range(64):
        c[i] = i
    assert len(c) == 64


@pytest.mark.parametrize("maxsize,behaviour", [
    (3, _evicts_lru), (2, _get_refreshes), (2, _set_refreshes),
    (0, _never_evicts)], ids=["evicts least recently used",
                              "get refreshes recency",
                              "set refreshes recency",
                              "non-positive maxsize never evicts"])
def test_step_cache(maxsize, behaviour):
    """The four behaviours of ``tests/test_step_cache.py``."""
    behaviour(StepCache(maxsize))


def test_engine_cache_is_sized_by_the_config():
    eng = _engine()
    assert eng.graphs.maxsize == eng.cfg.TPU.STEP_CACHE_SIZE == 16


def _s(batch):
    return [batch[k].shape[1] for k in sorted(batch)
            if k.startswith("gslot_src_")]


def test_signature_keys_bucket_batch_and_pool_size(engine):
    """One key for two batches in a bucket with equal S; another for a new
    S rung, another bucket, another batch size."""
    batches = [engine.collate([engine.preprocess(record(i))])
               for i in range(6)]
    same = [(a, b) for i, a in enumerate(batches) for b in batches[i + 1:]
            if _s(a) == _s(b)]
    assert same, [_s(b) for b in batches]
    a, b = same[0]
    assert not np.array_equal(a["coords"], b["coords"])
    assert batch_signature(a) == batch_signature(b)

    dense = engine.collate([engine._dummy_sample(1024)])
    assert _s(dense) != _s(a)
    assert batch_signature(dense) != batch_signature(a)

    bucketed = _engine(buckets=(512, 1024))
    small = bucketed.collate([bucketed.preprocess(record(3, n_points=420))])
    big = bucketed.collate([bucketed.preprocess(record(3))])
    assert len(small["pt_valid"]) == 512 and len(big["pt_valid"]) == 1024
    assert batch_signature(small) != batch_signature(big)
    pair = _engine(batch_size=2).collate([engine.preprocess(record(0))])
    assert batch_signature(pair) != batch_signature(batches[0])
    names = [k for k, _, _ in batch_signature(a)]
    assert names == sorted(device_batch(a, "cpu"))


def test_cpu_engine_runs_eagerly(engine):
    handle = engine.dispatch_samples([engine.preprocess(record(1))])
    assert isinstance(handle[2], torch.Tensor)
    engine.complete(handle, count_stats=False)
    assert len(engine.graphs) == 0 and engine.stats()["captures"] == 0


def test_engine_loads_a_checkpoint(engine, tmp_path):
    path = Checkpointer(save_dir=str(tmp_path)).save(
        "model", model=engine.model.state_dict())
    loaded = InferenceEngine(engine.cfg, device="cpu", seed=5,
                             checkpoint_path=path)
    rec = record(2)
    for key in KEYS:
        np.testing.assert_array_equal(loaded.predict(rec)[key],
                                      engine.predict(rec)[key])
    with pytest.raises(ValueError, match="not both"):
        InferenceEngine(engine.cfg, model=engine.model, device="cpu",
                        checkpoint_path=path)


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("slot_pool", [True, False],
                         ids=["group-pooled", "per-voxel"])
def test_the_step_takes_no_host_data_after_its_first_run(monkeypatch,
                                                         slot_pool):
    """A capture records the step's second run: its constant tables must
    already be on the device by then (``utils.device.device_constant``)."""
    eng = _engine()
    if not slot_pool:
        cfg = eng.cfg.clone()
        cfg.TPU.CONV_SLOT_POOL = False
        cfg.freeze()
        eng = InferenceEngine(cfg, model=eng.model, device="cpu")
    db = device_batch(eng.collate([eng.preprocess(record(4))]), "cpu")
    first = eng._step(db)
    refuse_host_data(monkeypatch)
    assert torch.equal(eng._step(db), first)


# --------------------------------------------------------------------- #
def test_server_concurrent_matches_serial_and_batching_changes_nothing():
    """Six requests from six threads through a batch-2 server: each equals
    the batch-1 engine's serial prediction, and the server counts them."""
    solo = _engine()
    pair = InferenceEngine(solo.cfg, model=solo.model, batch_size=2,
                           device="cpu")
    recs = [record(10 + i) for i in range(6)]
    serial = [solo.predict(r) for r in recs]
    for s, b in zip(serial[:2], pair.predict_batch(recs[:2])):
        for key in KEYS:
            np.testing.assert_array_equal(s[key], b[key])

    server = InferenceServer(pair, preproc_workers=2, batch_wait_ms=5.0)
    try:
        futs = [None] * len(recs)

        def submit(i):
            futs[i] = server.submit(recs[i])

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(recs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for fut, want in zip(futs, serial):
            got = fut.result(timeout=300)
            for key in KEYS:
                np.testing.assert_array_equal(got[key], want[key])
        stats = server.stats()
        assert stats["requests_completed"] == len(recs)
        assert stats["scans"] == len(recs) + 2
        assert stats["latency_ms"]["p50"] > 0
    finally:
        server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(recs[0])


def test_payloads_cross_between_the_packages():
    rec = record(21)
    for enc, dec in ((encode_record, jax_decode), (jax_encode, decode_npz)):
        back = dec(enc(rec))
        assert sorted(back) == sorted(rec)
        for k in rec:
            np.testing.assert_array_equal(back[k], rec[k])
            assert back[k].dtype == np.asarray(rec[k]).dtype


def test_http_roundtrip(engine):
    rec = record(20)
    want = engine.predict(rec)
    server = InferenceServer(engine)
    frontend = HTTPFrontend(server, port=0).start()
    url = f"http://127.0.0.1:{frontend.port}"
    try:
        req = urllib.request.Request(url + "/predict", data=jax_encode(rec),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            out = jax_decode(resp.read())
        for key in (*KEYS, "in_frustum"):
            np.testing.assert_array_equal(out[key], want[key])
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            assert resp.read() == b"ok"
        with urllib.request.urlopen(url + "/stats", timeout=60) as resp:
            assert b'"requests_completed": 1' in resp.read()
        bad = urllib.request.Request(url + "/predict", data=b"not an npz",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=60)
        assert err.value.code == 400
    finally:
        frontend.close()
        server.close()


def test_serve_tool_selftest_on_the_cpu(capsys):
    from fusiontransformer_tpu_torch.tools import serve

    report = serve.main([
        "--cfg", "configs/semantic_kitti/synthetic.yaml", "--device", "cpu",
        "--selftest", "2", "--clients", "2", "--points", "900", "--port", "0",
        "MODEL.VIT_IMG_SIZE", "32", "MODEL.VIT_EMBED_DIM", "64",
        "MODEL.VIT_DEPTH", "2", "MODEL.VIT_HEADS", "2",
        "MODEL.middle_feat_block_number", "0",
        "MODEL.late_feat_block_number", "1",
        "DATASET.SyntheticSCN.image_height", "40",
        "DATASET.SyntheticSCN.image_width", "60",
        "TPU.POINT_CAPACITY", "1024"])
    assert report["selftest_scans_ok"] == 4 and report["matches_serial"]
    assert [p["captures"] for p in report["passes"]] == [0, 0]
    assert report["stats"]["requests_completed"] == 4
    assert report["stats"]["collate_dropped_points"] == 0
    assert report["stats"]["voxel_overflow"] == 0
    assert report["device"] == "cpu" and sorted(report["warmup_s"]) == [1024]
    assert '"selftest_scans_ok": 4' in capsys.readouterr().out
