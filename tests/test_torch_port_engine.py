"""The port's InferenceEngine against the JAX package's, and its own
request-level behaviour (on the CPU, where the kernels' plain versions run).

Both engines get the same tiny middle-fusion config (f32), the same JAX
weights (carried across by ``load_jax_variables``, with random running
statistics) and the same raw records.  Labels may differ only where two
classes tie to f32 rounding: >= 99.9% of points must agree.
"""

import numpy as np
import pytest

from fusiontransformer_tpu.config.defaults import get_default_cfg as j_cfg
from fusiontransformer_tpu.serving import InferenceEngine as JEngine
from fusiontransformer_tpu_torch.config.defaults import (get_default_cfg as
                                                         t_cfg)
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
from fusiontransformer_tpu_torch.utils.convert_jax import load_jax_variables

from test_torch_port_common import jax_variables, record, tiny_cfg

KEYS = ("labels", "labels_2d", "labels_3d")


@pytest.fixture(scope="module")
def weights():
    return jax_variables(tiny_cfg(j_cfg))


def _port_engine(weights, **cfg_kw):
    cfg = tiny_cfg(t_cfg, **cfg_kw)
    model = load_jax_variables(build_model(cfg, device="cpu"), *weights)
    return InferenceEngine(cfg, model=model, device="cpu")


def test_engine_labels_match_jax(weights):
    params, stats = weights
    jax_engine = JEngine(tiny_cfg(j_cfg), params=params, batch_stats=stats)
    port = _port_engine(weights)
    recs = [record(i) for i in range(3)]
    for rec in recs:
        want, got = jax_engine.predict(rec), port.predict(rec)
        np.testing.assert_array_equal(got["in_frustum"], want["in_frustum"])
        assert got["num_voxels"] == want["num_voxels"]
        for key in KEYS:
            assert got[key].shape == want[key].shape
            agree = np.mean(got[key] == want[key])
            assert agree >= 0.999, (key, agree)
    for eng in (jax_engine, port):
        st = eng.stats()
        assert st["voxel_overflow"] == 0 and st["scans"] == len(recs)
        assert st["collate_dropped_points"] == 0


def test_engine_requests_are_deterministic_and_complete(weights):
    port = _port_engine(weights)
    rec = record(5)
    out1, out2 = port.predict(rec), port.predict(rec)
    n = len(rec["points"])
    for key in KEYS:
        assert out1[key].shape == (n,)
        assert out1[key].min() >= 0 and out1[key].max() < 20
        np.testing.assert_array_equal(out1[key], out2[key])
    np.testing.assert_array_equal(out1["labels"][~out1["in_frustum"]], 0)
    st = port.stats()
    assert st["scans"] == 2 and st["batches"] == 2
    assert st["voxel_overflow"] == 0 and st["oob_points"] == 0


def test_engine_bucket_routing_and_warmup_are_lossless(weights):
    fixed = _port_engine(weights)
    bucketed = _port_engine(weights, buckets=(512, 1024))
    times = bucketed.warmup()
    assert sorted(times) == [512, 1024]
    assert bucketed.stats()["scans"] == 0      # warmup is not traffic
    small, big = record(3, n_points=420), record(4)
    for rec, bucket in ((small, 512), (big, 1024)):
        np.testing.assert_array_equal(fixed.predict(rec)["labels"],
                                      bucketed.predict(rec)["labels"])
        assert bucketed.stats()["bucket_hits"][bucket] == 1


def test_engine_batching_does_not_change_predictions(weights):
    cfg = tiny_cfg(t_cfg)
    model = load_jax_variables(build_model(cfg, device="cpu"), *weights)
    solo = InferenceEngine(cfg, model=model, device="cpu")
    pair = InferenceEngine(cfg, model=model, batch_size=2, device="cpu")
    recs = [record(1), record(2)]
    for s, b in zip([solo.predict(r) for r in recs],
                    pair.predict_batch(recs)):
        for key in KEYS:
            np.testing.assert_array_equal(s[key], b[key])
