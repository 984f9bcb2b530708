"""The loader's worker pool (``DATALOADER.NUM_WORKERS > 0``) and
``SyntheticSCN.point_count_jitter``, on the CPU, against the port's thread
loader and the JAX package's loader and dataset: batches bitwise equal
(shuffling, augmentation, slot maps) over two epochs at 0 and 2 workers and
against JAX, every batch seeded from (seed, epoch, ordinal) whoever makes
it, a worker's error raised in the consumer, no CUDA in a worker, one pool
for every epoch, the native host library built before the pool starts, and
a trainer with workers training as one without them."""

from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.data.build import build_dataloader as j_loader
from fusiontransformer_tpu.data.synthetic import SyntheticSCN as JSynthetic
from fusiontransformer_tpu_torch import native
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data import build as data_build
from fusiontransformer_tpu_torch.data.build import build_dataloader
from fusiontransformer_tpu_torch.data.loader import (DataLoader, _share,
                                                     _unshare, batch_seed)
from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN

from test_torch_port_common import (H, W, CudaProbe, Draws,  # noqa: F401
                                    broken_collate, one_thread, train_cfg)

AUG = dict(noisy_rot=0.1, flip_y=0.5, rot_z=6.2831, transl=True)


def loader_cfg(get_cfg, workers=0, jitter=0.0):
    cfg = train_cfg(get_cfg)
    cfg.defrost()
    cfg.DATASET.SyntheticSCN.num_scans = 6
    cfg.DATASET.SyntheticSCN.point_count_jitter = jitter
    for k, v in AUG.items():
        cfg.DATASET.SyntheticSCN.augmentation[k] = v
    cfg.DATALOADER.NUM_WORKERS = workers
    # One device: the JAX package builds host slot maps only there (the
    # test session's JAX has eight CPU devices).
    cfg.TPU.NUM_DEVICES = 1
    cfg.freeze()
    return cfg


def assert_batches_equal(a, b, keys=None):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in keys or x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_worker_batches_equal_the_thread_loaders_and_jax(jitter):
    loaders = {n: build_dataloader(loader_cfg(get_default_cfg, n, jitter))
               for n in (0, 2)}
    jload = j_loader(loader_cfg(jcfg, 0, jitter))
    try:
        assert loaders[2].num_workers == 2 and loaders[2].prefetch == 2
        for epoch in (0, 1):
            got = {}
            for n, load in loaders.items():
                load.set_epoch(epoch)
                got[n] = list(load)
            jload.set_epoch(epoch)
            want = list(jload)
            assert_batches_equal(got[0], got[2])
            keys = [k for k in want[0] if k in got[0][0]
                    and isinstance(want[0][k], np.ndarray)]
            assert {"coords", "feats", "img", "gslot_src_0", "level_counts"} \
                <= set(keys)
            assert_batches_equal(got[0], want, keys)
        assert loaders[2]._pool is not None
    finally:
        loaders[2].close()
    assert loaders[2]._pool is None


def test_jittered_items_equal_jax_and_vary_in_size():
    kw = dict(split=("train",), num_scans=4, num_points=900, image_height=H,
              image_width=W, point_count_jitter=0.3, **AUG)
    jds = JSynthetic(output_orig=True, **kw)
    tds = SyntheticSCN(**kw)
    sizes = set()
    for i in range(4):
        a, b = jds[i], tds[i]
        for k in ("coords", "feats", "seg_label", "img_indices", "img",
                  "inverse_map", "orig_seg_label"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        sizes.add(len(b["orig_seg_label"]))
    assert len(sizes) > 1 and max(sizes) <= 900


def test_workers_seed_each_batch_from_seed_epoch_and_ordinal():
    threads = DataLoader(Draws(), 3, list, shuffle=True, seed=5)
    workers = DataLoader(Draws(), 3, list, shuffle=True, seed=5,
                         num_workers=2)
    try:
        for epoch in (0, 2):
            threads.set_epoch(epoch)
            workers.set_epoch(epoch)
            got = list(workers)
            assert got == list(threads)
            assert [[i for i, _ in b] for b in got] == \
                [list(b) for b in workers._index_batches()]
            for ordinal, b in enumerate(got):
                rs = np.random.RandomState(batch_seed(5, epoch, ordinal))
                assert [d for _, d in b] == [int(rs.randint(1 << 30))
                                             for _ in b]
        pool = workers._pool
        list(workers)
        assert workers._pool is pool            # one pool for every epoch
    finally:
        workers.close()


def test_a_batch_crosses_in_one_shared_block_that_is_then_unlinked():
    rs = np.random.RandomState(0)
    batch = {"coords": rs.randint(0, 9, (7, 3)).astype(np.int32),
             "img": rs.rand(2, 3, 5, 3).astype(np.float32),
             "pt_valid": rs.rand(7) > 0.5, "empty": np.zeros((0, 4)),
             "num_dropped": 3, "inverse_map": [np.arange(4)]}
    name, layout, rest = shared = _share(batch)
    assert set(layout) == {"coords", "img", "pt_valid", "empty"}
    assert set(rest) == {"num_dropped", "inverse_map"}
    assert all(offset % 64 == 0 for _, _, offset in layout.values())
    got = _unshare(shared)
    assert got.keys() == batch.keys() and got["num_dropped"] == 3
    for k in layout:
        assert got[k].dtype == batch[k].dtype
        np.testing.assert_array_equal(got[k], batch[k])
    np.testing.assert_array_equal(got["inverse_map"][0], np.arange(4))
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)
    assert _unshare(_share([1, 2])) == [1, 2]   # not a dict: passed whole


def test_a_worker_error_reaches_the_consumer():
    load = DataLoader(Draws(), 3, broken_collate, num_workers=2)
    try:
        with pytest.raises(ValueError, match="bad scan"):
            list(load)
    finally:
        load.close()


def test_workers_never_initialise_cuda():
    load = DataLoader(CudaProbe(), 2, list, num_workers=2)
    try:
        assert [x for b in load for x in b] == [False] * 4
    finally:
        load.close()


def test_the_native_library_is_built_before_the_pool(monkeypatch):
    calls = []
    monkeypatch.setattr(native, "get_lib", lambda: calls.append(1))
    build_dataloader(loader_cfg(get_default_cfg, 0))
    assert calls == []
    load = build_dataloader(loader_cfg(get_default_cfg, 2))
    assert calls == [1] and load._pool is None
    assert data_build.native is native


def test_a_trainer_with_workers_trains_as_one_without(tmp_path):
    from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
        SemanticTrainer)
    from test_torch_port_trainer import trainer_cfg

    ends = []
    for workers in (0, 2):
        cfg = trainer_cfg(tmp_path / str(workers),
                          **{"DATALOADER.NUM_WORKERS": workers})
        tr = SemanticTrainer(cfg, "", device="cpu")
        tr.train()
        assert tr.train_dataloader._pool is None      # closed by train()
        assert tr.val_dataloader._pool is None
        ends.append({k: v.clone() for k, v in tr.model.state_dict().items()})
    for k in ends[0]:
        assert torch.equal(ends[0][k], ends[1][k]), k
