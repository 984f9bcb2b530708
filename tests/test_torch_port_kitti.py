"""The port's SemanticKITTI path against the JAX package's, on the CPU: the
label maps, the offline preprocessor, the dataset's items with and without
their augmentations, and the loaders' batches, on raw trees fabricated in
the real on-disk formats (``tests/test_kitti_pipeline.py::_make_raw_kitti``:
velodyne ``.bin``, ``.label``, ``image_2/*.png``, ``calib.txt``).  The
build's dataset types and its whole config subtree (``SyntheticSCN`` at
``scale`` 10) are held against JAX's build too.

Everything here is compared bit for bit: the same numpy code runs in both
packages, with the same draws from numpy's global generator in the same
order, and Pillow reads, crops and pads the images in both.
"""

import os.path as osp
import pickle

import numpy as np
import pytest

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.data.build import build_dataloader as j_loader
from fusiontransformer_tpu.data.semantic_kitti import labels as JL
from fusiontransformer_tpu.data.semantic_kitti import preprocess as JP
from fusiontransformer_tpu.data.semantic_kitti.semantic_kitti_dataloader \
    import SemanticKITTISCN as JKitti
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data import build as data_build
from fusiontransformer_tpu_torch.data.build import build_dataloader
from fusiontransformer_tpu_torch.data.loader import batch_seed
from fusiontransformer_tpu_torch.data.semantic_kitti import labels as TL
from fusiontransformer_tpu_torch.data.semantic_kitti import preprocess as TP
from fusiontransformer_tpu_torch.data.semantic_kitti.semantic_kitti_dataloader \
    import SemanticKITTISCN as TKitti

from test_torch_port_common import one_thread  # noqa: F401
from tests.test_kitti_pipeline import H, W, _make_raw_kitti

AUGMENTED = dict(bottom_crop=(200, 64), fliplr=1.0,
                 color_jitter=(0.4, 0.4, 0.4), noisy_rot=0.1, flip_y=0.5,
                 rot_z=6.2831, transl=True)
NORMALIZER = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """A raw tree in the debug splits' sequences (train 07, val 01, test
    08), preprocessed by the JAX package: (raw root, preprocessed dir)."""
    tmp = tmp_path_factory.mktemp("kitti")
    root, out = str(tmp / "raw"), str(tmp / "pre")
    rng = np.random.RandomState(0)
    for seq, n in (("07", 4), ("01", 3), ("08", 2)):
        _make_raw_kitti(root, seq=seq, n_frames=n, n_pts=500, rng=rng)
    for split in ("train", "val", "test"):
        JP.preprocess(split, root, out, W, H, num_workers=2, debug=True)
    return root, out


def assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_label_maps_match_jax_over_every_raw_id():
    ids = np.arange(max(JL.LEARNING_MAP) + 1)
    got = TL.make_label_mapper()(ids)
    np.testing.assert_array_equal(got, JL.make_label_mapper()(ids))
    assert got.dtype == np.int64
    train_ids = np.arange(TL.NUM_CLASSES)
    np.testing.assert_array_equal(TL.make_inverse_label_mapper()(train_ids),
                                  JL.make_inverse_label_mapper()(train_ids))
    assert TL.class_names() == JL.class_names()
    assert TL.class_labels() == JL.class_labels()
    # Every raw id maps to its train id and back to a raw id of that class.
    back = TL.make_inverse_label_mapper()(got[list(TL.LEARNING_MAP)])
    assert set(back) <= set(TL.LEARNING_MAP)


def test_preprocess_writes_the_pickles_of_jax(kitti, tmp_path):
    root, jout = kitti
    tout = str(tmp_path / "pre")
    for split in ("train", "val", "test"):
        TP.preprocess(split, root, tout, W, H, num_workers=2, debug=True)
    n = 0
    for seq in ("07", "01", "08"):
        names = sorted(p for p in (tmp_path / "pre" / seq).iterdir())
        assert [p.name for p in names] == sorted(
            f"{i}.pkl" for i in range(len(names)))
        for p in names:
            with open(p, "rb") as f:
                got = pickle.load(f)
            with open(osp.join(jout, seq, p.name), "rb") as f:
                want = pickle.load(f)
            assert_items_equal(got, want)
            assert got["camera_path"] == f"dataset/sequences/{seq}/image_2/" \
                f"{int(p.stem):06d}.png"
            n += 1
    assert n == 9


def test_cli_finds_the_smallest_image_and_writes_every_split(kitti, tmp_path):
    root, jout = kitti
    TP.main(["--root", root, "--out", str(tmp_path / "cli"), "--workers",
             "1", "--splits", "test"])
    assert TP.calculate_min_img_shape(root) == (W, H)
    with open(tmp_path / "cli" / "08" / "0.pkl", "rb") as f:
        got = pickle.load(f)
    with open(osp.join(jout, "08", "0.pkl"), "rb") as f:
        assert_items_equal(got, pickle.load(f))


@pytest.mark.parametrize("case", ["plain", "augmented", "normalized"])
def test_items_match_jax_under_one_seed(kitti, case):
    root, out = kitti
    kw = dict(split=("train",), preprocess_dir=out, semantic_kitti_dir=root,
              image_width=W, image_height=H, debug=True, output_orig=True)
    if case == "augmented":
        kw.update(AUGMENTED)
    if case == "normalized":
        kw.update(image_normalizer=NORMALIZER, fliplr=0.5)
    jds, tds = JKitti(**kw), TKitti(**kw)
    assert len(tds) == len(jds) == 4
    for i in range(len(tds)):
        np.random.seed(100 + i)
        want, want_next = jds[i], np.random.rand()
        np.random.seed(100 + i)
        got, got_next = tds[i], np.random.rand()
        assert_items_equal(got, want)
        assert got_next == want_next          # the same draws were taken
        if case == "augmented":
            assert got["img"].shape == (64, 200, 3)


def test_an_image_narrower_than_the_crop_is_padded_with_zeros(kitti):
    root, out = kitti
    kw = dict(split=("val",), preprocess_dir=out, semantic_kitti_dir=root,
              image_width=W + 40, image_height=H + 8, debug=True)
    got, want = TKitti(**kw)[0], JKitti(**kw)[0]
    assert_items_equal(got, want)
    assert got["img"].shape == (H + 8, W + 40, 3)
    assert not got["img"][H:].any() and not got["img"][:, W:].any()
    assert got["img"][:H, :W].any()


def kitti_cfg(get_cfg, root, out, **over):
    cfg = get_cfg()
    cfg.MODEL.TYPE = "MiddleFusionTransformer"
    cfg.MODEL.USE_LIDAR = cfg.MODEL.USE_IMAGE = cfg.MODEL.USE_FUSION = True
    cfg.DATASET.TYPE = "SemanticKITTISCN"
    cfg.DATASET.TRAIN, cfg.DATASET.VAL = ("train",), ("val",)
    cfg.DATASET.TEST = ("test",)
    ds = cfg.DATASET.SemanticKITTISCN
    ds.preprocess_dir, ds.semantic_kitti_dir = out, root
    ds.image_width, ds.image_height = W, H
    ds.debug = True
    cfg.TRAIN.BATCH_SIZE = cfg.VAL.BATCH_SIZE = 2
    cfg.TPU.POINT_CAPACITY = 512
    cfg.TPU.CAPACITY_BUCKETS = (384, 512)
    # One device: the JAX package builds host slot maps only there (the
    # tests' JAX has eight CPU devices).
    cfg.TPU.NUM_DEVICES = 1
    for k, v in over.items():
        cfg.merge_from_list([k, v])
    cfg.freeze()
    return cfg


def jax_worker_batches(loader, epoch=0):
    """The JAX loader's batches as its worker pool makes them: numpy's
    global generator seeded per batch from (seed + epoch, ordinal)."""
    loader.set_epoch(epoch)
    out = []
    for ordinal, idx in enumerate(loader._index_batches()):
        np.random.seed(batch_seed(loader.seed, epoch, ordinal))
        out.append(loader._produce(idx))
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        keys = [k for k in b if isinstance(b[k], np.ndarray)]
        assert {"coords", "img", "gslot_src_0", "level_counts"} <= set(keys)
        for k in keys:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("orig_seg_label", "sparse_orig_points_idx", "inverse_map",
                  "seq", "filename"):
            if k in b:
                assert len(a[k]) == len(b[k])
                for x, y in zip(a[k], b[k]):
                    np.testing.assert_array_equal(x, y, err_msg=k)
        assert a["num_dropped"] == b["num_dropped"]


@pytest.mark.parametrize("augmented", [False, True])
def test_train_batches_match_jax(kitti, augmented):
    root, out = kitti
    over = {}
    if augmented:
        aug = "DATASET.SemanticKITTISCN.augmentation."
        over = {aug + k: v for k, v in AUGMENTED.items()}
    tload = build_dataloader(kitti_cfg(get_default_cfg, root, out, **over))
    jload = j_loader(kitti_cfg(jcfg, root, out, **over))
    for epoch in (0, 1):
        tload.set_epoch(epoch)
        got = list(tload)
        assert_batches_equal(got, jax_worker_batches(jload, epoch))
    assert not tload.dataset.output_orig
    want_hw = (64, 200) if augmented else (H, W)
    assert got[0]["img"].shape[1:3] == want_hw


@pytest.mark.parametrize("workers", [0, 2])
def test_val_batches_match_jax_and_carry_the_original_points(kitti, workers):
    """The original points' ragged fields cross the worker pool pickled
    (only top-level arrays go through its shared memory) and arrive
    intact."""
    root, out = kitti
    cfg = kitti_cfg(get_default_cfg, root, out,
                    **{"DATALOADER.NUM_WORKERS": workers})
    tload = build_dataloader(cfg, "val")
    try:
        got = list(tload)
    finally:
        tload.close()
    want = list(j_loader(kitti_cfg(jcfg, root, out), "val"))
    assert_batches_equal(got, want)
    assert sum(len(b["inverse_map"]) for b in got) == 3
    assert all(isinstance(m, np.ndarray) and m.dtype == np.int64
               for b in got for m in b["inverse_map"])


def synthetic_cfg(get_cfg, scale):
    cfg = get_cfg()
    cfg.DATASET.TYPE = "SyntheticSCN"
    cfg.DATASET.VAL = ("val",)
    ds = cfg.DATASET.SyntheticSCN
    ds.num_scans, ds.num_points = 2, 2048
    ds.scale = scale
    cfg.TPU.POINT_CAPACITY = 2048
    cfg.TPU.CAPACITY_BUCKETS = ()
    cfg.TPU.CONV_SLOT_POOL = False
    cfg.VAL.BATCH_SIZE = 1
    cfg.freeze()
    return cfg


def test_synthetic_scale_reaches_the_dataset_as_in_jax():
    """The build passes the dataset's whole config subtree: at scale 10
    the voxel coordinates are those of JAX's, half those at scale 20."""
    got = list(build_dataloader(synthetic_cfg(get_default_cfg, 10), "val"))
    want = list(j_loader(synthetic_cfg(jcfg, 10), "val"))
    for a, b in zip(got, want):
        for k in ("coords", "feats", "seg_label", "pt_valid", "img"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    at20 = next(iter(build_dataloader(synthetic_cfg(get_default_cfg, 20),
                                      "val")))
    assert at20["coords"].max() > 1.8 * got[0]["coords"].max()


@pytest.mark.parametrize("kind", sorted(data_build.DATASETS) + ["Nope"])
def test_the_build_knows_the_types_jax_knows(kitti, tmp_path, kind):
    from tests.test_nuscenes_pipeline import _fake_pickle

    root, out = kitti
    for split in ("train", "val"):
        pre, nus = _fake_pickle(tmp_path, np.random.RandomState(0),
                                n_scans=2, split=split)
    cfg = kitti_cfg(get_default_cfg, root, out)
    cfg.defrost()
    cfg.DATASET.TYPE = kind
    cfg.DATASET.NuScenesSCN.preprocess_dir = pre
    cfg.DATASET.NuScenesSCN.nuscenes_dir = nus
    cfg.DATASET.DebugSemanticKITTISCN.preprocess_dir = out
    cfg.DATASET.DebugSemanticKITTISCN.semantic_kitti_dir = root
    cfg.freeze()
    if kind == "Nope":
        with pytest.raises(ValueError, match="Unsupported dataset type"):
            build_dataloader(cfg, "val")
        return
    ds = build_dataloader(cfg, "val").dataset
    assert type(ds) is data_build.DATASETS[kind]
    assert ds.output_orig and len(ds) > 0
    assert not data_build.build_dataset(cfg, "train").output_orig
