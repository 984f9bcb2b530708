"""The port's NuScenes path against the JAX package's, on the CPU: the
projection, the box geometry, the pseudo-label refinement, the offline
preprocessor over a duck-typed database
(``tests/test_nuscenes_preprocess_e2e.py::FakeNusc``), the dataset's items
(``tests/test_nuscenes_pipeline.py::_fake_pickle``) with merged classes,
pseudo-labels, a resize and a horizontal flip, and the loader's batches of
``configs/nuscenes/middlefusion.yaml``; the port's own fabricated database
(``tools/fabricate.py::FakeNuScenes``) through both preprocessors.

Everything here is compared bit for bit: the same numpy code runs in both
packages, with the same draws from numpy's global generator in the same
order, and Pillow reads and resizes the images in both.
"""

import os.path as osp
import pickle

import numpy as np
import pytest

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.data.build import build_dataloader as j_loader
from fusiontransformer_tpu.data.nuscenes import boxes as JB
from fusiontransformer_tpu.data.nuscenes import preprocess as JP
from fusiontransformer_tpu.data.nuscenes import projection as JPr
from fusiontransformer_tpu.data.nuscenes.nuscenes_dataloader import (
    NuScenesSCN as JNus)
from fusiontransformer_tpu.data.utils.refine_pseudo_labels import (
    refine_pseudo_labels as j_refine)
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data.build import build_dataloader
from fusiontransformer_tpu_torch.data.nuscenes import boxes as TB
from fusiontransformer_tpu_torch.data.nuscenes import preprocess as TP
from fusiontransformer_tpu_torch.data.nuscenes import projection as TPr
from fusiontransformer_tpu_torch.data.nuscenes import splits as TS
from fusiontransformer_tpu_torch.data.nuscenes.nuscenes_dataloader import (
    NuScenesSCN as TNus)
from fusiontransformer_tpu_torch.data.utils.refine_pseudo_labels import (
    refine_pseudo_labels as t_refine)
from fusiontransformer_tpu_torch.tools.fabricate import FakeNuScenes

from test_torch_port_common import one_thread  # noqa: F401
from test_torch_port_kitti import (assert_batches_equal, assert_items_equal,
                                   jax_worker_batches)
from tests.test_nuscenes_pipeline import _fake_pickle
from tests.test_nuscenes_preprocess_e2e import FakeNusc


def _quat(rng):
    q = rng.randn(4)
    return list(q / np.linalg.norm(q))


def _calib(rng):
    return {"lidar2ego_translation": list(rng.randn(3)),
            "lidar2ego_rotation": _quat(rng),
            "ego2global_translation_lidar": list(rng.randn(3) * 100),
            "ego2global_rotation_lidar": _quat(rng),
            "ego2global_translation_cam": list(rng.randn(3) * 100),
            "ego2global_rotation_cam": _quat(rng),
            "cam2ego_translation": list(rng.randn(3)),
            "cam2ego_rotation": _quat(rng),
            "cam_intrinsic": [[1266.0, 0, 816.0], [0, 1266.0, 491.0],
                              [0, 0, 1]]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projection_and_boxes_match_jax(seed):
    rng = np.random.RandomState(seed)
    info = _calib(rng)
    pc = rng.randn(3, 4000) * 30
    shape = (900, 1600, 3)
    for got, want in zip(TPr.map_pointcloud_to_image(pc, shape, info),
                         JPr.map_pointcloud_to_image(pc, shape, info)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    q = _quat(rng)
    np.testing.assert_array_equal(TPr.quaternion_rotation_matrix(q),
                                  JPr.quaternion_rotation_matrix(q))
    for k in range(4):
        kw = dict(center=rng.randn(3) * 5, wlh=rng.rand(3) * 6 + 1,
                  orientation=_quat(rng), name="vehicle.car")
        pts = rng.randn(3, 3000) * 6
        mask = TB.points_in_box(TB.SimpleBox(**kw), pts, 1.0 + 0.1 * k)
        np.testing.assert_array_equal(
            mask, JB.points_in_box(JB.SimpleBox(**kw), pts, 1.0 + 0.1 * k))
        assert 0 < mask.sum() < len(mask) or k == 0
    for name in list(JB.DETECTION_NAME_MAP) + ["animal", "static_object.x"]:
        assert TB.category_to_detection_name(name) == \
            JB.category_to_detection_name(name)


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_pseudo_labels_matches_jax(seed):
    rng = np.random.RandomState(seed)
    probs = rng.rand(5000).astype(np.float32)
    labels = rng.randint(0, 11, 5000)
    before = labels.copy()
    got = t_refine(probs, labels)
    np.testing.assert_array_equal(got, j_refine(probs, labels))
    assert (got == -100).any() and (got != -100).any()
    np.testing.assert_array_equal(labels, before)   # the input is kept


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def assert_records_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            if k == "boxes":
                assert [x.token for x in a[k]] == [x.token for x in b[k]]
            elif k == "calib":
                assert a[k].keys() == b[k].keys()
                for c in a[k]:
                    np.testing.assert_array_equal(a[k][c], b[k][c])
            else:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


SUBSETS = [
    (("train", "test"), {}),
    (("train", "val", "test"), dict(location="singapore",
                                    subset_name="singapore")),
    (("train", "test"), dict(location="boston", subset_name="usa")),
    (("train", "test"), dict(keyword="night", keyword_action="exclude",
                             subset_name="day")),
    (("train", "val", "test"), dict(keyword="night", keyword_action="filter",
                                    subset_name="night")),
]


def test_preprocess_writes_the_pickles_of_jax(tmp_path):
    root = str(tmp_path / "nusc")
    car = JB.SimpleBox(center=(1.0, 0.0, 10.0), wlh=(2.0, 2.0, 2.0),
                       name="vehicle.car", token="box0")
    ped = JB.SimpleBox(center=(-2.0, 1.0, 14.0), wlh=(2.0, 3.0, 2.0),
                       orientation=(0.9238795, 0.0, 0.3826834, 0.0),
                       name="human.pedestrian.adult", token="box1")
    nusc = FakeNusc(root, [("scene-0001", "sunny day", car),
                           ("scene-0004", "rainy night", ped),
                           ("scene-0003", "night", None),
                           ("scene-9999", "in no split", None)])
    n = 0
    for split_names, kw in SUBSETS:
        for name, out in (("jax", JP), ("port", TP)):
            out.preprocess(nusc, split_names, root, str(tmp_path / name),
                           **kw)
        for split in split_names:
            suffix = "_" + kw["subset_name"] if kw else ""
            f = osp.join("preprocess", f"{split}{suffix}.pkl")
            got = _load(tmp_path / "port" / f)
            assert_records_equal(got, _load(tmp_path / "jax" / f))
            n += len(got)
    assert n >= 6


def test_the_fabricated_database_preprocesses_as_in_jax(tmp_path):
    root = str(tmp_path / "nusc")
    nusc = FakeNuScenes(root, [("scene-0001", "day", "boston-seaport", 2),
                               ("scene-0004", "day", "singapore-onenorth",
                                2)], rays=1500)
    for split_names, kw in SUBSETS[1:3]:
        for name, mod in (("jax", JP), ("port", TP)):
            mod.preprocess(nusc, split_names, root, str(tmp_path / name),
                           **kw)
    usa = _load(tmp_path / "port" / "preprocess" / "train_usa.pkl")
    sing = _load(tmp_path / "port" / "preprocess" / "val_singapore.pkl")
    assert len(usa) == len(sing) == 2 and "scene-0004" in TS.val_singapore
    for f in ("train_usa.pkl", "val_singapore.pkl"):
        assert_records_equal(_load(tmp_path / "port" / "preprocess" / f),
                             _load(tmp_path / "jax" / "preprocess" / f))
    labels = np.concatenate([r["seg_labels"] for r in usa + sing])
    assert (labels == 10).any() and (labels < 10).any()   # boxes and rest
    assert min(len(r["points"]) for r in usa) > 1000


def _pselab(tmp_path, pre, rng):
    recs = _load(osp.join(pre, "train.pkl"))
    rows = []
    for r in recs:
        n = len(r["seg_labels"])
        rows.append({"probs_2d": rng.rand(n), "pseudo_label_2d":
                     rng.randint(0, 5, n), "probs_3d": rng.rand(n),
                     "pseudo_label_3d": rng.randint(0, 5, n)})
    path = str(tmp_path / "pselab.npy")
    np.save(path, np.array(rows, dtype=object), allow_pickle=True)
    return path


@pytest.mark.parametrize("case", ["merged", "pseudo_labels", "plain"])
def test_items_match_jax_under_one_seed(tmp_path, case):
    rng = np.random.RandomState(0)
    pre, nus = _fake_pickle(tmp_path, rng, n_scans=3, n_pts=400)
    kw = dict(split=("train",), preprocess_dir=pre, nuscenes_dir=nus,
              output_orig=True)
    if case == "merged":
        kw.update(merge_classes=True, resize=(400, 225), fliplr=0.5,
                  color_jitter=(0.4, 0.4, 0.4), noisy_rot=0.1, flip_x=0.5,
                  rot_z=6.2831, transl=True,
                  image_normalizer=((0.5, 0.5, 0.5), (0.2, 0.2, 0.2)))
    elif case == "pseudo_labels":
        kw.update(pselab_paths=(_pselab(tmp_path, pre, rng),), fliplr=1.0,
                  merge_classes=True)
    else:
        kw.update(resize=None, point_feats="ones")
    jds, tds = JNus(**kw), TNus(**kw)
    assert tds.class_names == jds.class_names and len(tds) == 3
    for i in range(3):
        np.random.seed(7 + i)
        want, want_next = jds[i], np.random.rand()
        np.random.seed(7 + i)
        got, got_next = tds[i], np.random.rand()
        assert_items_equal(got, want)
        assert got_next == want_next
    if case == "merged":
        assert got["img"].shape == (225, 400, 3) and got["seg_label"].max() < 5
    if case == "pseudo_labels":
        assert (got["pseudo_label_2d"] == -100).any()


def nus_cfg(get_cfg, pre, nus, workers=0):
    cfg = get_cfg()
    cfg.merge_from_file("configs/nuscenes/middlefusion.yaml")
    cfg.merge_from_list([
        "DATASET.TRAIN", "('train',)", "DATASET.VAL", "('val',)",
        "DATASET.NuScenesSCN.preprocess_dir", pre,
        "DATASET.NuScenesSCN.nuscenes_dir", nus,
        "DATASET.NuScenesSCN.augmentation.fliplr", "0.5",
        "DATASET.NuScenesSCN.augmentation.flip_x", "0.5",
        "TRAIN.BATCH_SIZE", "2", "VAL.BATCH_SIZE", "2",
        "TPU.POINT_CAPACITY", "512", "TPU.NUM_DEVICES", "1",
        "DATALOADER.NUM_WORKERS", str(workers)])
    cfg.freeze()
    return cfg


def test_batches_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    for split in ("train", "val"):
        pre, nus = _fake_pickle(tmp_path, rng, n_scans=3, n_pts=300,
                                split=split)
    tload = build_dataloader(nus_cfg(get_default_cfg, pre, nus))
    jload = j_loader(nus_cfg(jcfg, pre, nus))
    for epoch in (0, 1):
        tload.set_epoch(epoch)
        assert_batches_equal(list(tload), jax_worker_batches(jload, epoch))
    tval = build_dataloader(nus_cfg(get_default_cfg, pre, nus, 2), "val")
    try:
        got = list(tval)
    finally:
        tval.close()
    assert_batches_equal(got, list(j_loader(nus_cfg(jcfg, pre, nus), "val")))
    assert got[0]["img"].shape == (2, 225, 400, 3)
    assert tval.dataset.map_inverse_label is None


def test_five_class_weights_carry_across_from_jax(tmp_path):
    """``load_jax_variables`` takes the 5-class heads of the NuScenes
    configuration: a NuScenes batch's logits of both packages, f32, within
    2e-3 (as ``tests/test_torch_port_models.py``), at tiny widths."""
    import jax
    import torch

    from fusiontransformer_tpu.models.build import build_model as j_build
    from fusiontransformer_tpu.modules.steps import (_device_batch,
                                                     _hier_from_cfg)
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                           hier_from_cfg)
    from fusiontransformer_tpu_torch.utils.convert_jax import (
        load_jax_variables)
    from test_torch_port_common import jax_variables, tiny_cfg

    pre, nus = _fake_pickle(tmp_path, np.random.RandomState(2), n_scans=2,
                            n_pts=400, split="val")

    def cfg_of(get_cfg):
        cfg = tiny_cfg(get_cfg, point_capacity=512)
        cfg.defrost()
        cfg.MODEL.NUM_CLASSES = 5
        cfg.DATASET.TYPE = "NuScenesSCN"
        cfg.DATASET.VAL = ("val",)
        cfg.DATASET.NuScenesSCN.preprocess_dir = pre
        cfg.DATASET.NuScenesSCN.nuscenes_dir = nus
        cfg.DATASET.NuScenesSCN.merge_classes = True
        cfg.VAL.BATCH_SIZE = 1
        cfg.TPU.NUM_DEVICES = 1
        cfg.freeze()
        return cfg

    cfg_j, cfg_t = cfg_of(jcfg), cfg_of(get_default_cfg)
    batch = next(iter(build_dataloader(cfg_t, "val")))
    params, stats = jax_variables(cfg_j)
    jb = _device_batch(batch)
    jm = j_build(cfg_j)[0]
    want = jax.jit(lambda p, s, b: jm.apply(
        {"params": p, "batch_stats": s}, b, _hier_from_cfg(cfg_j, b),
        train=False))(params, stats, jb)
    tm = load_jax_variables(build_model(cfg_t, "cpu"), params, stats).eval()
    tb = device_batch(batch, "cpu")
    with torch.no_grad():
        got = tm(tb, hier_from_cfg(cfg_t, tb))
    assert want.keys() == got.keys()
    for k in got:
        assert got[k].shape[-1] == 5, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=2e-3, err_msg=k)
