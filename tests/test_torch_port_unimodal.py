"""The uni-modal models of the port against the JAX package's, on the CPU:
``LidarSeg`` (SPVCNN alone) and ``ImageSegBilinear`` (the ViT alone), with
the JAX weights carried across by ``load_jax_variables``; the image warp;
``validate`` and the engine for each model type; the data build; the
pretrained ViT; the legacy types.  The STN model (``ImageSeg``) is in
``test_torch_port_stn.py``, the CLIs in ``test_torch_port_unimodal_cli.py``.

Small width: ViT 32 px / patch 16 / width 64 / depth 2 / 2 heads, SPVCNN
cr 1, 40x60 images, ~900-point SyntheticSCN scans.

Tolerances, as in ``test_torch_port_models.py`` and
``test_torch_port_train.py``: f32 logits within 2e-3 max-abs (the
full-model bound of ``PARITY.md``), bf16 within 1e-3 (both packages round
the operands to bf16 and keep f32 products).  At SPVCNN's full width
(cr 1) its bf16 features round an f32 sum one bf16 step the other way at
~0.4% of the values (2^-7 of the largest feature), which moves a logit
by up to ~1.7e-3: there 99% of the values are held to 1e-3, every feature
to one bf16 step of the largest and every logit to 4e-3.  Train-step
losses 1e-5
relative, gradients per leaf ``LEAF_RTOL`` of the leaf's largest |g| plus
``LEAF_ATOL`` with the median within ``MEDIAN_RTOL``, BatchNorm statistics
1e-5, confusion matrices exactly equal.  The image warp: max-abs 1e-5 (the
same f32 arithmetic).  ``validate``: matrices and meters equal.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.data.build import build_dataloader as j_loader
from fusiontransformer_tpu.data.utils.validate import validate as j_validate
from fusiontransformer_tpu.models.build import (build_model as j_build,
                                                maybe_load_pretrained_image)
from fusiontransformer_tpu.modules import steps as js
from fusiontransformer_tpu.modules.SemanticTrainer import init_train_state
from fusiontransformer_tpu.ops import image_warp as jw
from fusiontransformer_tpu.serving import InferenceEngine as JEngine
from fusiontransformer_tpu.solver.build import build_optimizer as j_opt
from fusiontransformer_tpu.utils.metric_logger import MetricLogger as JML
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data.build import (build_dataloader,
                                                    slot_pool_spec)
from fusiontransformer_tpu_torch.data.collate import collate_padded
from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
from fusiontransformer_tpu_torch.data.utils.validate import validate
from fusiontransformer_tpu_torch.models import spvcnn
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.modules import steps as ts
from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
    SemanticTrainer, modalities)
from fusiontransformer_tpu_torch.ops import image_warp as tw
from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
from fusiontransformer_tpu_torch.solver.build import build_optimizer
from fusiontransformer_tpu_torch.train import load_cfg
from fusiontransformer_tpu_torch.utils.convert_jax import (jax_leaf_paths,
                                                           load_jax_variables)
from fusiontransformer_tpu_torch.utils.metric_logger import MetricLogger
from fusiontransformer_tpu_torch.utils.torch_checkpoint import (
    load_pretrained_image)

from test_torch_port_common import (CLASS_WEIGHTS, LEAF_ATOL, LEAF_RTOL,
                                    MEDIAN_RTOL, H, W, jax_variables,
                                    one_thread, record,  # noqa: F401
                                    tiny_cfg)
from test_torch_port_eval_cli import fake_predictions

# MODEL.TYPE, USE_LIDAR, USE_IMAGE of each uni-modal kind.
KINDS = {"lidar": ("LidarSeg", True, False),
         "bilinear": ("ImageSegBilinear", False, True),
         "stn": ("ImageSeg", False, True)}


def uni_cfg(get_cfg, kind, dtype="float32", slot_pool=True, dual=False,
            train=False):
    """``tiny_cfg`` turned into the uni-modal model ``kind``; with
    ``train`` the flagship's training settings (Adam, wd 5e-4, its class
    weights), batch 2."""
    cfg = tiny_cfg(get_cfg, dtype=dtype)
    cfg.defrost()
    m = cfg.MODEL
    m.TYPE, m.USE_LIDAR, m.USE_IMAGE = KINDS[kind]
    m.USE_FUSION, m.DUAL_HEAD = False, dual
    m.middle_feat_block_number = None
    cfg.TPU.CONV_SLOT_POOL = slot_pool
    if train:
        cfg.OPTIMIZER.TYPE = "Adam"
        cfg.OPTIMIZER.BASE_LR = 1e-2
        cfg.OPTIMIZER.WEIGHT_DECAY = 5e-4
        cfg.TRAIN.CLASS_WEIGHTS = list(CLASS_WEIGHTS)
        cfg.TRAIN.BATCH_SIZE = 2
    cfg.DATASET.TRAIN, cfg.DATASET.VAL = ("train",), ("val",)
    cfg.freeze()
    return cfg


@functools.lru_cache(maxsize=None)
def weights(kind, dual=False):
    """JAX params and random running statistics of ``kind``."""
    return jax_variables(uni_cfg(jcfg, kind, dual=dual))


def val_batch(cfg_t):
    ds = SyntheticSCN(split=("val",), num_scans=1, num_points=900,
                      image_height=H, image_width=W)
    b = collate_padded([ds[0]], 1, 1024, H, W,
                       slot_pool=slot_pool_spec(cfg_t, adaptive=False))
    assert b.get("gslot_overflow", 0) == 0
    return b


def hier_of(cfg_j, jb):
    return js._hier_from_cfg(cfg_j, jb) if cfg_j.MODEL.USE_LIDAR else None


def run_both(kind, dtype="float32", slot_pool=True, dual=False):
    """Eval-mode outputs of both packages on one scan: {key: (jax, port,
    the port's dtype)}."""
    cfg_j = uni_cfg(jcfg, kind, dtype, slot_pool, dual)
    cfg_t = uni_cfg(get_default_cfg, kind, dtype, slot_pool, dual)
    params, stats = weights(kind, dual)
    b = val_batch(cfg_t)
    assert ("gslot_src_0" in b) == (slot_pool and kind == "lidar")
    jm = j_build(cfg_j)[0]
    want = jax.jit(lambda p, s, x: jm.apply(
        {"params": p, "batch_stats": s}, x, hier_of(cfg_j, x),
        train=False))(params, stats, js._device_batch(b))
    tm = load_jax_variables(build_model(cfg_t, "cpu"), params, stats).eval()
    tb = ts.device_batch(b, "cpu")
    with torch.no_grad():
        got = tm(tb, ts.step_hier(cfg_t, tb))
    assert want.keys() == got.keys()
    return {k: (np.asarray(want[k], np.float32), got[k].float().numpy(),
                got[k].dtype) for k in want}


@pytest.mark.parametrize("kind,dtype,slot_pool,dual", [
    ("lidar", "float32", True, False), ("lidar", "float32", False, False),
    ("lidar", "bfloat16", True, False), ("lidar", "bfloat16", False, False),
    ("bilinear", "float32", False, True), ("bilinear", "bfloat16", False,
                                           False)])
def test_unimodal_logits_match_jax(kind, dtype, slot_pool, dual):
    """LidarSeg on group-pooled and on per-voxel maps, ImageSegBilinear
    with one and two heads, in f32 and bf16."""
    outs = run_both(kind, dtype, slot_pool, dual)
    want_keys = {"lidar": {"lidar_seg_logit", "lidar_feats"},
                 "bilinear": {"img_seg_logit"}}[kind]
    assert set(outs) == want_keys | ({"img_seg_logit2"} if dual else set())
    tol = 2e-3 if dtype == "float32" else 1e-3
    for k, (want, got, got_dtype) in outs.items():
        assert np.abs(want).max() > 1e-2, k
        if dtype == "bfloat16" and kind == "lidar":
            # SPVCNN's features are bf16: where an f32 sum rounds one bf16
            # step the other way, a feature moves by up to 2^-7 of the
            # largest one, and the head's logits by that times a weight.
            # At most 1% of the values may leave the 1e-3 bound.
            bound = (2.0 ** -7 * np.abs(want).max()
                     if got_dtype == torch.bfloat16 else 4e-3)
            np.testing.assert_allclose(got, want, rtol=0, atol=bound,
                                       err_msg=k)
            assert np.mean(np.abs(got - want) > tol) < 0.01, k
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=k)


# --------------------------------------------------------------------------- #
class _NoDropout(fnn.Module):
    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


@pytest.fixture(scope="module", params=["lidar", "bilinear"])
def one_step(request):
    """One train step of each package from the same weights and batch
    (dropout neutralised on both sides)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn, "Dropout", _NoDropout)
    mp.setattr(spvcnn, "DROPOUT", 0.0)
    try:
        yield request.param, _one_step(request.param)
    finally:
        mp.undo()


def _one_step(kind):
    cfg_j = uni_cfg(jcfg, kind, train=True)
    cfg_t = uni_cfg(get_default_cfg, kind, train=True)
    batch = next(iter(build_dataloader(cfg_t, "train")))
    caps = ts.batch_level_caps(cfg_t, batch) if kind == "lidar" else None

    model = j_build(cfg_j)[0]
    tx, _ = j_opt(cfg_j)
    state = init_train_state(cfg_j, model, tx, 2, rng_seed=5)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    jb = js._device_batch(batch)
    step, _ = js.make_train_step(cfg_j, model, tx, 2, level_caps=caps)
    new_state, jmetrics = jax.jit(step)(state, jb, jax.random.PRNGKey(0))
    cw = jnp.asarray(cfg_j.TRAIN.CLASS_WEIGHTS, jnp.float32)

    def loss_fn(p):
        hier = (js._hier_from_cfg(cfg_j, jb, caps) if kind == "lidar"
                else None)
        out, _ = model.apply({"params": p, "batch_stats": state.batch_stats},
                             jb, hier, train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(0)})
        return js._losses(cfg_j, out, jb, cw)[0]

    jgrads = jax.jit(jax.grad(loss_fn))(state.params)

    tmodel = load_jax_variables(build_model(cfg_t, "cpu"), params, stats)
    opt, _ = build_optimizer(cfg_t, tmodel.parameters())
    tgrads = {}
    names = {id(p): n for n, p in tmodel.named_parameters()}
    opt.register_step_pre_hook(lambda o, a, k: tgrads.update(
        {names[id(p)]: p.grad.clone() for g in o.param_groups
         for p in g["params"]}))
    tstep = ts.make_train_step(cfg_t, tmodel, opt)
    tmetrics = tstep(ts.device_batch(batch, "cpu"), torch.Generator(), caps)
    return (jmetrics, jax.tree_util.tree_map(np.asarray, jgrads),
            jax.tree_util.tree_map(np.asarray, new_state.batch_stats),
            tmetrics, tgrads, tmodel, batch)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_unimodal_train_step_metrics_match_jax(one_step):
    """The stream's loss, no other; its confusion matrix, no other; the
    overflow count with the 3D stream only; the batch's slot maps and
    level counts with the 3D stream only."""
    kind, (jmetrics, _, _, tmetrics, _, _, batch) = one_step
    dim = "3d" if kind == "lidar" else "2d"
    assert set(tmetrics) == set(jmetrics)
    want = {"total_loss", f"seg_loss_{dim}", f"cm_{dim}"}
    if kind == "lidar":
        want.add("voxel_overflow")
        assert int(tmetrics["voxel_overflow"]) == 0
    assert set(tmetrics) == want
    for k in ("total_loss", f"seg_loss_{dim}"):
        np.testing.assert_allclose(tmetrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tmetrics[f"cm_{dim}"].numpy(),
                                  np.asarray(jmetrics[f"cm_{dim}"]))
    has_maps = any(k.startswith(("gslot_", "level_counts")) for k in batch)
    assert has_maps == (kind == "lidar")


def test_unimodal_train_step_gradients_match_jax(one_step):
    kind, (_, jgrads, _, _, tgrads, tmodel, _) = one_step
    paths = jax_leaf_paths(tmodel)
    assert len(tgrads) == sum(1 for c, _ in paths.values() if c == "params")
    shares = []
    for name, g in tgrads.items():
        want = _leaf(jgrads, paths[name][1])
        scale = float(np.abs(want).max())
        err = float(np.abs(g.numpy() - want).max())
        if scale == 0.0:
            assert err == 0.0, name
            continue
        assert err <= LEAF_RTOL * scale + LEAF_ATOL, (name, err, scale)
        shares.append(err / scale)
    assert np.median(shares) <= MEDIAN_RTOL, np.median(shares)
    if kind == "lidar":     # the K1 / K2 convs at L0-L3 are among them
        assert any(n.startswith("backbone.stage1_res1.") for n in tgrads)


def test_unimodal_train_step_batchnorm_stats_match_jax(one_step):
    _, (_, _, jstats, _, _, tmodel, _) = one_step
    paths = jax_leaf_paths(tmodel)
    n = 0
    for name, buf in tmodel.named_buffers():
        np.testing.assert_allclose(buf.numpy(), _leaf(jstats, paths[name][1]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        n += 1
    assert n > 0


# --------------------------------------------------------------------------- #
def _thetas(b, kind, rng):
    ident = np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (b, 1, 1))
    if kind == "near identity":
        return ident + 0.1 * rng.randn(b, 2, 3).astype(np.float32)
    # Zoomed out, shifted and rotated: most samples fall outside the image.
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.array([[2.5 * c, -2.5 * s, 0.9], [2.5 * s, 2.5 * c, -1.3]],
                   np.float32)
    return np.tile(rot, (b, 1, 1)) + 0.05 * rng.randn(b, 2, 3).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(2, 7, 9, 3, 5, 11), (1, 16, 16, 4, 23, 9),
                                   (3, 5, 12, 2, 5, 12)])
@pytest.mark.parametrize("theta_kind", ["near identity", "outside"])
def test_image_warp_matches_jax_and_torch(shape, theta_kind):
    """``affine_grid`` / ``grid_sample_bilinear`` against the JAX package's
    (max-abs 1e-5), forward and gradients, and against torch's own
    ``F.affine_grid`` / ``F.grid_sample`` (bilinear, zeros,
    ``align_corners=False``), whose semantics both implement."""
    b, h, w, c, ho, wo = shape
    rng = np.random.RandomState(sum(shape))
    img = rng.randn(b, h, w, c).astype(np.float32)
    theta = _thetas(b, theta_kind, rng)
    wout = rng.randn(b, ho, wo, c).astype(np.float32)

    def jf(im, th):
        grid = jw.affine_grid(th, ho, wo)
        return jw.grid_sample_bilinear(im, grid), grid

    (jout, jgrid) = jf(jnp.asarray(img), jnp.asarray(theta))
    jgi, jgt = jax.grad(lambda im, th: jnp.sum(jf(im, th)[0] * wout),
                        argnums=(0, 1))(jnp.asarray(img), jnp.asarray(theta))
    ti = torch.tensor(img, requires_grad=True)
    tt = torch.tensor(theta, requires_grad=True)
    tgrid = tw.affine_grid(tt, ho, wo)
    tout = tw.grid_sample_bilinear(ti, tgrid)
    (tout * torch.from_numpy(wout)).sum().backward()
    for name, got, want in (("grid", tgrid, jgrid), ("out", tout, jout),
                            ("d img", ti.grad, jgi),
                            ("d theta", tt.grad, jgt)):
        want = np.asarray(want)
        scale = 1.0 if name != "d theta" else max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
    outside = (tgrid.detach().abs() > 1).any(-1).float().mean().item()
    assert (outside > 0.5) == (theta_kind == "outside")
    ref_grid = F.affine_grid(torch.from_numpy(theta), (b, c, ho, wo),
                             align_corners=False)
    ref = F.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2), ref_grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(tgrid.detach().numpy(), ref_grid.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tout.detach().numpy(), ref.numpy(), rtol=0,
                               atol=1e-4)


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["lidar", "bilinear"])
def test_validate_of_one_stream_matches_jax(kind):
    """The same per-voxel predictions through both loops: the present
    stream's evaluator only, equal confusion matrices, equal meters."""
    cfg_t = uni_cfg(get_default_cfg, kind)
    cfg_j = uni_cfg(jcfg, kind)
    dim = "3d" if kind == "lidar" else "2d"
    mod = dim.upper()
    keys = (f"pred_{dim}", f"seg_loss_{dim}")

    def run_batch(batch):
        return ts.read_back({k: torch.as_tensor(v) for k, v in
                             fake_predictions(batch).items() if k in keys})

    def j_step(state, batch):
        return {k: v for k, v in fake_predictions(batch).items()
                if k in keys}

    tml, jml = MetricLogger(), JML()
    got = validate(cfg_t, run_batch, build_dataloader(cfg_t, "val"), tml)
    want = j_validate(cfg_j, j_step, None, j_loader(cfg_j, "val"), jml)
    assert [m for m, _ in got] == [m for m, _ in want] == [mod]
    np.testing.assert_array_equal(got[0][1].confusion_matrix,
                                  want[0][1].confusion_matrix)
    assert got[0][1].confusion_matrix.sum() > 500
    names = set(tml.meters) - {"time", "data"}
    assert names == set(jml.meters) - {"time", "data"} == {
        f"seg_loss_{dim}", f"seg_iou_{dim}", "collate_dropped",
        "oob_points"}
    for name in names:
        assert tml.meters[name].global_avg == jml.meters[name].global_avg, \
            name


@pytest.mark.parametrize("kind", ["lidar", "bilinear"])
def test_eval_step_returns_the_present_streams(kind):
    cfg = uni_cfg(get_default_cfg, kind)
    model = build_model(cfg, "cpu")
    b = val_batch(cfg)
    res = ts.make_eval_step(cfg, model)(ts.device_batch(b, "cpu"))
    dim = "3d" if kind == "lidar" else "2d"
    assert set(res) == {f"pred_{dim}", f"seg_loss_{dim}"}
    assert modalities(cfg) == [dim]


@pytest.mark.parametrize("kind", ["lidar", "bilinear"])
def test_engine_matches_jax_for_each_model_type(kind):
    """The predict step's keys and per-point labels against the JAX
    engine's with the same weights (>= 99.9% of points; ties to f32
    rounding may go either way)."""
    params, stats = weights(kind)
    cfg_t = uni_cfg(get_default_cfg, kind)
    jax_engine = JEngine(uni_cfg(jcfg, kind), params=params,
                         batch_stats=stats)
    port = InferenceEngine(cfg_t, model=load_jax_variables(
        build_model(cfg_t, "cpu"), params, stats), device="cpu")
    assert port._pred_keys == jax_engine._pred_keys == (
        ["pred", "pred_3d", "voxel_overflow"] if kind == "lidar"
        else ["pred", "pred_2d"])
    assert (port._slot_pool is None) == (kind != "lidar")
    for i in range(2):
        rec = record(i)
        want, got = jax_engine.predict(rec), port.predict(rec)
        assert set(got) == set(want)
        label_keys = {k for k in got if k.startswith("labels")}
        assert label_keys == {"labels", "labels_3d" if kind == "lidar"
                              else "labels_2d"}
        np.testing.assert_array_equal(got["in_frustum"], want["in_frustum"])
        for key in label_keys:
            assert np.mean(got[key] == want[key]) >= 0.999, key
        single = "labels_3d" if kind == "lidar" else "labels_2d"
        np.testing.assert_array_equal(got["labels"], got[single])
    st = port.stats()
    assert st["voxel_overflow"] == 0 and st["collate_dropped_points"] == 0


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["lidar", "bilinear", "stn"])
def test_the_data_build_gives_slot_maps_to_the_3d_stream_only(kind):
    cfg = uni_cfg(get_default_cfg, kind, train=True)
    batch = next(iter(build_dataloader(cfg, "train")))
    lidar = kind == "lidar"
    assert ("gslot_src_0" in batch) == lidar
    assert ("level_counts" in batch) == lidar
    assert (slot_pool_spec(cfg, adaptive=True) is None) == (not lidar)
    assert set(ts.device_arrays(batch)) >= {"coords", "pt_batch", "img",
                                           "img_indices"}


@pytest.mark.parametrize("name", ["lidar", "debuglidar", "imageBilinear",
                                  "imageBilinearPretrained", "debugimage",
                                  "image"])
def test_the_unimodal_configs_build(name):
    """The shipped uni-modal configs (SemanticKITTI) build their model
    types; widths as shipped except the ViT of the bilinear ones (cut to
    keep the CPU quick; ImageSeg ignores those keys)."""
    cfg = load_cfg(f"configs/semantic_kitti/{name}.yaml", [
        "MODEL.VIT_EMBED_DIM", "64", "MODEL.VIT_DEPTH", "12",
        "MODEL.VIT_HEADS", "2", "MODEL.IMAGE_PRETRAINED_PATH", ""])
    model = build_model(cfg, "cpu")
    want = {"LidarSeg": "LidarSeg", "ImageSegBilinear": "ImageSegBilinear",
            "ImageSeg": "ImageSegSTN"}[cfg.MODEL.TYPE]
    assert type(model).__name__ == want
    if want == "LidarSeg":
        assert model.backbone.cs == [32, 32, 64, 128, 256, 256, 128, 96, 96]
        assert model.linear.kernel.shape == (96, 20)
    elif want == "ImageSegSTN":
        vit = model.image_backbone.backbone
        assert (vit.depth, vit.pos_embed.shape) == (12, (1, 578, 768))
        assert model.image_backbone.up_11.up_conv.kernel.shape == (
            768, 96 * 16 * 16)


@pytest.mark.parametrize("name", ["legacy_scn_lidar", "legacy_resnet_image",
                                  "legacy_xmuda"])
def test_the_legacy_types_still_raise(name):
    cfg = load_cfg(f"configs/semantic_kitti/{name}.yaml", [])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(cfg, "cpu")


# --------------------------------------------------------------------------- #
def test_image_bilinear_pretrained_loads_a_backbone_checkpoint(tmp_path):
    """``imageBilinearPretrained.yaml`` at the tiny width: a SimCLR
    checkpoint (``backbone.``-prefixed timm keys) written here loads into
    ``image_backbone.backbone`` of the port's trainer, every ViT leaf equal
    to what JAX's loader puts there."""
    from test_torch_port_pretrained import deit_state_dict
    import test_torch_port_pretrained as tp
    sd = {f"backbone.{k}": v for k, v in deit_state_dict().items()}
    path = str(tmp_path / "simclr_backbone.ckpt")
    torch.save({"state_dict": sd}, path)
    over = ["MODEL.IMAGE_PRETRAINED_PATH", path, "MODEL.VIT_IMG_SIZE",
            str(tp.IMG), "MODEL.VIT_EMBED_DIM", str(tp.DIM),
            "MODEL.VIT_DEPTH", str(tp.DEPTH), "MODEL.VIT_HEADS",
            str(tp.HEADS), "DATASET.TYPE", "SyntheticSCN",
            "DATASET.SyntheticSCN.image_height", str(H),
            "DATASET.SyntheticSCN.image_width", str(W),
            "DATASET.SyntheticSCN.num_points", "900",
            "DATASET.SyntheticSCN.num_scans", "2",
            "DATASET.TRAIN", "('train',)", "DATASET.VAL", "('val',)",
            "TPU.POINT_CAPACITY", "1024", "TPU.CAPACITY_BUCKETS", "(1024,)",
            "OUTPUT_DIR", ""]
    cfg_file = "configs/semantic_kitti/imageBilinearPretrained.yaml"
    cfg_t = load_cfg(cfg_file, over)
    tr = SemanticTrainer(cfg_t, "", device="cpu")
    cfg_j = jcfg()
    cfg_j.merge_from_file(cfg_file)
    cfg_j.merge_from_list(over)
    cfg_j.freeze()
    params = jax.tree_util.tree_map(np.array, init_train_state(
        cfg_j, j_build(cfg_j)[0], None, 1).params)
    n = maybe_load_pretrained_image(cfg_j, params)
    assert n == 5 + 12 * tp.DEPTH
    vit = dict(tr.model.image_backbone.backbone.state_dict())
    flat = tp._flat(params["image_backbone"]["backbone"])
    assert flat.keys() == vit.keys()
    for k, want in flat.items():
        np.testing.assert_array_equal(vit[k].numpy(), want, err_msg=k)
    # A model without the ViT refuses the key.
    lidar = build_model(uni_cfg(get_default_cfg, "lidar"), "cpu")
    with pytest.raises(ValueError, match="no ViT"):
        load_pretrained_image(cfg_t, lidar)
