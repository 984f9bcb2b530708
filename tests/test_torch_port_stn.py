"""The STN image model (``ImageSeg``: ``image_models_stn.py::ImageSegSTN``)
of the port against the JAX package's, on the CPU, with the JAX weights
carried across by ``load_jax_variables``: its logits in f32 and bf16, its
engine, its identity warp at initialisation and the pretrained ViT.

``ImageSeg`` builds the DeiT-B/384 ViT with its defaults whatever the
config says (as JAX does), so this file runs the full-width ViT and the
STN up to 40x60 images, one scan at a time.  The regressors ``fc2_*`` of
both STNs get random values so that the warps are not the identity.

Tolerances: f32 logits within 2e-3 max-abs (``PARITY.md``; measured
5e-5).  bf16 (the ViT and ``up_conv`` round their operands to bf16 in
both packages, the localisation nets and heads stay f32): within twice
what JAX's own logits move when its input moves by 1e-7 relative, and at
least 1e-3.  At the ViT's full width an f32 difference that small flips
the bf16 rounding of some operands: JAX's ViT moves by 1.9e-3 after one
block and 1.2e-2 after twelve under such a move, the same as the port's
gap to it (1.9e-3, 1.2e-2), while at width 64 neither moves (3e-8,
``test_torch_port_models.py``).  Measured on the STN's logits: port 2.9e-3
from JAX, JAX's bf16 6.7e-3 from its f32.
"""

import jax
import numpy as np
import pytest
import torch

from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
from fusiontransformer_tpu.models.build import (build_model as j_build,
                                                maybe_load_pretrained_image)
from fusiontransformer_tpu.modules import steps as js
from fusiontransformer_tpu.serving import InferenceEngine as JEngine
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.modules import steps as ts
from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
from fusiontransformer_tpu_torch.utils.convert_jax import load_jax_variables
from fusiontransformer_tpu_torch.utils.torch_checkpoint import (
    load_pretrained_image)

from test_torch_port_common import (jax_variables, one_thread,  # noqa: F401
                                    record)
from test_torch_port_unimodal import uni_cfg, val_batch

STNS = ("stn_down", "up_11/up_stn")


@pytest.fixture(scope="module")
def weights():
    params, stats = jax_variables(uni_cfg(jcfg, "stn"))
    rng = np.random.RandomState(11)
    for path in STNS:
        node = params["image_backbone"]
        for k in path.split("/"):
            node = node[k]
        assert not node["fc2_kernel"].any()          # the identity warp
        node["fc2_kernel"] = (0.05 * rng.randn(32, 6)).astype(np.float32)
        node["fc2_bias"] = (node["fc2_bias"] + 0.1 * rng.randn(6)).astype(
            np.float32)
    return params, stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stn_logits_match_jax(weights, dtype):
    params, stats = weights
    cfg_j = uni_cfg(jcfg, "stn", dtype)
    cfg_t = uni_cfg(get_default_cfg, "stn", dtype)
    b = val_batch(cfg_t)
    jm = j_build(cfg_j)[0]
    apply = jax.jit(lambda p, s, x: jm.apply(
        {"params": p, "batch_stats": s}, x, None, train=False))
    jb = js._device_batch(b)
    want = apply(params, stats, jb)
    tm = load_jax_variables(build_model(cfg_t, "cpu"), params, stats).eval()
    assert tm.image_backbone.backbone.depth == 12
    with torch.no_grad():
        got = tm(ts.device_batch(b, "cpu"), None)
    assert set(got) == set(want) == {"img_seg_logit"}
    w = np.asarray(want["img_seg_logit"])
    assert np.abs(w).max() > 1e-2
    tol = 2e-3
    if dtype == "bfloat16":
        # At the ViT's full width JAX's own bf16 logits move by ~3e-3 when
        # its image moves by 1e-7 relative (an f32 rounding): the rounding
        # of ~1 in 4000 operands to bf16 flips.  The port's summation
        # order is such a move; it is held to twice JAX's own.
        rng = np.random.RandomState(0)
        moved = dict(jb, img=jb["img"] * (
            1 + 1e-7 * rng.randn(*jb["img"].shape)).astype(np.float32))
        self_move = float(np.abs(np.asarray(
            apply(params, stats, moved)["img_seg_logit"]) - w).max())
        tol = max(1e-3, 2 * self_move)
    np.testing.assert_allclose(got["img_seg_logit"].numpy(), w, rtol=0,
                               atol=tol)


def test_stn_dual_head_returns_one_logit_and_starts_at_the_identity():
    """``ImageSegSTN`` returns ``img_seg_logit`` alone even with
    ``DUAL_HEAD`` (it builds ``linear2`` all the same, as JAX does); a
    randomly initialised model warps by the identity."""
    cfg = uni_cfg(get_default_cfg, "stn", dual=True)
    model = build_model(cfg, "cpu")
    assert hasattr(model.image_backbone, "linear2")
    ident = torch.tensor([1.0, 0, 0, 0, 1, 0])
    for stn in (model.image_backbone.stn_down,
                model.image_backbone.up_11.up_stn):
        assert not stn.fc2_kernel.any()
        assert torch.equal(stn.fc2_bias.detach(), ident)
    with torch.no_grad():
        out = model(ts.device_batch(val_batch(cfg), "cpu"))
    assert set(out) == {"img_seg_logit"}


def test_stn_engine_matches_jax(weights):
    params, stats = weights
    cfg_t = uni_cfg(get_default_cfg, "stn")
    jax_engine = JEngine(uni_cfg(jcfg, "stn"), params=params,
                         batch_stats=stats)
    port = InferenceEngine(cfg_t, model=load_jax_variables(
        build_model(cfg_t, "cpu"), params, stats), device="cpu")
    assert port._pred_keys == jax_engine._pred_keys == ["pred", "pred_2d"]
    rec = record(0)
    want, got = jax_engine.predict(rec), port.predict(rec)
    assert set(got) == set(want) == {"labels", "labels_2d", "in_frustum",
                                     "num_voxels"}
    for key in ("labels", "labels_2d"):
        assert np.mean(got[key] == want[key]) >= 0.999, key
    np.testing.assert_array_equal(got["labels"], got["labels_2d"])


def test_stn_pretrained_vit_is_found_as_jax_finds_it(weights, tmp_path):
    """A SimCLR ``backbone.`` checkpoint of DeiT-B/384 loads into the STN's
    ViT (``image_backbone.backbone``) in both packages, leaf for leaf."""
    from test_torch_port_pretrained import _flat
    gen = torch.Generator().manual_seed(0)
    d, n_tok = 768, 578

    def t(*shape):
        return 0.02 * torch.randn(shape, generator=gen)

    sd = {"patch_embed.proj.weight": t(d, 3, 16, 16),
          "patch_embed.proj.bias": t(d), "cls_token": t(1, 1, d),
          "dist_token": t(1, 1, d), "pos_embed": t(1, n_tok, d)}
    for i in range(12):
        b = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            sd[b + norm + ".weight"] = 1 + t(d)
            sd[b + norm + ".bias"] = t(d)
        for name, (o, k) in {"attn.qkv": (3 * d, d), "attn.proj": (d, d),
                             "mlp.fc1": (4 * d, d),
                             "mlp.fc2": (d, 4 * d)}.items():
            sd[b + name + ".weight"] = t(o, k)
            sd[b + name + ".bias"] = t(o)
    path = str(tmp_path / "simclr.ckpt")
    torch.save({"state_dict": {f"backbone.{k}": v for k, v in sd.items()}},
               path)
    del sd
    cfgs = []
    for get in (jcfg, get_default_cfg):
        cfg = uni_cfg(get, "stn")
        cfg.defrost()
        cfg.MODEL.IMAGE_PRETRAINED_PATH = path
        cfg.freeze()
        cfgs.append(cfg)
    params = jax.tree_util.tree_map(np.array, weights[0])
    n_jax = maybe_load_pretrained_image(cfgs[0], params)
    model = build_model(cfgs[1], "cpu")
    n_port = load_pretrained_image(cfgs[1], model)
    assert n_port == n_jax == 5 + 12 * 12
    vit = model.image_backbone.backbone.state_dict()
    for k, want in _flat(params["image_backbone"]["backbone"]).items():
        np.testing.assert_array_equal(vit[k].numpy(), want, err_msg=k)
