"""The port's fusion models against the JAX package's, with the JAX weights
carried across by ``utils.convert_jax.load_jax_variables``.

Small width: SPVCNN cr 0.25, ViT 32 px / patch 16 / width 64 / depth 2 /
2 heads, 40x60 images, a 900-point SyntheticSCN scan with group-pooled slot
maps at L0-L3.  Running statistics are random so eval-mode BN is exercised.

Tolerances: f32 logits within 2e-3 max-abs (the full-model parity bound of
the repo's torch reference); in practice they agree to ~1e-6.  bf16 logits
within 1e-3 max-abs: both packages round the operands to bf16 and
accumulate and return every product in f32 (see ``ops/sparse_conv.py``);
measured gaps are ~3e-8 on logits of magnitude up to 1, and the bound
leaves room for an operand that rounds the other way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusiontransformer_tpu.models.fusion import FusionTransformerBase as JFT
from fusiontransformer_tpu.models.layers import MaskedBatchNorm as JBN
from fusiontransformer_tpu.modules.steps import (_device_batch,
                                                 _hier_from_cfg)
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data.collate import collate_padded
from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
from fusiontransformer_tpu_torch.models.fusion import (FusionTransformerBase
                                                       as TFT)
from fusiontransformer_tpu_torch.models.layers import MaskedBatchNorm
from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                       hier_from_cfg)
from fusiontransformer_tpu_torch.ops.host_slots import SlotPoolSpec
from fusiontransformer_tpu_torch.utils.convert_jax import load_jax_variables

from test_torch_port_common import H, W, tiny_cfg

KW = dict(num_classes=20, dual_head=True, middle_feat_block=0,
          late_feat_block=1, cr=0.25, image_height=H, image_width=W,
          vit_img_size=32, vit_patch=16, vit_embed_dim=64, vit_depth=2,
          vit_heads=2)


@pytest.fixture(scope="module")
def batch():
    cfg = tiny_cfg(get_default_cfg)
    ds = SyntheticSCN(split=("val",), num_scans=1, num_points=900,
                      image_height=H, image_width=W)
    spec = SlotPoolSpec([0, 1, 2, 3], cfg.TPU.L0_CAPACITY_FRACTION,
                        cfg.TPU.LEVEL_CAPACITY_FRACTIONS)
    b = collate_padded([ds[0]], 1, 1024, H, W, slot_pool=spec)
    assert b["gslot_overflow"] == 0
    return cfg, b


def _random_stats(tree, rng):
    return {k: _random_stats(v, rng) if isinstance(v, dict) else
            ((0.2 * rng.randn(*v.shape)) if k == "mean"
             else (0.5 + rng.rand(*v.shape))).astype(np.float32)
            for k, v in tree.items()}


def _run_both(cfg, batch, fusion, jdt, tdt):
    jb = _device_batch(batch)
    jm = JFT(fusion=fusion, compute_dtype=jdt, **KW)
    variables = jax.jit(lambda b: jm.init(
        jax.random.PRNGKey(7), b, _hier_from_cfg(cfg, b), train=False))(jb)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = _random_stats(jax.tree_util.tree_map(
        np.asarray, variables["batch_stats"]), np.random.RandomState(1))
    want = jax.jit(lambda p, s, b: jm.apply(
        {"params": p, "batch_stats": s}, b, _hier_from_cfg(cfg, b),
        train=False))(params, stats, jb)
    tm = load_jax_variables(TFT(fusion=fusion, compute_dtype=tdt, **KW),
                            params, stats).eval()
    tb = device_batch(batch, "cpu")
    with torch.no_grad():
        got = tm(tb, hier_from_cfg(cfg, tb))
    assert want.keys() == got.keys()
    return {k: (np.asarray(want[k]), got[k].numpy()) for k in want}


@pytest.mark.parametrize("fusion", ["middle", "early"])
def test_fusion_model_f32_matches_jax(batch, fusion):
    cfg, b = batch
    outs = _run_both(cfg, b, fusion, jnp.float32, torch.float32)
    assert len(outs) == 4
    for k, (want, got) in outs.items():
        assert np.abs(want).max() > 1e-2, k          # not a trivial zero
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3, err_msg=k)


def test_middle_fusion_bf16_matches_jax(batch):
    cfg, b = batch
    for k, (want, got) in _run_both(cfg, b, "middle", jnp.bfloat16,
                                    torch.bfloat16).items():
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, err_msg=k)


def test_masked_batchnorm_train_matches_jax():
    """Train mode: statistics over the valid rows only, biased variance for
    the running update; eval mode reads the running statistics."""
    rs = np.random.RandomState(0)
    x = rs.randn(64, 6).astype(np.float32)
    mask = rs.rand(64) < 0.7
    jbn = JBN()
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                 False)
    params = {"scale": np.float32(1.5) + rs.rand(6).astype(np.float32),
              "bias": rs.randn(6).astype(np.float32)}
    stats = {"mean": rs.randn(6).astype(np.float32),
             "var": (0.5 + rs.rand(6)).astype(np.float32)}
    y, upd = jbn.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), jnp.asarray(mask), True,
                       mutable=["batch_stats"])
    bn = load_jax_variables(MaskedBatchNorm(6), params, stats).train()
    got = bn(torch.as_tensor(x), torch.as_tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-6, atol=1e-6)
    assert v["batch_stats"]["var"].shape == (6,)
    y_eval = jbn.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), jnp.asarray(mask), False)
    bn_eval = load_jax_variables(MaskedBatchNorm(6), params, stats).eval()
    np.testing.assert_allclose(
        bn_eval(torch.as_tensor(x), torch.as_tensor(mask)).detach().numpy(),
        np.asarray(y_eval), rtol=1e-6, atol=1e-6)
