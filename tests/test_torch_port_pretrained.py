"""``MODEL.IMAGE_PRETRAINED_PATH`` in the port against the JAX package, and the
config keys the port does not honour yet.

A seeded timm/DeiT-layout state_dict (12 blocks, the depth the JAX loader
converts, at a small width) is written with ``torch.save``, once as a timm
dump and once as a SimCLR checkpoint with the ``backbone.`` prefix.  Both
packages load it into the same middle-fusion model; every ViT leaf must be
equal, and the logits must agree within the f32 bound of ``PARITY.md``
(max-abs 2e-3).  Nothing is downloaded.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusiontransformer_tpu.config.defaults import get_default_cfg as j_cfg
from fusiontransformer_tpu.models.build import maybe_load_pretrained_image
from fusiontransformer_tpu.models.fusion import FusionTransformerBase as JFT
from fusiontransformer_tpu.modules.steps import (_device_batch,
                                                 _hier_from_cfg)
from fusiontransformer_tpu.utils.torch_convert import (load_pretrained_vit,
                                                       merge_params)
from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
from fusiontransformer_tpu_torch.data.collate import collate_padded
from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
from fusiontransformer_tpu_torch.models.fusion import (FusionTransformerBase
                                                       as TFT)
from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
    UNPORTED_KEYS, SemanticTrainer)
from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                       hier_from_cfg)
from fusiontransformer_tpu_torch.ops.host_slots import SlotPoolSpec
from fusiontransformer_tpu_torch.utils.convert_jax import load_jax_variables
from fusiontransformer_tpu_torch.utils.torch_checkpoint import (
    load_pretrained_image)

from test_torch_port_common import H, W, tiny_cfg
from test_torch_port_trainer import trainer_cfg

DEPTH, DIM, HEADS, IMG, PATCH = 12, 32, 2, 32, 16
KW = dict(num_classes=20, dual_head=True, middle_feat_block=0,
          late_feat_block=1, cr=0.25, image_height=H, image_width=W,
          vit_img_size=IMG, vit_patch=PATCH, vit_embed_dim=DIM,
          vit_depth=DEPTH, vit_heads=HEADS)


def deit_state_dict(seed=0):
    """A timm ``deit_*_distilled`` state_dict at width DIM: the ViT's
    tensors plus the final norm and the two heads, which no loader reads."""
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy((0.05 * rng.randn(*shape)).astype(np.float32))

    n = (IMG // PATCH) ** 2 + 2
    sd = {"patch_embed.proj.weight": t(DIM, 3, PATCH, PATCH),
          "patch_embed.proj.bias": t(DIM), "cls_token": t(1, 1, DIM),
          "dist_token": t(1, 1, DIM), "pos_embed": t(1, n, DIM),
          "norm.weight": t(DIM), "norm.bias": t(DIM),
          "head.weight": t(1000, DIM), "head.bias": t(1000),
          "head_dist.weight": t(1000, DIM), "head_dist.bias": t(1000)}
    for i in range(DEPTH):
        b = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            sd[b + norm + ".weight"] = 1 + t(DIM)
            sd[b + norm + ".bias"] = t(DIM)
        for name, (o, k) in {"attn.qkv": (3 * DIM, DIM),
                             "attn.proj": (DIM, DIM),
                             "mlp.fc1": (4 * DIM, DIM),
                             "mlp.fc2": (DIM, 4 * DIM)}.items():
            sd[b + name + ".weight"] = t(o, k)
            sd[b + name + ".bias"] = t(o)
    return sd


@pytest.fixture(scope="module", params=["timm", "simclr"])
def checkpoint(request, tmp_path_factory):
    sd = deit_state_dict()
    if request.param == "simclr":
        sd = {**{f"backbone.{k}": v for k, v in sd.items()},
              "projector.0.weight": torch.zeros(8, DIM)}
    path = tmp_path_factory.mktemp("pretrained") / f"{request.param}.pth"
    torch.save({"state_dict": sd}, path)
    return request.param, str(path)


@pytest.fixture(scope="module")
def batch():
    cfg = tiny_cfg(get_default_cfg)
    ds = SyntheticSCN(split=("val",), num_scans=1, num_points=900,
                      image_height=H, image_width=W)
    spec = SlotPoolSpec([0, 1, 2, 3], cfg.TPU.L0_CAPACITY_FRACTION,
                        cfg.TPU.LEVEL_CAPACITY_FRACTIONS)
    b = collate_padded([ds[0]], 1, 1024, H, W, slot_pool=spec)
    return cfg, b


def _with_path(get_cfg, path):
    cfg = get_cfg()
    cfg.MODEL.IMAGE_PRETRAINED_PATH = path
    cfg.freeze()
    return cfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_pretrained(kind, path, params):
    """JAX's loader on ``params`` (numpy trees) in place.  The trainer's entry
    point reads the ``backbone.``-prefixed SimCLR layout only: it keeps just
    the keys holding the prefix, so a plain timm dump gives it no
    ``patch_embed``; that layout goes through ``load_pretrained_vit``,
    which tries it as it is first."""
    if kind == "simclr":
        return maybe_load_pretrained_image(_with_path(j_cfg, path), params)
    with pytest.raises(KeyError, match="patch_embed"):
        maybe_load_pretrained_image(_with_path(j_cfg, path),
                                    copy.deepcopy(params))
    return merge_params(params["image_backbone"]["backbone"],
                        load_pretrained_vit(path))


def test_pretrained_vit_matches_jax(checkpoint, batch):
    kind, path = checkpoint
    cfg, b = batch
    jb = _device_batch(b)
    jm = JFT(fusion="middle", compute_dtype=jnp.float32, **KW)
    variables = jax.jit(lambda x: jm.init(
        jax.random.PRNGKey(7), x, _hier_from_cfg(cfg, x), train=False))(jb)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    tm = load_jax_variables(TFT(fusion="middle", compute_dtype=torch.float32,
                                **KW), params, stats).eval()
    before = {k: v.clone() for k, v in tm.state_dict().items()}

    n_jax = _jax_pretrained(kind, path, params)
    n_port = load_pretrained_image(_with_path(get_default_cfg, path), tm)
    assert n_port == n_jax == 5 + 12 * DEPTH

    # Every ViT leaf equal; nothing outside the ViT moved.
    port = tm.state_dict()
    vit = _flat(params["image_backbone"]["backbone"])
    assert len(vit) == n_port
    for k, want in vit.items():
        got = port[f"image_backbone.backbone.{k}"].numpy()
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k, t in port.items():
        if not k.startswith("image_backbone.backbone."):
            assert torch.equal(t, before[k]), k

    want = jax.jit(lambda p, x: jm.apply(
        {"params": p, "batch_stats": stats}, x, _hier_from_cfg(cfg, x),
        train=False))(params, jb)
    tb = device_batch(b, "cpu")
    with torch.no_grad():
        got = tm(tb, hier_from_cfg(cfg, tb))
    assert want.keys() == got.keys()
    for k in want:
        w = np.asarray(want[k])
        assert np.abs(w).max() > 1e-2, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=2e-3,
                                   err_msg=k)


def test_trainer_loads_the_pretrained_vit(checkpoint, tmp_path):
    """The port's trainer loads the file where it builds its model, as the
    JAX trainer does after ``init_train_state``."""
    _, path = checkpoint
    cfg = trainer_cfg(tmp_path, **{"MODEL.VIT_DEPTH": DEPTH,
                                   "MODEL.VIT_EMBED_DIM": DIM,
                                   "MODEL.VIT_HEADS": HEADS,
                                   "MODEL.IMAGE_PRETRAINED_PATH": path})
    tr = SemanticTrainer(cfg, str(tmp_path), device="cpu")
    vit = tr.model.image_backbone.backbone
    sd = deit_state_dict()
    assert torch.equal(vit.block7.mlp.fc1.kernel,
                       sd["blocks.7.mlp.fc1.weight"].t())
    assert torch.equal(vit.patch_embed.kernel,
                       sd["patch_embed.proj.weight"].permute(2, 3, 1, 0)
                       .reshape(-1, DIM))
    assert torch.equal(vit.dist_token, sd["dist_token"])


@pytest.mark.parametrize("broken", ["no block", "shape", "depth"])
def test_a_checkpoint_that_does_not_fit_raises(tmp_path, broken):
    sd = deit_state_dict()
    if broken == "no block":
        del sd["blocks.3.attn.qkv.weight"]
    elif broken == "shape":
        sd["pos_embed"] = torch.zeros(1, 7, DIM)
    else:
        sd = {k: v for k, v in sd.items() if not k.startswith("blocks.11.")}
    path = tmp_path / "bad.pth"
    torch.save(sd, path)
    tm = TFT(fusion="middle", compute_dtype=torch.float32, **KW)
    err = KeyError if broken == "no block" else ValueError
    with pytest.raises(err, match="qkv" if broken == "no block" else ""):
        load_pretrained_image(_with_path(get_default_cfg, str(path)), tm)


@pytest.mark.parametrize("key,value", [
    ("TRAIN.SUMMARY_PERIOD", 10), ("TRAIN.LOG_HISTOGRAM", True),
    ("TPU.NUM_DEVICES", 4), ("TPU.MODEL_PARALLEL", 2),
    ("TPU.ZERO_OPTIMIZER", True), ("TPU.REMAT_VIT", True)])
def test_keys_the_port_does_not_honour_raise(key, value):
    assert key in {k for k, _, _ in UNPORTED_KEYS}
    cfg = tiny_cfg(get_default_cfg)
    cfg.defrost()
    cfg.merge_from_list([key, value])
    cfg.freeze()
    with pytest.raises(NotImplementedError, match=f"{key}.*ROADMAP.md"):
        SemanticTrainer(cfg, "", device="cpu")
