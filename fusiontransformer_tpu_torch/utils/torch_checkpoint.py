"""Load a pretrained DeiT image backbone (``MODEL.IMAGE_PRETRAINED_PATH``).

Port of ``load_torch_state_dict``, ``convert_deit_to_vit2d`` and
``load_pretrained_vit`` of ``fusiontransformer_tpu/utils/torch_convert.py``
and of ``models/build.py::maybe_load_pretrained_image``.  The checkpoint is a
torch state_dict in timm's DeiT(-distilled) layout, or a SimCLR backbone
with a ``backbone.`` prefix (the prefix is stripped when no ``patch_embed*``
key is present).  The port's ``models/vit.py::VisionTransformer2D`` keeps
the flax names and layouts, so the mapping is the JAX one:

* a torch Linear weight ``[out, in]`` becomes a ``kernel`` ``[in, out]``;
* the patch-embed conv ``[D, C, ph, pw]`` becomes ``[(ph, pw, C), D]``, the
  HWC patch flattening of the ViT's forward;
* LayerNorm ``weight`` becomes ``scale``.

Every tensor the ViT needs must be in the checkpoint (``dist_token`` may be
missing, as in a plain DeiT; the ViT keeps its own then), with the ViT's
shapes and depth; otherwise this raises.
"""

from __future__ import annotations

import torch

from fusiontransformer_tpu_torch.models.vit import VisionTransformer2D


def load_state_dict_tensors(path, strip_prefix=None):
    """``{key: tensor}`` of a torch checkpoint on the CPU: the payload's
    ``state_dict`` or ``model`` entry where it nests one, its tensors only;
    with ``strip_prefix``, only the keys holding it, the prefix removed.
    The file is read with ``weights_only`` (tensors and plain containers):
    unpickling anything else could run code from the file."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "state_dict" in payload:
        payload = payload["state_dict"]
    if isinstance(payload, dict) and "model" in payload and not any(
            torch.is_tensor(v) for v in payload.values()):
        payload = payload["model"]
    out = {}
    for k, v in payload.items():
        if strip_prefix:
            if strip_prefix not in k:
                continue
            k = k.replace(strip_prefix, "")
        if torch.is_tensor(v):
            out[k] = v.detach()
    return out


def convert_deit(sd, depth):
    """The port's ViT state_dict entries (``VisionTransformer2D`` keys) from a
    timm DeiT state_dict ``sd`` with ``depth`` blocks."""
    w = sd["patch_embed.proj.weight"]                    # [D, C, ph, pw]
    out = {"patch_embed.kernel": w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]),
           "patch_embed.bias": sd["patch_embed.proj.bias"],
           "cls_token": sd["cls_token"], "pos_embed": sd["pos_embed"]}
    if "dist_token" in sd:
        out["dist_token"] = sd["dist_token"]
    for i in range(depth):
        b = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            out[f"block{i}.{norm}.scale"] = sd[f"{b}{norm}.weight"]
            out[f"block{i}.{norm}.bias"] = sd[f"{b}{norm}.bias"]
        for lin in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            out[f"block{i}.{lin}.kernel"] = sd[f"{b}{lin}.weight"].t()
            out[f"block{i}.{lin}.bias"] = sd[f"{b}{lin}.bias"]
    return out


def load_pretrained_vit(vit, path):
    """Copy the DeiT / SimCLR checkpoint at ``path`` into ``vit`` (a
    ``VisionTransformer2D``) in place; returns the count of tensors
    replaced.  Raises ``KeyError`` for a tensor the ViT needs that the
    checkpoint lacks, ``ValueError`` for a shape or depth that differs."""
    sd = load_state_dict_tensors(path)
    if not any(k.startswith("patch_embed") for k in sd):
        sd = load_state_dict_tensors(path, strip_prefix="backbone.")
    blocks = {int(k.split(".")[1]) for k in sd if k.startswith("blocks.")}
    if blocks and max(blocks) + 1 != vit.depth:
        raise ValueError(f"{path}: {max(blocks) + 1} ViT blocks, the model "
                         f"has {vit.depth}")
    try:
        new = convert_deit(sd, vit.depth)
    except KeyError as e:
        raise KeyError(f"{path}: no tensor {e} for the ViT") from None
    state = vit.state_dict()
    for k, t in new.items():
        if tuple(t.shape) != tuple(state[k].shape):
            raise ValueError(f"{path}: {k} has shape {tuple(t.shape)}, the "
                             f"ViT's is {tuple(state[k].shape)}")
    with torch.no_grad():
        for k, t in new.items():
            state[k].copy_(t.to(state[k].dtype))
    return len(new)


def load_pretrained_image(cfg, model):
    """``MODEL.IMAGE_PRETRAINED_PATH`` into the ViT of ``model``'s image
    stream (``model.image_backbone.backbone``), as the JAX trainer loads it
    into ``params["image_backbone"]["backbone"]``; returns the count of
    tensors replaced (0 when no path is set)."""
    path = cfg.MODEL.IMAGE_PRETRAINED_PATH
    if not path:
        return 0
    vit = getattr(getattr(model, "image_backbone", model), "backbone", None)
    if not isinstance(vit, VisionTransformer2D):
        raise ValueError(f"MODEL.IMAGE_PRETRAINED_PATH is set, but "
                         f"{type(model).__name__} has no ViT image backbone")
    return load_pretrained_vit(vit, path)
