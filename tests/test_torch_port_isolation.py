"""The port stands alone: no JAX, no JAX package, no quiet CPU fallback; its
modules import Pillow only where they read or write an image."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parents[1] / "fusiontransformer_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax")


def _forbidden(module: str) -> bool:
    # ``fusiontransformer_tpu_torch`` starts with ``fusiontransformer_tpu``:
    # match the JAX package by its exact name or its ``.`` children only.
    root = module.split(".")[0]
    return root in FORBIDDEN_ROOTS or root == "fusiontransformer_tpu"


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_no_forbidden_imports_in_source():
    bad = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad
    assert not _forbidden("fusiontransformer_tpu_torch.ops.keys")
    assert _forbidden("fusiontransformer_tpu.ops.keys")


def test_importing_every_module_loads_no_jax():
    mods = _port_modules()
    assert len(mods) > 20, mods
    assert {"fusiontransformer_tpu_torch.parallel.data_parallel",
            "fusiontransformer_tpu_torch.parallel.tensor_parallel",
            "fusiontransformer_tpu_torch.parallel.zero",
            "fusiontransformer_tpu_torch.parallel.pipeline_parallel",
            "fusiontransformer_tpu_torch.modules.DistributedTrainer",
            "fusiontransformer_tpu_torch.modules.TorchpackInterface",
            "fusiontransformer_tpu_torch.modules.callbacks",
            "fusiontransformer_tpu_torch.utils.sampler"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                    'fusiontransformer_tpu', 'PIL'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(PKG.parent))
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.modules.DistributedTrainer import (
        DistributedTrainer)
    from fusiontransformer_tpu_torch.serving.engine import InferenceEngine
    from fusiontransformer_tpu_torch.tools import serve
    from fusiontransformer_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_default_cfg()
    cfg.merge_from_file(str(PKG.parent / "configs/semantic_kitti/"
                                         "middlefusion.yaml"))
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: build_model(cfg),
                 lambda: InferenceEngine(cfg),
                 lambda: InferenceEngine(cfg, batch_size=2, num_devices=2),
                 lambda: DistributedTrainer(cfg),
                 lambda: serve.main(["--cfg", str(PKG.parent / "configs/"
                                                  "semantic_kitti/"
                                                  "middlefusion.yaml"),
                                     "--selftest", "1", "--port", "0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_flagship_config_loads_unchanged_into_both_packages():
    from fusiontransformer_tpu.config.defaults import get_default_cfg as jcfg
    from fusiontransformer_tpu_torch.config.defaults import (
        get_default_cfg as tcfg)

    path = str(PKG.parent / "configs/semantic_kitti/middlefusion.yaml")
    a, b = jcfg(), tcfg()
    a.merge_from_file(path)
    b.merge_from_file(path)
    assert a.dump() == b.dump()
