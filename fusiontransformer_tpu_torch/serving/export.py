"""Ahead-of-time export of the serving predict programs (``torch.export``).

Port of ``fusiontransformer_tpu/serving/export.py``.  A deployment traces
the predict step once at release time and ships one serialized program per
capacity bucket; the server loads the programs instead of tracing Python.
Weights are not baked in: each program takes the model's ``state_dict()``
as its first argument (the model runs through
``torch.func.functional_call``), so one artifact serves every checkpoint
of the same config, and no parameter is written into it (the exported
program's example inputs are cleared before it is saved).

Layout of an export directory:

    manifest.json          shapes, buckets, model type, device type
    predict_<bucket>.pt2   one ``torch.export`` program (its archive's
                           entries deflated)

A program runs the predict step of ``serving/engine.py::make_predict_step``
on the per-voxel path: it takes no host-built ``gslot_*`` maps (their
pool size S changes from batch to batch) and builds the per-voxel K-slot
maps on the device, as the JAX package's artifacts do.  The hand-written
kernels appear in the program as the ``ftx`` custom ops
(``ops/kernels/binned_conv.py``, ``ops/kernels/segment_sum.py``), which
this module's import registers before a program is loaded.  A program
keeps the device type it was exported on (``platforms``): export on the
card to serve on the card, on the CPU to serve on the CPU.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from fusiontransformer_tpu_torch.data.collate import collate_padded
from fusiontransformer_tpu_torch.modules.steps import device_batch
# The ftx ops must be registered before a program that calls them loads.
from fusiontransformer_tpu_torch.ops.kernels import binned_conv  # noqa: F401
from fusiontransformer_tpu_torch.ops.kernels import segment_sum  # noqa: F401
from fusiontransformer_tpu_torch.utils.device import resolve_device

MANIFEST = "manifest.json"


class PredictProgram(torch.nn.Module):
    """``forward(state, batch)``: the predict step of ``make_predict_step``
    with ``model``'s weights and running statistics taken from ``state`` (a
    ``state_dict()``).  The model is not a submodule, so an export of this
    module lifts none of its tensors."""

    def __init__(self, cfg, model):
        super().__init__()
        self.cfg = cfg
        self._model = (model,)

    def forward(self, state, batch):
        from fusiontransformer_tpu_torch.serving.engine import \
            make_predict_step
        model = self._model[0]
        step, _ = make_predict_step(
            self.cfg, lambda *args: torch.func.functional_call(model, state,
                                                               args))
        return step(batch)


def example_batch(cfg, cap: int, batch_size: int, image_height: int,
                  image_width: int, device):
    """A device batch of bucket ``cap`` (no host slot maps), the input
    signature of that bucket's program."""
    from fusiontransformer_tpu_torch.serving.engine import dummy_sample
    samples = [dummy_sample(cap, image_height, image_width)
               for _ in range(batch_size)]
    host = collate_padded(samples, batch_size, cap, image_height,
                          image_width, capacity_buckets=(cap,))
    return device_batch(host, device)


def export_predict(cfg, model, out_dir: str, batch_size: int = 1,
                   device=None) -> Dict:
    """Export one predict program per capacity bucket of ``cfg`` into
    ``out_dir``; returns the manifest (with ``export_s`` and ``bytes`` per
    bucket beside it in ``stats``)."""
    import time

    from fusiontransformer_tpu_torch.serving.engine import pred_keys

    dev = resolve_device(device)
    model = model.to(dev).eval()
    os.makedirs(out_dir, exist_ok=True)
    ds = cfg.DATASET.get(cfg.DATASET.TYPE, {})
    h, w = ds.get("image_height", 370), ds.get("image_width", 1226)
    buckets = tuple(sorted(cfg.TPU.CAPACITY_BUCKETS)) or (
        cfg.TPU.POINT_CAPACITY,)
    manifest = {
        "model_type": cfg.MODEL.TYPE,
        "num_classes": int(cfg.MODEL.NUM_CLASSES),
        "batch_size": int(batch_size),
        "buckets": [int(b) for b in buckets],
        "image_height": int(h), "image_width": int(w),
        "platforms": [dev.type],
        "torch_version": torch.__version__,
        "compute_dtype": cfg.TPU.COMPUTE_DTYPE,
        "pred_keys": pred_keys(cfg),    # columns of the packed [N, K] output
        "artifacts": {},
    }
    program = PredictProgram(cfg, model)
    state = dict(model.state_dict())
    stats = {}
    for cap in buckets:
        t0 = time.perf_counter()
        batch = example_batch(cfg, int(cap), batch_size, h, w, dev)
        ep = torch.export.export(program, (state, batch), strict=False)
        if ep.state_dict:
            raise AssertionError(f"the exported program holds tensors of "
                                 f"the model: {sorted(ep.state_dict)[:5]}")
        # The example inputs hold the weights; the file must not.
        ep.example_inputs = None
        fname = f"predict_{int(cap)}.pt2"
        path = os.path.join(out_dir, fname)
        torch.export.save(ep, path)
        _deflate(path)
        manifest["artifacts"][str(int(cap))] = fname
        stats[int(cap)] = {"export_s": time.perf_counter() - t0,
                           "bytes": os.path.getsize(path)}
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return {**manifest, "stats": stats}


def _deflate(path):
    """Rewrite the archive at ``path`` with its entries deflated (the
    program's graph is JSON, ~1 kB a node, which ``torch.export.save``
    stores uncompressed; ``torch.export.load`` reads either)."""
    import zipfile
    tmp = path + ".tmp"
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(
            tmp, "w", zipfile.ZIP_DEFLATED, compresslevel=9) as dst:
        for info in src.infolist():
            dst.writestr(info.filename, src.read(info.filename))
    os.replace(tmp, path)


class ExportedPredict:
    """The programs of an export directory, loaded for ``device``:
    ``fn(state, device_batch)`` runs the program of the batch's bucket (the
    live step's call with the weights in front; ``KeyError`` for a bucket
    with no program).  An artifact exported on another device type than
    ``device``'s, or at another ``batch_size`` than one asked for, raises
    before any program loads: programs are not moved between devices."""

    def __init__(self, export_dir: str, device, batch_size=None):
        import time

        with open(os.path.join(export_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        dev = torch.device(device)
        if self.manifest["platforms"] != [dev.type]:
            raise ValueError(
                f"the artifact in {export_dir} was exported for "
                f"{self.manifest['platforms']}, not for {dev.type}: export "
                f"it on the device type it serves on")
        self.batch_size = int(self.manifest["batch_size"])
        if batch_size is not None and batch_size != self.batch_size:
            raise ValueError(f"the artifact was exported at batch "
                             f"{self.batch_size}, not {batch_size}")
        self.load_s = {}
        self._fns = {}
        for cap_s, fname in self.manifest["artifacts"].items():
            t0 = time.perf_counter()
            ep = torch.export.load(os.path.join(export_dir, fname))
            self._fns[int(cap_s)] = ep.module()
            self.load_s[int(cap_s)] = time.perf_counter() - t0

    def __call__(self, state, batch):
        cap = batch["coords"].shape[0] // self.batch_size
        if cap not in self._fns:
            raise KeyError(f"no exported program for bucket {cap} "
                           f"(have {sorted(self._fns)})")
        return self._fns[cap](state, batch)
