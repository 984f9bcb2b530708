#!/usr/bin/env python
"""Export ahead-of-time serving artifacts of the port: one ``torch.export``
program per capacity bucket (the counterpart of ``tools/export_model.py``).

    python -m fusiontransformer_tpu_torch.tools.export_model \\
        --cfg configs/semantic_kitti/middlefusion.yaml --ckpt model.pth \\
        --out export_dir [--batch 1] [--device cpu] [KEY VALUE ...]

The directory is read by ``InferenceEngine(cfg, ..., exported_dir=...)``
or ``tools/serve.py --exported-dir``.  Weights are not baked in (the
programs take them as an argument), so one artifact serves every
checkpoint of the config; ``--ckpt`` (a checkpoint of the port's trainer)
or, without it, random weights from ``RNG_SEED`` only give the export its
model.  Exports on the CUDA card unless ``--device cpu`` is given; an
artifact serves on the device type it was exported on.  Prints the
manifest, with each bucket's export seconds and bytes under ``stats``.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="export the predict programs "
                                "(PyTorch/CUDA port)")
    p.add_argument("--cfg", required=True, help="config file path")
    p.add_argument("--ckpt", default="", help="checkpoint of the port's "
                   "trainer (empty: random weights from RNG_SEED)")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--batch", type=int, default=1, help="device batch size")
    p.add_argument("--device", default=None,
                   help="'cpu' to export for the CPU; the CUDA card "
                   "otherwise")
    p.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.serving.export import export_predict
    from fusiontransformer_tpu_torch.train import load_cfg
    from fusiontransformer_tpu_torch.utils.checkpoint import Checkpointer

    cfg = load_cfg(args.cfg, args.opts)
    model = build_model(cfg, args.device, seed=cfg.RNG_SEED)
    if args.ckpt:
        model.load_state_dict(Checkpointer().load(args.ckpt,
                                                  resume=False)["model"])
    else:
        print("WARNING: no --ckpt, exporting with random weights",
              file=sys.stderr)
    manifest = export_predict(cfg, model, args.out, batch_size=args.batch,
                              device=args.device)
    print(json.dumps(manifest, indent=2))
    return manifest


if __name__ == "__main__":
    main()
