#!/usr/bin/env python
"""Training CLI of the port (``fusiontransformer_tpu/train.py`` for one
device):

    python -m fusiontransformer_tpu_torch.train --cfg configs/semantic_kitti/synthetic.yaml \\
        [--device cpu] [--run_name NAME] [KEY VALUE ...]

The '@' in OUTPUT_DIR is replaced with the config path; dotted-key overrides
merge after the file.  Trains on the CUDA card unless ``--device cpu`` is
given; with no card and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="FusionTransformer training "
                                     "(PyTorch/CUDA port)")
    parser.add_argument("--cfg", dest="config_file", default="",
                        metavar="FILE", help="path to config file")
    parser.add_argument("--device", default=None,
                        help="'cpu' to train with the plain PyTorch path; "
                        "the CUDA card otherwise")
    parser.add_argument("--run_name", default=None, help="name for the run")
    parser.add_argument("opts", help="config overrides: KEY VALUE ...",
                        default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def load_cfg(config_file, opts):
    from fusiontransformer_tpu_torch.config.defaults import get_default_cfg
    from fusiontransformer_tpu_torch.utils.config import purge_cfg

    cfg = get_default_cfg()
    if config_file:
        cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(opts)
    purge_cfg(cfg)
    cfg.freeze()
    return cfg


def resolve_output_dir(cfg, config_file, run_name=None):
    output_dir = cfg.OUTPUT_DIR
    if output_dir:
        config_path = osp.splitext(config_file)[0]
        output_dir = output_dir.replace("@",
                                        config_path.replace("configs/", ""))
    if run_name is None:
        run_name = time.strftime("MONTH_%m_DAY_%d_HOUR_%H_MIN_%M_SEC_%S")
    output_dir = os.path.join(output_dir, run_name)
    os.makedirs(output_dir, exist_ok=True)
    return output_dir, run_name


def main(argv=None):
    args = parse_args(argv)
    cfg = load_cfg(args.config_file, args.opts)
    output_dir, run_name = resolve_output_dir(cfg, args.config_file,
                                              args.run_name)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s: "
        "%(message)s", handlers=[
            logging.StreamHandler(),
            logging.FileHandler(osp.join(output_dir, f"train.{run_name}.log"))])
    logging.getLogger("FusionTransformer").info(
        "output dir %s; config %s:\n%s", output_dir, args.config_file, cfg)

    from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
        SemanticTrainer)
    trainer = SemanticTrainer(cfg, output_dir, run_name, device=args.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
