#!/usr/bin/env python
"""Training CLI of the port (``fusiontransformer_tpu/train.py``):

    python -m fusiontransformer_tpu_torch.train --cfg configs/semantic_kitti/synthetic.yaml \\
        [--device cpu] [--run_name NAME] [KEY VALUE ...]

The '@' in OUTPUT_DIR is replaced with the config path; dotted-key overrides
merge after the file.  Trains on the CUDA card unless ``--device cpu`` is
given; with no card and no ``--device cpu`` it raises.

Data parallelism, one process per card (``modules/DistributedTrainer.py``):

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m fusiontransformer_tpu_torch.train --cfg ... --distributed 1

With ``TPU.ZERO_OPTIMIZER True`` each process keeps 1/N of the optimizer's
moments; with ``TPU.MODEL_PARALLEL m`` the processes form a (data, model)
layout whose model groups of m shard the ViT.

``--distributed 1`` or ``--use_torchpack 1`` trains, ``--use_torchpack_test
1`` scores the test split with the newest best-IoU checkpoint and dumps the
predictions (the JAX CLI's flags).  Each process takes ``cuda:LOCAL_RANK``
(gloo with ``--device cpu``); rank 0's run name is every rank's, and only
rank 0 logs INFO lines and writes the log file.
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
    parser.add_argument("--distributed", type=int, default=0,
                        help="1: train data-parallel, one process per device "
                        "(under torch.distributed.run)")
    parser.add_argument("--use_torchpack", type=int, default=0,
                        help="1: as --distributed 1 (the reference's flag)")
    parser.add_argument("--use_torchpack_test", type=int, default=0,
                        help="1: score the test split data-parallel with "
                        "the newest best-IoU checkpoint, dumping predictions")
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
    distributed = bool(args.distributed or args.use_torchpack
                       or args.use_torchpack_test)
    device, rank, run_name = args.device, 0, args.run_name
    if distributed:
        # This process's rank of torchrun's process group, on its device.
        import torch.distributed as dist

        from fusiontransformer_tpu_torch.parallel.data_parallel import (
            init_distributed)
        from fusiontransformer_tpu_torch.utils.device import resolve_device
        device = resolve_device(device)
        rank, _ = init_distributed(device)
        names = [run_name or time.strftime(
            "MONTH_%m_DAY_%d_HOUR_%H_MIN_%M_SEC_%S")]
        dist.broadcast_object_list(names, src=0)
        run_name = names[0]
    output_dir, run_name = resolve_output_dir(cfg, args.config_file,
                                              run_name)
    handlers = [logging.StreamHandler()]
    if rank == 0:
        handlers.append(logging.FileHandler(
            osp.join(output_dir, f"train.{run_name}.log")))
    logging.basicConfig(
        level=logging.INFO if rank == 0 else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        handlers=handlers)
    logging.getLogger("FusionTransformer").info(
        "output dir %s; config %s:\n%s", output_dir, args.config_file, cfg)

    if not distributed:
        from fusiontransformer_tpu_torch.modules.SemanticTrainer import (
            SemanticTrainer)
        trainer = SemanticTrainer(cfg, output_dir, run_name, device=device)
        trainer.train()
        return trainer
    from fusiontransformer_tpu_torch.modules.DistributedTrainer import (
        DistributedTrainer)
    trainer = DistributedTrainer(cfg, output_dir, run_name, device=device)
    if args.use_torchpack_test and not (args.distributed
                                        or args.use_torchpack):
        trainer.test()
    else:
        trainer.train()
    dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
