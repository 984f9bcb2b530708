#!/usr/bin/env python
"""Eval CLI of the port (``fusiontransformer_tpu/test.py`` for one device):

    python -m fusiontransformer_tpu_torch.test --cfg configs/semantic_kitti/middlefusion.yaml \\
        [--ckpt PATH] [--device cpu] [KEY VALUE ...]

Loads a checkpoint of the port's trainer (``--ckpt``, where '@' stands for
the output directory; without it the newest one the output directory's
manifest names) into the model of the config, runs ``validate`` over the
test split (``DATASET.TEST``, ``TEST.BATCH_SIZE``) through the eval step's
CUDA graphs (``modules/SemanticTrainer.py::StepRunner``, as the trainer
validates), and logs the per-class accuracy and IoU of the model's
predictions on the original points (2D with the image stream, 3D with the 3D
stream, 2D+3D for a fusion model), through the dataset's inverse label map.
With an output directory each of those modalities' tables is also written
there (``test_<modality>.tsv``, ``Evaluator.save_table``).  The '@' in
OUTPUT_DIR is replaced with the config path.  Runs on the CUDA card unless
``--device cpu`` is given; with no card and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="FusionTransformer test "
                                     "(PyTorch/CUDA port)")
    parser.add_argument("--cfg", dest="config_file", default="",
                        metavar="FILE", help="path to config file")
    parser.add_argument("--ckpt", default="",
                        help="checkpoint of the model ('@' = output dir)")
    parser.add_argument("--device", default=None,
                        help="'cpu' to run the plain PyTorch path; the CUDA "
                        "card otherwise")
    parser.add_argument("opts", help="config overrides: KEY VALUE ...",
                        default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def test(cfg, ckpt="", output_dir="", device=None):
    """Score the checkpoint on the test split; returns ``{"meters":
    MetricLogger, "evaluators": {modality: Evaluator}, "captures": eval
    graphs captured}``."""
    from fusiontransformer_tpu_torch.data.build import build_dataloader
    from fusiontransformer_tpu_torch.data.utils.validate import validate
    from fusiontransformer_tpu_torch.models.build import build_model
    from fusiontransformer_tpu_torch.modules.SemanticTrainer import StepRunner
    from fusiontransformer_tpu_torch.utils.checkpoint import Checkpointer
    from fusiontransformer_tpu_torch.utils.device import resolve_device
    from fusiontransformer_tpu_torch.utils.metric_logger import MetricLogger

    logger = logging.getLogger(f"FusionTransformer.{cfg.MODEL.TYPE}.test")
    device = resolve_device(device)
    model = build_model(cfg, device, seed=cfg.RNG_SEED)
    checkpointer = Checkpointer(output_dir, logger)
    if ckpt:
        payload = checkpointer.load(ckpt.replace("@", output_dir),
                                    resume=False)
    else:
        payload = checkpointer.load(None, resume=True)
    if payload:
        model.load_state_dict(payload["model"])
    runner = StepRunner(cfg, model, device, logger)
    loader = build_dataloader(cfg, mode="test")
    meters = MetricLogger(delimiter="  ")
    try:
        eval_list = validate(cfg, runner.run_eval_batch, loader, meters,
                             logger_name=logger.name)
    finally:
        loader.close()
    logger.info("Test %s", meters.summary_str)
    logger.info("eval graphs captured: %d", runner.captures["eval"])
    if output_dir:
        for modality, evaluator in eval_list:
            evaluator.save_table(osp.join(
                output_dir, f"test_{modality.replace('+', '_')}.tsv"))
    return {"meters": meters, "evaluators": dict(eval_list),
            "captures": runner.captures["eval"]}


def main(argv=None):
    args = parse_args(argv)
    from fusiontransformer_tpu_torch.train import load_cfg

    cfg = load_cfg(args.config_file, args.opts)
    output_dir = cfg.OUTPUT_DIR
    if output_dir:
        config_path = osp.splitext(args.config_file)[0]
        output_dir = output_dir.replace("@",
                                        config_path.replace("configs/", ""))
        os.makedirs(output_dir, exist_ok=True)
    handlers = [logging.StreamHandler()]
    if output_dir:
        handlers.append(logging.FileHandler(osp.join(
            output_dir, time.strftime("test.%m-%d_%H-%M-%S.log"))))
    logging.basicConfig(level=logging.INFO, handlers=handlers,
                        format="%(asctime)s %(name)s %(levelname)s: "
                        "%(message)s")
    logging.getLogger("FusionTransformer").info(
        "Loaded configuration file %s", args.config_file)
    return test(cfg, args.ckpt, output_dir, args.device)


if __name__ == "__main__":
    main()
