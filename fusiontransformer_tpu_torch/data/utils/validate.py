"""Validation: devoxelization of per-voxel predictions back to raw points
(``map_sparse_to_org``) and the eval loop (``validate``), ported from
``fusiontransformer_tpu/data/utils/validate.py``.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from fusiontransformer_tpu_torch.data.utils.evaluate import Evaluator



def predictions(cfg):
    """``[(modality, result key), ...]`` of the config's model, in the JAX
    package's order: 2D with the image stream, 3D with the 3D stream, and
    the 2D+3D ensemble for a fusion model."""
    m = cfg.MODEL
    return [(mod, key) for use, mod, key in (
        (m.USE_IMAGE, "2D", "pred_2d"), (m.USE_LIDAR, "3D", "pred_3d"),
        (m.USE_FUSION, "2D+3D", "pred_ensemble")) if use]


def map_sparse_to_org(x, inverse_map):
    """Devoxelize per-voxel values back to original points.

    Voxels beyond ``len(x)`` were dropped by the static point capacity; their
    points get class 0, the ignore id, and are counted.
    """
    oob = inverse_map >= len(x)
    n_oob = int(oob.sum())
    if n_oob:
        out = x[np.where(oob, 0, inverse_map)]
        out[oob] = 0
        return out, n_oob
    return x[inverse_map], 0


def validate(cfg, run_batch, dataloader, val_metric_logger, log_tables=True,
             logger_name=None):
    """Eval loop: per-class IoU on the original points of each prediction
    the config's model makes (``predictions``: 2D, 3D and for a fusion
    model the 2D+3D ensemble; ``fusiontransformer_tpu/data/utils/
    validate.py``), with the dataset's inverse label map applied to
    predictions and labels (raw SemanticKITTI ids; ``map_inverse_label``
    None keeps the training ids).

    ``run_batch(host_batch)`` enqueues the eval step on one collated batch
    and returns its results (the ``pred_*`` keys of ``predictions`` and the
    present streams' ``seg_loss_2d`` / ``seg_loss_3d``) on their way to
    the host: a
    ``modules.steps.Readback``, whose ``numpy()`` waits for them.  Batch k
    is read and scored after batch k+1 has been enqueued, so the card runs
    one batch while the host scores the one before (the JAX package's
    ``consume``).  Returns ``[(modality, Evaluator), ...]``.
    """
    logger = logging.getLogger(
        logger_name or f"FusionTransformer.{cfg['MODEL']['TYPE']}.validate")
    logger.info("Validation")
    dataset = dataloader.dataset
    inverse_label = dataset.map_inverse_label
    preds = predictions(cfg)
    evaluators = {key: Evaluator(dataset.class_names, dataset.class_labels)
                  for _, key in preds}
    totals = {"dropped": 0, "oob": 0, "points": 0}

    def consume(readback, batch, data_time, end, dispatched):
        wait = time.time()
        res = readback.numpy()
        # This batch's own span: host work up to its dispatch, then the wait
        # for its results (not the next batch's load, which came between).
        batch_time = (dispatched - end) + (time.time() - wait)
        scan_count = batch["scan_count"]
        cap = len(batch["pt_valid"]) // len(scan_count)
        for i, n_pts in enumerate(scan_count):
            if n_pts == 0:
                continue
            sl = slice(i * cap, i * cap + n_pts)
            inverse_map = batch["inverse_map"][i]
            kept = np.asarray(batch["sparse_orig_points_idx"][i])
            seg_label = np.asarray(batch["orig_seg_label"][i])
            gt = seg_label[kept] if kept.dtype == bool else seg_label
            if inverse_label is not None:
                gt = inverse_label(gt)
            totals["points"] += len(inverse_map)
            for key, ev in evaluators.items():
                pred, n_oob = map_sparse_to_org(res[key][sl], inverse_map)
                totals["oob"] += n_oob
                if inverse_label is not None:
                    pred = inverse_label(pred)
                ev.update(pred, gt.copy())
        val_metric_logger.update(time=batch_time, data=data_time, **{
            k: float(res[k]) for k in ("seg_loss_3d", "seg_loss_2d")
            if k in res})

    pending = None
    end = time.time()
    for batch in dataloader:
        data_time = time.time() - end
        totals["dropped"] += int(batch.get("num_dropped", 0))
        readback = run_batch(batch)
        dispatched = time.time()
        if pending is not None:
            consume(*pending)
        pending = (readback, batch, data_time, end, dispatched)
        end = time.time()
    if pending is not None:
        consume(*pending)

    dropped, oob = totals["dropped"], totals["oob"] // len(evaluators)
    logger.info("capacity overflow: %d points dropped at collate, %d points "
                "scored as class 0 via out-of-bounds inverse map (of %d "
                "evaluated)", dropped, oob, totals["points"])
    if dropped or oob:
        logger.warning("TPU.POINT_CAPACITY / CAPACITY_BUCKETS undersized for "
                       "this dataset: %d+%d points lost", dropped, oob)
    val_metric_logger.update(collate_dropped=dropped, oob_points=oob)
    val_metric_logger.update(**{
        f"seg_iou_{key[-2:]}": evaluators[key].overall_iou
        for key in ("pred_2d", "pred_3d") if key in evaluators})
    eval_list = [(modality, evaluators[key]) for modality, key in preds]
    for modality, evaluator in (eval_list if log_tables else []):
        logger.info("%s overall accuracy=%.2f%%", modality,
                    100.0 * evaluator.overall_acc)
        logger.info("%s overall IOU=%.2f", modality,
                    100.0 * evaluator.overall_iou)
        logger.info("%s class-wise segmentation accuracy and IoU.\n%s",
                    modality, evaluator.print_table())
    return eval_list
