"""Validation: devoxelization of per-voxel predictions back to raw points
(``map_sparse_to_org``) and the eval loop (``validate``), ported from
``fusiontransformer_tpu/data/utils/validate.py``.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from fusiontransformer_tpu_torch.data.utils.evaluate import Evaluator


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


def validate(cfg, run_batch, dataloader, val_metric_logger, log_tables=True):
    """Eval loop: per-class IoU of the 2D, 3D and 2D+3D ensemble predictions
    on the original points (``fusiontransformer_tpu/data/utils/validate.py``
    for the fusion models).

    ``run_batch(host_batch)`` returns the eval step's results
    (``pred_2d``, ``pred_3d``, ``pred_ensemble``, ``seg_loss_2d``,
    ``seg_loss_3d``) for one collated batch, as numpy arrays.  Returns
    ``[(modality, Evaluator), ...]``.
    """
    logger = logging.getLogger(
        f"FusionTransformer.{cfg['MODEL']['TYPE']}.validate")
    logger.info("Validation")
    dataset = dataloader.dataset
    evaluators = {k: Evaluator(dataset.class_names, dataset.class_labels)
                  for k in ("pred_2d", "pred_3d", "pred_ensemble")}
    total_dropped = total_oob = total_points = 0
    end = time.time()
    for batch in dataloader:
        data_time = time.time() - end
        total_dropped += int(batch.get("num_dropped", 0))
        res = run_batch(batch)
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
            total_points += len(inverse_map)
            for key, ev in evaluators.items():
                pred, n_oob = map_sparse_to_org(res[key][sl], inverse_map)
                total_oob += n_oob
                ev.update(pred, gt.copy())
        val_metric_logger.update(time=time.time() - end, data=data_time,
                                 seg_loss_3d=float(res["seg_loss_3d"]),
                                 seg_loss_2d=float(res["seg_loss_2d"]))
        end = time.time()

    oob = total_oob // len(evaluators)
    logger.info("capacity overflow: %d points dropped at collate, %d points "
                "scored as class 0 via out-of-bounds inverse map (of %d "
                "evaluated)", total_dropped, oob, total_points)
    if total_dropped or oob:
        logger.warning("TPU.POINT_CAPACITY / CAPACITY_BUCKETS undersized for "
                       "this dataset: %d+%d points lost", total_dropped, oob)
    val_metric_logger.update(collate_dropped=total_dropped, oob_points=oob)
    val_metric_logger.update(seg_iou_2d=evaluators["pred_2d"].overall_iou,
                             seg_iou_3d=evaluators["pred_3d"].overall_iou)
    eval_list = [("2D", evaluators["pred_2d"]), ("3D", evaluators["pred_3d"]),
                 ("2D+3D", evaluators["pred_ensemble"])]
    for modality, evaluator in (eval_list if log_tables else []):
        logger.info("%s overall accuracy=%.2f%%", modality,
                    100.0 * evaluator.overall_acc)
        logger.info("%s overall IOU=%.2f", modality,
                    100.0 * evaluator.overall_iou)
        logger.info("%s class-wise segmentation accuracy and IoU.\n%s",
                    modality, evaluator.print_table())
    return eval_list
