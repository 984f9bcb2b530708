"""Inference engine: a resident model that answers per-scan requests.

Port of ``fusiontransformer_tpu/serving/engine.py`` for one device:

* ``preprocess`` — the dataloader's eval-time voxelisation of a raw record
  (``points`` [N, 3], ``feats`` [N, <=4], ``img`` HWC, ``points_img``
  [N, 2] row/col);
* ``dispatch_samples`` — ``collate_padded`` into the smallest capacity
  bucket, with host-built group-pooled slot maps when ``TPU.CONV_SLOT_POOL``
  is on, then the predict step on the device;
* the predict step (``make_predict_step``) — hierarchy + slot maps -> model
  -> per-point argmax of each stream and of the sum of the 2D and 3D
  softmaxes, packed with the ``voxel_overflow`` health count into one int32
  array, so each batch needs one device->host copy;
* ``complete`` — de-voxelise the predictions back to every raw point
  (out-of-frustum and capacity-dropped points get class 0, the ignore id).

The engine runs on the card unless it is given ``device="cpu"``; with no
CUDA device and no explicit CPU it raises.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fusiontransformer_tpu_torch.data.collate import collate_padded
from fusiontransformer_tpu_torch.data.quantize import sparse_quantize
from fusiontransformer_tpu_torch.data.utils.augmentation_3d import (
    augment_and_scale_3d)
from fusiontransformer_tpu_torch.data.utils.validate import map_sparse_to_org
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.modules.steps import (device_batch,
                                                       hier_from_cfg)
from fusiontransformer_tpu_torch.ops.host_slots import SlotPoolSpec
from fusiontransformer_tpu_torch.utils.device import resolve_device

PRED_KEYS = ("pred", "pred_2d", "pred_3d", "voxel_overflow")


def make_predict_step(cfg, model):
    """Labels-only predict step: ``(step, keys)``; ``step(batch)`` returns
    one [N, len(keys)] int32 tensor whose columns are ``keys``."""

    def step(batch):
        with torch.inference_mode():
            hier = hier_from_cfg(cfg, batch)
            out = model(batch, hier)
            lidar, img = out["lidar_seg_logit"], out["img_seg_logit"]
            probs = torch.softmax(img, -1) + torch.softmax(lidar, -1)
            overflow = sum((l.nvalid_raw - l.valid.shape[0]).clamp(min=0)
                           for l in hier.levels)
            pred = torch.argmax(probs, -1)
            cols = [pred, torch.argmax(img, -1), torch.argmax(lidar, -1),
                    overflow.expand(pred.shape)]
            return torch.stack([c.to(torch.int32) for c in cols], dim=1)

    return step, list(PRED_KEYS)


class InferenceEngine:
    """Owns the model and answers requests, one batch at a time.

    ``model``: a built model (e.g. with weights loaded by
    ``utils.convert_jax.load_jax_variables``); by default one is built from
    ``cfg`` with random weights from ``seed``.  Thread-safe for concurrent
    ``predict`` calls: the device step runs under a lock, host
    preprocessing outside it.
    """

    def __init__(self, cfg, model=None, batch_size: int = 1, device=None,
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        if model is None:
            model = build_model(cfg, self.device, seed)
        self.model = model.to(self.device).eval()

        ds = cfg.DATASET.get(cfg.DATASET.TYPE, {})
        self.scale = ds.get("scale", 20)
        self.full_scale = ds.get("full_scale", 4096)
        self.image_height = ds.get("image_height", 370)
        self.image_width = ds.get("image_width", 1226)
        self.image_normalizer = ds.get("image_normalizer", None)
        self.buckets = tuple(sorted(cfg.TPU.CAPACITY_BUCKETS)) or (
            cfg.TPU.POINT_CAPACITY,)
        self.point_capacity = max(self.buckets)
        self._step, self._pred_keys = make_predict_step(cfg, self.model)

        # Host-built group-pooled slot maps at the levels CONV_TAP_SLOTS
        # names.
        self._slot_pool = None
        if cfg.TPU.CONV_SLOT_POOL and any(cfg.TPU.CONV_TAP_SLOTS):
            self._slot_pool = SlotPoolSpec(
                [l for l, k in enumerate(cfg.TPU.CONV_TAP_SLOTS) if k],
                cfg.TPU.L0_CAPACITY_FRACTION,
                cfg.TPU.LEVEL_CAPACITY_FRACTIONS,
                quantum=int(cfg.TPU.SLOT_POOL_QUANTUM))
        self._device_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.counters = {
            "scans": 0, "batches": 0, "collate_dropped_points": 0,
            "oob_points": 0, "voxel_overflow": 0,
            "bucket_hits": {int(b): 0 for b in self.buckets},
        }

    # ------------------------------------------------------------------ #
    def preprocess(self, record: Dict) -> Dict:
        """Eval-time voxelisation of one raw record (no augmentation)."""
        points = np.asarray(record["points"], np.float32)
        n = len(points)
        feats = record.get("feats")
        if feats is None:
            feats = points
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 1:
            feats = feats[:, None]

        img = np.asarray(record["img"])
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img[:self.image_height, :self.image_width].astype(np.float32)
        if self.image_normalizer:
            mean, std = self.image_normalizer
            img = (img - np.asarray(mean, np.float32)) / np.asarray(
                std, np.float32)
        points_img = np.asarray(record["points_img"]).astype(np.int64)
        np.clip(points_img[:, 0], 0, self.image_height - 1,
                out=points_img[:, 0])
        np.clip(points_img[:, 1], 0, self.image_width - 1,
                out=points_img[:, 1])

        coords = augment_and_scale_3d(points, self.scale).astype(np.int64)
        keep = (coords.min(1) >= 0) & (coords.max(1) < self.full_scale)
        vox_coords = coords[keep]
        uniq, inverse = sparse_quantize(vox_coords)
        return {
            "coords": vox_coords[uniq].astype(np.int32),
            "feats": feats[keep][uniq].astype(np.float32),
            "seg_label": np.zeros(len(uniq), np.int32),
            "img_indices": points_img[keep][uniq].astype(np.int32),
            "img": img,
            "orig_seg_label": np.zeros(n, np.int32),
            "sparse_orig_points_idx": keep,
            "inverse_map": inverse,
            "num_input_points": n,
        }

    # ------------------------------------------------------------------ #
    def predict(self, record: Dict) -> Dict:
        return self.predict_batch([record])[0]

    def predict_batch(self, records: Sequence[Dict]) -> List[Dict]:
        return self.run_samples([self.preprocess(r) for r in records])

    def run_samples(self, samples: List[Dict],
                    count_stats: bool = True) -> List[Dict]:
        return self.complete(self.dispatch_samples(samples),
                             count_stats=count_stats)

    def collate(self, samples: List[Dict]) -> Dict:
        """Padded host batch of already-preprocessed samples."""
        if not 0 < len(samples) <= self.batch_size:
            raise ValueError(f"need 1..{self.batch_size} samples, "
                             f"got {len(samples)}")
        return collate_padded(
            samples, self.batch_size, self.point_capacity,
            self.image_height, self.image_width, capacity_buckets=self.buckets, slot_pool=self._slot_pool)

    def dispatch_samples(self, samples: List[Dict]):
        """Collate and enqueue the device step; returns a handle for
        ``complete``."""
        batch = self.collate(samples)
        with self._device_lock:
            packed = self._step(device_batch(batch, self.device))
        return samples, batch, packed

    def forward(self, samples: List[Dict]):
        """The model's raw outputs (logit tensors on the device) for
        already-preprocessed samples, with the host batch they came from."""
        batch = self.collate(samples)
        with self._device_lock, torch.inference_mode():
            db = device_batch(batch, self.device)
            out = self.model(db, hier_from_cfg(self.cfg, db))
        return batch, out

    def complete(self, handle, count_stats: bool = True) -> List[Dict]:
        """One device->host copy, then de-voxelise per scan."""
        samples, batch, packed = handle
        cap = len(batch["pt_valid"]) // self.batch_size
        packed = packed.cpu().numpy()
        res = {k: packed[:, j] for j, k in enumerate(self._pred_keys)}
        overflow = int(res.pop("voxel_overflow")[0])

        results = []
        oob_total = 0
        for i, s in enumerate(samples):
            n_vox = int(batch["scan_count"][i])
            sl = slice(i * cap, i * cap + n_vox)
            inverse_map = batch["inverse_map"][i]
            kept = batch["sparse_orig_points_idx"][i]
            out = {"in_frustum": kept, "num_voxels": n_vox}
            for key in ("pred", "pred_2d", "pred_3d"):
                pt_pred, n_oob = map_sparse_to_org(res[key][sl], inverse_map)
                if key == "pred":
                    oob_total += n_oob
                full = np.zeros(s["num_input_points"], pt_pred.dtype)
                full[kept] = pt_pred
                out["labels" if key == "pred" else
                    key.replace("pred", "labels")] = full
            results.append(out)

        if count_stats:
            with self._stats_lock:
                c = self.counters
                c["scans"] += len(samples)
                c["batches"] += 1
                c["collate_dropped_points"] += int(batch["num_dropped"])
                c["oob_points"] += oob_total
                c["voxel_overflow"] += overflow + int(
                    batch.get("gslot_overflow", 0))
                c["bucket_hits"][cap] = c["bucket_hits"].get(cap, 0) + 1
        return results

    # ------------------------------------------------------------------ #
    def warmup(self, buckets: Optional[Sequence[int]] = None
               ) -> Dict[int, float]:
        """Run every capacity bucket once at a full batch before traffic
        (the first run builds the kernels and warms the libraries).
        Returns {bucket: seconds}."""
        times = {}
        for b in (buckets or self.buckets):
            t0 = time.time()
            samples = [self._dummy_sample(int(b))
                       for _ in range(self.batch_size)]
            self.run_samples(samples, count_stats=False)
            times[int(b)] = time.time() - t0
        return times

    def _dummy_sample(self, n_points: int) -> Dict:
        """Synthetic record preprocessed to exactly fill ``n_points``."""
        rng = np.random.RandomState(0)
        side = int(np.ceil(n_points ** (1 / 3))) + 1
        grid = np.stack(np.meshgrid(*[np.arange(side)] * 3,
                                    indexing="ij"), -1).reshape(-1, 3)
        return {
            "coords": grid[:n_points].astype(np.int32),
            "feats": rng.rand(n_points, 4).astype(np.float32),
            "seg_label": np.zeros(n_points, np.int32),
            "img_indices": np.zeros((n_points, 2), np.int32),
            "img": np.zeros((self.image_height, self.image_width, 3),
                            np.float32),
            "orig_seg_label": np.zeros(n_points, np.int32),
            "sparse_orig_points_idx": np.ones(n_points, bool),
            "inverse_map": np.arange(n_points),
            "num_input_points": n_points,
        }

    def stats(self) -> Dict:
        with self._stats_lock:
            c = dict(self.counters)
            c["bucket_hits"] = dict(self.counters["bucket_hits"])
        return c
