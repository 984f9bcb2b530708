"""Inference engine: a resident model that answers per-scan requests.

Port of ``fusiontransformer_tpu/serving/engine.py``:

* ``preprocess`` — the dataloader's eval-time voxelisation of a raw record
  (``points`` [N, 3], ``feats`` [N, <=4], ``img`` HWC, ``points_img``
  [N, 2] row/col), with the native quantize;
* ``dispatch_samples`` — ``collate_padded`` into the smallest capacity
  bucket, with host-built group-pooled slot maps when ``TPU.CONV_SLOT_POOL``
  is on, then the predict step on the device;
* the predict step (``make_predict_step``) — hierarchy + slot maps (the
  batch's group-pooled maps, or per-voxel K-slot maps built on the device
  when ``TPU.CONV_SLOT_POOL`` is off; none for an image-only model) ->
  model -> per-point argmax of each present stream and ``pred``: the
  argmax of the sum of the 2D and 3D softmaxes for a fusion model, else the
  one stream's; with the 3D stream packed with the ``voxel_overflow``
  health count (dropped voxels plus, with per-voxel maps, dropped live
  taps) into one int32 array, so each batch needs one device->host copy;
* ``complete`` — de-voxelise the predictions back to every raw point
  (out-of-frustum and capacity-dropped points get class 0, the ignore id).

With ``exported_dir`` the predict step is the per-bucket ``torch.export``
program of ``serving/export.py`` (always the per-voxel path: no host slot
maps), called with this engine's weights; everything else is the same.

On the card the step runs as CUDA graphs, the role ``jax.jit`` plays in the
JAX engine: one ``StepGraph`` (``modules/steps.py``) per input signature
(``batch_signature``: the bucket, the batch size and each level's slot-pool
size S), kept in a ``StepCache`` of ``TPU.STEP_CACHE_SIZE``.  A miss runs
the eager step once and captures it; a hit copies the batch into the
graph's static inputs, replays it and copies the packed output into pinned
host memory of the request's own.  There is no switch to run the card
eagerly, and a capture that fails raises.  ``device="cpu"`` runs the step eagerly (no graphs on
the CPU); ``forward`` is eager on either device.

The engine runs on the card unless it is given ``device="cpu"``; with no
CUDA device and no explicit CPU it raises.

Data parallelism (the JAX engine's ``num_devices``): ``num_devices`` = n
> 1 keeps one replica of the model on each of ``cuda:0`` .. ``cuda:n-1``
(n replicas on the CPU with ``device="cpu"``), or ``devices=[...]`` names
them, repeats allowed (replicas on one device share its model).  Each batch
of ``batch_size`` scans (a multiple of n) is cut into n contiguous runs of
whole scans (``parallel.data_parallel.shard_of``, scan ids re-based), each
replica runs its run through its own graphs, and the per-point outputs are
concatenated in order; the replicas' ``voxel_overflow`` counts are summed,
as the JAX engine ``psum``s them.  Past one replica there are no host slot
maps (per-voxel maps), and exported programs stay single-device.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fusiontransformer_tpu_torch.data.build import slot_pool_spec
from fusiontransformer_tpu_torch.data.collate import collate_padded
from fusiontransformer_tpu_torch.data.quantize import sparse_quantize
from fusiontransformer_tpu_torch.data.utils.augmentation_3d import (
    augment_and_scale_3d)
from fusiontransformer_tpu_torch.data.utils.validate import map_sparse_to_org
from fusiontransformer_tpu_torch.models.build import build_model
from fusiontransformer_tpu_torch.modules.steps import (Readback, StepCache,
                                                       StepGraph,
                                                       batch_signature,
                                                       device_batch,
                                                       overflow_metrics,
                                                       step_hier)
from fusiontransformer_tpu_torch.parallel.data_parallel import shard_of
from fusiontransformer_tpu_torch.utils.checkpoint import Checkpointer
from fusiontransformer_tpu_torch.utils.device import resolve_device

LABEL_KEYS = {"pred": "labels", "pred_2d": "labels_2d",
              "pred_3d": "labels_3d"}


def pred_keys(cfg):
    """The predict step's columns for the config's model (the JAX
    engine's): ``pred``, then ``pred_2d`` with the image stream, ``pred_3d``
    and ``voxel_overflow`` with the 3D stream."""
    m = cfg.MODEL
    return ["pred"] + (["pred_2d"] if m.USE_IMAGE else []) + (
        ["pred_3d", "voxel_overflow"] if m.USE_LIDAR else [])


def make_predict_step(cfg, model):
    """Labels-only predict step: ``(step, keys)``; ``step(batch)`` returns
    one [N, len(keys)] int32 tensor whose columns are ``keys``
    (``pred_keys``)."""
    m = cfg.MODEL
    keys = pred_keys(cfg)

    def step(batch):
        with torch.inference_mode():
            hier = step_hier(cfg, batch)
            out = model(batch, hier)
            res = {}
            if m.USE_LIDAR:
                res["pred_3d"] = torch.argmax(out["lidar_seg_logit"], -1)
            if m.USE_IMAGE:
                res["pred_2d"] = torch.argmax(out["img_seg_logit"], -1)
            if m.USE_FUSION:
                probs = (torch.softmax(out["img_seg_logit"], -1)
                         + torch.softmax(out["lidar_seg_logit"], -1))
                res["pred"] = torch.argmax(probs, -1)
            else:
                res["pred"] = res["pred_3d" if m.USE_LIDAR else "pred_2d"]
            if hier is not None:
                # Live taps the per-voxel slot maps dropped count as
                # overflow too (the JAX engine's rule).
                overflow = sum(overflow_metrics(cfg, batch, hier).values())
                res["voxel_overflow"] = overflow.expand(res["pred"].shape)
            return torch.stack([res[k].to(torch.int32) for k in keys],
                               dim=1)

    return step, keys


def dummy_sample(n_points: int, image_height: int, image_width: int) -> Dict:
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
        "img": np.zeros((image_height, image_width, 3), np.float32),
        "orig_seg_label": np.zeros(n_points, np.int32),
        "sparse_orig_points_idx": np.ones(n_points, bool),
        "inverse_map": np.arange(n_points),
        "num_input_points": n_points,
    }


@dataclass
class Replica:
    """One device's copy of the engine's step: its model and predict step,
    and the graphs captured from it into its own memory pool."""
    device: torch.device
    model: torch.nn.Module
    step: object
    graphs: StepCache
    pool: object = None


def replica_devices(device, num_devices, devices):
    """The devices of the engine's replicas: ``devices`` as given, else
    ``num_devices`` of ``device``'s type (the CPU n times, or ``cuda:0`` ..
    ``cuda:n-1``)."""
    if devices:
        return [resolve_device(d) for d in devices]
    n = int(num_devices)
    if n < 1:
        raise ValueError(f"num_devices = {n}")
    first = resolve_device(device)
    if n == 1:
        return [first]
    if first.type == "cpu":
        return [first] * n
    if torch.cuda.device_count() < n:
        raise ValueError(f"num_devices = {n} but {torch.cuda.device_count()}"
                         f" CUDA device(s) are visible")
    return [torch.device("cuda", i) for i in range(n)]


class InferenceEngine:
    """Owns the model and answers requests, one batch at a time.

    ``model``: a built model (e.g. with weights loaded by
    ``utils.convert_jax.load_jax_variables``); or ``checkpoint_path``, a
    checkpoint of the port's trainer (``utils/checkpoint.py``) whose
    ``model`` state dict is loaded; by default one is built from ``cfg``
    with random weights from ``seed``.  ``exported_dir``: serve through the
    ahead-of-time programs of ``serving/export.py`` with those weights.
    Thread-safe for concurrent ``predict`` calls: captures and replays run
    under a lock, host preprocessing and the wait for a result outside it.
    ``num_devices`` / ``devices``: one replica per device (the module's
    docstring); ``model`` lives on the first.
    """

    def __init__(self, cfg, model=None, batch_size: int = 1, device=None,
                 seed: int = 0, checkpoint_path: str = "",
                 exported_dir: str = "", num_devices: int = 1,
                 devices: Optional[Sequence] = None):
        self.cfg = cfg
        self.devices = replica_devices(device, num_devices, devices)
        self.device = self.devices[0]
        self.batch_size = int(batch_size)
        n = len(self.devices)
        if self.batch_size % n:
            raise ValueError(f"batch_size {self.batch_size} does not divide "
                             f"over {n} replicas")
        if exported_dir and n > 1:
            raise ValueError("exported programs are single-device; shard a "
                             "live model over num_devices")
        if model is not None and checkpoint_path:
            raise ValueError("pass a model or a checkpoint_path, not both")
        if model is None:
            model = build_model(cfg, self.device, seed)
            if checkpoint_path:
                payload = Checkpointer().load(checkpoint_path, resume=False)
                if "model" not in payload:
                    raise ValueError(f"no model state in checkpoint "
                                     f"{checkpoint_path}")
                model.load_state_dict(payload["model"])
        self.model = model.to(self.device).eval()

        ds = cfg.DATASET.get(cfg.DATASET.TYPE, {})
        self.scale = ds.get("scale", 20)
        self.full_scale = ds.get("full_scale", 4096)
        self.image_height = ds.get("image_height", 370)
        self.image_width = ds.get("image_width", 1226)
        self.image_normalizer = ds.get("image_normalizer", None)
        self.buckets = tuple(sorted(cfg.TPU.CAPACITY_BUCKETS)) or (
            cfg.TPU.POINT_CAPACITY,)
        # Host-built group-pooled slot maps at the levels CONV_TAP_SLOTS
        # names, at the static capacities of the bucket (None with
        # CONV_SLOT_POOL off: the step builds per-voxel maps; None for a
        # model without the 3D stream, which builds no hierarchy).
        self._slot_pool = slot_pool_spec(cfg, adaptive=False, world_size=n)
        self.exported = None
        self.replicas = [Replica(self.device, self.model, None,
                                 StepCache(cfg.TPU.STEP_CACHE_SIZE))]
        if exported_dir:
            self._use_exported(exported_dir)
        else:
            self._step, self._pred_keys = make_predict_step(cfg, self.model)
        for dev in self.devices[1:]:
            self.replicas.append(self._replica(dev))
        self.point_capacity = max(self.buckets)

        self._device_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.counters = {
            "scans": 0, "batches": 0, "collate_dropped_points": 0,
            "oob_points": 0, "voxel_overflow": 0, "captures": 0,
            "bucket_hits": {int(b): 0 for b in self.buckets},
        }

    # The first replica's step and graphs (one captured step per input
    # signature, on the card), as the engine's own.
    @property
    def _step(self):
        return self.replicas[0].step

    @_step.setter
    def _step(self, step):
        self.replicas[0].step = step

    @property
    def graphs(self):
        return self.replicas[0].graphs

    @property
    def _pool(self):
        return self.replicas[0].pool

    def _replica(self, device):
        """A replica on ``device``: the first replica's model where the
        device is the same, else a copy of its weights there."""
        first = self.replicas[0]
        model, step = first.model, first.step
        if device != first.device:
            model = build_model(self.cfg, device)
            model.load_state_dict(first.model.state_dict())
            model.eval()
            step, _ = make_predict_step(self.cfg, model)
        return Replica(device, model, step,
                       StepCache(self.cfg.TPU.STEP_CACHE_SIZE))

    def _use_exported(self, exported_dir):
        """Serve through the programs of ``serving/export.py`` (the JAX
        engine's ``exported_dir``): the buckets, the image size and the
        output columns come from the artifact's manifest, the weights from
        this engine's model, and there are no host slot maps (a program
        takes none)."""
        from fusiontransformer_tpu_torch.serving.export import ExportedPredict
        exported = ExportedPredict(exported_dir, self.device,
                                   self.batch_size)
        m = exported.manifest
        self.buckets = tuple(sorted(int(b) for b in m["buckets"]))
        self.image_height = int(m["image_height"])
        self.image_width = int(m["image_width"])
        self._pred_keys = list(m["pred_keys"])
        self._slot_pool = None
        self.exported = exported
        state = dict(self.model.state_dict())

        def step(batch):
            with torch.inference_mode():
                return exported(state, batch)

        self._step = step

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
        """Collate and enqueue the device step (each replica's run of whole
        scans on its device); returns a handle for ``complete`` (the wait
        for the result is there)."""
        batch = self.collate(samples)
        n = len(self.replicas)
        with self._device_lock:
            if n == 1:
                packed = self._dispatch(self.replicas[0], batch)
            else:
                packed = [self._dispatch(r, shard_of(batch, i, n))
                          for i, r in enumerate(self.replicas)]
        return samples, batch, packed

    def _dispatch(self, replica, batch):
        if replica.device.type == "cpu":
            return replica.step(device_batch(batch, replica.device))
        with torch.cuda.device(replica.device):
            return self.graph_for(batch, replica).replay(batch)

    def graph_for(self, batch, replica=None) -> StepGraph:
        """The captured step of ``batch``'s signature on ``replica`` (the
        first by default), captured now on a miss.  Call under
        ``_device_lock``."""
        r = replica or self.replicas[0]
        sig = batch_signature(batch)
        graph = r.graphs.get(sig)
        if graph is None:
            if r.pool is None:
                r.pool = torch.cuda.graph_pool_handle()
            try:
                graph = StepGraph(r.step, batch, r.device, r.pool)
            except BaseException:
                r.pool = None   # unfit for another capture
                raise
            r.graphs[sig] = graph
            with self._stats_lock:
                self.counters["captures"] += 1
        return graph

    def forward(self, samples: List[Dict]):
        """The model's raw outputs (logit tensors on the device) for
        already-preprocessed samples, with the host batch they came from
        (the whole batch on the first replica)."""
        batch = self.collate(samples)
        with self._device_lock, torch.inference_mode():
            db = device_batch(batch, self.device)
            out = self.model(db, step_hier(self.cfg, db))
        return batch, out

    def complete(self, handle, count_stats: bool = True) -> List[Dict]:
        """One device->host copy a replica, then de-voxelise per scan (the
        replicas' overflow counts summed)."""
        samples, batch, packed = handle
        cap = len(batch["pt_valid"]) // self.batch_size
        parts = [p.numpy() if isinstance(p, Readback) else p.cpu().numpy()
                 for p in (packed if isinstance(packed, list) else [packed])]
        packed = np.concatenate(parts)
        res = {k: packed[:, j] for j, k in enumerate(self._pred_keys)}
        overflow = 0
        if "voxel_overflow" in res:
            col = self._pred_keys.index("voxel_overflow")
            overflow = sum(int(p[0, col]) for p in parts)
            del res["voxel_overflow"]

        results = []
        oob_total = 0
        for i, s in enumerate(samples):
            n_vox = int(batch["scan_count"][i])
            sl = slice(i * cap, i * cap + n_vox)
            inverse_map = batch["inverse_map"][i]
            kept = batch["sparse_orig_points_idx"][i]
            out = {"in_frustum": kept, "num_voxels": n_vox}
            for key, label_key in LABEL_KEYS.items():
                if key not in res:
                    continue
                pt_pred, n_oob = map_sparse_to_org(res[key][sl], inverse_map)
                if key == "pred":
                    oob_total += n_oob
                full = np.zeros(s["num_input_points"], pt_pred.dtype)
                full[kept] = pt_pred
                out[label_key] = full
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
        """Run every capacity bucket once at a full batch before traffic:
        on the card that captures its graph (the first run also builds the
        kernels).  Returns {bucket: seconds}."""
        times = {}
        for b in (buckets or self.buckets):
            t0 = time.time()
            samples = [self._dummy_sample(int(b))
                       for _ in range(self.batch_size)]
            self.run_samples(samples, count_stats=False)
            times[int(b)] = time.time() - t0
        return times

    def _dummy_sample(self, n_points: int) -> Dict:
        return dummy_sample(n_points, self.image_height, self.image_width)

    def stats(self) -> Dict:
        with self._stats_lock:
            c = dict(self.counters)
            c["bucket_hits"] = dict(self.counters["bucket_hits"])
        return c
