"""Dataloader factory (port of ``fusiontransformer_tpu/data/build.py`` for
one device).

Builds the dataset of ``DATASET.TYPE`` for the mode's split (the
augmentation subtree applies to the training split only), the padded
collate with capacity buckets, per-level voxel counts when
``TPU.ADAPTIVE_LEVEL_CAPS`` is on, and host-built group-pooled slot maps when
``TPU.CONV_SLOT_POOL`` is on, and wraps them in the loader: one prefetch
thread with ``DATALOADER.NUM_WORKERS`` 0, else a pool of that many worker
processes with max(1, NUM_WORKERS) batches of prefetch, as in the JAX
package.  Only ``SyntheticSCN`` is ported: the real datasets' loaders
(``SemanticKITTISCN``, ``NuScenesSCN``) need data that is not in the
repository (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from fusiontransformer_tpu_torch import native
from fusiontransformer_tpu_torch.data.collate import get_collate
from fusiontransformer_tpu_torch.data.loader import DataLoader
from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
from fusiontransformer_tpu_torch.ops.host_slots import SlotPoolSpec


def slot_pool_spec(cfg, adaptive: bool):
    """The ``SlotPoolSpec`` of ``TPU.CONV_SLOT_POOL`` / ``CONV_TAP_SLOTS``,
    or None when the config builds no group-pooled maps (then the batches
    carry none, and the steps build per-voxel K-slot maps on the device)."""
    levels = [l for l, k in enumerate(cfg.TPU.CONV_TAP_SLOTS) if k]
    if not (cfg.TPU.CONV_SLOT_POOL and levels):
        return None
    return SlotPoolSpec(levels, cfg.TPU.L0_CAPACITY_FRACTION,
                        cfg.TPU.LEVEL_CAPACITY_FRACTIONS,
                        quantum=int(cfg.TPU.SLOT_POOL_QUANTUM),
                        adaptive=adaptive)


def build_dataloader(cfg, mode="train", seed=0, batch_size=None):
    if mode not in ("train", "val", "test"):
        raise ValueError(f"unknown mode {mode!r}")
    if cfg.DATASET.TYPE != "SyntheticSCN":
        raise NotImplementedError(
            f"only SyntheticSCN is ported, got {cfg.DATASET.TYPE}")
    is_train = mode == "train"
    if batch_size is None:
        batch_size = {"train": cfg.TRAIN.BATCH_SIZE, "val": cfg.VAL.BATCH_SIZE,
                      "test": cfg.TEST.BATCH_SIZE}[mode]
    ds_cfg = cfg.DATASET.SyntheticSCN
    aug = {}
    if is_train:
        aug = {k: v for k, v in dict(ds_cfg.augmentation).items()
               if v is not None}
    dataset = SyntheticSCN(split=tuple(cfg.DATASET[mode.upper()]),
                           num_scans=ds_cfg.num_scans,
                           num_points=ds_cfg.num_points,
                           image_width=ds_cfg.image_width,
                           image_height=ds_cfg.image_height,
                           seed=ds_cfg.seed,
                           point_count_jitter=ds_cfg.point_count_jitter,
                           **aug)
    buckets = tuple(cfg.TPU.CAPACITY_BUCKETS)
    if buckets and max(buckets) != cfg.TPU.POINT_CAPACITY:
        raise ValueError(f"max(TPU.CAPACITY_BUCKETS)={max(buckets)} must "
                         f"equal TPU.POINT_CAPACITY={cfg.TPU.POINT_CAPACITY}")
    adaptive = bool(cfg.TPU.ADAPTIVE_LEVEL_CAPS)
    n_levels = 1 + len(cfg.TPU.LEVEL_CAPACITY_FRACTIONS)
    collate = get_collate(batch_size=batch_size,
                          point_capacity=cfg.TPU.POINT_CAPACITY,
                          image_height=ds_cfg.image_height,
                          image_width=ds_cfg.image_width,
                          capacity_buckets=buckets,
                          level_counts=n_levels if adaptive else 0,
                          slot_pool=slot_pool_spec(cfg, adaptive))
    workers = int(cfg.DATALOADER.NUM_WORKERS)
    if workers > 0:
        # The collate's native host code, built here once: the workers
        # load the library and never race to build it.
        native.get_lib()
    return DataLoader(dataset, batch_size, collate, shuffle=is_train,
                      seed=seed + cfg.RNG_SEED, prefetch=max(1, workers),
                      num_workers=workers)
