"""Dataloader factory (port of ``fusiontransformer_tpu/data/build.py``).

Builds the dataset of ``DATASET.TYPE`` (``SemanticKITTISCN``,
``DebugSemanticKITTISCN``, ``NuScenesSCN`` or ``SyntheticSCN``) for the
mode's split from the dataset's whole config subtree, as the JAX package
does: its augmentation subtree applies to the training split only, and the
other splits carry the original points' labels and inverse maps
(``output_orig``) that validation scores.  A training ``bottom_crop``
shrinks the batch's image buffer to the crop.  Then the padded collate with
capacity buckets, per-level voxel counts when ``TPU.ADAPTIVE_LEVEL_CAPS`` is
on, and host-built group-pooled slot maps when ``TPU.CONV_SLOT_POOL`` is on
(both for the models with the 3D stream only), in the loader: one prefetch
thread with ``DATALOADER.NUM_WORKERS`` 0, else a pool of that many worker
processes with max(1, NUM_WORKERS) batches of prefetch.  The real datasets
read the trees their preprocessors write
(``data/semantic_kitti/preprocess.py``, ``data/nuscenes/preprocess.py``).

Data parallelism (``use_distributed`` with ``world_size`` > 1): each
process loads its share of the split, ``ShardedView`` (every
``world_size``-th scan from ``rank``, the DistributedSampler of the
reference), and past one device the batches carry no group-pooled maps
(``slot_pool_spec``): each rank's steps build per-voxel K-slot maps.
"""

from __future__ import annotations

from fusiontransformer_tpu_torch import native
from fusiontransformer_tpu_torch.data.collate import get_collate
from fusiontransformer_tpu_torch.data.loader import DataLoader
from fusiontransformer_tpu_torch.data.nuscenes.nuscenes_dataloader import (
    NuScenesSCN)
from fusiontransformer_tpu_torch.data.semantic_kitti import (
    semantic_kitti_dataloader as kitti)
from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN
from fusiontransformer_tpu_torch.ops.host_slots import SlotPoolSpec

DATASETS = {
    "SemanticKITTISCN": kitti.SemanticKITTISCN,
    "DebugSemanticKITTISCN": kitti.DebugSemanticKITTISCN,
    "NuScenesSCN": NuScenesSCN,
    "SyntheticSCN": SyntheticSCN,
}


def slot_pool_spec(cfg, adaptive: bool, world_size: int = 1):
    """The ``SlotPoolSpec`` of ``TPU.CONV_SLOT_POOL`` / ``CONV_TAP_SLOTS``,
    or None when the config builds no group-pooled maps: then the batches
    carry none, and the steps build per-voxel K-slot maps on the device, or
    no hierarchy at all for a model without the 3D stream.  Past one device
    (``world_size`` > 1, or ``TPU.NUM_DEVICES`` > 1) there are none either,
    as in the JAX package: the maps are pooled over the whole batch, and
    each device holds a shard of it."""
    levels = [l for l, k in enumerate(cfg.TPU.CONV_TAP_SLOTS) if k]
    if not (cfg.MODEL.USE_LIDAR and cfg.TPU.CONV_SLOT_POOL and levels):
        return None
    if world_size > 1 or cfg.TPU.NUM_DEVICES > 1:
        return None
    return SlotPoolSpec(levels, cfg.TPU.L0_CAPACITY_FRACTION,
                        cfg.TPU.LEVEL_CAPACITY_FRACTIONS,
                        quantum=int(cfg.TPU.SLOT_POOL_QUANTUM),
                        adaptive=adaptive)


def build_dataset(cfg, mode):
    """The dataset of ``DATASET.TYPE`` for ``mode``'s split, with its config
    subtree as keyword arguments (``ValueError`` on another type)."""
    kind = cfg.DATASET.TYPE
    if kind not in DATASETS:
        raise ValueError(f"Unsupported dataset type: {kind}")
    is_train = mode == "train"
    kwargs = dict(cfg.DATASET.get(kind, {}))
    augmentation = dict(kwargs.pop("augmentation", {})) if is_train else {}
    kwargs.pop("augmentation", None)
    augmentation = {k: v for k, v in augmentation.items() if v is not None}
    return DATASETS[kind](split=tuple(cfg.DATASET[mode.upper()]),
                          output_orig=not is_train, **kwargs, **augmentation)


class ShardedView:
    """One process's share of a dataset (the DistributedSampler of the
    reference, ``_ShardedView`` of the JAX package): item i is the
    dataset's ``i * world_size + rank``, wrapping past the end, so every
    rank has ``ceil(len / world_size)`` items and as many batches."""

    def __init__(self, dataset, rank, world_size):
        self.dataset = dataset
        self.rank = rank
        self.world_size = world_size
        for attr in ("class_names", "class_labels", "map_inverse_label",
                     "image_height", "image_width"):
            if hasattr(dataset, attr):
                setattr(self, attr, getattr(dataset, attr))

    def __len__(self):
        return (len(self.dataset) + self.world_size - 1) // self.world_size

    def __getitem__(self, i):
        return self.dataset[(i * self.world_size + self.rank)
                            % len(self.dataset)]


def build_dataloader(cfg, mode="train", seed=0, batch_size=None,
                     use_distributed=False, rank=0, world_size=1):
    """The loader of ``mode``'s split; with ``use_distributed`` and
    ``world_size`` > 1, of rank ``rank``'s ``ShardedView`` of it (the
    caller passes the per-rank ``batch_size`` and ``seed``)."""
    if mode not in ("train", "val", "test"):
        raise ValueError(f"unknown mode {mode!r}")
    is_train = mode == "train"
    if batch_size is None:
        batch_size = {"train": cfg.TRAIN.BATCH_SIZE, "val": cfg.VAL.BATCH_SIZE,
                      "test": cfg.TEST.BATCH_SIZE}[mode]
    dataset = build_dataset(cfg, mode)
    if not use_distributed:
        world_size = 1
    if world_size > 1:
        dataset = ShardedView(dataset, rank, world_size)
    image_width, image_height = dataset.image_width, dataset.image_height
    # bottom_crop shrinks the training images to (crop_w, crop_h); the batch
    # buffer follows (the ViT reads the crop).
    aug = cfg.DATASET[cfg.DATASET.TYPE].get("augmentation", {})
    crop = aug.get("bottom_crop") if is_train else None
    if crop:
        image_width, image_height = crop
    buckets = tuple(cfg.TPU.CAPACITY_BUCKETS)
    if buckets and max(buckets) != cfg.TPU.POINT_CAPACITY:
        raise ValueError(f"max(TPU.CAPACITY_BUCKETS)={max(buckets)} must "
                         f"equal TPU.POINT_CAPACITY={cfg.TPU.POINT_CAPACITY}")
    # Per-level voxel counts size the 3D stream's capacities; an image-only
    # model builds no hierarchy and its batches carry none.
    adaptive = bool(cfg.TPU.ADAPTIVE_LEVEL_CAPS and cfg.MODEL.USE_LIDAR)
    n_levels = 1 + len(cfg.TPU.LEVEL_CAPACITY_FRACTIONS)
    collate = get_collate(batch_size=batch_size,
                          point_capacity=cfg.TPU.POINT_CAPACITY,
                          image_height=image_height, image_width=image_width,
                          capacity_buckets=buckets,
                          level_counts=n_levels if adaptive else 0,
                          slot_pool=slot_pool_spec(cfg, adaptive,
                                                   world_size))
    workers = int(cfg.DATALOADER.NUM_WORKERS)
    if workers > 0:
        # The collate's native host code, built here once: the workers
        # load the library and never race to build it.
        native.get_lib()
    return DataLoader(dataset, batch_size, collate, shuffle=is_train,
                      seed=seed + cfg.RNG_SEED, prefetch=max(1, workers),
                      num_workers=workers)
