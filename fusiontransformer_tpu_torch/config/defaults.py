"""Default configuration schema (a copy of ``fusiontransformer_tpu/config/defaults.py``).

The tree is kept key for key identical to the JAX package's, ``TPU.*``
section names included, so every YAML under ``configs/`` merges into both
packages unchanged.  The port reads ``MODEL.*``, ``DATASET.*`` and the
capacity / slot-map / dtype keys of ``TPU.*``; the rest is schema only.

Mirrors the reference yacs schema so the same YAML files merge cleanly:
* base tree: reference ``FusionTransformer/common/config/base.py:10-122``
* project overlay: reference ``FusionTransformer/config/FusionTransformerConfig.py:7-144``

TPU-specific additions live under ``TPU`` (static-shape capacities, dtype and
mesh policy) — the reference has no equivalent because torchsparse handles
dynamic shapes with GPU hash tables; on TPU we pad to fixed capacities so every
scan compiles to the same XLA program.
"""

import os.path as osp

from fusiontransformer_tpu_torch.utils.config import CfgNode as CN

# timm's IMAGENET_DEFAULT_MEAN/STD, inlined (timm is not a dependency here).
IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)

_C = CN()

# ---------------------------------------------------------------------------- #
# Resume (reference common/config/base.py:16-20)
# ---------------------------------------------------------------------------- #
_C.AUTO_RESUME = True
_C.RESUME_STATES = True
_C.RESUME_PATH = ""

# ---------------------------------------------------------------------------- #
# DataLoader
# ---------------------------------------------------------------------------- #
_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 0
_C.DATALOADER.DROP_LAST = True

# ---------------------------------------------------------------------------- #
# Optimizer (reference common/config/base.py:40-56)
# ---------------------------------------------------------------------------- #
_C.OPTIMIZER = CN()
_C.OPTIMIZER.TYPE = ""
_C.OPTIMIZER.BASE_LR = 0.001
_C.OPTIMIZER.WEIGHT_DECAY = 0.0

_C.OPTIMIZER.SGD = CN()
_C.OPTIMIZER.SGD.momentum = 0.9
_C.OPTIMIZER.SGD.dampening = 0.0

_C.OPTIMIZER.Adam = CN()
_C.OPTIMIZER.Adam.betas = (0.9, 0.999)

# ---------------------------------------------------------------------------- #
# Scheduler (reference common/config/base.py:61-75)
# ---------------------------------------------------------------------------- #
_C.SCHEDULER = CN()
_C.SCHEDULER.TYPE = ""
_C.SCHEDULER.MAX_EPOCH = 1
_C.SCHEDULER.CLIP_LR = 0.0

_C.SCHEDULER.StepLR = CN()
_C.SCHEDULER.StepLR.step_size = 0
_C.SCHEDULER.StepLR.gamma = 0.1

_C.SCHEDULER.MultiStepLR = CN()
_C.SCHEDULER.MultiStepLR.milestones = ()
_C.SCHEDULER.MultiStepLR.gamma = 0.1

# ---------------------------------------------------------------------------- #
# Train (reference common/config/base.py:80-96 + project overlay)
# ---------------------------------------------------------------------------- #
_C.TRAIN = CN()
_C.TRAIN.BATCH_SIZE = 1
# Accumulate gradients over k micro-batches before each optimizer update
# (beyond-parity: the reference has no accumulation — SURVEY §2.3).  The
# effective batch is BATCH_SIZE * GRAD_ACCUM_STEPS with unchanged memory:
# the optimizer is wrapped in optax.MultiSteps, so the train step stays one
# jitted program and the accumulator lives in opt_state.
_C.TRAIN.GRAD_ACCUM_STEPS = 1
_C.TRAIN.CHECKPOINT_PERIOD = 0
_C.TRAIN.LOG_PERIOD = 50
_C.TRAIN.SUMMARY_PERIOD = 0
_C.TRAIN.MAX_TO_KEEP = 100
# Write checkpoints from a background thread (the device->host snapshot is
# still synchronous; only the disk write overlaps training).  Flagship
# checkpoints are ~1.2 GB — minutes of blocked training per save otherwise.
_C.TRAIN.ASYNC_CHECKPOINT = True
_C.TRAIN.FROZEN_PATTERNS = ()
_C.TRAIN.LOG_HISTOGRAM = False
_C.TRAIN.CLASS_WEIGHTS = []

_C.TRAIN.FusionTransformer = CN()
_C.TRAIN.FusionTransformer.lambda_xm = 0.0

# ---------------------------------------------------------------------------- #
# Val / Test
# ---------------------------------------------------------------------------- #
_C.VAL = CN()
_C.VAL.BATCH_SIZE = 1
_C.VAL.PERIOD = 0
_C.VAL.LOG_PERIOD = 20
_C.VAL.METRIC = "seg_iou"

_C.TEST = CN()
_C.TEST.BATCH_SIZE = 1

# ---------------------------------------------------------------------------- #
# Datasets (reference FusionTransformerConfig.py:24-120)
# ---------------------------------------------------------------------------- #
_C.DATASET = CN()
_C.DATASET.TYPE = ""
_C.DATASET.TRAIN = tuple()
_C.DATASET.VAL = tuple()
_C.DATASET.TEST = tuple()

# SemanticKITTISCN
_C.DATASET.SemanticKITTISCN = CN()
_C.DATASET.SemanticKITTISCN.preprocess_dir = ""
_C.DATASET.SemanticKITTISCN.semantic_kitti_dir = ""
_C.DATASET.SemanticKITTISCN.scale = 20
_C.DATASET.SemanticKITTISCN.full_scale = 4096
_C.DATASET.SemanticKITTISCN.image_normalizer = (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)
_C.DATASET.SemanticKITTISCN.image_width = 1226
_C.DATASET.SemanticKITTISCN.image_height = 370
_C.DATASET.SemanticKITTISCN.debug = False
_C.DATASET.SemanticKITTISCN.augmentation = CN()
_C.DATASET.SemanticKITTISCN.augmentation.noisy_rot = 0.0
_C.DATASET.SemanticKITTISCN.augmentation.flip_y = 0.0
_C.DATASET.SemanticKITTISCN.augmentation.rot_z = 0.0
_C.DATASET.SemanticKITTISCN.augmentation.transl = False
_C.DATASET.SemanticKITTISCN.augmentation.bottom_crop = None
_C.DATASET.SemanticKITTISCN.augmentation.fliplr = None
_C.DATASET.SemanticKITTISCN.augmentation.color_jitter = None

# DebugSemanticKITTISCN (tiny-dataset fixture, reference FusionTransformerConfig.py:100-120)
_C.DATASET.DebugSemanticKITTISCN = CN()
_C.DATASET.DebugSemanticKITTISCN.preprocess_dir = ""
_C.DATASET.DebugSemanticKITTISCN.semantic_kitti_dir = ""
_C.DATASET.DebugSemanticKITTISCN.scale = 20
_C.DATASET.DebugSemanticKITTISCN.full_scale = 4096
_C.DATASET.DebugSemanticKITTISCN.image_normalizer = (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)
_C.DATASET.DebugSemanticKITTISCN.image_width = 1226
_C.DATASET.DebugSemanticKITTISCN.image_height = 370
_C.DATASET.DebugSemanticKITTISCN.debug = False
_C.DATASET.DebugSemanticKITTISCN.augmentation = CN()
_C.DATASET.DebugSemanticKITTISCN.augmentation.noisy_rot = 0.0
_C.DATASET.DebugSemanticKITTISCN.augmentation.flip_y = 0.0
_C.DATASET.DebugSemanticKITTISCN.augmentation.rot_z = 0.0
_C.DATASET.DebugSemanticKITTISCN.augmentation.transl = False
_C.DATASET.DebugSemanticKITTISCN.augmentation.bottom_crop = None
_C.DATASET.DebugSemanticKITTISCN.augmentation.fliplr = None
_C.DATASET.DebugSemanticKITTISCN.augmentation.color_jitter = None

# SyntheticSCN — in-memory random-scan fixture (no reference equivalent; this
# replaces the reference's on-disk DebugDataset for hermetic tests).
_C.DATASET.SyntheticSCN = CN()
_C.DATASET.SyntheticSCN.num_scans = 8
_C.DATASET.SyntheticSCN.num_points = 4096
_C.DATASET.SyntheticSCN.scale = 20
_C.DATASET.SyntheticSCN.full_scale = 4096
_C.DATASET.SyntheticSCN.image_width = 1226
_C.DATASET.SyntheticSCN.image_height = 370
_C.DATASET.SyntheticSCN.image_normalizer = (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)
_C.DATASET.SyntheticSCN.seed = 0
# Per-scan size spread: each scan draws U[(1-jitter)*num_points, num_points]
# rays (real frustum scans vary widely; needed to exercise capacity buckets).
_C.DATASET.SyntheticSCN.point_count_jitter = 0.0
_C.DATASET.SyntheticSCN.augmentation = CN()
_C.DATASET.SyntheticSCN.augmentation.noisy_rot = 0.0
_C.DATASET.SyntheticSCN.augmentation.flip_y = 0.0
_C.DATASET.SyntheticSCN.augmentation.rot_z = 0.0
_C.DATASET.SyntheticSCN.augmentation.transl = False
_C.DATASET.SyntheticSCN.augmentation.bottom_crop = None
_C.DATASET.SyntheticSCN.augmentation.fliplr = None
_C.DATASET.SyntheticSCN.augmentation.color_jitter = None

# NuScenesSCN (reference data/nuscenes/nuscenes_dataloader.py:111-246; the
# rebuild feeds 4-ch feats to SPVCNN — see SURVEY.md §7 step 8)
_C.DATASET.NuScenesSCN = CN()
_C.DATASET.NuScenesSCN.preprocess_dir = ""
_C.DATASET.NuScenesSCN.nuscenes_dir = ""
_C.DATASET.NuScenesSCN.merge_classes = False
_C.DATASET.NuScenesSCN.pselab_paths = ()
_C.DATASET.NuScenesSCN.scale = 20
_C.DATASET.NuScenesSCN.full_scale = 4096
_C.DATASET.NuScenesSCN.resize = (400, 225)
_C.DATASET.NuScenesSCN.image_normalizer = ()
_C.DATASET.NuScenesSCN.augmentation = CN()
_C.DATASET.NuScenesSCN.augmentation.noisy_rot = 0.0
_C.DATASET.NuScenesSCN.augmentation.flip_x = 0.0
_C.DATASET.NuScenesSCN.augmentation.rot_z = 0.0
_C.DATASET.NuScenesSCN.augmentation.transl = False
_C.DATASET.NuScenesSCN.augmentation.fliplr = 0.0
_C.DATASET.NuScenesSCN.augmentation.color_jitter = None

# ---------------------------------------------------------------------------- #
# Model (reference FusionTransformerConfig.py:124-139)
# ---------------------------------------------------------------------------- #
_C.MODEL = CN()
_C.MODEL.TYPE = ""
_C.MODEL.SAVE = True
_C.MODEL.CKPT_PATH = ""
_C.MODEL.NUM_CLASSES = 20
_C.MODEL.DUAL_HEAD = False
_C.MODEL.USE_IMAGE = False
_C.MODEL.USE_LIDAR = False
_C.MODEL.USE_FUSION = False
_C.MODEL.IMAGE_PRETRAINED_PATH = ""
# ViT stream geometry.  Defaults are DeiT-B distilled @384 (the reference
# hardcodes timm's deit_base_distilled_patch16_384, models/transformers.py);
# the knobs exist so smaller variants (DeiT-S/Ti) and tests can size down.
_C.MODEL.VIT_IMG_SIZE = 384
_C.MODEL.VIT_PATCH = 16
_C.MODEL.VIT_EMBED_DIM = 768
_C.MODEL.VIT_DEPTH = 12
_C.MODEL.VIT_HEADS = 12
_C.MODEL.middle_feat_block_number = None
_C.MODEL.late_feat_block_number = None

# ---------------------------------------------------------------------------- #
# TPU-specific (no reference equivalent)
# ---------------------------------------------------------------------------- #
_C.TPU = CN()
# Per-scan point buffer capacity. Batches allocate BATCH_SIZE * cap.
_C.TPU.POINT_CAPACITY = 32768
# Per-scan capacity buckets (ascending).  Empty = fixed POINT_CAPACITY.
# With buckets, each batch is padded to the smallest bucket that fits its
# largest scan; the jitted step retraces once per bucket and every level's
# voxel capacity scales down with it (gathers are row-count-bound, so small
# scans stop paying for the worst case).  POINT_CAPACITY should equal the
# largest bucket.
_C.TPU.CAPACITY_BUCKETS = ()
# Level-0 voxel capacity as a fraction of the point buffer.  Points are 1:1
# with L0 voxels (dataloader dedup), so the voxel arrays only need capacity
# for the *valid* points; the point buffer's padding headroom can be shaved
# here (invalid points sort to the tail and are sliced off).  1.0 = safe.
_C.TPU.L0_CAPACITY_FRACTION = 1.0
# Capacity fraction per downsample level relative to previous level.
# NOTE: sparse LiDAR returns barely merge under 2x downsampling (the spacing
# between returns exceeds the voxel size at range), so deep levels need far
# more capacity than the naive 1/8 geometric intuition suggests.  Defaults
# are sized for worst-case sparse clouds; tighten per dataset using the
# per-step overflow metric (metrics["voxel_overflow"], 0 == lossless).
_C.TPU.LEVEL_CAPACITY_FRACTIONS = (1.0, 0.9, 0.8, 0.7)
# Occupancy-compacted voxel capacities: the collate counts each batch's
# EXACT per-level unique-voxel totals (host-side, a few ms inside the MP
# workers) and the trainer sizes every level to the smallest
# ladder-quantized capacity that fits — the fraction knobs above become a
# safety ceiling instead of the operative size.  Gathers/GEMMs scale with
# capacity, so conservative fractions stop costing throughput (measured
# occupancy at the default fractions is 0.16-0.75 per level).  One retrace
# per distinct capacity tuple (the ~1.3x ladder keeps that to a handful
# per run; each is logged).  On multi-device/multi-host runs the trainer
# syncs a global per-level max across ranks first (all ranks must compile
# the same program); per-batch counts ride the collate's `level_counts`.
_C.TPU.ADAPTIVE_LEVEL_CAPS = True
# Conv tap slots per level (K); 0 at a level (or all zeros) = the dense
# 27-tap ks=3 conv there.  At a level with K > 0 every ks=3 conv runs a
# hand-written binned-conv kernel pair on slot maps: the group-pooled maps
# of CONV_SLOT_POOL below, or, with it off, per-voxel K-slot maps that the
# hierarchy builds on the device (ops/hierarchy.py tap_slot_maps): the
# first K live taps of each voxel.  Live taps beyond K are DROPPED and
# counted in `tap_overflow` (the train step's metric, the engine's
# `voxel_overflow`; the trainer warns; 0 == lossless).  LiDAR surfaces are
# thin, so K=16 is lossless on KITTI-like scans.  Levels past the tuple's
# length run dense (the tuple is zero-padded to the hierarchy depth).
# Default: K=16 at the first four levels; the deepest level runs dense.
_C.TPU.CONV_TAP_SLOTS = (16, 16, 16, 16, 0)
# Kept for the JAX package's configs; no meaning in the port.  There it
# picks the Pallas kernel or the XLA formulation for the per-voxel maps on
# a TPU; here every slot-map conv runs its CUDA kernel pair (K1'/K2' on
# per-voxel maps), whatever its widths or K (ops/sparse_conv.py).
_C.TPU.CONV_PALLAS = True
# Host-built GROUP-POOLED slot maps (ops/host_slots.py): the collate joins
# ks3 neighbors per scan and pools slots per 8-voxel kernel group (exact
# compaction), at the levels where CONV_TAP_SLOTS is nonzero; their convs
# run K1/K2.  Off: the batches carry no host maps and the steps build
# per-voxel K-slot maps on the device (K1'/K2'; data/build.py
# slot_pool_spec).  SLOT_POOL_QUANTUM ladders the per-batch pool size S
# (multiples of this).
_C.TPU.CONV_SLOT_POOL = True
_C.TPU.SLOT_POOL_QUANTUM = 16
# LRU bound on cached per-capacity jitted steps (train + eval each).  Every
# live compiled step retains ~1-1.2 GB of host memory on this stack and the
# adaptive ladders mint new tuples over a long run (the r5-diagnosed cause
# of RSS growth); evicted steps re-load from the persistent XLA compile cache in
# seconds on a re-hit.  <= 0 disables eviction.
_C.TPU.STEP_CACHE_SIZE = 16
# Compute dtype for matmul-heavy paths: "bfloat16" or "float32".
_C.TPU.COMPUTE_DTYPE = "bfloat16"
# Data-parallel mesh size (1 = single chip). 0 = use all visible devices.
_C.TPU.NUM_DEVICES = 0
# Tensor-parallel ranks for the ViT stream (Megatron head/hidden sharding
# over a 'model' mesh axis; parallel/tensor_parallel.py).  Composes with
# data parallelism into a (data, model) mesh: NUM_DEVICES must be a
# multiple of MODEL_PARALLEL; the data axis gets the quotient.  Requires a
# ViT-stream model, vit_heads % MODEL_PARALLEL == 0 and GRAD_ACCUM_STEPS 1
# (modules/DistributedTrainer.py).  Checkpoints stay canonical tp=1 layout
# (merged on save, re-split on restore).
_C.TPU.MODEL_PARALLEL = 1
# ZeRO-1: shard optimizer moments 1/n across the data axis
# (parallel/zero.py).  Optimizer math is bitwise identical; adds one
# params-sized all_gather per step, saves 2x-params-/n of memory per card.
# Checkpoints stay canonical (merged on save, re-split on restore).
# Requires MODEL_PARALLEL == 1 and GRAD_ACCUM_STEPS 1.
_C.TPU.ZERO_OPTIMIZER = False
# Remat (checkpoint) the ViT blocks to save HBM during training.
_C.TPU.REMAT_VIT = False

# ---------------------------------------------------------------------------- #
# Misc
# ---------------------------------------------------------------------------- #
_C.OUTPUT_DIR = osp.expanduser("../logs/FusionTransformer/@")
_C.RNG_SEED = 1

cfg = _C


def get_default_cfg():
    """Return a fresh (defrosted) clone of the default config tree."""
    return _C.clone()
