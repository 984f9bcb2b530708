"""SemanticKITTI dataset (reference ``data/semantic_kitti/semantic_kitti_dataloader.py``;
a copy of ``fusiontransformer_tpu/data/semantic_kitti/semantic_kitti_dataloader.py``
with the same numpy draws in the same order, so one item under one
``np.random`` seed is bit for bit the JAX package's).

Per-item pipeline parity:
  load per-frame pickle -> map raw labels to train ids -> crop image to
  (1226, 370) -> optional bottom_crop with point re-index (``:169-191``) ->
  color jitter / horizontal flip with index flip (``:196-203``) -> imagenet
  normalize -> 3D augment + scale to voxels -> in-bounds mask (``:225``) ->
  sparse_quantize unique-voxel selection + inverse map (``:231``).

Images are read and cropped with Pillow, imported where an item is made
(the module imports without it).

Differences from the reference (deliberate, kept from the JAX package):
* images stay HWC float32;
* color jitter is a numpy re-implementation of torchvision ColorJitter's
  brightness/contrast/saturation factors;
* the debug variant is a constructor flag on the same class (the reference's
  ``DebugSemanticKITTISCN`` is a near-copy file).
"""

from __future__ import annotations

import os.path as osp
import pickle
from pathlib import Path

import numpy as np

from fusiontransformer_tpu_torch.data.quantize import sparse_quantize
from fusiontransformer_tpu_torch.data.semantic_kitti import labels as L
from fusiontransformer_tpu_torch.data.semantic_kitti import splits
from fusiontransformer_tpu_torch.data.utils.augmentation_3d import augment_and_scale_3d


def color_jitter_np(img, brightness, contrast, saturation, rng):
    """torchvision ColorJitter(b, c, s) semantics on a float HWC image in [0,1]."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: x * f)
    if contrast > 0:
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)

        def _contrast(x, f=f):
            gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
            return x * f + gray.mean() * (1 - f)

        ops.append(_contrast)
    if saturation > 0:
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)

        def _sat(x, f=f):
            gray = (x @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]
            return x * f + gray * (1 - f)

        ops.append(_sat)
    order = rng.permutation(len(ops))
    for i in order:
        img = ops[i](img)
    return np.clip(img, 0.0, 1.0)


class SemanticKITTIBase:
    """Globs per-sequence pickles and holds the label mapping."""

    def __init__(self, split, preprocess_dir, debug=False):
        assert isinstance(split, tuple)
        self.split = split
        self.preprocess_dir = preprocess_dir
        split_seqs = getattr(splits.debug if debug else splits.regular,
                             split[0])
        self.data_paths = []
        for seq in split_seqs:
            seq_path = Path(preprocess_dir) / seq
            self.data_paths.extend(sorted(seq_path.rglob("*.pkl")))
        self.class_names = L.class_names()
        self.class_labels = L.class_labels()
        self.map_label = L.make_label_mapper()
        self.map_inverse_label = L.make_inverse_label_mapper()

    def __len__(self):
        return len(self.data_paths)


class SemanticKITTISCN(SemanticKITTIBase):
    def __init__(self, split, preprocess_dir, semantic_kitti_dir="",
                 scale=20, full_scale=4096, image_normalizer=None,
                 noisy_rot=0.0, flip_y=0.0, rot_z=0.0, transl=False,
                 bottom_crop=None, fliplr=None, color_jitter=None,
                 output_orig=False, image_width=1226, image_height=370,
                 debug=False):
        super().__init__(split, preprocess_dir, debug=debug)
        self.semantic_kitti_dir = semantic_kitti_dir
        self.output_orig = output_orig
        self.scale = scale
        self.full_scale = full_scale
        self.noisy_rot = noisy_rot
        self.flip_y = flip_y
        self.rot_z = rot_z
        self.transl = transl
        self.image_normalizer = image_normalizer
        self.bottom_crop = bottom_crop
        self.fliplr = fliplr
        self.color_jitter = color_jitter
        self.image_width = image_width
        self.image_height = image_height

    def __getitem__(self, index):
        from PIL import Image

        rng = np.random
        data_path = str(self.data_paths[index])
        with open(data_path, "rb") as f:
            data_dict = pickle.load(f)

        points = data_dict["points"].copy()
        feats = data_dict["feats"].copy()
        seg_label = self.map_label(data_dict["seg_labels"].astype(np.int64))
        points_img = data_dict["points_img"].copy()

        img_path = osp.join(self.semantic_kitti_dir, data_dict["camera_path"])
        image = Image.open(img_path).crop(
            (0, 0, self.image_width, self.image_height))

        if self.bottom_crop is not None:
            # bottom_crop = (crop_width, crop_height); random horizontal slot.
            left = int(rng.rand() * (image.size[0] + 1 - self.bottom_crop[0]))
            right = left + self.bottom_crop[0]
            top = image.size[1] - self.bottom_crop[1]
            bottom = image.size[1]
            keep = ((points_img[:, 0] >= top) & (points_img[:, 0] < bottom) &
                    (points_img[:, 1] >= left) & (points_img[:, 1] < right))
            image = image.crop((left, top, right, bottom))
            points_img = points_img[keep].copy()
            points_img[:, 0] -= top
            points_img[:, 1] -= left
            points = points[keep]
            seg_label = seg_label[keep]
            feats = feats[keep]

        img_indices = points_img.astype(np.int64)
        image = np.asarray(image, dtype=np.float32) / 255.0

        if self.color_jitter is not None:
            image = color_jitter_np(image, *self.color_jitter, rng=rng)
        if self.fliplr is not None and rng.rand() < self.fliplr:
            image = np.ascontiguousarray(np.fliplr(image))
            img_indices[:, 1] = image.shape[1] - 1 - img_indices[:, 1]
        if self.image_normalizer:
            mean, std = self.image_normalizer
            image = (image - np.asarray(mean, np.float32)) / np.asarray(
                std, np.float32)

        coords = augment_and_scale_3d(
            points, self.scale, self.full_scale, noisy_rot=self.noisy_rot,
            flip_y=self.flip_y, rot_z=self.rot_z, transl=self.transl,
        ).astype(np.int64)

        keep = (coords.min(1) >= 0) & (coords.max(1) < self.full_scale)
        vox_coords = coords[keep]
        vox_feats = feats[keep]
        vox_seg = seg_label[keep]
        vox_img_idx = img_indices[keep]

        uniq, inverse = sparse_quantize(vox_coords)
        out = {
            "coords": vox_coords[uniq].astype(np.int32),
            "feats": vox_feats[uniq].astype(np.float32),
            "seg_label": vox_seg[uniq].astype(np.int32),
            "img_indices": vox_img_idx[uniq].astype(np.int32),
            "img": image,
            "seq": Path(data_path).parent.name,
            "filename": Path(data_path).stem,
        }
        if self.output_orig:
            out["orig_seg_label"] = seg_label
            out["sparse_orig_points_idx"] = keep
            out["inverse_map"] = inverse
        return out


class DebugSemanticKITTISCN(SemanticKITTISCN):
    """Tiny-dataset fixture (reference ``debug_semantic_kitti_dataloader.py``)."""

    def __init__(self, *args, **kwargs):
        kwargs["debug"] = True
        super().__init__(*args, **kwargs)
