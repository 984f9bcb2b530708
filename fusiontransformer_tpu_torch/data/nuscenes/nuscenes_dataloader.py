"""NuScenes dataset (reference ``data/nuscenes/nuscenes_dataloader.py``; a copy
of ``fusiontransformer_tpu/data/nuscenes/nuscenes_dataloader.py`` with the
same numpy draws in the same order).  Images are read and resized with
Pillow, imported where an item is made (the module imports without it).

Parity notes:
* per-split pickles are loaded whole (``:52-55``);
* optional pseudo-label loading + per-class refinement (``:57-93``);
* optional 11 -> 5 class merge via ``categories`` (``:95-102``);
* image resize to (400, 225) with point rescale (``:175-185``), flip/jitter/
  normalize, ``flip_x`` 3D augmentation (nuScenes x = right);
* the reference feeds ``ones(N, 1)`` features (``:226``) because NuScenes was
  only ever run through the legacy SCN path; SPVCNN's stem expects 4 channels
  (``spvcnn.py:99``), so ``point_feats='xyz1'`` (default) emits
  [x, y, z, 1] — set ``point_feats='ones'`` for strict reference parity with
  1-channel models.  (SURVEY.md §7 step 8 documents this divergence.)
"""

from __future__ import annotations

import os.path as osp
import pickle

import numpy as np

from fusiontransformer_tpu_torch.data.quantize import sparse_quantize
from fusiontransformer_tpu_torch.data.semantic_kitti.semantic_kitti_dataloader import (
    color_jitter_np)
from fusiontransformer_tpu_torch.data.utils.augmentation_3d import augment_and_scale_3d
from fusiontransformer_tpu_torch.data.utils.refine_pseudo_labels import (
    refine_pseudo_labels)


class NuScenesBase:
    class_names = [
        "car", "truck", "bus", "trailer", "construction_vehicle",
        "pedestrian", "motorcycle", "bicycle", "traffic_cone", "barrier",
        "background",
    ]

    categories = {
        "vehicle": ["car", "truck", "bus", "trailer", "construction_vehicle"],
        "pedestrian": ["pedestrian"],
        "bike": ["motorcycle", "bicycle"],
        "traffic_boundary": ["traffic_cone", "barrier"],
        "background": ["background"],
    }

    def __init__(self, split, preprocess_dir, merge_classes=False,
                 pselab_paths=None):
        assert isinstance(split, tuple)
        self.split = split
        self.preprocess_dir = preprocess_dir
        self.data = []
        for curr_split in split:
            with open(osp.join(preprocess_dir, curr_split + ".pkl"), "rb") as f:
                self.data.extend(pickle.load(f))

        self.pselab_data = None
        if pselab_paths:
            assert isinstance(pselab_paths, tuple)
            self.pselab_data = []
            for p in pselab_paths:
                self.pselab_data.extend(np.load(p, allow_pickle=True))
            assert len(self.pselab_data) == len(self.data)
            for i in range(len(self.pselab_data)):
                assert len(self.pselab_data[i]["pseudo_label_2d"]) == \
                    len(self.data[i]["seg_labels"])

            probs2d = np.concatenate(
                [d["probs_2d"] for d in self.pselab_data])
            pl2d = np.concatenate(
                [d["pseudo_label_2d"] for d in self.pselab_data]).astype(int)
            pl2d = refine_pseudo_labels(probs2d, pl2d)

            if "probs_3d" in self.pselab_data[0]:
                probs3d = np.concatenate(
                    [d["probs_3d"] for d in self.pselab_data])
                pl3d = np.concatenate(
                    [d["pseudo_label_3d"]
                     for d in self.pselab_data]).astype(int)
                pl3d = refine_pseudo_labels(probs3d, pl3d)
            else:
                pl3d = None

            left = 0
            for d in self.pselab_data:
                right = left + len(d["probs_2d"])
                d["pseudo_label_2d"] = pl2d[left:right]
                d["pseudo_label_3d"] = (pl3d[left:right]
                                        if pl3d is not None else None)
                left = right

        if merge_classes:
            self.label_mapping = -100 * np.ones(len(self.class_names), int)
            for cat_idx, cat_list in enumerate(self.categories.values()):
                for name in cat_list:
                    self.label_mapping[self.class_names.index(name)] = cat_idx
            self.class_names = list(self.categories.keys())
        else:
            self.label_mapping = None
        self.class_labels = list(range(len(self.class_names)))
        self.map_inverse_label = None

    def __len__(self):
        return len(self.data)


class NuScenesSCN(NuScenesBase):
    def __init__(self, split, preprocess_dir, nuscenes_dir="",
                 pselab_paths=None, merge_classes=False, scale=20,
                 full_scale=4096, use_image=True, resize=(400, 225),
                 image_normalizer=None, noisy_rot=0.0, flip_x=0.0, rot_z=0.0,
                 transl=False, fliplr=0.0, color_jitter=None,
                 output_orig=False, point_feats="xyz1"):
        super().__init__(split, preprocess_dir, merge_classes=merge_classes,
                         pselab_paths=tuple(pselab_paths)
                         if pselab_paths else None)
        self.nuscenes_dir = nuscenes_dir
        self.output_orig = output_orig
        self.scale = scale
        self.full_scale = full_scale
        self.noisy_rot = noisy_rot
        self.flip_x = flip_x
        self.rot_z = rot_z
        self.transl = transl
        self.use_image = use_image
        self.resize = resize
        self.image_normalizer = image_normalizer
        self.fliplr = fliplr
        self.color_jitter = color_jitter
        self.point_feats = point_feats
        self.image_width = resize[0] if resize else 1600
        self.image_height = resize[1] if resize else 900

    def __getitem__(self, index):
        from PIL import Image

        rng = np.random
        data_dict = self.data[index]
        points = data_dict["points"].copy()
        seg_label = data_dict["seg_labels"].astype(np.int64)
        if self.label_mapping is not None:
            seg_label = self.label_mapping[seg_label]

        out_dict = {}
        image = None
        img_indices = None
        if self.use_image:
            points_img = data_dict["points_img"].copy()
            img_path = osp.join(self.nuscenes_dir, data_dict["camera_path"])
            image = Image.open(img_path)
            if self.resize and image.size != tuple(self.resize):
                assert image.size[0] > self.resize[0]
                points_img[:, 0] = (float(self.resize[1]) / image.size[1]
                                    * np.floor(points_img[:, 0]))
                points_img[:, 1] = (float(self.resize[0]) / image.size[0]
                                    * np.floor(points_img[:, 1]))
                image = image.resize(tuple(self.resize), Image.BILINEAR)

            img_indices = points_img.astype(np.int64)
            image = np.asarray(image, dtype=np.float32) / 255.0
            if self.color_jitter is not None:
                image = color_jitter_np(image, *self.color_jitter, rng=rng)
            if rng.rand() < self.fliplr:
                image = np.ascontiguousarray(np.fliplr(image))
                img_indices[:, 1] = image.shape[1] - 1 - img_indices[:, 1]
            if self.image_normalizer:
                mean, std = self.image_normalizer
                image = ((image - np.asarray(mean, np.float32))
                         / np.asarray(std, np.float32))

        coords = augment_and_scale_3d(
            points, self.scale, self.full_scale, noisy_rot=self.noisy_rot,
            flip_x=self.flip_x, rot_z=self.rot_z, transl=self.transl,
        ).astype(np.int64)
        keep = (coords.min(1) >= 0) & (coords.max(1) < self.full_scale)

        if self.point_feats == "xyz1":
            feats = np.concatenate(
                [points, np.ones((len(points), 1))], 1).astype(np.float32)
        else:
            feats = np.ones((len(points), 1), np.float32)

        vox_coords = coords[keep]
        uniq, inverse = sparse_quantize(vox_coords)
        out_dict["coords"] = vox_coords[uniq].astype(np.int32)
        out_dict["feats"] = feats[keep][uniq]
        out_dict["seg_label"] = seg_label[keep][uniq].astype(np.int32)
        if self.use_image:
            out_dict["img"] = image
            out_dict["img_indices"] = img_indices[keep][uniq].astype(np.int32)
        out_dict["seq"] = data_dict.get("scene_name", "nuscenes")
        out_dict["filename"] = data_dict.get("sample_token", str(index))

        if self.pselab_data is not None:
            out_dict["pseudo_label_2d"] = \
                self.pselab_data[index]["pseudo_label_2d"][keep][uniq]
            pl3d = self.pselab_data[index]["pseudo_label_3d"]
            out_dict["pseudo_label_3d"] = (pl3d[keep][uniq]
                                           if pl3d is not None else None)

        if self.output_orig:
            out_dict["orig_seg_label"] = seg_label
            out_dict["sparse_orig_points_idx"] = keep
            out_dict["inverse_map"] = inverse
        return out_dict
