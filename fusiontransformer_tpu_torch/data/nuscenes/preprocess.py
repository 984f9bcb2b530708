"""Offline NuScenes preprocessor (reference ``data/nuscenes/preprocess.py``; a
copy of ``fusiontransformer_tpu/data/nuscenes/preprocess.py``).

Iterates ``nusc.sample``; assigns scenes to splits by the official scene
lists with USA/Singapore (location) and day/night (description keyword)
subset filters; projects the 5-channel LiDAR sweep into the front camera
(``projection.map_pointcloud_to_image``); labels points by box membership
over camera-visible boxes (background = len(classes)); writes one pickle per
split: ``{points, seg_labels, points_img, lidar_path, camera_path, boxes,
sample_token, scene_name, calib}``.

The ``nuscenes-devkit`` is only needed to construct the ``nusc`` DB object
(deferred import in ``main``); all geometry — projection, box membership,
detection-class mapping — is implemented natively (``projection.py``,
``boxes.py``), so ``preprocess()`` itself runs against any duck-typed DB
(hermetic tests fabricate one).
"""

from __future__ import annotations

import os
import os.path as osp
import pickle

import numpy as np

from fusiontransformer_tpu_torch.data.nuscenes import splits
from fusiontransformer_tpu_torch.data.nuscenes.projection import (
    map_pointcloud_to_image)


def _class_names_to_id():
    from fusiontransformer_tpu_torch.data.nuscenes.nuscenes_dataloader import (
        NuScenesBase)
    mapping = dict(zip(NuScenesBase.class_names,
                       range(len(NuScenesBase.class_names))))
    mapping.pop("background", None)
    return mapping


def preprocess(nusc, split_names, root_dir, out_dir, keyword=None,
               keyword_action=None, subset_name=None, location=None):
    from fusiontransformer_tpu_torch.data.nuscenes.boxes import (
        category_to_detection_name, points_in_box)

    assert not (bool(keyword) and bool(location))
    if keyword:
        assert keyword_action in ("filter", "exclude")
    class_names_to_id = _class_names_to_id()

    pkl_dict = {name: [] for name in split_names}

    for i, sample in enumerate(nusc.sample):
        scene_name = nusc.get("scene", sample["scene_token"])["name"]
        curr_split = None
        for split_name in split_names:
            if scene_name in getattr(splits, split_name):
                curr_split = split_name
                break
        if curr_split is None:
            continue
        if subset_name == "night" and curr_split == "train" \
                and scene_name in splits.val_night:
            curr_split = "val"
        if subset_name == "singapore" and curr_split == "train" \
                and scene_name in splits.val_singapore:
            curr_split = "val"
        if keyword:
            desc = nusc.get("scene", sample["scene_token"])["description"]
            has_kw = keyword.lower() in desc.lower()
            if (has_kw and keyword_action == "exclude") \
                    or (not has_kw and keyword_action == "filter"):
                continue
        if location:
            scene = nusc.get("scene", sample["scene_token"])
            if location not in nusc.get("log", scene["log_token"])["location"]:
                continue

        lidar_token = sample["data"]["LIDAR_TOP"]
        cam_token = sample["data"]["CAM_FRONT"]
        lidar_path, boxes_lidar, _ = nusc.get_sample_data(lidar_token)
        cam_path, boxes_cam, cam_intrinsic = nusc.get_sample_data(cam_token)

        sd_lidar = nusc.get("sample_data", lidar_token)
        cs_lidar = nusc.get("calibrated_sensor",
                            sd_lidar["calibrated_sensor_token"])
        pose_lidar = nusc.get("ego_pose", sd_lidar["ego_pose_token"])
        sd_cam = nusc.get("sample_data", cam_token)
        cs_cam = nusc.get("calibrated_sensor",
                          sd_cam["calibrated_sensor_token"])
        pose_cam = nusc.get("ego_pose", sd_cam["ego_pose_token"])

        calib_infos = {
            "lidar2ego_translation": cs_lidar["translation"],
            "lidar2ego_rotation": cs_lidar["rotation"],
            "ego2global_translation_lidar": pose_lidar["translation"],
            "ego2global_rotation_lidar": pose_lidar["rotation"],
            "ego2global_translation_cam": pose_cam["translation"],
            "ego2global_rotation_cam": pose_cam["rotation"],
            "cam2ego_translation": cs_cam["translation"],
            "cam2ego_rotation": cs_cam["rotation"],
            "cam_intrinsic": cam_intrinsic,
        }

        pts = np.fromfile(lidar_path, dtype=np.float32,
                          count=-1).reshape(-1, 5)[:, :3].T
        valid, _, pts_img = map_pointcloud_to_image(pts, (900, 1600, 3),
                                                    calib_infos)
        pts_img = np.ascontiguousarray(np.fliplr(pts_img))  # (row, col)
        pts = pts[:, valid]

        num_pts = pts.shape[1]
        seg_labels = np.full(num_pts, fill_value=len(class_names_to_id),
                             dtype=np.uint8)
        valid_box_tokens = {box.token for box in boxes_cam}
        for box in boxes_lidar:
            if box.token not in valid_box_tokens:
                continue
            fg_mask = points_in_box(box, pts)
            det_class = category_to_detection_name(box.name)
            if det_class is not None:
                seg_labels[fg_mask] = class_names_to_id[det_class]

        pkl_dict[curr_split].append({
            "points": pts.T,
            "seg_labels": seg_labels,
            "points_img": pts_img,
            "lidar_path": osp.relpath(lidar_path, root_dir),
            "camera_path": osp.relpath(cam_path, root_dir),
            "boxes": boxes_lidar,
            "sample_token": sample["token"],
            "scene_name": scene_name,
            "calib": calib_infos,
        })
        if i % 200 == 0:
            print(f"{i}/{len(nusc.sample)} {scene_name}")

    save_dir = osp.join(out_dir, "preprocess")
    os.makedirs(save_dir, exist_ok=True)
    for split_name in split_names:
        suffix = "_" + subset_name if subset_name else ""
        save_path = osp.join(save_dir, f"{split_name}{suffix}.pkl")
        with open(save_path, "wb") as f:
            pickle.dump(pkl_dict[split_name], f)
        print("Wrote preprocessed data to " + save_path)


def main(argv=None):  # pragma: no cover
    import argparse

    from nuscenes.nuscenes import NuScenes

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    args = ap.parse_args(argv)
    nusc = NuScenes(version=args.version, dataroot=args.root, verbose=True)
    preprocess(nusc, ["train", "test"], args.root, args.out,
               location="boston", subset_name="usa")
    preprocess(nusc, ["train", "val", "test"], args.root, args.out,
               location="singapore", subset_name="singapore")
    preprocess(nusc, ["train", "test"], args.root, args.out,
               keyword="night", keyword_action="exclude", subset_name="day")
    preprocess(nusc, ["train", "val", "test"], args.root, args.out,
               keyword="night", keyword_action="filter", subset_name="night")


if __name__ == "__main__":
    main()
