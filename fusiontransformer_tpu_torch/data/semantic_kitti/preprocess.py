"""Offline SemanticKITTI preprocessor (reference ``data/semantic_kitti/preprocess.py``;
a copy of ``fusiontransformer_tpu/data/semantic_kitti/preprocess.py``).

Per camera frame: read the velodyne scan and label file (lower 16 bits are the
semantic id), keep points in front of the vehicle, project with P2 @ Tr,
frustum-cull to the image rectangle, store (row, col) pixel coords, and pickle
one record per frame with the same schema the dataset reader expects:
``{points, feats, seg_labels, points_img, lidar_path, camera_path, image_size}``.

Pure numpy — no torch DataLoader scaffolding; an optional thread pool overlaps
file IO with projection math.  Images are opened with Pillow, imported where
an image is read (the module imports without it).

Usage:
    python -m fusiontransformer_tpu_torch.data.semantic_kitti.preprocess \
        --root /data/SemanticKitti --out /data/SemanticKitti/preprocessed
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from fusiontransformer_tpu_torch.data.semantic_kitti import splits


def read_calib(calib_path):
    calib_all = {}
    with open(calib_path, "r") as f:
        for line in f:
            if line == "\n":
                break
            key, value = line.split(":", 1)
            calib_all[key] = np.array([float(x) for x in value.split()])
    out = {"P2": calib_all["P2"].reshape(3, 4), "Tr": np.identity(4)}
    out["Tr"][:3, :4] = calib_all["Tr"].reshape(3, 4)
    return out


def select_points_in_frustum(points_2d, x1, y1, x2, y2):
    return ((points_2d[:, 0] > x1) & (points_2d[:, 1] > y1)
            & (points_2d[:, 0] < x2) & (points_2d[:, 1] < y2))


def process_frame(cam_path, lidar_path, label_path, proj_matrix,
                  img_width, img_height):
    scan = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, 4)
    points = scan[:, :3]
    label = np.fromfile(label_path, dtype=np.uint32).reshape(-1)
    label = label & 0xFFFF  # lower half = semantic id

    from PIL import Image
    with Image.open(cam_path) as im:
        image_size = im.crop((0, 0, img_width, img_height)).size

    keep_idx = points[:, 0] > 0
    pts_h = np.concatenate(
        [points[keep_idx],
         np.ones([int(keep_idx.sum()), 1], dtype=np.float32)], axis=1)
    img_points = (proj_matrix @ pts_h.T).T
    img_points = img_points[:, :2] / img_points[:, 2:3]
    keep_img = select_points_in_frustum(img_points, 0, 0, *image_size)
    keep_idx[keep_idx] = keep_img
    img_points = np.fliplr(img_points)  # (row, col), not (col, row)

    return {
        "points": points[keep_idx],
        "feats": scan[keep_idx],
        "seg_labels": label[keep_idx].astype(np.int16),
        "points_img": img_points[keep_img],
        "image_size": tuple(image_size),
    }


def preprocess(split_name, root_dir, out_dir, img_width, img_height,
               num_workers=4, debug=False):
    sequences = getattr(splits.debug if debug else splits.regular, split_name)
    for seq in sequences:
        seq_dir = osp.join(root_dir, "dataset", "sequences", seq)
        cam_paths = sorted(glob.glob(osp.join(seq_dir, "image_2", "*.png")))
        calib = read_calib(osp.join(seq_dir, "calib.txt"))
        proj_matrix = (calib["P2"] @ calib["Tr"]).astype(np.float32)
        save_dir = osp.join(out_dir, str(seq))
        os.makedirs(save_dir, exist_ok=True)

        def handle(i_cam):
            i, cam_path = i_cam
            frame_id = osp.splitext(osp.basename(cam_path))[0]
            lidar_path = osp.join(seq_dir, "velodyne", frame_id + ".bin")
            label_path = osp.join(seq_dir, "labels", frame_id + ".label")
            rec = process_frame(cam_path, lidar_path, label_path, proj_matrix,
                                img_width, img_height)
            rec["lidar_path"] = osp.relpath(lidar_path, root_dir)
            rec["camera_path"] = osp.relpath(cam_path, root_dir)
            with open(osp.join(save_dir, f"{i}.pkl"), "wb") as f:
                pickle.dump(rec, f)
            return i

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            for i in pool.map(handle, enumerate(cam_paths)):
                if i % 200 == 0:
                    print(f"{seq}: {i}/{len(cam_paths)}")


def calculate_min_img_shape(root_dir):
    """Smallest (W, H) over all camera images (reference ``:172-186``)."""
    from PIL import Image
    paths = list(Path(root_dir).rglob("dataset/sequences/**/image_2/*.png"))
    shapes = []
    for p in paths:
        with Image.open(str(p)) as img:
            shapes.append(img.size)
    shapes = np.array(shapes)
    return int(shapes[:, 0].min()), int(shapes[:, 1].min())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--splits", nargs="+", default=["val", "train", "test"])
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    w, h = args.width, args.height
    if not (w and h):
        w, h = calculate_min_img_shape(args.root)
        print("min image shape:", w, h)
    for split in args.splits:
        preprocess(split, args.root, args.out, w, h, args.workers)


if __name__ == "__main__":
    main()
