"""Raw SemanticKITTI- and NuScenes-format data, for drives of the real-data
path (preprocess -> train -> validate -> test) without the datasets.

* ``make_kitti`` writes a raw SemanticKITTI tree in the on-disk formats the
  preprocessor reads: per frame ``velodyne/<id>.bin`` (float32 x, y, z,
  intensity), ``labels/<id>.label`` (uint32: raw semantic id in the low 16
  bits, an instance id above) and ``image_2/<id>.png`` (8-bit RGB), and a
  ``calib.txt`` (P2, Tr) per sequence.  The scans are ``SyntheticSCN``'s
  beam-pattern ray casts (a 64-beam lidar against ground, facades and
  boxes), so voxels merge across levels as in a real scan; the image is the
  camera's render of the same surfaces; the calibration is the synthetic
  pinhole.  Every sequence of the regular train / val / test splits gets at
  least its ``calib.txt``, so the preprocessor runs over every split.
* ``FakeNuScenes`` is a duck-typed stand-in for ``nuscenes.NuScenes`` (the
  tables ``data/nuscenes/preprocess.py`` reads, an identity calibration
  chain: lidar frame = camera frame, looking along +z) over such scans,
  with 5-channel lidar ``.bin`` files, a JPEG front image per sample and
  oriented boxes of detection categories.

    python -m fusiontransformer_tpu_torch.tools.fabricate --root R \\
        [--frames 00:20 07:10 08:4] [--rays 36000] [--width 1226] [--height 370]

Images are written with Pillow, imported where one is written.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from fusiontransformer_tpu_torch.data.nuscenes.boxes import (
    DETECTION_NAME_MAP, SimpleBox)
from fusiontransformer_tpu_torch.data.semantic_kitti import labels as L
from fusiontransformer_tpu_torch.data.semantic_kitti import splits
from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN

KITTI_FRAMES = {"00": 20, "07": 10, "08": 4}
# Lidar (x forward, y left, z up) to the KITTI camera (x right, y down,
# z forward).
KITTI_TR = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]], float)


def _uint8(img):
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def _scans(rays, width, height, seed):
    """``SyntheticSCN`` for beam scans and renders at ``width`` x
    ``height``, and a generator for the extra draws."""
    return (SyntheticSCN(num_points=rays, image_width=width,
                         image_height=height),
            np.random.RandomState(seed))


def make_kitti(root, frames=None, rays=36000, width=1226, height=370,
               seed=0):
    """Write the raw tree under ``root``; ``frames``: frames per sequence
    (default ``KITTI_FRAMES``: 20 in 00, a train sequence; 10 in 07, val;
    4 in 08, test).  Returns {sequence: frames}."""
    from PIL import Image

    frames = dict(KITTI_FRAMES if frames is None else frames)
    gen, rng = _scans(rays, width, height, seed)
    p2 = np.array([[gen.fx, 0, gen.cx, 0], [0, gen.fy, gen.cy, 0],
                   [0, 0, 1, 0]])
    sequences = sorted(set(splits.regular.train + splits.regular.val
                           + splits.regular.test) | set(frames))
    raw_of_train = np.array([L.LEARNING_MAP_INV[i]
                             for i in range(L.NUM_CLASSES)], np.uint32)
    for seq in sequences:
        seq_dir = osp.join(root, "dataset", "sequences", seq)
        for sub in ("velodyne", "labels", "image_2"):
            os.makedirs(osp.join(seq_dir, sub), exist_ok=True)
        with open(osp.join(seq_dir, "calib.txt"), "w") as f:
            for key, m in (("P0", np.zeros(12)), ("P2", p2),
                           ("Tr", KITTI_TR)):
                f.write(f"{key}: " + " ".join(repr(float(v))
                                              for v in m.reshape(-1)) + "\n")
        for i in range(frames.get(seq, 0)):
            points, seg, surfaces = gen._make_scan(rng)
            scan = np.concatenate(
                [points, rng.rand(len(points), 1).astype(np.float32)], 1)
            scan.astype(np.float32).tofile(
                osp.join(seq_dir, "velodyne", f"{i:06d}.bin"))
            instance = rng.randint(0, 1 << 16, len(seg)).astype(np.uint32)
            (raw_of_train[seg] | (instance << 16)).tofile(
                osp.join(seq_dir, "labels", f"{i:06d}.label"))
            noise = rng.rand(height, width, 3).astype(np.float32)
            Image.fromarray(_uint8(gen._render_image(surfaces, noise))).save(
                osp.join(seq_dir, "image_2", f"{i:06d}.png"))
    return frames


class FakeNuScenes:
    """The ``nusc`` tables ``data/nuscenes/preprocess.py`` reads, for
    ``scenes`` = [(name, description, location, samples), ...]: each sample
    a beam scan of ``rays`` rays in the camera's frame (identity chain,
    1600 x 900 image, focal length 400), three boxes of detection
    categories centred on scan points, and a JPEG front image under
    ``root``."""

    W, H, F = 1600, 900, 400.0

    def __init__(self, root, scenes, rays=10000, seed=0):
        from PIL import Image

        gen, rng = _scans(rays, self.W, self.H, seed)
        ident = {"translation": [0.0, 0.0, 0.0],
                 "rotation": [1.0, 0.0, 0.0, 0.0]}
        self.intrinsic = np.array([[self.F, 0, self.W / 2],
                                   [0, self.F, self.H / 2], [0, 0, 1.0]])
        self.sample = []
        self._tables = {"scene": {}, "log": {}, "sample_data": {},
                        "calibrated_sensor": {"cs0": dict(ident)},
                        "ego_pose": {"ep0": dict(ident)}}
        self._payload = {}
        categories = sorted(DETECTION_NAME_MAP)
        os.makedirs(osp.join(root, "samples"), exist_ok=True)
        n = 0
        for s, (name, description, location, samples) in enumerate(scenes):
            self._tables["log"][f"log{s}"] = {"location": location}
            self._tables["scene"][f"scene{s}"] = {
                "name": name, "description": description,
                "log_token": f"log{s}"}
            for _ in range(samples):
                points, _, surfaces = gen._make_scan(rng)
                # Lidar axes to the camera's: x right, y down, z forward.
                cam = np.stack([-points[:, 1], -points[:, 2], points[:, 0]])
                pts5 = np.concatenate([cam, rng.rand(2, cam.shape[1])])
                lidar = osp.join(root, "samples", f"lidar{n}.bin")
                pts5.T.astype(np.float32).tofile(lidar)
                image = osp.join(root, "samples", f"cam{n}.jpg")
                noise = rng.rand(self.H, self.W, 3).astype(np.float32)
                Image.fromarray(_uint8(gen._render_image(
                    surfaces, noise))).save(image)
                boxes = [SimpleBox(center=cam[:, rng.randint(cam.shape[1])],
                                   wlh=(2.0, 4.0, 2.0),
                                   name=categories[rng.randint(
                                       len(categories))],
                                   token=f"box{n}_{b}") for b in range(3)]
                lid_tok, cam_tok = f"lid{n}", f"cam{n}"
                for tok in (lid_tok, cam_tok):
                    self._tables["sample_data"][tok] = {
                        "calibrated_sensor_token": "cs0",
                        "ego_pose_token": "ep0"}
                self._payload[lid_tok] = (lidar, boxes, None)
                self._payload[cam_tok] = (image, boxes, self.intrinsic)
                self.sample.append({
                    "token": f"sample{n}", "scene_token": f"scene{s}",
                    "data": {"LIDAR_TOP": lid_tok, "CAM_FRONT": cam_tok}})
                n += 1

    def get(self, table, token):
        return self._tables[table][token]

    def get_sample_data(self, token):
        return self._payload[token]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Write a raw SemanticKITTI-"
                                 "format tree of synthetic beam scans")
    ap.add_argument("--root", required=True)
    ap.add_argument("--frames", nargs="+", default=None,
                    help="SEQ:N frames per sequence (default "
                    + " ".join(f"{k}:{v}" for k, v in KITTI_FRAMES.items())
                    + ")")
    ap.add_argument("--rays", type=int, default=36000)
    ap.add_argument("--width", type=int, default=1226)
    ap.add_argument("--height", type=int, default=370)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    frames = (None if args.frames is None else
              {s: int(n) for s, n in (f.split(":") for f in args.frames)})
    print(make_kitti(args.root, frames, args.rays, args.width, args.height,
                     args.seed))


if __name__ == "__main__":
    main()
