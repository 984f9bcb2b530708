"""Synthetic in-memory LiDAR+camera scans for hermetic tests and benchmarks.

A copy of ``fusiontransformer_tpu/data/synthetic.py`` with the same rng draw
order, so one split and index give the same scan in both packages.

Replaces the reference's on-disk ``DebugDataset`` fixture: random planar surfaces inside a camera frustum, analytically projected to
pixels with a KITTI-like pinhole, labeled by surface id.  Emits exactly the
same per-item schema as the real SemanticKITTI dataset so every downstream
stage (collate, hierarchy, model, eval devoxelization) is exercised without
any dataset on disk.
"""

from __future__ import annotations

import numpy as np

from fusiontransformer_tpu_torch.data.quantize import sparse_quantize
from fusiontransformer_tpu_torch.data.utils.augmentation_3d import (
    augment_and_scale_3d)


def _class_palette(n):
    """n well-separated RGB colors: the {0, 1/2, 1}^3 lattice in a fixed
    shuffled order (min pairwise distance 0.5, far above the 0.25-amplitude
    noise layer), cycled if n > 27.  Deterministic — no rng draws."""
    lattice = np.stack(np.meshgrid(*[np.array([0.0, 0.5, 1.0])] * 3,
                                   indexing="ij"), -1).reshape(-1, 3)
    order = np.random.RandomState(12345).permutation(27)
    return lattice[order[np.arange(n) % 27]].astype(np.float32)


class SyntheticSCN:
    """KITTI-shaped synthetic dataset: 20 classes, voxels of 1 / ``scale`` m
    (5 cm) in a ``full_scale``^3 grid (4096).  With ``output_orig`` (the
    default here; the build passes False for the training split, as the JAX
    package does) items carry the eval-time fields (original labels,
    inverse map).  ``image_normalizer`` is accepted and unused, as in the
    JAX package: the rendered images stay in [0, 1].  ``aug``: the
    training split's augmentations (``noisy_rot``, ``flip_y``, ``rot_z``,
    ``transl`` of ``augment_and_scale_3d``), drawn from each item's
    ``RandomState(seed + index)`` after the scan, as in the JAX package.
    ``point_count_jitter`` > 0 draws each scan's ray count from
    U[(1 - jitter) * num_points, num_points] (the JAX package's draw), so
    that a run meets several capacity buckets."""

    num_classes = 20
    class_names = tuple(f"class_{i}" for i in range(num_classes))
    class_labels = tuple(range(num_classes))
    map_inverse_label = None       # the labels are the classes

    def __init__(self, split=("train",), num_scans=8, num_points=4096,
                 scale=20, full_scale=4096, image_width=1226,
                 image_height=370, image_normalizer=None, seed=0,
                 output_orig=True, point_count_jitter=0.0, **aug):
        self.split = split
        self.scale = scale
        self.full_scale = full_scale
        self.output_orig = output_orig
        self.num_scans = num_scans
        self.num_points = num_points
        self.point_count_jitter = float(point_count_jitter)
        self.image_width = image_width
        self.image_height = image_height
        self.aug = {k: v for k, v in aug.items()
                    if k in ("noisy_rot", "flip_y", "rot_z", "transl")}
        self.seed = seed + {"train": 0, "val": 10_000,
                            "test": 20_000}.get(split[0], 0)
        # KITTI-like intrinsics scaled to the synthetic image size.
        self.fx = 707.0 * image_width / 1226.0
        self.fy = 707.0 * image_height / 370.0
        self.cx = image_width / 2.0
        self.cy = image_height / 2.0

    def __len__(self):
        return self.num_scans

    def _draw_surfaces(self, rng):
        """Per-scan world: 2 side facades + 6 boxes (rng draw order is
        frozen — derived bucket ladders and every seeded test depend on the
        scan statistics staying bit-identical)."""
        walls = [(-1.0, -1.0 * rng.uniform(8.0, 20.0)),
                 (1.0, 1.0 * rng.uniform(8.0, 20.0))]
        boxes = []
        for _ in range(6):
            cx = rng.uniform(6.0, 45.0)
            cyy = rng.uniform(-8.0, 8.0)
            half = rng.uniform(0.8, 2.2)
            lab = 1 + int(rng.randint(1, self.num_classes - 1))
            boxes.append((cx, cyy, half, lab))
        return walls, boxes

    def _cast(self, dx, dy, dz, surfaces):
        """Nearest-hit ray cast against the scan's surfaces; returns
        (distance, label) per ray (label 0 = no hit)."""
        walls, boxes = surfaces
        t_best = np.full(dx.shape, 80.0)                   # max range
        label = np.zeros(dx.shape, np.int64)

        def hit(t, mask, lab):
            nonlocal t_best, label
            better = mask & (t > 0.5) & (t < t_best)
            t_best = np.where(better, t, t_best)
            label = np.where(better, lab, label)

        # Ground plane z = -1.73 (label 9 = 'road'-slot modulo classes).
        tz = np.where(dz < -1e-4, -1.73 / dz, np.inf)
        hit(tz, np.isfinite(tz), 9 % self.num_classes or 1)
        # Side facades y = +/- (8..20)m (label 13-slot, 'building').
        for sgn, ywall in walls:
            ty = np.where(sgn * dy > 1e-4, ywall / dy, np.inf)
            hit(ty, np.isfinite(ty), 13 % self.num_classes or 2)
        # A few boxes (cars etc.).
        for cx, cyy, half, lab in boxes:
            tx = cx / np.maximum(dx, 1e-4)
            py = tx * dy
            pz = tx * dz
            inside = (np.abs(py - cyy) < half) & (pz > -1.73) & (pz < 0.3)
            hit(tx, inside, lab)
        return t_best, label

    def _make_scan(self, rng):
        """Rotating-beam ray-cast scan (KITTI-like occupancy statistics).

        Rays from a 64-beam pattern hit the ground plane, 2 side facades, or
        one of a few random boxes — nearest intersection wins.  This matters
        for benchmarking: beam geometry produces the real dataset's strong
        voxel merging at coarse levels, which uniform random points do not.
        """
        n = self.num_points
        if self.point_count_jitter > 0:
            n = int(n * (1.0 - self.point_count_jitter * rng.rand()))
        n_beams = 64
        n_az = (n + n_beams - 1) // n_beams
        elev = np.linspace(-0.43, 0.05, n_beams)           # rad, ~KITTI HDL-64
        az_half = np.arctan(self.image_width / (2 * self.fx))
        az = np.linspace(-az_half, az_half, n_az)
        ev, av = np.meshgrid(elev, az, indexing="ij")
        ev = ev.ravel()[:n] + rng.randn(n) * 1e-3
        av = av.ravel()[:n] + rng.randn(n) * 1e-3
        # Ray directions in lidar frame (x fwd, y left, z up).
        dx = np.cos(ev) * np.cos(av)
        dy = np.cos(ev) * np.sin(av)
        dz = np.sin(ev)

        surfaces = self._draw_surfaces(rng)
        t_best, label = self._cast(dx, dy, dz, surfaces)

        valid = t_best < 79.0
        t = np.where(valid, t_best, 60.0)
        points = np.stack([t * dx, t * dy, t * dz], 1).astype(np.float32)
        seg = np.where(valid, label, 0).astype(np.int64)
        seg[seg == 0] = 1 + (np.arange(n)[seg == 0] % (self.num_classes - 1))
        # Keep only rays that project into the camera frustum.
        keep = points[:, 0] > 1.0
        return points[keep], seg[keep], surfaces

    def _render_image(self, surfaces, noise):
        """Camera view of the SAME surfaces the lidar rays hit: per-pixel
        ray cast at 1/2 resolution -> class-keyed colors -> upsample + the
        (pre-drawn) noise layer.  Makes the 2D stream learnable — a pixel's
        color determines the class of the surface behind it, so per-point
        lifted image features carry the label signal the reference's real
        camera provides.  Rendered at stride 2 to keep per-item cost low."""
        H, W = self.image_height, self.image_width
        h, w = (H + 1) // 2, (W + 1) // 2
        # Pixel centers (stride 2) -> camera rays via the inverse pinhole.
        v, u = np.meshgrid(np.arange(h) * 2 + 0.5, np.arange(w) * 2 + 0.5,
                           indexing="ij")
        dy = (self.cx - u) / self.fx
        dz = (self.cy - v) / self.fy
        dx = np.ones_like(dy)
        inv_n = 1.0 / np.sqrt(dx * dx + dy * dy + dz * dz)
        _, label = self._cast((dx * inv_n).ravel(), (dy * inv_n).ravel(),
                              (dz * inv_n).ravel(), surfaces)
        label = label.reshape(h, w)
        palette = _class_palette(self.num_classes + 1)
        img = palette[label]
        img = np.repeat(np.repeat(img, 2, axis=0), 2, axis=1)[:H, :W]
        return 0.75 * img + 0.25 * noise

    def _project(self, points):
        """Pinhole projection to (row, col); all synthetic points x>0."""
        u = self.cx - self.fx * points[:, 1] / points[:, 0]
        v = self.cy - self.fy * points[:, 2] / points[:, 0]
        rows = np.clip(np.floor(v), 0, self.image_height - 1)
        cols = np.clip(np.floor(u), 0, self.image_width - 1)
        return np.stack([rows, cols], 1).astype(np.int64)

    def __getitem__(self, index):
        rng = np.random.RandomState(self.seed + index)
        points, seg_label, surfaces = self._make_scan(rng)
        points_img = self._project(points)
        feats = np.concatenate(
            [points, rng.rand(len(points), 1).astype(np.float32)], 1)
        # The noise layer keeps this rng.rand draw (and so every downstream
        # augmentation draw / scan statistic) identical to the pre-render
        # generator; the class-keyed render is added deterministically.
        noise = rng.rand(self.image_height, self.image_width,
                         3).astype(np.float32)
        img = self._render_image(surfaces, noise)

        coords = augment_and_scale_3d(points, self.scale, self.full_scale,
                                      rng=rng, **self.aug).astype(np.int64)
        keep = (coords.min(1) >= 0) & (coords.max(1) < self.full_scale)
        vox_coords = coords[keep]
        vox_feats = feats[keep]
        vox_seg = seg_label[keep]
        vox_img_idx = points_img[keep]

        uniq, inverse = sparse_quantize(vox_coords)
        out = {
            "coords": vox_coords[uniq].astype(np.int32),
            "feats": vox_feats[uniq].astype(np.float32),
            "seg_label": vox_seg[uniq].astype(np.int32),
            "img_indices": vox_img_idx[uniq].astype(np.int32),
            "img": img,
            "seq": "synthetic",
            "filename": f"{index:06d}",
        }
        if self.output_orig:
            out["orig_seg_label"] = seg_label
            out["sparse_orig_points_idx"] = keep
            out["inverse_map"] = inverse
        return out
