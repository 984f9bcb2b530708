"""Native NuScenes box geometry + detection-class mapping (a copy of
``fusiontransformer_tpu/data/nuscenes/boxes.py``).

Replaces the two nuscenes-devkit functions the preprocessor used
(``nuscenes.utils.geometry_utils.points_in_box`` and
``nuscenes.eval.detection.utils.category_to_detection_name``, reference
``data/nuscenes/preprocess.py:8-9,110-119``) with numpy implementations, so
the devkit is only needed to read the dataset DB — not for any geometry.

A "box" is anything exposing the devkit ``Box`` attributes used here:
``center`` (3,), ``wlh`` (width, length, height), ``orientation`` (either an
object with ``.rotation_matrix`` — e.g. a pyquaternion Quaternion — or a
length-4 (w, x, y, z) array), plus ``name``/``token`` read by the caller.
"""

from __future__ import annotations

import numpy as np

from fusiontransformer_tpu_torch.data.nuscenes.projection import (
    quaternion_rotation_matrix)

# Official nuScenes detection-challenge mapping (general category ->
# detection class); categories absent here (e.g. static_object.*,
# animal) carry no detection label.
DETECTION_NAME_MAP = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}


def category_to_detection_name(category_name):
    return DETECTION_NAME_MAP.get(category_name)


def _rotation_matrix(orientation):
    rm = getattr(orientation, "rotation_matrix", None)
    if rm is not None:
        return np.asarray(rm, dtype=np.float64)
    return quaternion_rotation_matrix(orientation)


def points_in_box(box, points, wlh_factor: float = 1.0):
    """Boolean mask of ``points`` (3, N) inside the oriented ``box``.

    Devkit parity: the box x-axis spans the length, y the width, z the
    height; a point is inside when its box-frame coordinates fall within
    ``wlh_factor/2`` of each extent.
    """
    points = np.asarray(points, dtype=np.float64)
    assert points.ndim == 2 and points.shape[0] == 3, points.shape
    rot = _rotation_matrix(box.orientation)
    local = rot.T @ (points - np.asarray(
        box.center, dtype=np.float64).reshape(3, 1))
    w, l, h = np.asarray(box.wlh, dtype=np.float64) * wlh_factor
    return ((np.abs(local[0]) <= l / 2.0)
            & (np.abs(local[1]) <= w / 2.0)
            & (np.abs(local[2]) <= h / 2.0))


class SimpleBox:
    """Minimal devkit-``Box``-compatible container (tests, fake DBs)."""

    def __init__(self, center, wlh, orientation=(1.0, 0.0, 0.0, 0.0),
                 name="vehicle.car", token=""):
        self.center = np.asarray(center, dtype=np.float64)
        self.wlh = np.asarray(wlh, dtype=np.float64)
        self.orientation = np.asarray(orientation, dtype=np.float64)
        self.name = name
        self.token = token
