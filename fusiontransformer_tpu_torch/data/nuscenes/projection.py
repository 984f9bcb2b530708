"""LiDAR -> front-camera projection for NuScenes (reference
``data/nuscenes/projection.py:9-69``); a copy of
``fusiontransformer_tpu/data/nuscenes/projection.py``.

Transform chain: lidar -> ego(t_lidar) -> global -> ego(t_cam) -> camera ->
pinhole.  Quaternion math is implemented in numpy (no pyquaternion
dependency): q = (w, x, y, z) as stored by the devkit.
"""

from __future__ import annotations

import numpy as np


def quaternion_rotation_matrix(q):
    """Rotation matrix from (w, x, y, z) quaternion."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])


def view_points(points, intrinsic, normalize=True):
    """Project 3D camera-frame points with a 3x3 intrinsic (devkit parity)."""
    viewpad = np.eye(4)
    intrinsic = np.asarray(intrinsic)
    viewpad[:intrinsic.shape[0], :intrinsic.shape[1]] = intrinsic
    n = points.shape[1]
    pts = np.concatenate([points, np.ones((1, n))])
    pts = viewpad @ pts
    pts = pts[:3]
    if normalize:
        pts = pts / pts[2:3].repeat(3, 0).reshape(3, n)
    return pts


def map_pointcloud_to_image(pc, im_shape, info):
    """Returns (mask, cam_frame_points.T, pixel_coords[:, :2] as (col, row)).

    pc: (3, N) lidar-frame points; info: calibration dict with the devkit
    translation/rotation entries (see reference preprocess ``:86-96``).
    """
    pc = pc.copy()

    pc = quaternion_rotation_matrix(info["lidar2ego_rotation"]) @ pc
    pc = pc + np.array(info["lidar2ego_translation"])[:, np.newaxis]

    pc = quaternion_rotation_matrix(info["ego2global_rotation_lidar"]) @ pc
    pc = pc + np.array(info["ego2global_translation_lidar"])[:, np.newaxis]

    pc = pc - np.array(info["ego2global_translation_cam"])[:, np.newaxis]
    pc = quaternion_rotation_matrix(info["ego2global_rotation_cam"]).T @ pc

    pc = pc - np.array(info["cam2ego_translation"])[:, np.newaxis]
    pc = quaternion_rotation_matrix(info["cam2ego_rotation"]).T @ pc

    depths = pc[2, :]
    points = view_points(pc, np.array(info["cam_intrinsic"]), normalize=True)
    points = points.astype(np.float32)

    mask = (depths > 0) \
        & (points[0, :] > 0) & (points[0, :] < im_shape[1]) \
        & (points[1, :] > 0) & (points[1, :] < im_shape[0])
    points = points[:, mask]
    return mask, pc.T, points.T[:, :2]
