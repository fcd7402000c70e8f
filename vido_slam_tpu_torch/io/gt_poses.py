"""Ground-truth object pose parsers — Tracking::ObjPoseParsingKT /
ObjPoseParsingOX (reference vido_slam/src/Tracking.cc:2323-2497);
counterpart of ``vido_slam_tpu/io/gt_poses.py``, in numpy.

KITTI object GT rows: [frame, track_id, type..., x(6), y(7), z(8), ry(9)];
pose = [R_y(ry + pi/2) composed Euler y-x-z | t]. OMD rows carry position
(2..4) and an axis-angle rotation (5..7); the returned pose is expressed in
the first camera's frame via the sequence origin (Tracking.cc:2489-2492).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def obj_pose_parsing_kt(row: Sequence[float]) -> np.ndarray:
    """KITTI-format GT object pose (Tracking.cc:2323-2390)."""
    t = np.array([row[6], row[7], row[8]], np.float64)
    y = row[9] + np.pi / 2
    x = 0.0
    z = 0.0
    cy, sy = np.cos(y), np.sin(y)
    cx, sx = np.cos(x), np.sin(x)
    cz, sz = np.cos(z), np.sin(z)
    # R = Ry * Rx * Rz
    R = np.array([
        [cy * cz + sy * sx * sz, -cy * sz + sy * sx * cz, sy * cx],
        [cx * sz, cx * cz, -sx],
        [-sy * cz + cy * sx * sz, sy * sz + cy * sx * cz, cy * cx],
    ])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T.astype(np.float32)


def obj_pose_parsing_ox(row: Sequence[float],
                        origin_inv: np.ndarray | None = None) -> np.ndarray:
    """Oxford-Multimotion-format GT object pose (Tracking.cc:2392-2492):
    t = row[2:5], axis-angle = row[5:8] (Rodrigues); optionally re-expressed
    relative to the sequence origin."""
    t = np.array(row[2:5], np.float64)
    rvec = np.array(row[5:8], np.float64)
    angle = np.linalg.norm(rvec)
    if angle > 0:
        axis = rvec / angle
    else:
        axis = rvec
    s, c = np.sin(angle), np.cos(angle)
    v = 1 - c
    x, y, z = axis
    R = np.array([
        [x * x * v + c, x * y * v - z * s, x * z * v + y * s],
        [x * y * v + z * s, y * y * v + c, y * z * v - x * s],
        [x * z * v - y * s, y * z * v + x * s, z * z * v + c],
    ])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    if origin_inv is not None:
        T = np.asarray(origin_inv, np.float64) @ T
    return T.astype(np.float32)
