"""KITTI raw-data utilities — the port's copy of
``vido_slam_tpu/data/kitti_utils.py``, the counterpart of the reference's
vendored mono_depth2 helpers (src/thirdparty/mono_depth2/src/depricated/
{kitti_utils.py, export_gt_depth.py}): calibration parsing, velodyne point
loading, and sparse GT depth-map generation by projecting the scan into the
rectified camera.

Behavioral parity notes (kitti_utils.py:45-100):
  - points behind the image plane (x < 0 in velodyne coords) are dropped;
  - pixel coords are `round(u) - 1` to match the KITTI matlab devkit;
  - duplicate pixels keep the MINIMUM depth (implemented here as a
    vectorised scatter-min instead of the reference's Counter loop);
  - negative depths zeroed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np


def load_velodyne_points(filename: str) -> np.ndarray:
    """(N, 4) float32 homogeneous points from a KITTI .bin scan (the 4th
    reflectance column is overwritten with 1)."""
    pts = np.fromfile(filename, dtype=np.float32).reshape(-1, 4).copy()
    pts[:, 3] = 1.0
    return pts


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    """KITTI 'key: v0 v1 ...' calibration text -> dict of float arrays
    (non-numeric values stay strings)."""
    out: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                out[key] = np.asarray([float(v) for v in value.split()])
            except ValueError:
                out[key] = value
    return out


def velo_to_image_projection(cam2cam: Dict, velo2cam: Dict, cam: int = 2
                             ) -> np.ndarray:
    """(3, 4) projection velodyne -> rectified camera `cam` image plane:
    P_rect_0N @ R_rect_00 @ Tr_velo_to_cam."""
    T = np.eye(4)
    T[:3, :3] = velo2cam["R"].reshape(3, 3)
    T[:3, 3] = velo2cam["T"]
    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    return P_rect @ R_rect @ T


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """Sparse (H, W) depth map for one frame from its velodyne scan and the
    day's calibration directory (calib_cam_to_cam.txt +
    calib_velo_to_cam.txt)."""
    cam2cam = read_calib_file(
        os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam = read_calib_file(
        os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    im_shape = cam2cam[f"S_rect_0{cam}"][::-1].astype(np.int32)  # (H, W)
    P = velo_to_image_projection(cam2cam, velo2cam, cam)

    velo = load_velodyne_points(velo_filename)
    velo = velo[velo[:, 0] >= 0]           # in front of the sensor

    proj = velo @ P.T                       # (N, 3)
    z = proj[:, 2]
    u = np.round(proj[:, 0] / z) - 1        # matlab-devkit pixel convention
    v = np.round(proj[:, 1] / z) - 1
    depth_val = velo[:, 0] if vel_depth else z

    H, W = int(im_shape[0]), int(im_shape[1])
    ok = (u >= 0) & (v >= 0) & (u < W) & (v < H)
    u = u[ok].astype(np.int64)
    v = v[ok].astype(np.int64)
    d = depth_val[ok]

    depth = np.full(H * W, np.inf, np.float64)
    np.minimum.at(depth, v * W + u, d)      # duplicate pixels keep min depth
    depth[~np.isfinite(depth)] = 0.0
    depth = depth.reshape(H, W)
    depth[depth < 0] = 0.0
    return depth.astype(np.float32)


def export_gt_depths(
    frames: Sequence, output_path: str, cam: int = 2,
    vel_depth: bool = True,
) -> List[np.ndarray]:
    """export_gt_depth.py counterpart without the split-file machinery:
    `frames` is a sequence of (calib_dir, velo_filename) pairs; writes the
    stacked result as a compressed npz {'data': object array} like the
    reference's gt_depths.npz and returns the list."""
    gt = [generate_depth_map(c, vf, cam, vel_depth) for c, vf in frames]
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    np.savez_compressed(output_path,
                        data=np.asarray(gt, dtype=object))
    return gt
