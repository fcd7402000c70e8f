"""Trajectory and object-motion metrics — Tracking::GetMetricError
(reference vido_slam/src/Tracking.cc:3531-3674) plus standard ATE.

The reference prints RPE-style per-frame camera translation/rotation errors
and per-object motion errors evaluated in the object body frame
(RigMotBody = ObjPosePre^-1 * RigMot * ObjPosePre). This module reproduces
those plus ATE RMSE with optional Umeyama alignment for benchmarking.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _rot_angle_deg(R: np.ndarray) -> float:
    tr = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    return float(np.degrees(np.arccos(tr)))


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity aligning src -> dst; returns (R, t, s)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def camera_centers(poses_cw: np.ndarray) -> np.ndarray:
    """(T, 4, 4) world->cam poses -> (T, 3) camera centers in world."""
    R = poses_cw[:, :3, :3]
    t = poses_cw[:, :3, 3]
    return -np.einsum("tij,ti->tj", R, t)


def ate_rmse(
    est_cw: np.ndarray, gt_cw: np.ndarray, align: bool = True,
    with_scale: bool = False,
) -> float:
    """Absolute trajectory error RMSE over camera centers."""
    pe = camera_centers(est_cw)
    pg = camera_centers(gt_cw)
    if align:
        R, t, s = umeyama_alignment(pe, pg, with_scale)
        pe = (s * (R @ pe.T)).T + t
    err = np.linalg.norm(pe - pg, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe_camera(
    est_cw: np.ndarray, gt_cw: np.ndarray
) -> Dict[str, float]:
    """Per-frame relative pose error (translation m, rotation deg) —
    the quantity GetMetricError prints per frame, averaged."""
    T = est_cw.shape[0]
    t_errs, r_errs = [], []
    for i in range(1, T):
        rel_est = est_cw[i] @ np.linalg.inv(est_cw[i - 1])
        rel_gt = gt_cw[i] @ np.linalg.inv(gt_cw[i - 1])
        dE = np.linalg.inv(rel_gt) @ rel_est
        t_errs.append(np.linalg.norm(dE[:3, 3]))
        r_errs.append(_rot_angle_deg(dE[:3, :3]))
    return {
        "rpe_trans_mean": float(np.mean(t_errs)) if t_errs else 0.0,
        "rpe_rot_deg_mean": float(np.mean(r_errs)) if r_errs else 0.0,
    }


def object_motion_error(
    H_est: np.ndarray, H_gt: np.ndarray, obj_pose_pre: Optional[np.ndarray] = None
) -> Dict[str, float]:
    """Error of one object motion estimate.

    If obj_pose_pre is given, the error transform is conjugated into the
    object body frame first (Tracking.cc:3606-3640: RigMotBody =
    ObjPosePre^-1 * RigMot * ObjPosePre)."""
    if obj_pose_pre is not None:
        P = obj_pose_pre
        Pinv = np.linalg.inv(P)
        H_est = Pinv @ H_est @ P
        H_gt = Pinv @ H_gt @ P
    dE = np.linalg.inv(H_gt) @ H_est
    return {
        "trans_err": float(np.linalg.norm(dE[:3, 3])),
        "rot_err_deg": _rot_angle_deg(dE[:3, :3]),
    }


def gt_object_motion(pose_pre: np.ndarray, pose_cur: np.ndarray) -> np.ndarray:
    """World-frame GT rigid motion from two object poses (object->world):
    a point on the body moves x_w(t) = P_t P_{t-1}^-1 x_w(t-1), so
    H_gt = P_cur @ inv(P_pre) — the quantity the estimated vmRigidMotion is
    compared against (Tracking.cc GetMetricError)."""
    return np.asarray(pose_cur) @ np.linalg.inv(np.asarray(pose_pre))


def speed_error(speed_est_kmh: float, H_gt: np.ndarray, centroid: np.ndarray,
                fps: float = 10.0) -> float:
    """|est - gt| speed where gt = |t - (I-R) c| * 3.6 * fps (Tracking.cc:1295-1302)."""
    v = H_gt[:3, 3] - (np.eye(3) - H_gt[:3, :3]) @ centroid
    gt = np.linalg.norm(v) * 3.6 * fps
    return float(abs(speed_est_kmh - gt))
