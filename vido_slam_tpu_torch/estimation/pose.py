"""Per-frame camera pose and object motion estimation — counterpart of
``vido_slam_tpu/estimation/pose.py`` on its ``use_pallas=True`` branches:
RANSAC against the motion-model hypothesis, then the batched LM of
``lm_kernel`` (PoseOptimizationNew with Huber sqrt(0.01) for the camera,
PoseOptimizationObjMot through P = K Tcw without a robust kernel for the
objects; Optimizer.cc:2180-2334, 2826-3035)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vido_slam_tpu_torch.estimation.lm_kernel import pose_lm_batched
from vido_slam_tpu_torch.estimation.ransac import pnp_ransac, score
from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.geometry.se3 import inverse_se3

RP_THRES = 0.01          # chi2 inlier threshold, camera and objects
HUBER_DELTA_POSE = 0.1   # sqrt(0.01)
POSE_ITERS = 100
OBJ_ITERS = 100
RANSAC_REPROJ = 0.4      # px (Tracking.cc:1966)


class PoseEstimate(NamedTuple):
    T: torch.Tensor            # (4, 4)
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor
    chi2: torch.Tensor         # (N,)


def pose_optimization(T_init, pts3d_world, obs_uv, valid, cam: Camera,
                      max_iters: int = POSE_ITERS) -> PoseEstimate:
    """LM refine of the camera pose on fixed correspondences."""
    eye = torch.eye(4, dtype=T_init.dtype, device=T_init.device)
    pb = pose_lm_batched(
        T_init[None].contiguous(), eye[None], pts3d_world.contiguous(),
        obs_uv.contiguous(), valid[None].contiguous(), cam,
        huber_delta=HUBER_DELTA_POSE, max_iters=max_iters)
    inl = (pb.chi2[0] <= RP_THRES) & valid
    return PoseEstimate(T=pb.T[0], inliers=inl, num_inliers=inl.sum(),
                        chi2=pb.chi2[0])


def estimate_camera_pose(key, pts3d_world, obs_uv, valid, cam: Camera,
                         T_motion_model, obs_pc: Optional[torch.Tensor] = None,
                         num_hypotheses: int = 500) -> PoseEstimate:
    """RANSAC vs the constant-velocity model (Tracking.cc:1125-1136), then
    the LM on the winner's inliers. On a tie RANSAC wins (a deliberate
    choice of the JAX package: the motion model compounds two earlier
    estimates and, picked every frame, feeds back unstably)."""
    rr = pnp_ransac(key[None], pts3d_world, obs_uv, valid[None], cam, obs_pc,
                    num_hypotheses=num_hypotheses)
    mm_ok, mm_count = score(T_motion_model[None], pts3d_world, obs_uv, cam,
                            valid[None], RANSAC_REPROJ)
    use_ransac = rr.num_inliers[0] >= mm_count[0]
    T_init = torch.where(use_ransac, rr.T[0], T_motion_model)
    init_inl = torch.where(use_ransac, rr.inliers[0], mm_ok[0])
    return pose_optimization(T_init, pts3d_world, obs_uv, init_inl, cam)


def object_motion_optimization(H_init, Tcw, pts3d_world, obs_uv, valid,
                               cam: Camera,
                               max_iters: int = OBJ_ITERS) -> PoseEstimate:
    """LM refine of one rigid object's world-frame motion H (X_cur = H
    X_pre) through P = K Tcw, without a robust kernel: a B=1 call of the
    batched LM."""
    pb = pose_lm_batched(
        H_init[None].contiguous(), Tcw[None].contiguous(),
        pts3d_world.contiguous(), obs_uv.contiguous(),
        valid[None].contiguous(), cam, huber_delta=None, max_iters=max_iters)
    inl = (pb.chi2[0] <= RP_THRES) & valid
    return PoseEstimate(T=pb.T[0], inliers=inl, num_inliers=inl.sum(),
                        chi2=pb.chi2[0])


def _object_motions(keys, Tcw, pts3d_world, obs_uv, masks, cam: Camera,
                    H_motion_model, has_motion_model, obs_pc,
                    num_hypotheses: int):
    """RANSAC against the motion model for each of K objects, then their K
    LM refines as one batched solve: (the batch's result, inliers (K, N))."""
    K = masks.shape[0]
    rr = pnp_ransac(keys, pts3d_world, obs_uv, masks, cam, obs_pc,
                    num_hypotheses=num_hypotheses)
    M_mm = Tcw @ H_motion_model
    mm_ok, mm_count = score(M_mm, pts3d_world, obs_uv, cam, masks,
                            RANSAC_REPROJ)
    mm_count = torch.where(has_motion_model, mm_count,
                           torch.full_like(mm_count, -1))
    use_ransac = rr.num_inliers >= mm_count
    M_init = torch.where(use_ransac[:, None, None], rr.T, M_mm)
    init_inl = torch.where(use_ransac[:, None], rr.inliers, mm_ok)
    H_init = inverse_se3(Tcw) @ M_init
    pb = pose_lm_batched(
        H_init.contiguous(), Tcw.expand(K, 4, 4).contiguous(),
        pts3d_world.contiguous(), obs_uv.contiguous(),
        init_inl.contiguous(), cam, huber_delta=None, max_iters=OBJ_ITERS)
    return pb, (pb.chi2 <= RP_THRES) & init_inl


def estimate_object_motions_batched(keys, Tcw, pts3d_world, obs_uv, masks,
                                    cam: Camera, H_motion_model,
                                    has_motion_model,
                                    obs_pc: Optional[torch.Tensor] = None,
                                    num_hypotheses: int = 500):
    """All K object motions at once: keys (K, 2), masks (K, N),
    H_motion_model (K, 4, 4), has_motion_model (K,). RANSAC solves for
    M = Tcw H; the winner becomes H = Tcw^-1 M and the K LM refines run as
    one batched solve. Returns (H (K, 4, 4), inliers (K, N), counts (K,))."""
    pb, inl = _object_motions(keys, Tcw, pts3d_world, obs_uv, masks, cam,
                              H_motion_model, has_motion_model, obs_pc,
                              num_hypotheses)
    return pb.T, inl, inl.sum(dim=-1)


def estimate_object_motion(key, Tcw, pts3d_world, obs_uv, valid, cam: Camera,
                           H_motion_model, has_motion_model,
                           obs_pc: Optional[torch.Tensor] = None,
                           num_hypotheses: int = 500) -> PoseEstimate:
    """One object's motion (Tracking.cc:1213, 2030-2162): the B=1 case of
    ``estimate_object_motions_batched``, with the LM's chi2."""
    has = torch.as_tensor(has_motion_model, device=Tcw.device)
    pb, inl = _object_motions(key[None], Tcw, pts3d_world, obs_uv,
                              valid[None], cam, H_motion_model[None],
                              has[None], obs_pc, num_hypotheses)
    return PoseEstimate(T=pb.T[0], inliers=inl[0],
                        num_inliers=inl[0].sum(), chi2=pb.chi2[0])
