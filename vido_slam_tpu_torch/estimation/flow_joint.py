"""Joint flow + pose estimation (the reference's bJoint path) — counterpart
of ``vido_slam_tpu/estimation/flow_joint.py``:

- ``flow_joint_optimization``: one joint solve (PoseOptimizationFlow2Cam /
  PoseOptimizationFlow2, Optimizer.cc:2622-2824, 3037-3253), a B=1 call of
  the batched kernel ``flow_joint_batched``;
- ``estimate_camera_pose_joint``: GetInitModelCam, then Flow2Cam
  (Tracking.cc:1125-1135);
- ``estimate_object_motions_joint_batched``: GetInitModelObj, then Flow2
  for all K objects in one kernel launch (Tracking.cc:1213, 1268-1271);
  ``estimate_object_motion_joint`` is its K=1 case.

Unlike the fixed-correspondence estimators of ``pose.py``, the joint ones
keep the motion model on a tie: RANSAC wins only with strictly more 0.4 px
inliers (the reference's ``>``, Tracking.cc:2012), as the JAX package's
joint estimators do. The caller moves inlier keypoints to
``obs_last + flow_opt`` (the reference's updateflow write-back).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vido_slam_tpu_torch.estimation.flow_joint_kernel import (
    CHI2_LATER,
    HUBER_DELTA,
    MIN_EDGES,
    ROUND_ITERS,
    RP_THRES_JOINT,
    SIGMA_PRIOR,
    SIGMA_PROJ,
    flow_joint_batched,
)
from vido_slam_tpu_torch.estimation.pose import (
    RANSAC_REPROJ,
    PoseEstimate,
)
from vido_slam_tpu_torch.estimation.ransac import pnp_ransac, score
from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.geometry.se3 import inverse_se3

# the reference constants live beside the kernel's plain version, which
# needs them; they are part of this module's interface, as in the JAX one
__all__ = [
    "CHI2_LATER", "HUBER_DELTA", "MIN_EDGES", "ROUND_ITERS", "RP_THRES_JOINT",
    "SIGMA_PRIOR", "SIGMA_PROJ", "FlowJointEstimate",
    "estimate_camera_pose_joint", "estimate_object_motion_joint",
    "estimate_object_motions_joint_batched", "flow_joint_optimization",
]


class FlowJointEstimate(NamedTuple):
    T: torch.Tensor            # (4, 4) optimized SE(3) vertex
    flow: torch.Tensor         # (N, 2) optimized per-point flow
    inliers: torch.Tensor      # (N,) bool, the last round's chi2 gate
    num_inliers: torch.Tensor
    chi2: torch.Tensor         # (N,) final 0.1 |r1|^2


def flow_joint_optimization(T_init, pts3d_world, obs_last, flow_meas, valid,
                            cam: Camera,
                            iters: int = ROUND_ITERS) -> FlowJointEstimate:
    """The four-round joint solve of one problem."""
    jb = flow_joint_batched(
        T_init[None].contiguous(), pts3d_world.contiguous(),
        obs_last.contiguous(), flow_meas.contiguous(),
        valid[None].contiguous(), cam, iters=iters)
    return FlowJointEstimate(T=jb.T[0], flow=jb.flow[0], inliers=jb.inliers[0],
                             num_inliers=jb.num_inliers[0], chi2=jb.chi2[0])


def estimate_camera_pose_joint(key, pts3d_world, obs_last, cur_uv, valid,
                               cam: Camera, T_motion_model,
                               obs_pc: Optional[torch.Tensor] = None,
                               num_hypotheses: int = 500):
    """RANSAC vs the constant-velocity model on the flow-propagated
    positions ``cur_uv``, then the joint solve from the winner on its
    inliers. Returns (PoseEstimate, flow_opt (N, 2))."""
    rr = pnp_ransac(key[None], pts3d_world, cur_uv, valid[None], cam, obs_pc,
                    num_hypotheses=num_hypotheses)
    mm_ok, mm_count = score(T_motion_model[None], pts3d_world, cur_uv, cam,
                            valid[None], RANSAC_REPROJ)
    use_ransac = rr.num_inliers[0] > mm_count[0]
    T_init = torch.where(use_ransac, rr.T[0], T_motion_model)
    init_inl = torch.where(use_ransac, rr.inliers[0], mm_ok[0])
    je = flow_joint_optimization(T_init, pts3d_world, obs_last,
                                 cur_uv - obs_last, init_inl, cam)
    return PoseEstimate(T=je.T, inliers=je.inliers,
                        num_inliers=je.num_inliers, chi2=je.chi2), je.flow


def _object_motions_joint(keys, Tcw, pts3d_world, obs_last, cur_uv, masks,
                          cam: Camera, H_motion_model, has_motion_model,
                          obs_pc, num_hypotheses: int):
    """GetInitModelObj for each of K objects, then their joint solves as
    one kernel launch: the batch's result, with M = Tcw H as its T."""
    rr = pnp_ransac(keys, pts3d_world, cur_uv, masks, cam, obs_pc,
                    num_hypotheses=num_hypotheses)
    M_mm = Tcw @ H_motion_model
    mm_ok, mm_count = score(M_mm, pts3d_world, cur_uv, cam, masks,
                            RANSAC_REPROJ)
    mm_count = torch.where(has_motion_model, mm_count,
                           torch.full_like(mm_count, -1))
    use_ransac = rr.num_inliers > mm_count
    M_init = torch.where(use_ransac[:, None, None], rr.T, M_mm)
    init_inl = torch.where(use_ransac[:, None], rr.inliers, mm_ok)
    return flow_joint_batched(
        M_init.contiguous(), pts3d_world.contiguous(), obs_last.contiguous(),
        (cur_uv - obs_last).contiguous(), init_inl.contiguous(), cam)


def estimate_object_motions_joint_batched(keys, Tcw, pts3d_world, obs_last,
                                          cur_uv, masks, cam: Camera,
                                          H_motion_model, has_motion_model,
                                          obs_pc: Optional[torch.Tensor] = None,
                                          num_hypotheses: int = 500):
    """All K object motions: keys (K, 2), masks (K, N), H_motion_model
    (K, 4, 4), has_motion_model (K,). The joint vertex is M = Tcw H (world
    points of the last frame into the current camera); the K solves share
    the point arrays and run as one kernel launch. Returns (H (K, 4, 4),
    inliers (K, N), num_inliers (K,), flow (K, N, 2))."""
    jb = _object_motions_joint(keys, Tcw, pts3d_world, obs_last, cur_uv,
                               masks, cam, H_motion_model, has_motion_model,
                               obs_pc, num_hypotheses)
    return inverse_se3(Tcw) @ jb.T, jb.inliers, jb.num_inliers, jb.flow


def estimate_object_motion_joint(key, Tcw, pts3d_world, obs_last, cur_uv,
                                 valid, cam: Camera, H_motion_model,
                                 has_motion_model,
                                 obs_pc: Optional[torch.Tensor] = None,
                                 num_hypotheses: int = 500):
    """One object's GetInitModelObj + PoseOptimizationFlow2
    (Tracking.cc:1213, 1268-1271): the B=1 case of
    ``estimate_object_motions_joint_batched``. Returns (PoseEstimate with
    H = Tcw^-1 M, flow_opt (N, 2))."""
    has = torch.as_tensor(has_motion_model, device=Tcw.device)
    jb = _object_motions_joint(key[None], Tcw, pts3d_world, obs_last, cur_uv,
                               valid[None], cam, H_motion_model[None],
                               has[None], obs_pc, num_hypotheses)
    est = PoseEstimate(T=inverse_se3(Tcw) @ jb.T[0], inliers=jb.inliers[0],
                       num_inliers=jb.num_inliers[0], chi2=jb.chi2[0])
    return est, jb.flow[0]
