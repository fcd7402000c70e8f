"""3D scene flow of object points — Tracking::GetSceneFlowObj
(Tracking.cc:1582-1668); counterpart of
``vido_slam_tpu/frontend/sceneflow.py``."""

from __future__ import annotations

import torch

from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.geometry.se3 import inverse_se3


def unproject_to_world(cam: Camera, uv: torch.Tensor, depth: torch.Tensor,
                       Tcw: torch.Tensor) -> torch.Tensor:
    """X_w = Twc * backproject(uv, depth), (N, 3)."""
    pc = cam.backproject(uv, depth)
    Twc = inverse_se3(Tcw)
    return pc @ Twc[:3, :3].T + Twc[:3, 3]


def scene_flow_world(cam: Camera, uv_pre, depth_pre, Tcw_pre, uv_cur,
                     depth_cur, Tcw_cur, sem_pre, sem_cur, valid):
    """Returns (flow3d (N, 3), xz-norm (N,), valid (N,)); the vertical
    component is left out of the norm (Tracking.cc:1746)."""
    Xp = unproject_to_world(cam, uv_pre, depth_pre, Tcw_pre)
    Xc = unproject_to_world(cam, uv_cur, depth_cur, Tcw_cur)
    flow3d = Xc - Xp
    sf_norm = torch.sqrt(flow3d[:, 0] ** 2 + flow3d[:, 2] ** 2)
    ok = valid & (sem_pre > 0) & (sem_cur > 0)
    return flow3d, sf_norm, ok
