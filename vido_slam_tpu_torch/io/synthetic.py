"""Synthetic depth + flow + mask sequences with ground truth — counterpart of
``vido_slam_tpu/io/synthetic.py`` (the renderer of the offline inputs).

A ground plane plus moving axis-aligned boxes is ray cast per frame into
exactly what ``TrackRGBD`` reads from disk in the reference's offline demo:
metric depth (0 where no surface), forward optical flow to the next frame
and int32 instance labels, with the ground-truth camera poses. Camera looks
down +z, y points down; the world frame is the first camera frame.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.geometry.se3 import inverse_se3, make_se3
from vido_slam_tpu_torch.utils.device import resolve_device


class Box(NamedTuple):
    half_extent: torch.Tensor  # (3,)
    label: int                 # instance label (> 0)
    pose0: torch.Tensor        # (4, 4) object->world at t=0
    motion: torch.Tensor       # (4, 4) world-frame per-step motion H


class SyntheticScene(NamedTuple):
    cam: Camera
    ground_y: float
    boxes: Tuple[Box, ...]


def _ray_dirs(cam: Camera, device) -> torch.Tensor:
    """(H, W, 3) ray directions with z = 1."""
    vv, uu = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float32, device=device),
        torch.arange(cam.width, dtype=torch.float32, device=device),
        indexing="ij")
    x = (uu - cam.cx) / cam.fx
    y = (vv - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _guard(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) < 1e-9, torch.full_like(x, 1e-9), x)


def _plane_depth(Tcw, dirs, ground_y: float) -> torch.Tensor:
    """Ray / plane y = ground_y intersection as z-depth (inf where none)."""
    Twc = inverse_se3(Tcw)
    R, t = Twc[:3, :3], Twc[:3, 3]
    dy = dirs @ R[1]
    s = (ground_y - t[1]) / _guard(dy)
    valid = (s > 0.1) & (dy > 1e-6)
    return torch.where(valid, s, torch.full_like(s, float("inf")))


def _box_depth(T_ow, Tcw, dirs, half) -> torch.Tensor:
    """Ray / AABB intersection in the object frame as z-depth."""
    T_oc = inverse_se3(T_ow) @ inverse_se3(Tcw)
    R, o = T_oc[:3, :3], T_oc[:3, 3]
    inv_d = 1.0 / _guard(dirs @ R.T)
    t0 = (-half - o) * inv_d
    t1 = (half - o) * inv_d
    tmin = torch.minimum(t0, t1).max(dim=-1).values
    tmax = torch.maximum(t0, t1).min(dim=-1).values
    hit = tmax > torch.clamp(tmin, min=0.1)
    return torch.where(hit, tmin, torch.full_like(tmin, float("inf")))


def render_frame(scene: SyntheticScene, Tcw, box_poses):
    """(depth (H, W), mask (H, W) int32) of one frame."""
    dirs = _ray_dirs(scene.cam, Tcw.device)
    depth = _plane_depth(Tcw, dirs, scene.ground_y)
    mask = torch.zeros(depth.shape, dtype=torch.int32, device=Tcw.device)
    for box, T_ow in zip(scene.boxes, box_poses):
        zb = _box_depth(T_ow, Tcw, dirs, box.half_extent.to(Tcw.device))
        closer = zb < depth
        depth = torch.where(closer, zb, depth)
        mask = torch.where(closer, torch.full_like(mask, box.label), mask)
    depth = torch.where(torch.isinf(depth), torch.zeros_like(depth), depth)
    return depth, mask


def flow_between(scene: SyntheticScene, Tcw_a, Tcw_b, depth_a, mask_a,
                 box_motions) -> torch.Tensor:
    """Forward flow a -> b: unproject with depth_a, move box points by their
    world motion, project into frame b."""
    cam = scene.cam
    dirs = _ray_dirs(cam, depth_a.device)
    pc = dirs * depth_a[..., None]
    Twc = inverse_se3(Tcw_a)
    pw = pc @ Twc[:3, :3].T + Twc[:3, 3]
    for box, H in zip(scene.boxes, box_motions):
        moved = pw @ H[:3, :3].T + H[:3, 3]
        pw = torch.where((mask_a == box.label)[..., None], moved, pw)
    pb = pw @ Tcw_b[:3, :3].T + Tcw_b[:3, 3]
    uvb = cam.project(pb)
    vv, uu = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float32, device=depth_a.device),
        torch.arange(cam.width, dtype=torch.float32, device=depth_a.device),
        indexing="ij")
    flow = uvb - torch.stack([uu, vv], dim=-1)
    return torch.where((depth_a > 0)[..., None], flow, torch.zeros_like(flow))


class SyntheticFrame(NamedTuple):
    depth: np.ndarray
    flow: np.ndarray
    mask: np.ndarray
    Tcw_gt: np.ndarray
    box_poses: List[np.ndarray]
    box_motions: List[np.ndarray]


class SyntheticSequence:
    """Renders a whole sequence with ground truth on ``device`` (the card
    unless the caller asks for the CPU); pose chains compose in float64 on
    the host. Frames come back as numpy arrays."""

    def __init__(self, scene: SyntheticScene, cam_motions: Sequence[np.ndarray],
                 n_frames: int, device=None):
        self.scene = scene
        self.frames: List[SyntheticFrame] = []
        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=dev)

        Tcw = np.eye(4)
        box_poses = [np.asarray(b.pose0, np.float64) for b in scene.boxes]
        Tcws, poses_t = [], []
        for t in range(n_frames):
            Tcws.append(f32(Tcw))
            poses_t.append([f32(p) for p in box_poses])
            dT = np.asarray(cam_motions[min(t, len(cam_motions) - 1)],
                            np.float64)
            Tcw = dT @ Tcw
            box_poses = [np.asarray(b.motion, np.float64) @ p
                         for b, p in zip(scene.boxes, box_poses)]
        motions = [f32(b.motion) for b in scene.boxes]
        for t in range(n_frames):
            depth, mask = render_frame(scene, Tcws[t], poses_t[t])
            if t + 1 < n_frames:
                flow = flow_between(scene, Tcws[t], Tcws[t + 1], depth, mask,
                                    motions)
            else:
                flow = torch.zeros(depth.shape + (2,), dtype=torch.float32,
                                   device=dev)
            self.frames.append(SyntheticFrame(
                depth=depth.cpu().numpy(), flow=flow.cpu().numpy(),
                mask=mask.cpu().numpy(), Tcw_gt=Tcws[t].cpu().numpy(),
                box_poses=[p.cpu().numpy() for p in poses_t[t]],
                box_motions=[np.asarray(b.motion, np.float32)
                             for b in scene.boxes]))

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i) -> SyntheticFrame:
        return self.frames[i]


def translation_se3(t) -> torch.Tensor:
    """(4, 4) pure translation."""
    return make_se3(torch.eye(3), torch.as_tensor(t, dtype=torch.float32))


def simple_scene(width: int = 256, height: int = 160, moving_box: bool = True,
                 box_speed: float = 0.8) -> SyntheticScene:
    """Ground plane + one (optionally moving) box."""
    cam = Camera.create(fx=200.0, fy=200.0, cx=width / 2, cy=height / 2,
                        width=width, height=height, bf=40.0)
    motion = (translation_se3([box_speed, 0.0, 0.0]) if moving_box
              else torch.eye(4))
    box = Box(half_extent=torch.tensor([2.0, 1.5, 2.0]), label=2,
              pose0=translation_se3([-4.0, 0.0, 12.0]), motion=motion)
    return SyntheticScene(cam=cam, ground_y=1.5, boxes=(box,))


# Analytic driving trajectory (the bench clip's camera path)
DRIVING_V0 = 6.0          # m/s mean forward speed
DRIVING_V1 = 1.5          # m/s speed oscillation amplitude
DRIVING_PSI1 = 0.02       # rad yaw oscillation amplitude
DRIVING_PERIOD = 2.4      # s


def _yaw_mat(psi: float) -> np.ndarray:
    c, s = np.cos(psi), np.sin(psi)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float64)


def driving_pose(t: float) -> np.ndarray:
    """GT Tcw (float64) at time t: forward along +z_w at v(t) = V0 + V1
    sin(w t) with a small yaw oscillation."""
    w = 2.0 * np.pi / DRIVING_PERIOD
    s = DRIVING_V0 * t - DRIVING_V1 / w * (np.cos(w * t) - 1.0)
    Twc = np.eye(4)
    Twc[:3, :3] = _yaw_mat(DRIVING_PSI1 * np.sin(w * t))
    Twc[:3, 3] = [0.0, 0.0, s]
    return np.linalg.inv(Twc)
