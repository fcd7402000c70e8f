"""Pinhole camera and the per-dataset depth conversion — counterpart of
``vido_slam_tpu/geometry/camera.py``. Intrinsics are Python floats rounded
to float32, so products with float32 tensors round as the JAX float32
scalars do."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    dist: Tuple[float, ...]   # k1, k2, p1, p2, k3 (parsed, not applied)
    width: int
    height: int
    bf: float
    fps: float

    @classmethod
    def create(cls, fx, fy, cx, cy, dist=None, width=0, height=0, bf=0.0,
               fps=10.0):
        dist = (0.0,) * 5 if dist is None else tuple(
            _f32(d) for d in np.asarray(dist).reshape(-1))
        return cls(fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy),
                   dist=dist, width=int(width), height=int(height),
                   bf=_f32(bf), fps=float(fps))

    def project(self, pts_cam: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        """Camera-frame points (..., 3) -> pixels (..., 2), no distortion;
        |z| < eps is replaced by eps."""
        z = pts_cam[..., 2]
        z_safe = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
        u = self.fx * pts_cam[..., 0] / z_safe + self.cx
        v = self.fy * pts_cam[..., 1] / z_safe + self.cy
        return torch.stack([u, v], dim=-1)

    def backproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        x = (uv[..., 0] - self.cx) * depth / self.fx
        y = (uv[..., 1] - self.cy) * depth / self.fy
        return torch.stack([x, y, depth], dim=-1)

    def in_bounds(self, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
        u, v = uv[..., 0], uv[..., 1]
        return ((u >= margin) & (u < self.width - margin)
                & (v >= margin) & (v < self.height - margin))


def convert_depth(raw: torch.Tensor, dataset: str, depth_map_factor: float,
                  bf: float, scale: float = 1.0,
                  eps: float = 1e-12) -> torch.Tensor:
    """Raw network/stereo depth -> metric depth (Tracking.cc:299-322):
    OMD d/f; KITTI bf/(d/f); KAIST scale*bf/(d/f); raw <= 0 stays 0."""
    raw = torch.where(raw < 0, torch.zeros_like(raw), raw)
    d = raw / _f32(depth_map_factor)
    if dataset == "omd":
        out = d
    elif dataset == "kitti":
        out = _f32(bf) / torch.clamp(d, min=eps)
    elif dataset == "kaist":
        out = _f32(scale * bf) / torch.clamp(d, min=eps)
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    return torch.where(raw <= 0, torch.zeros_like(out), out)
