"""SE(3) operations on (..., 4, 4) float32 tensors; tangent vectors are
(..., 6) ordered [rho, phi] (translation, rotation), as in
``vido_slam_tpu/geometry/se3.py``."""

from __future__ import annotations

import torch

from vido_slam_tpu_torch.geometry.so3 import (
    _sin_cos_coeffs,
    exp_so3,
    hat,
    log_so3,
    right_jacobian_inv_so3,
)


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from R (..., 3, 3) and t (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def inverse_se3(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_se3(Rt, -(Rt @ t[..., None])[..., 0])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (4, 4) to points (N, 3)."""
    return pts @ T[:3, :3].T + T[:3, 3]


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) [rho, phi] -> (..., 4, 4); t = V(phi) rho."""
    rho = xi[..., :3]
    phi = xi[..., 3:]
    R = exp_so3(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    _, B, C = _sin_cos_coeffs(theta2)
    W = hat(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    t = (V @ rho[..., None])[..., 0]
    return make_se3(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = log_so3(R)
    Vinv = right_jacobian_inv_so3(-phi)
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def adjoint_se3(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of SE(3), (..., 4, 4) -> (..., 6, 6), acting on [rho, phi]:
    [[R, hat(t) R], [0, R]]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return torch.cat([torch.cat([R, hat(t) @ R], -1),
                      torch.cat([torch.zeros_like(R), R], -1)], -2)
