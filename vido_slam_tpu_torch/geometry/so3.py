"""SO(3) Lie-group operations on float32 tensors, batched over leading dims.

Counterpart of ``vido_slam_tpu/geometry/so3.py``: rotation vectors are
``(..., 3)``, matrices ``(..., 3, 3)``. Small-angle branches guard the
divisor before dividing (the "double-where" pattern), so no branch that
``torch.where`` discards produces a NaN or inf.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``w``: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sin_cos_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t / t, (1 - cos t) / t^2, (1 - A) / t^2), with the
    Taylor series below ``_EPS``."""
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2_safe)
    return A, B, C


def _eye3(ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(ref.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: R = I + A hat(w) + B hat(w)^2."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sin_cos_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector; theta from atan2 so the
    derivative stays finite at theta -> 0."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_hat = vee(R - R.transpose(-1, -2)) * 0.5
    s2 = torch.sum(w_hat * w_hat, dim=-1)
    small = s2 < 1e-12
    s2_safe = torch.where(small, torch.ones_like(s2), s2)
    sin_theta = torch.sqrt(s2_safe)
    theta = torch.atan2(sin_theta, cos_theta)
    scale = torch.where(small, 1.0 + s2 / 6.0, theta / sin_theta)
    return scale[..., None] * w_hat


def right_jacobian_inv_so3(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian Jr^{-1}(w): (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    cot_term = (1.0 + torch.cos(theta)) / (2.0 * theta * torch.sin(theta))
    coeff = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                        1.0 / theta2_safe - cot_term)
    W = hat(w)
    W2 = W @ W
    return _eye3(W) + 0.5 * W + coeff[..., None, None] * W2


def right_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(w) = I - B hat(w) + C hat(w)^2: (..., 3) ->
    (..., 3, 3) (ImuTypes.cc IntegratedRotation rightJ)."""
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _sin_cos_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye3(W) - B[..., None, None] * W + C[..., None, None] * W2


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto SO(3) by SVD, a reflection flipped back
    (ORB-SLAM3 NormalizeRotation)."""
    u, _, vt = torch.linalg.svd(R)
    sign = torch.sign(torch.linalg.det(u @ vt))[..., None, None]
    return torch.cat([u[..., :, :2], u[..., :, 2:] * sign], dim=-1) @ vt
