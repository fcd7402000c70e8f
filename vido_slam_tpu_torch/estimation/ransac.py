"""Batched PnP RANSAC — counterpart of ``vido_slam_tpu/estimation/ransac.py``
(cv::solvePnPRansac in the reference: 500 hypotheses, 0.4 px,
Tracking.cc:1965-1968).

The JAX function is vmapped over problems; here the problem batch is a
leading dimension K written out (K=1 for the camera, K=max_objects for the
objects). Hypotheses come from 4-point Kabsch alignment (Horn's quaternion
by 40 power iterations) when camera-frame points are given, else from a
6-point DLT. Samples are drawn by one stable sort of per-point uniform keys;
all hypotheses are scored by one matmul.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vido_slam_tpu_torch.geometry.camera import Camera, _f32
from vido_slam_tpu_torch.geometry.se3 import make_se3
from vido_slam_tpu_torch.utils import prng


class RansacResult(NamedTuple):
    T: torch.Tensor            # (K, 4, 4) best hypothesis, world->camera
    inliers: torch.Tensor      # (K, N) bool
    num_inliers: torch.Tensor  # (K,) int


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _dlt_pose(X: torch.Tensor, x_norm: torch.Tensor) -> torch.Tensor:
    """6+ point DLT: world points (..., S, 3) and normalised image points
    (..., S, 2) -> (..., 4, 4) world->camera."""
    mu = X.mean(dim=-2)
    scale = _norm(X - mu[..., None, :]).mean(dim=-1) + 1e-12
    Xc = (X - mu[..., None, :]) / scale[..., None, None]
    Xh = torch.cat([Xc, torch.ones_like(Xc[..., :1])], dim=-1)   # (..., S, 4)
    u = x_norm[..., 0:1]
    v = x_norm[..., 1:2]
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                             # (..., 2S, 12)
    AtA = A.transpose(-1, -2) @ A
    # the null vector of AtA is ill-conditioned in float32 (torch's float32
    # eigh loses ~2 digits more than the JAX package's here), so the 12x12
    # eigenproblem is solved in float64
    _, vecs = torch.linalg.eigh(AtA.double())
    P = vecs[..., :, 0].to(X.dtype).reshape(vecs.shape[:-2] + (3, 4))
    z = (Xh @ P[..., 2, :, None])[..., 0]
    sign = torch.where(torch.sum(torch.sign(z), dim=-1) < 0, -1.0, 1.0)
    P = P * sign[..., None, None]
    U, s, Vt = torch.linalg.svd(P[..., :, :3])
    det = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(det), torch.ones_like(det), det], dim=-1))
    R = U @ D @ Vt
    t = P[..., :, 3] / (s.mean(dim=-1) + 1e-12)[..., None]
    t_final = scale[..., None] * t - (R @ mu[..., None])[..., 0]
    return make_se3(R, t_final)


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _kabsch_pose(Xw: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """Horn's quaternion alignment, Xc = R Xw + t, for (..., S, 3) samples:
    the rotation is the dominant eigenvector of a 4x4 symmetric matrix,
    found by 40 shifted power iterations (normalised every 4)."""
    cw = Xw.mean(dim=-2)
    cc = Xc.mean(dim=-2)
    M = (Xw - cw[..., None, :]).transpose(-1, -2) @ (Xc - cc[..., None, :])
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    A = M - M.transpose(-1, -2)
    d = torch.stack([A[..., 1, 2], A[..., 2, 0], A[..., 0, 1]], dim=-1)
    eye3 = torch.eye(3, dtype=M.dtype, device=M.device)
    lower = M + M.transpose(-1, -2) - tr[..., None, None] * eye3
    K = torch.cat([
        torch.cat([tr[..., None, None], d[..., None, :]], dim=-1),
        torch.cat([d[..., :, None], lower], dim=-1),
    ], dim=-2)
    shift = torch.sqrt(torch.sum(K * K, dim=(-1, -2))) + 1e-6
    Ks = K + shift[..., None, None] * torch.eye(4, dtype=M.dtype,
                                                device=M.device)
    q = torch.tensor([1.0, 0.01, 0.01, 0.01], dtype=M.dtype,
                     device=M.device).expand(K.shape[:-1])
    for i in range(40):
        q = (Ks @ q[..., None])[..., 0]
        if i % 4 == 3:
            q = q / torch.clamp(_norm(q), min=1e-12)[..., None]
    q = q / torch.clamp(_norm(q), min=1e-12)[..., None]
    R = _quat_to_rot(q)
    t = cc - (R @ cw[..., None])[..., 0]
    return make_se3(R, t)


def score(T, X, obs_uv, cam: Camera, valid, thresh: float):
    """Inlier mask and count of one hypothesis per problem: T (K, 4, 4),
    valid (K, N)."""
    pc = X @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
    err = _norm(cam.project(pc) - obs_uv)
    ok = (err < thresh) & valid & (pc[..., 2] > 0)
    return ok, ok.sum(dim=-1)


def _score_counts_all(Ts, X, obs_uv, cam: Camera, valid, thresh: float):
    """Inlier counts of all hypotheses as one (N, 4) @ (4, 3H) matmul per
    problem: Ts (K, H, 4, 4), valid (K, N) -> (K, H)."""
    H = Ts.shape[1]
    P = torch.cat([Ts[:, :, 0, :], Ts[:, :, 1, :], Ts[:, :, 2, :]], dim=1)
    Xh = torch.cat([X, torch.ones_like(X[:, :1])], dim=-1)       # (N, 4)
    PC = Xh @ P.transpose(-1, -2)                                # (K, N, 3H)
    xs, ys, zs = PC[..., :H], PC[..., H:2 * H], PC[..., 2 * H:]
    iz = 1.0 / torch.where(torch.abs(zs) < 1e-6, torch.full_like(zs, 1e-6),
                           zs)
    du = cam.fx * xs * iz + cam.cx - obs_uv[:, :1]
    dv = cam.fy * ys * iz + cam.cy - obs_uv[:, 1:2]
    ok = ((du * du + dv * dv < _f32(thresh * thresh))
          & valid[:, :, None] & (zs > 0))
    return ok.sum(dim=1)


def pnp_ransac(keys: torch.Tensor, pts3d: torch.Tensor, obs_uv: torch.Tensor,
               valid: torch.Tensor, cam: Camera,
               obs_pc: Optional[torch.Tensor] = None, *,
               num_hypotheses: int = 500, sample_size: int = 4,
               threshold: float = 0.4) -> RansacResult:
    """K independent RANSACs over shared points: keys (K, 2), pts3d (N, 3),
    obs_uv (N, 2), valid (K, N), obs_pc (N, 3) or None.

    Sampling: each problem sorts ``reps`` tiles of per-point uniform keys
    (invalid points sink to the end of their tile, tile t is offset by
    100 t), stably; hypotheses take consecutive groups of the permuted
    points. When a tile holds fewer points than the hypotheses need, the
    next tile is an independent permutation of the same points."""
    K = keys.shape[0]
    N = pts3d.shape[0]
    S = max(sample_size, 6 if obs_pc is None else sample_size)
    if N < S:
        raise ValueError(f"pnp_ransac needs at least {S} points, got {N}")
    need = num_hypotheses * S
    reps = -(-need // N)
    r = prng.uniform(keys, (reps * N,))                          # (K, reps*N)
    vbig = valid.repeat(1, reps)
    sort_key = torch.where(vbig, r, r + 10.0)
    if reps > 1:
        tiles = torch.arange(reps, dtype=r.dtype, device=r.device)
        sort_key = sort_key + 100.0 * tiles.repeat_interleave(N)
    perm = torch.sort(sort_key, dim=-1, stable=True).indices[:, :need]
    idx = (perm % N).reshape(K, num_hypotheses, S)
    v_s = torch.gather(vbig, 1, perm).reshape(K, num_hypotheses, S)
    sample_ok = v_s.all(dim=-1)
    Xw_s = pts3d[idx]                                           # (K, H, S, 3)
    if obs_pc is not None:
        Ts = _kabsch_pose(Xw_s, obs_pc[idx])
    else:
        uv_s = obs_uv[idx]
        xn = torch.stack([(uv_s[..., 0] - cam.cx) / cam.fx,
                          (uv_s[..., 1] - cam.cy) / cam.fy], dim=-1)
        Ts = _dlt_pose(Xw_s, xn)
    counts = _score_counts_all(Ts, pts3d, obs_uv, cam, valid, threshold)
    counts = torch.where(sample_ok, counts, torch.full_like(counts, -1))
    best = torch.argmax(counts, dim=-1)                          # first max
    ar = torch.arange(K, device=keys.device)
    best_count = counts[ar, best]
    good = best_count >= 0
    T_best = Ts[ar, best]
    ok_best, _ = score(T_best, pts3d, obs_uv, cam, valid, threshold)
    eye = torch.eye(4, dtype=T_best.dtype, device=T_best.device)
    return RansacResult(
        T=torch.where(good[:, None, None], T_best, eye),
        inliers=ok_best & good[:, None],
        num_inliers=torch.clamp(best_count, min=0))
