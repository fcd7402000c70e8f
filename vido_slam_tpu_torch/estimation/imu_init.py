"""Inertial initialization — Optimizer::InertialOptimization
(Optimizer.cc:2336-2620) and the gravity/scale/bias flow of
Tracking::InitializeIMU (Tracking.cc:937-1044); counterpart of
``vido_slam_tpu/estimation/imu_init.py``.

The unknowns are the EdgeInertialGS vertex set (G2oTypes.h:339-424): the
body velocities, shared gyro and acc biases, a 2-DoF gravity direction and
a scale; the camera poses stay fixed. Each consecutive frame pair gives the
9-dim preintegration error (G2oTypes.cc EdgeInertialGS::computeError)

  r_R = Log( dR(bg)^T R1^T R2 )
  r_V = R1^T (s (V2 - V1) - g dt) - dV(bg, ba)
  r_P = R1^T (s (P2 - P1 - V1 dt) - 0.5 g dt^2) - dP(bg, ba)

whitened by the preintegration covariance, with bias priors (priorG=1e2,
priorA=1e9 at the first init, Tracking.cc:937,1000). Fixed shapes: the
frames pad to ``max_frames`` with pair validity masks.
"""

from __future__ import annotations

from typing import NamedTuple

import scipy.linalg
import torch

from vido_slam_tpu_torch.estimation.lm import (cholesky_or_nan, lm_solve,
                                               lu_solve_trsm, require_cpu)
from vido_slam_tpu_torch.geometry.so3 import exp_so3, log_so3
from vido_slam_tpu_torch.imu.preintegration import GRAVITY_VALUE

# LM iterations of initialize_imu's stage-C polish (the JAX package's
# refine_iters default, which no caller changes)
REFINE_ITERS = 100


class InertialInitResult(NamedTuple):
    scale: torch.Tensor       # scalar
    Rwg: torch.Tensor         # (3, 3) gravity-direction rotation
    bg: torch.Tensor          # (3,)
    ba: torch.Tensor          # (3,)
    velocities: torch.Tensor  # (N, 3) velocities (mono/scaled frame)
    cost: torch.Tensor
    num_iters: int


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., i, j) x (..., j) -> (..., i)."""
    return (M @ v[..., None])[..., 0]


def _rot_to(gn: torch.Tensor) -> torch.Tensor:
    """The rotation taking gI = (0, 0, -1) onto the unit vector gn."""
    gI = torch.tensor([0.0, 0.0, -1.0], dtype=gn.dtype, device=gn.device)
    v = torch.linalg.cross(gI, gn)
    ang = torch.arccos(torch.clamp(torch.dot(gI, gn), -1.0, 1.0))
    return exp_so3(v / torch.clamp(torch.linalg.norm(v), min=1e-9) * ang)


def _lapack_solve(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Solve M x = v as the JAX package's CPU ``jnp.linalg.solve`` does, to
    the bit: LAPACK's LU (getrf, through scipy, whose LAPACK JAX's CPU
    kernels call), the pivots applied, then two BLAS trsm. Stage B's
    normal equations are ill-conditioned (cond ~1e7), so in float32 the
    solution carries rounding error of up to percents, and the inertial
    init's later stages and the tracker's accept decisions follow it: with
    torch's LU the scale moved 1.4 % on tests/test_imu.py's problem."""
    require_cpu(M, "linear_alignment")
    lu, piv = scipy.linalg.lu_factor(M.detach().numpy())
    return torch.from_numpy(lu_solve_trsm(lu, piv, v.detach().numpy()))


def estimate_gravity_direction(Rwb: torch.Tensor, dV: torch.Tensor,
                               pair_valid: torch.Tensor) -> torch.Tensor:
    """Initial Rwg from the mean preintegrated velocity direction
    (Tracking.cc:955-988): dirG = -sum(Rwb_i dV_i), and Rwg rotates
    gI = (0, 0, -1) onto it."""
    dirG = -torch.sum(_mv(Rwb[:-1], dV) * pair_valid[:, None], dim=0)
    return _rot_to(dirG / torch.clamp(torch.linalg.norm(dirG), min=1e-9))


def _bias_corrected(dR, dV, dP, JRg, JVg, JPg, bg):
    """The deltas corrected to gyro bias bg to first order
    (ImuTypes.cc:347-368)."""
    return (dR @ exp_so3(_mv(JRg, bg)), dV + _mv(JVg, bg),
            dP + _mv(JPg, bg))


def initialize_imu(Rwb, twb, dts, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, C9,
                   pair_valid, prior_g: float = 1e2, prior_a: float = 1e9
                   ) -> InertialInitResult:
    """The staged init (each stage starts near its optimum, where the
    reference's single joint LM, Tracking.cc:937-1044, has spurious minima
    started cold): A. gyro bias from rotation-only residuals; B. closed-form
    linear alignment for velocities, gravity and scale; C. the joint LM
    polish with whitened 9-dim residuals and bias priors."""
    N = Rwb.shape[0]
    dev = Rwb.device

    def rejected(scale, Rwg, bg):
        return InertialInitResult(
            scale=scale, Rwg=Rwg, bg=bg, ba=torch.zeros(3, device=dev),
            velocities=torch.zeros(N, 3, device=dev),
            cost=torch.tensor(float("inf"), device=dev), num_iters=0)

    # cheapest first: one closed-form stage-B pass at zero gyro bias; the
    # tracker retries every frame while uninitialized, and a hopeless
    # window is hopeless at bg = 0 too. The JAX package rejects below 0.08
    # here (imu_init.py:106), not at the reference's 0.1; the port copies it
    Rwg_g = estimate_gravity_direction(Rwb, dV, pair_valid)
    _, s_gate, Rwg_gate, _ = linear_alignment(Rwb, twb, dts, dV, dP,
                                              pair_valid, Rwg_g)
    if float(s_gate) < 0.08:
        return rejected(torch.clamp(s_gate, max=0.05), Rwg_gate,
                        torch.zeros(3, device=dev))

    bg_A = estimate_gyro_bias(Rwb, dR, JRg, pair_valid)
    dR_b, dV_b, dP_b = _bias_corrected(dR, dV, dP, JRg, JVg, JPg, bg_A)
    Rwg0 = estimate_gravity_direction(Rwb, dV_b, pair_valid)
    # re-centre the gravity tangent twice: the second closed-form pass
    # removes the first's linearisation error
    U, s, Rwg1, _ = linear_alignment(Rwb, twb, dts, dV_b, dP_b, pair_valid,
                                     Rwg0)
    U, s, Rwg1, _ = linear_alignment(Rwb, twb, dts, dV_b, dP_b, pair_valid,
                                     Rwg1)
    # the caller rejects a scale below the reference's abort gate
    # (Tracking.cc:1008); skip the LM polish then
    if float(s) < 0.1:
        return rejected(s, Rwg1, bg_A)
    s_safe = torch.clamp(s, min=0.1)
    res = inertial_optimization(
        Rwb, twb, dts, dR_b, dV_b, dP_b, JRg, JVg, JVa, JPg, JPa, C9,
        pair_valid, Rwg1, prior_g, prior_a, v_init=U / s_safe,
        log_s_init=torch.log(s_safe), max_iters=REFINE_ITERS)
    return res._replace(bg=res.bg + bg_A)


def estimate_gyro_bias(Rwb, dR, JRg, pair_valid, *,
                       max_iters: int = 20) -> torch.Tensor:
    """Stage A: the gyro bias from rotation-only residuals
    r(bg) = Log((dR Exp(JRg bg))^T R1^T R2), 3 unknowns."""
    rel = Rwb[:-1].transpose(-1, -2) @ Rwb[1:]

    def residual(bg):
        dR_b = dR @ exp_so3(_mv(JRg, bg))
        return log_so3(dR_b.transpose(-1, -2) @ rel) * pair_valid[:, None]

    return lm_solve(residual, torch.zeros(3, device=Rwb.device),
                    max_iters=max_iters).x


def linear_alignment(Rwb, twb, dts, dV_b, dP_b, pair_valid, Rwg0):
    """Stage B: closed-form visual-inertial alignment. With U_i = s V_i both
    preintegration constraints are linear in x = [U_1..U_N, dg (2), s]:
        R1^T (U2 - U1 - (g0 + B dg) dt)                    = dV
        R1^T (s (P2 - P1) - U1 dt - 0.5 (g0 + B dg) dt^2)  = dP
    so the global optimum is one least-squares solve (the VINS-Mono
    aligner). Returns (U, s, Rwg, dg)."""
    N = Rwb.shape[0]
    f = dict(dtype=Rwb.dtype, device=Rwb.device)
    gI = torch.tensor([0.0, 0.0, -1.0], **f) * GRAVITY_VALUE
    g0 = Rwg0 @ gI
    # tangent basis of the gravity sphere at g0
    B = Rwg0 @ torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]],
                            **f) * GRAVITY_VALUE
    P = 3 * N + 3
    R1t = Rwb[:-1].transpose(-1, -2)
    A = torch.zeros(N - 1, 6, P, **f)
    b = torch.zeros(N - 1, 6, **f)
    for i in range(N - 1):
        Rt = R1t[i]
        d = dts[i]
        A[i, :3, 3 * i:3 * i + 3] = -Rt
        A[i, :3, 3 * (i + 1):3 * (i + 2)] = Rt
        A[i, :3, 3 * N:3 * N + 2] = -d * Rt @ B
        b[i, :3] = dV_b[i] + d * Rt @ g0
        A[i, 3:, 3 * i:3 * i + 3] = -d * Rt
        A[i, 3:, 3 * N:3 * N + 2] = -0.5 * d * d * Rt @ B
        A[i, 3:, 3 * N + 2] = Rt @ (twb[i + 1] - twb[i])
        b[i, 3:] = dP_b[i] + 0.5 * d * d * Rt @ g0
    w = pair_valid.to(A.dtype)[:, None, None]
    A = (A * w).reshape((N - 1) * 6, P)
    b = (b * w[:, :, 0]).reshape((N - 1) * 6)
    # light Tikhonov keeps the gravity tangent well-posed at low excitation
    x = _lapack_solve(A.T @ A + 1e-8 * torch.eye(P, **f), A.T @ b)
    U = x[:3 * N].reshape(N, 3)
    dg = x[3 * N:3 * N + 2]
    g_new = g0 + B @ dg
    return U, x[3 * N + 2], _rot_to(
        g_new / torch.clamp(torch.linalg.norm(g_new), min=1e-9)), dg


def inertial_optimization(Rwb, twb, dts, dR, dV, dP, JRg, JVg, JVa, JPg, JPa,
                          C9, pair_valid, Rwg0, prior_g: float = 1e2,
                          prior_a: float = 1e9, v_init=None, log_s_init=None,
                          *, max_iters: int = 200) -> InertialInitResult:
    """Stage C: the joint LM over velocities, biases, 2 gravity angles and
    the log-scale, camera poses fixed (Optimizer.cc:2336-2620)."""
    N = Rwb.shape[0]
    dev = Rwb.device
    gI = torch.tensor([0.0, 0.0, -1.0], device=dev) * GRAVITY_VALUE

    # block-diagonal whitening: the full 9x9 covariance is near-singular
    # (rot, vel and pos errors correlate over short intervals) and its
    # float32 inverse gives a noisy metric; independent 3x3 inverses keep
    # the relative weighting and stay well conditioned
    def block_L(Cb):
        d = torch.mean(torch.diagonal(Cb, dim1=-2, dim2=-1), dim=-1)
        eye = torch.eye(3, device=dev)
        Wb = torch.linalg.inv(
            Cb + eye * 1e-4 * torch.clamp(d, min=1e-14)[:, None, None])
        return cholesky_or_nan(0.5 * (Wb + Wb.transpose(-1, -2)))

    L_r = block_L(C9[:, 0:3, 0:3])
    L_v = block_L(C9[:, 3:6, 3:6])
    L_p = block_L(C9[:, 6:9, 6:9])

    if v_init is None:
        # finite differences, in the same scaled frame as the positions
        vel_fd = (twb[1:] - twb[:-1]) / torch.clamp(dts, min=1e-3)[:, None]
        v0 = torch.cat([vel_fd, vel_fd[-1:]])
    else:
        v0 = v_init

    R1, R2 = Rwb[:-1], Rwb[1:]
    R1t = R1.transpose(-1, -2)
    rel = R1t @ R2
    dP_vis = twb[1:] - twb[:-1]
    dt = dts[:, None]
    sq_g = torch.sqrt(torch.tensor(prior_g, device=dev))
    sq_a = torch.sqrt(torch.tensor(prior_a, device=dev))
    zero1 = torch.zeros(1, device=dev)

    def unpack(x):
        vel = x[:3 * N].reshape(N, 3)
        bg = x[3 * N:3 * N + 3]
        ba = x[3 * N + 3:3 * N + 6]
        dg = x[3 * N + 6:3 * N + 8]
        return vel, bg, ba, dg, x[3 * N + 8:]

    # (1,)-shaped log-scale and rotation vector: forward-mode AD gives a
    # float64 tangent to a 0-dim tensor combined with a Python number
    def gravity_rot(dg):
        return Rwg0 @ exp_so3(torch.cat([dg, zero1])[None])[0]

    def residual(x):
        vel, bg, ba, dg, log_s = unpack(x)
        s = torch.exp(log_s)
        g = gravity_rot(dg) @ gI
        # no SVD re-orthonormalisation: its derivative is NaN at the
        # repeated singular values of a rotation
        dR_b = dR @ exp_so3(_mv(JRg, bg))
        dV_b = dV + _mv(JVg, bg) + _mv(JVa, ba)
        dP_b = dP + _mv(JPg, bg) + _mv(JPa, ba)
        V1, V2 = vel[:-1], vel[1:]
        rR = log_so3(dR_b.transpose(-1, -2) @ rel)
        rV = _mv(R1t, s * (V2 - V1) - g * dt) - dV_b
        rP = _mv(R1t, s * (dP_vis - V1 * dt) - 0.5 * g * dt * dt) - dP_b
        r_white = torch.cat([_mv(L_r.transpose(-1, -2), rR),
                             _mv(L_v.transpose(-1, -2), rV),
                             _mv(L_p.transpose(-1, -2), rP)], dim=-1)
        r_white = r_white * pair_valid[:, None]
        # bias priors (EdgePriorGyro/Acc, information prior * I), padded
        # to 9 columns
        extra = torch.stack([sq_g * bg, sq_a * ba])
        extra9 = torch.cat([extra, torch.zeros(2, 6, device=dev)], dim=-1)
        return torch.cat([r_white, extra9])

    ls0 = (torch.zeros(1, device=dev) if log_s_init is None
           else torch.reshape(log_s_init, (1,)))
    x0 = torch.cat([v0.reshape(-1), torch.zeros(8, device=dev), ls0])
    res = lm_solve(residual, x0, max_iters=max_iters)
    vel, bg, ba, dg, log_s = unpack(res.x)
    return InertialInitResult(scale=torch.exp(log_s[0]), Rwg=gravity_rot(dg),
                              bg=bg, ba=ba, velocities=vel, cost=res.cost,
                              num_iters=res.num_iters)
