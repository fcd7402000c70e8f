"""Sliding-window bundle adjustment — Optimizer::PartialBatchOptimization
(Optimizer.cc:43-1228), counterpart of ``solve_window_ba`` in
``vido_slam_tpu/estimation/window_ba.py``.

W camera->world poses with odometry edges (information 1/1e-4, Huber 0.01),
P static points with camera-frame observations (information 1/16, Huber
0.01). Levenberg-Marquardt eliminates the points by a Schur complement over
their (diagonal) 3x3 blocks and solves the 6W x 6W reduced system with a
Cholesky factorisation; the first real pose and every pad pose are pinned
exactly (g2o setFixed).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vido_slam_tpu_torch.estimation.lm import huber_weight
from vido_slam_tpu_torch.geometry.se3 import (adjoint_se3, exp_se3,
                                              inverse_se3, log_se3)
from vido_slam_tpu_torch.geometry.so3 import hat

# Optimizer.cc:190-196, 214
SIGMA2_CAM = 1e-4
SIGMA2_3D_STA = 16.0
DELTA_HUBER = 0.01


class WindowBAResult(NamedTuple):
    Twc: torch.Tensor       # (W, 4, 4)
    points: torch.Tensor    # (P, 3)
    cost: torch.Tensor
    num_iters: int


def _odom_residual(T_prev, T_cur, M):
    """r = log(M^-1 T_prev^-1 T_cur) per edge: the JAX residual
    log(M^-1 (T_prev exp(dp))^-1 (T_cur exp(dc))) at dp = dc = 0."""
    return log_se3(inverse_se3(M) @ (inverse_se3(T_prev) @ T_cur))


def _ad(xi: torch.Tensor) -> torch.Tensor:
    """se(3) adjoint ad(xi) for [rho, phi]: [[hat(phi), hat(rho)],
    [0, hat(phi)]], (E, 6) -> (E, 6, 6)."""
    P, Rh = hat(xi[:, 3:]), hat(xi[:, :3])
    return torch.cat([torch.cat([P, Rh], -1),
                      torch.cat([torch.zeros_like(P), P], -1)], -2)


def _odom_jac(r_od, M):
    """Jacobians (E, 6, 6) of r = log(M^-1 exp(-dp) A^-1 B exp(dc)) at
    zero, given r = xi there: dr/ddc = Jr^-1(xi), dr/ddp = -Jl^-1(xi)
    Ad(M^-1). Jl^-1, Jr^-1 = I -/+ ad/2 + ad^2/12 - ad^4/720 (Bernoulli
    series; the next term is O(|xi|^6 / 30240), far below float32 for the
    small odometry residuals). The JAX package takes jax.jacfwd of the same
    residual; tests hold the two together."""
    a = _ad(r_od)
    a2 = a @ a
    eye = torch.eye(6, dtype=r_od.dtype, device=r_od.device)
    base = eye + a2 / 12.0 - (a2 @ a2) / 720.0
    Ja = -(base - 0.5 * a) @ adjoint_se3(inverse_se3(M))
    return Ja, base + 0.5 * a


def _huber_rho(chi2):
    d2 = DELTA_HUBER * DELTA_HUBER
    return torch.where(
        chi2 <= d2, chi2,
        2.0 * DELTA_HUBER * torch.sqrt(torch.clamp(chi2, min=1e-20)) - d2)


def solve_window_ba(Twc0, odom, odom_valid, X0, obs, obs_valid, point_valid,
                    frame_valid=None, *, max_iters: int = 20,
                    gain_tol: float = 1e-3) -> WindowBAResult:
    """Twc0 (W, 4, 4), odom (W-1, 4, 4), odom_valid (W-1,), X0 (P, 3),
    obs (W, P, 3), obs_valid (W, P), point_valid (P,), frame_valid (W,)."""
    W = Twc0.shape[0]
    P = X0.shape[0]
    D = 6 * W
    dev, f32 = Twc0.device, Twc0.dtype
    obs_valid = obs_valid & point_valid[None, :]
    if frame_valid is None:
        frame_valid = torch.ones(W, dtype=torch.bool, device=dev)
    first_real = torch.argmax(frame_valid.to(torch.int32))
    gauge = ~frame_valid | (torch.arange(W, device=dev) == first_real)
    free_d = (~gauge).to(f32).repeat_interleave(6)
    obs_valid_f = obs_valid.to(f32)
    odom_valid_f = odom_valid.to(f32)
    eye_d = torch.eye(D, dtype=f32, device=dev)
    e0 = torch.arange(W - 1, device=dev)

    def linearize(Twc, X):
        """Lambda-independent normal-equation pieces at (Twc, X), and the
        cost there (the trial-point evaluation of the previous step)."""
        Tcw = inverse_se3(Twc)
        Rcw = Tcw[:, :3, :3]
        Xc = torch.einsum("wij,pj->wpi", Rcw, X) + Tcw[:, None, :3, 3]
        r_pt = Xc - obs
        chi2_pt = torch.sum(r_pt * r_pt, dim=-1) * (1.0 / SIGMA2_3D_STA)
        w_pt = huber_weight(chi2_pt, DELTA_HUBER) * (1.0 / SIGMA2_3D_STA)
        w_pt = torch.where(obs_valid, w_pt, torch.zeros_like(w_pt))

        # E[w, p] = [[-Rcw], [-hat(Xc) Rcw]] (6x3 per edge)
        top = (-Rcw)[:, None].expand(W, P, 3, 3)
        cols = Rcw.transpose(-1, -2)
        bot = torch.linalg.cross(cols[:, None, :, :], Xc[:, :, None, :],
                                 dim=-1).transpose(-1, -2)
        E = torch.cat([top, bot], dim=2)                     # (W, P, 6, 3)
        Ef = E.permute(0, 2, 1, 3)                           # (W, 6, P, 3)
        G1 = (Ef * torch.sqrt(w_pt)[:, None, :, None]).reshape(W, 6, P * 3)
        Gw = (Ef * w_pt[:, None, :, None]).reshape(D, P * 3)
        JtJ_c = G1 @ G1.transpose(-1, -2)                    # (W, 6, 6)

        Tp, Tc = Twc[:-1], Twc[1:]
        r_od = _odom_residual(Tp, Tc, odom)
        Ja, Jb = _odom_jac(r_od, odom)
        chi2_od = torch.sum(r_od * r_od, dim=-1) * (1.0 / SIGMA2_CAM)
        w_od = huber_weight(chi2_od, DELTA_HUBER) * (1.0 / SIGMA2_CAM)
        w_od = torch.where(odom_valid, w_od, torch.zeros_like(w_od))
        cost = torch.sum(_huber_rho(chi2_pt) * obs_valid_f) + torch.sum(
            _huber_rho(chi2_od) * odom_valid_f)

        Hcc = torch.zeros(W, W, 6, 6, dtype=f32, device=dev)
        ii = torch.arange(W, device=dev)
        Hcc[ii, ii] += JtJ_c
        Haa = torch.einsum("eij,e,eik->ejk", Ja, w_od, Ja)
        Hab = torch.einsum("eij,e,eik->ejk", Ja, w_od, Jb)
        Hbb = torch.einsum("eij,e,eik->ejk", Jb, w_od, Jb)
        Hcc[e0, e0] += Haa
        Hcc[e0, e0 + 1] += Hab
        Hcc[e0 + 1, e0] += Hab.transpose(-1, -2)
        Hcc[e0 + 1, e0 + 1] += Hbb
        Hcc_base = Hcc.permute(0, 2, 1, 3).reshape(D, D)

        wr = w_pt[..., None] * r_pt                          # (W, P, 3)
        g_pt_t = -torch.sum(wr, dim=1)
        g_pt_r = -torch.sum(torch.linalg.cross(Xc, wr, dim=-1), dim=1)
        g_c = torch.cat([g_pt_t, g_pt_r], dim=1)             # (W, 6)
        g_c[:-1] += torch.einsum("eij,e,ei->ej", Ja, w_od, r_od)
        g_c[1:] += torch.einsum("eij,e,ei->ej", Jb, w_od, r_od)
        g_p = torch.einsum("wij,wpi->pj", Rcw, wr)           # (P, 3)
        w_sum = torch.sum(w_pt, dim=0)                       # (P,)
        return (Gw, Hcc_base, g_c.reshape(D), g_p, w_sum), cost

    def assemble(cache, lam):
        """Schur complement and reduced system for this damping."""
        Gw, Hcc_base, g_c, g_p, w_sum = cache
        s_p = torch.clamp(w_sum + lam, min=1e-20)
        inv_s3 = (1.0 / s_p).repeat_interleave(3)[None]
        inv_sq3 = (1.0 / torch.sqrt(s_p)).repeat_interleave(3)[None]
        Gv = Gw * inv_sq3
        S = Hcc_base + lam * eye_d - Gv @ Gv.T
        Gs = Gw * inv_s3
        rhs = g_c - Gs @ g_p.reshape(P * 3)
        S = S * (free_d[:, None] * free_d[None, :]) + torch.diag(1.0 - free_d)
        return S, rhs * free_d, s_p, Gs

    Twc, X = Twc0, X0
    cache, cost = linearize(Twc, X)
    lam = torch.tensor(1e-4, dtype=f32, device=dev)
    nu = torch.tensor(2.0, dtype=f32, device=dev)
    it = 0
    while it < max_iters:
        S, rhs, s_p, Gs = assemble(cache, lam)
        # cholesky_ex reports a matrix that is not positive definite
        # instead of raising; such a step is rejected like a NaN one
        L, info = torch.linalg.cholesky_ex(S)
        y = torch.linalg.solve_triangular(L, -rhs[:, None], upper=False)
        dc = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
        bad = (info != 0) | torch.isnan(dc).any()
        dc = torch.where(bad, torch.zeros_like(dc), dc)
        g_p = cache[3]
        Bt_dc = (Gs.T @ dc).reshape(P, 3) * torch.sqrt(s_p)[:, None]
        dp = -(g_p + Bt_dc) / s_p[:, None]
        dp = torch.where(point_valid[:, None], dp, torch.zeros_like(dp))
        Twc_new = Twc @ exp_se3(dc.reshape(W, 6))
        X_new = X + dp
        cache_new, cost_new = linearize(Twc_new, X_new)
        accept = (cost_new < cost) & ~bad
        lam_new = torch.where(accept, lam * (1.0 / 3.0), lam * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        lam = lam_new
        Twc = torch.where(accept, Twc_new, Twc)
        X = torch.where(accept, X_new, X)
        cost_next = torch.where(accept, cost_new, cost)
        cache = tuple(torch.where(accept, b, a)
                      for a, b in zip(cache, cache_new))
        rel_impr = (cost - cost_next) / torch.clamp(cost, min=1e-20)
        cost = cost_next
        it += 1
        # g2o SparseOptimizerTerminateAction, gain 1e-3 (Optimizer.cc:182)
        if bool(accept & (rel_impr < gain_tol)):
            break
    return WindowBAResult(Twc=Twc, points=X, cost=cost, num_iters=it)
