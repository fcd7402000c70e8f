"""Full-batch dynamic-SLAM bundle adjustment — Optimizer::FullBatchOptimization
(reference vido_slam/src/Optimizer.cc:1235-2178, STATIC_ONLY=false);
counterpart of ``vido_slam_tpu/estimation/full_ba.py``.

The graph covers the whole sequence:
  - camera poses, odometry edges and static points (as the window BA);
  - an object motion H_{i,k} per frame and object, with smoothness edges
    between consecutive motions of one object (sigma2_obj_smo = 0.1);
  - dynamic points per frame with camera-point edges (sigma2_3d_dyn = 16)
    and the ternary edge D_{i-1} - H^{-1} D_i (sigma2_obj = 20);
  - Huber delta 0.01 on every edge; optionally the altitude prior on each
    motion's y translation (sigma2_alti = 1, not robust).

The LM step is matrix-free, as in the JAX package: the residual blocks are
one function of the parameters; the gradient J^T W r comes from one
``torch.func.vjp``, and each product J^T W J v of the conjugate-gradient
solve from a ``torch.func.jvp`` and that same VJP, whose closure is reused
across the CG iterations. The CG runs a fixed ``cg_iters`` with no
preconditioner (the JAX module's docstring says Jacobi-preconditioned; its
body, copied here, is not). The first real pose and the pad slots are
pinned exactly by projecting them out of the operator. Each LM iteration
reads its accept and stop test on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vjp

from vido_slam_tpu_torch.estimation.lm import huber_weight
from vido_slam_tpu_torch.estimation.window_ba import (DELTA_HUBER,
                                                      SIGMA2_3D_STA,
                                                      SIGMA2_CAM, _huber_rho)
from vido_slam_tpu_torch.geometry.se3 import exp_se3, inverse_se3, log_se3

# Optimizer.cc:190-196
SIGMA2_OBJ_SMO = 0.1
SIGMA2_OBJ = 20.0
SIGMA2_3D_DYN = 16.0
SIGMA2_ALT = 1.0


class FullBAProblem(NamedTuple):
    """Fixed-shape inputs: F frames, Ps static tracks, Nd dynamic slots, K
    object-motion slots a frame."""

    Twc0: torch.Tensor          # (F, 4, 4)
    frame_valid: torch.Tensor   # (F,)
    odom: torch.Tensor          # (F-1, 4, 4)
    odom_valid: torch.Tensor    # (F-1,)
    X0: torch.Tensor            # (Ps, 3)
    sobs: torch.Tensor          # (F, Ps, 3) camera-frame measurements
    sobs_valid: torch.Tensor    # (F, Ps)
    spoint_valid: torch.Tensor  # (Ps,)
    D0: torch.Tensor            # (F, Nd, 3) world initialisation
    dobs: torch.Tensor          # (F, Nd, 3) camera-frame measurements
    dobs_valid: torch.Tensor    # (F, Nd)
    # slot j at frame i links to slot j at frame i-1 under motion slot
    # midx[i, j] of frame i
    tern_valid: torch.Tensor    # (F, Nd), False at i = 0
    midx: torch.Tensor          # (F, Nd) int32 in [0, K)
    H0: torch.Tensor            # (F, K, 4, 4) world-frame motions
    motion_valid: torch.Tensor  # (F, K)
    smooth_valid: torch.Tensor  # (F, K) same-object link to frame i-1


class Params(NamedTuple):
    xi: torch.Tensor   # (F, 6) pose chart deltas
    xs: torch.Tensor   # (Ps, 3) static point deltas
    xd: torch.Tensor   # (F, Nd, 3) dynamic point deltas
    xh: torch.Tensor   # (F, K, 6) motion chart deltas


class FullBAResult(NamedTuple):
    Twc: torch.Tensor
    H: torch.Tensor
    X: torch.Tensor
    D: torch.Tensor
    cost: torch.Tensor
    num_iters: int


def _residuals(p: Params, prob: FullBAProblem, altitude: bool = False):
    """Every residual block at Twc0 exp(xi) etc.: a tuple of (residual,
    weight, robust) triples, the weights folding validity and information.
    ``altitude`` adds EdgeSE3Altitude (types_dyn_slam3d.h:44-60), off by
    default like the reference's ALTITUDE_CONSTRAINT (Optimizer.cc:212)."""
    f32 = torch.float32
    Twc = prob.Twc0 @ exp_se3(p.xi)
    Tcw = inverse_se3(Twc)
    X = prob.X0 + p.xs
    D = prob.D0 + p.xd
    H = prob.H0 @ exp_se3(p.xh)

    # odometry
    rel = inverse_se3(Twc[:-1]) @ Twc[1:]
    r_od = log_se3(inverse_se3(prob.odom) @ rel)
    w_od = prob.odom_valid.to(f32) / SIGMA2_CAM

    # static points
    pc_s = torch.einsum("fij,pj->fpi", Tcw[:, :3, :3], X) \
        + Tcw[:, None, :3, 3]
    r_sp = pc_s - prob.sobs
    w_sp = (prob.sobs_valid & prob.spoint_valid[None, :]).to(f32) \
        / SIGMA2_3D_STA

    # dynamic points: camera-point edges
    pc_d = torch.einsum("fij,fnj->fni", Tcw[:, :3, :3], D) \
        + Tcw[:, None, :3, 3]
    r_dp = pc_d - prob.dobs
    w_dp = prob.dobs_valid.to(f32) / SIGMA2_3D_DYN

    # ternary motion edges: D_{i-1,j} - H_{i,k}^-1 D_{i,j}
    Hinv = inverse_se3(H)                                  # (F, K, 4, 4)
    K = H.shape[1]
    frames = torch.arange(H.shape[0], device=H.device)[:, None]
    Hi = Hinv[frames, prob.midx.clamp(0, K - 1).long()]    # (F, Nd, 4, 4)
    mapped = torch.einsum("fnij,fnj->fni", Hi[:, :, :3, :3], D) \
        + Hi[:, :, :3, 3]
    r_t = torch.cat([D[:1] * 0.0, D[:-1]]) - mapped
    w_t = prob.tern_valid.to(f32) / SIGMA2_OBJ

    # motion smoothness: log(H_{i-1,k}^-1 H_{i,k})
    r_sm = log_se3(inverse_se3(H[:-1]) @ H[1:])            # (F-1, K, 6)
    w_sm = prob.smooth_valid[1:].to(f32) / SIGMA2_OBJ_SMO

    blocks = [(r_od, w_od, True), (r_sp, w_sp, True), (r_dp, w_dp, True),
              (r_t, w_t, True), (r_sm, w_sm, True)]
    if altitude:
        r_alt = H[:, :, 1, 3:4]                            # (F, K, 1)
        w_alt = prob.motion_valid.to(f32) / SIGMA2_ALT
        blocks.append((r_alt, w_alt, False))
    return tuple(blocks)


def _robust_weights(blocks):
    """Huber IRLS factors of each block at the current estimate."""
    out = []
    for r, w, robust in blocks:
        chi2 = torch.sum(r * r, dim=-1) * w
        out.append((huber_weight(chi2, DELTA_HUBER) if robust else 1.0) * w)
    return tuple(out)


def _cost(blocks):
    c = 0.0
    for r, w, robust in blocks:
        chi2 = torch.sum(r * r, dim=-1) * w
        # rho with the information already inside chi2
        rho = _huber_rho(chi2) if robust else chi2
        c = c + torch.sum(torch.where(w > 0, rho, torch.zeros_like(rho)))
    return c


def _dot(a: Params, b: Params):
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def _axpy(alpha, x: Params, y: Params) -> Params:
    return Params(*(b + alpha * a for a, b in zip(x, y)))


def _scale(alpha, x: Params) -> Params:
    return Params(*(alpha * a for a in x))


def solve_full_ba(prob: FullBAProblem, *, max_iters: int = 15,
                  cg_iters: int = 60, altitude: bool = False) -> FullBAResult:
    """LM over the whole problem on its tensors' device: each iteration
    builds the gradient, solves the damped step by ``cg_iters`` of CG on
    the free coordinates, accepts if the cost falls (lambda halves) or
    rejects (lambda times nu, nu doubles), and stops after an accepted
    step whose relative decrease is below 1e-6."""
    F, K = prob.H0.shape[0], prob.H0.shape[1]
    Ps = prob.X0.shape[0]
    Nd = prob.D0.shape[1]
    dev = prob.H0.device
    f32 = torch.float32

    zero = Params(xi=torch.zeros(F, 6, device=dev),
                  xs=torch.zeros(Ps, 3, device=dev),
                  xd=torch.zeros(F, Nd, 3, device=dev),
                  xh=torch.zeros(F, K, 6, device=dev))

    # gauge: the first valid frame's pose and the pads are pinned exactly
    # (g2o setFixed): the operator is projected onto the free subspace, so
    # no large soft diagonal enters the Krylov basis. ``free`` is 1.0 on
    # the optimised coordinates.
    first_real = torch.argmax(prob.frame_valid.to(torch.int32))
    gauge_pose = (~prob.frame_valid) | (torch.arange(F, device=dev)
                                        == first_real)
    free = Params(
        xi=(~gauge_pose)[:, None].to(f32).expand(F, 6),
        xs=prob.spoint_valid[:, None].to(f32).expand(Ps, 3),
        xd=(prob.dobs_valid | prob.tern_valid)[:, :, None].to(f32)
        .expand(F, Nd, 3),
        xh=prob.motion_valid[:, :, None].to(f32).expand(F, K, 6))

    def project_free(v: Params) -> Params:
        return Params(*(a * m for a, m in zip(v, free)))

    def res_fn(*p):
        return tuple(r for r, _, _ in _residuals(Params(*p), prob, altitude))

    def step(p: Params, lam: float):
        blocks = _residuals(p, prob, altitude)
        w_rob = _robust_weights(blocks)
        # the gradient J^T W r from one VJP, reused by every CG product
        _, vjp_fn = vjp(res_fn, *p)
        g = Params(*vjp_fn(tuple(r * w[..., None]
                                 for (r, _, _), w in zip(blocks, w_rob))))

        def Hv(v: Params) -> Params:
            """P H P v + (I - P) v: SPD, the pinned coordinates stay 0."""
            _, Jv = jvp(res_fn, tuple(p), tuple(project_free(v)))
            JtWJv = vjp_fn(tuple(jv * w[..., None]
                                 for jv, w in zip(Jv, w_rob)))
            return Params(*(m * (h + lam * vv) + (1.0 - m) * vv
                            for h, vv, m in zip(JtWJv, v, free)))

        # CG on Hv(d) = -g over the free subspace
        r = project_free(_scale(-1.0, g))
        d, z, rz = zero, r, _dot(r, r)
        for _ in range(cg_iters):
            Hd = Hv(z)
            alpha = rz / torch.clamp(_dot(z, Hd), min=1e-20)
            d = _axpy(alpha, z, d)
            r = _axpy(-alpha, Hd, r)
            rz_new = _dot(r, r)
            beta = rz_new / torch.clamp(rz, min=1e-20)
            z = _axpy(beta, z, r)
            rz = rz_new
        p_new = Params(*(a + b for a, b in zip(p, d)))
        return p_new, _cost(_residuals(p_new, prob, altitude))

    with torch.no_grad():
        cost = _cost(_residuals(zero, prob, altitude))
    p = zero
    lam, nu = np.float32(1e-4), np.float32(2.0)
    it, done = 0, False
    while it < max_iters and not done:
        p_new, cost_new = step(p, float(lam))
        c_old, c_new = (np.float32(c) for c in
                        torch.stack([cost, cost_new]).detach().cpu().numpy())
        accept = c_new < c_old
        if accept:
            p, cost, c_next = p_new, cost_new, c_new
            lam, nu = lam * np.float32(0.5), np.float32(2.0)
        else:
            c_next = c_old
            lam, nu = lam * nu, nu * np.float32(2.0)
        rel = (c_old - c_next) / max(c_old, np.float32(1e-20))
        done = bool(accept and rel < np.float32(1e-6))
        it += 1

    with torch.no_grad():
        return FullBAResult(Twc=prob.Twc0 @ exp_se3(p.xi),
                            H=prob.H0 @ exp_se3(p.xh), X=prob.X0 + p.xs,
                            D=prob.D0 + p.xd, cost=cost.detach(),
                            num_iters=it)
