"""Batched joint flow + pose solves: the CUDA kernel ``csrc/flow_joint.cu``
(counterpart of the Pallas ``flow_joint_batched_pallas``,
``vido_slam_tpu/estimation/flow_joint_pallas.py``) and its plain PyTorch
version.

Both run B independent 4-round solves of one SE(3) vertex and one 2-D flow
per point (PoseOptimizationFlow2Cam / Flow2, Optimizer.cc:2622-2824,
3037-3253) with the Pallas kernel's rules: the pose restarts from T_init
every round while the flows carry over; lambda restarts at 1e-3, halves on
an accepted step and quadruples on a rejected one; Huber (delta 0.2 on
0.1 |r1|^2) in rounds 0-2 only; damping S_jj + lam max(S_jj, 1e-6); the
``isfinite(sum(dxi))`` step guard; a round stops at ``iters``, on
convergence or at lam >= 1e6 and ends with the chi2 gate (0.04 after round
0, 5.991 after the others) and z > 1e-3. The prior set is the initial
inlier set ``valid``.

``flow_joint_batched`` runs the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from vido_slam_tpu_torch.estimation.lm_kernel import (
    ClusterPlan,
    _check,
    _chol_solve6,
    _exp_se3_compose,
    _full_batch,
    cluster_plan,
)
from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.utils import cuda_build
from vido_slam_tpu_torch.utils.device import refuse_grad

# Reference constants (Optimizer.cc:2624-2625, 2663-2666, 2690-2693, 2745)
RP_THRES_JOINT = 0.04      # round-0 chi2 gate and Huber delta^2
CHI2_LATER = 5.991         # rounds 1-3 gate
SIGMA_PROJ = 0.1           # EdgeSE3ProjectFlow2 information
SIGMA_PRIOR = 0.3          # EdgeFlowPrior information
HUBER_DELTA = 0.2          # sqrt(0.04)
ROUND_ITERS = 10           # LM steps per round
MIN_EDGES = 5              # Optimizer.cc:2794: below this no step is taken
ROUNDS = 4

PLANES = 13                # floats a point of the prior set keeps (52 B)


def launch_plan(B: int, N: int) -> ClusterPlan:
    """The kernel's launch plan (``lm_kernel.cluster_plan``): a cluster of
    CTAs a problem, each holding its share of the problem's compacted prior
    set, 52 B a point."""
    return cluster_plan(B, N, PLANES)


class FlowJointBatch(NamedTuple):
    T: torch.Tensor            # (B, 4, 4)
    flow: torch.Tensor         # (B, N, 2)
    inliers: torch.Tensor      # (B, N) bool, the last round's gate
    num_inliers: torch.Tensor  # (B,) int32
    chi2: torch.Tensor         # (B, N) 0.1 |r1|^2 at the final T and flow
    num_iters: torch.Tensor    # (B, 4) int32 iterations of each round


# float32 operations of the kernel's arithmetic, an FMA counted as 2, for the
# roofline bound of chip_smoke.py; every pass but the last gate runs over
# the points of the prior set only. They are itemised as two passes an
# iteration; the kernel's one pass does the same two linearisations and
# sums (and the trial cost from the second), so the count and the bound
# stay comparable across the two designs. Per point: the round-start cost and
# active count (reprojection residual 29, chi2 4, gate 2, prior term 7,
# sums 2) ...
FLOPS_COST = 44
# ... pass 1 of an iteration: the linearisation 64 (residual 29, chi2 4,
# a and v 5, Jacobian factors 8 and rows 10, b_f 8), the reduced residuals
# and coefficients 9, 21 S entries 96 and 6 right-hand-side entries 24 ...
FLOPS_NORMAL_EQS = 193
# ... pass 2: the linearisation again 64, J dxi 24, the flow step 8 and the
# trial cost 43 ...
FLOPS_TRIAL = 139
# ... the Huber weights and rho, in rounds 0-2 (cost 4; per iteration 2 + 2
# in the linearisations and 4 in the trial cost) ...
FLOPS_HUBER_COST = 4
FLOPS_HUBER_ITER = 8
# ... and the round-end gate (residual 29, chi2 4, gate 2).
FLOPS_GATE = 35
# Per problem and iteration (thread 0): damping 18, the 6x6 Cholesky solve
# ~163, exp-compose ~195 and the accept rule, about.
FLOPS_STEP = 400


def operations(valid: torch.Tensor, num_iters: torch.Tensor) -> int:
    """float32 operations a call's solves need on these inputs: per round a
    cost pass, per iteration the two passes, per round but the last a gate
    over the prior set, and the last gate over every point."""
    n_valid = valid.sum(-1).to(torch.int64)                    # (B,)
    its = num_iters.to(torch.int64)                            # (B, 4)
    huber = torch.tensor([1, 1, 1, 0], dtype=torch.int64,
                         device=its.device)
    per_iter = (FLOPS_NORMAL_EQS + FLOPS_TRIAL
                + huber * FLOPS_HUBER_ITER)                    # (4,)
    per_round = FLOPS_COST + huber * FLOPS_HUBER_COST          # (4,)
    point_ops = (its * per_iter).sum(-1) + per_round.sum() \
        + (ROUNDS - 1) * FLOPS_GATE
    return (int((n_valid * point_ops).sum()) + int(its.sum()) * FLOPS_STEP
            + valid.numel() * FLOPS_GATE)


def flow_joint_batched_ref(T_init, pts3d, obs_last, flow_meas, valid,
                           cam: Camera, iters: int = ROUND_ITERS
                           ) -> FlowJointBatch:
    """Plain PyTorch version of the kernel: the B problems step together
    and a per-problem ``run`` mask freezes the finished ones."""
    f32 = torch.float32
    B, N = valid.shape
    pts = _full_batch(pts3d, B)
    ol = _full_batch(obs_last, B)
    fm = _full_batch(flow_meas, B)
    ou, ov = ol[..., 0], ol[..., 1]
    fmu, fmv = fm[..., 0], fm[..., 1]
    val = valid.to(f32)
    s_pr = SIGMA_PRIOR * val
    d2 = HUBER_DELTA * HUBER_DELTA

    def resid(T, fu, fv):
        pc = pts @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
        pcx, pcy, pcz = pc.unbind(-1)
        iz = 1.0 / torch.where(pcz.abs() < 1e-6, torch.full_like(pcz, 1e-6),
                               pcz)
        r1u = ou + fu - (cam.fx * pcx * iz + cam.cx)
        r1v = ov + fv - (cam.fy * pcy * iz + cam.cy)
        return pcx, pcy, pcz, iz, r1u, r1v

    def cost(T, fu, fv, active, use_huber):
        _, _, pcz, _, r1u, r1v = resid(T, fu, fv)
        c1 = SIGMA_PROJ * (r1u * r1u + r1v * r1v)
        rho = torch.where(
            c1 <= d2, c1,
            2.0 * HUBER_DELTA * torch.sqrt(torch.clamp(c1, min=1e-12)) - d2
        ) if use_huber else c1
        gate = active * (pcz > 1e-3).to(f32)
        r2u, r2v = fu - fmu, fv - fmv
        c2 = s_pr * (r2u * r2u + r2v * r2v)
        return torch.sum(rho * gate, -1) + torch.sum(c2, -1)

    def step(T, fu, fv, lam, active, use_huber):
        """The Schur-reduced LM step at (T, f): T_new, the trial flows and
        whether dxi is finite."""
        pcx, pcy, pcz, iz, r1u, r1v = resid(T, fu, fv)
        chi2 = SIGMA_PROJ * (r1u * r1u + r1v * r1v)
        w = torch.where(chi2 <= d2, torch.ones_like(chi2),
                        HUBER_DELTA / torch.sqrt(torch.clamp(chi2, min=1e-12))
                        ) if use_huber else torch.ones_like(chi2)
        a = active * (pcz > 1e-3).to(f32) * (SIGMA_PROJ * w)
        v = a + s_pr + 1e-12
        az, cz = cam.fx * iz, -cam.fx * pcx * iz * iz
        ez, fz = cam.fy * iz, -cam.fy * pcy * iz * iz
        zr = torch.zeros_like(az)
        Ju = torch.stack([az, zr, cz, cz * pcy, az * pcz - cz * pcx,
                          -az * pcy], -1)                           # (B, N, 6)
        Jv = torch.stack([zr, ez, fz, fz * pcy - ez * pcz, -fz * pcx,
                          ez * pcx], -1)
        b_fu = a * r1u + s_pr * (fu - fmu)
        b_fv = a * r1v + s_pr * (fv - fmv)
        coef = a * s_pr / v
        ru = a * r1u - (a / v) * b_fu
        rv = a * r1v - (a / v) * b_fv
        cJu, cJv = coef[..., None] * Ju, coef[..., None] * Jv
        S = cJu.transpose(-1, -2) @ Ju + cJv.transpose(-1, -2) @ Jv
        rhs = torch.sum(Ju * ru[..., None] + Jv * rv[..., None], dim=1)
        dS = torch.diagonal(S, dim1=-2, dim2=-1)
        Sd = S + torch.diag_embed(lam[:, None] * torch.clamp(dS, min=1e-6))
        dxi = _chol_solve6(Sd, rhs)
        fu_n = fu + (-(b_fu - a * torch.sum(Ju * dxi[:, None], -1)) / v)
        fv_n = fv + (-(b_fv - a * torch.sum(Jv * dxi[:, None], -1)) / v)
        return (_exp_se3_compose(dxi, T), fu_n, fv_n,
                torch.isfinite(dxi.sum(-1)))

    fu = fmu * val
    fv = fmv * val
    active = val
    num_iters = torch.zeros(B, ROUNDS, dtype=torch.int32, device=val.device)
    for rnd in range(ROUNDS):
        use_huber = rnd < 3
        enough = active.sum(-1) >= MIN_EDGES
        T = T_init.clone()
        c = cost(T, fu, fv, active, use_huber)
        lam = torch.full_like(c, 1e-3)
        it = torch.zeros(B, dtype=torch.int32, device=val.device)
        done = torch.zeros(B, dtype=torch.bool, device=val.device)
        for _ in range(iters):
            run = ~done & (lam < 1e6)
            if not bool(run.any()):
                break
            T_new, fu_n, fv_n, finite = step(T, fu, fv, lam, active,
                                             use_huber)
            c_new = cost(T_new, fu_n, fv_n, active, use_huber)
            ok = (c_new < c) & finite & enough
            take = run & ok
            done = done | (take & (c - c_new
                                   < 1e-8 * torch.clamp(c, min=1.0)))
            T = torch.where(take[:, None, None], T_new, T)
            fu = torch.where(take[:, None], fu_n, fu)
            fv = torch.where(take[:, None], fv_n, fv)
            c = torch.where(take, c_new, c)
            lam = torch.where(run, torch.where(ok, lam * 0.5, lam * 4.0), lam)
            it = it + run.to(torch.int32)
        num_iters[:, rnd] = it
        _, _, pcz, _, r1u, r1v = resid(T, fu, fv)
        chi2 = SIGMA_PROJ * (r1u * r1u + r1v * r1v)
        thr = RP_THRES_JOINT if rnd == 0 else CHI2_LATER
        active = val * (chi2 <= thr).to(f32) * (pcz > 1e-3).to(f32)
    inl = active > 0.5
    return FlowJointBatch(T=T, flow=torch.stack([fu, fv], -1), inliers=inl,
                          num_inliers=inl.sum(-1).to(torch.int32), chi2=chi2,
                          num_iters=num_iters)


_launch_fn = None


def _launch(args, cam: Camera, iters: int, plan: ClusterPlan,
            out: FlowJointBatch) -> int:
    """Launches the kernel on the current stream for
    args = (T_init, pts3d, obs_last, flow_meas, valid) with `plan`, writing
    into `out`; returns the launcher's CUDA error (cudaErrorInvalidValue for
    a plan it cannot run), 0 on success."""
    global _launch_fn
    if _launch_fn is None:
        P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
            ctypes.c_longlong
        fn = cuda_build.load("flow_joint").flow_joint_batched_launch
        fn.argtypes = [P, P, LL, P, LL, P, LL, P, P, P, P, P, P, P, P, I, I,
                       I, I, I, I, F, F, F, F, F, F, F, F, F, F, I, I, P]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    T_init, pts3d, obs_last, flow_meas, valid = args
    B, N = valid.shape
    dev = T_init.device
    scratch = (torch.empty((plan.scratch_floats,), dtype=torch.float32,
                           device=dev) if plan.scratch_floats else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return _launch_fn(
            T_init.data_ptr(), pts3d.data_ptr(),
            0 if pts3d.ndim == 2 else N * 3, obs_last.data_ptr(),
            0 if obs_last.ndim == 2 else N * 2, flow_meas.data_ptr(),
            0 if flow_meas.ndim == 2 else N * 2, valid.data_ptr(),
            *(t.data_ptr() for t in out),
            0 if scratch is None else scratch.data_ptr(), B, N,
            plan.cluster, plan.threads, plan.cap, plan.smem_bytes,
            cam.fx, cam.fy, cam.cx, cam.cy, SIGMA_PROJ, SIGMA_PRIOR,
            HUBER_DELTA, HUBER_DELTA * HUBER_DELTA, RP_THRES_JOINT,
            CHI2_LATER, MIN_EDGES, int(iters), stream)


def flow_joint_batched(T_init, pts3d, obs_last, flow_meas, valid,
                       cam: Camera, iters: int = ROUND_ITERS
                       ) -> FlowJointBatch:
    """B joint solves. T_init (B, 4, 4); pts3d (B, N, 3) or shared (N, 3);
    obs_last and flow_meas (B, N, 2) or shared (N, 2); valid (B, N) bool,
    the initial inlier set of each problem."""
    tensors = (T_init, pts3d, obs_last, flow_meas, valid)
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return flow_joint_batched_ref(T_init, pts3d, obs_last, flow_meas,
                                      valid, cam, iters=iters)
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError("flow_joint_batched: all tensors must be on the CPU "
                         "or all on one CUDA device")
    refuse_grad("flow_joint_batched", tensors)
    B, N = valid.shape
    _check("T_init", T_init, torch.float32, (B, 4, 4))
    _check("pts3d", pts3d, torch.float32,
           (N, 3) if pts3d.ndim == 2 else (B, N, 3))
    for name, t in (("obs_last", obs_last), ("flow_meas", flow_meas)):
        _check(name, t, torch.float32, (N, 2) if t.ndim == 2 else (B, N, 2))
    _check("valid", valid, torch.bool, (B, N))
    out = empty_batch(B, N, T_init.device)
    rc = _launch(tensors, cam, iters, launch_plan(B, N), out)
    if rc != 0:
        raise RuntimeError(f"flow_joint kernel launch failed: CUDA error {rc}")
    flow_joint_batched.launches += 1
    return out


def empty_batch(B: int, N: int, device) -> FlowJointBatch:
    """Uninitialised outputs of B solves over N points, as the kernel
    writes them."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)
    return FlowJointBatch(T=empty((B, 4, 4), torch.float32),
                          flow=empty((B, N, 2), torch.float32),
                          inliers=empty((B, N), torch.bool),
                          num_inliers=empty((B,), torch.int32),
                          chi2=empty((B, N), torch.float32),
                          num_iters=empty((B, ROUNDS), torch.int32))


# kernel launches since the last reset (the wrapper adds one per launch)
flow_joint_batched.launches = 0
