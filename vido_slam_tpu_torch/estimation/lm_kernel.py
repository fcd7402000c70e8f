"""Batched 6-DoF LM reprojection solves: the CUDA kernel ``csrc/pose_lm.cu``
(counterpart of the Pallas ``pose_lm_batched_pallas``,
``vido_slam_tpu/estimation/lm_pallas.py``) and its plain PyTorch version.

Both solve B problems ``min_T sum rho(|pi(T_pre T X) - obs|^2)`` with the
Pallas kernel's Levenberg policy: Marquardt damping, g2o gain ratio with
``ni`` doubling, exits on gain, relative tolerance or exploding damping,
the ``isfinite(sum(delta))`` step guard and the predicted gain
``0.5 delta^T (lam D delta - g)``.

``pose_lm_batched`` runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.utils import cuda_build

# The launch plan of the LM kernels (csrc/pose_lm.cu, csrc/flow_joint.cu): a
# cluster of CTAs a problem, each holding its share of the problem's
# compacted points.
SM_COUNT = 132             # H100 SXM
MAX_CLUSTER = 8            # portable cluster size
MAX_THREADS = 256
MIN_POINTS_PER_CTA = 32    # a CTA gets at least a warp's worth of N
SMEM_LIMIT = 232448        # bytes of shared memory a block may use on sm_90
SMEM_RESERVE = 4096        # room for the static shared memory
PLANES = 5                 # floats a valid point keeps in pose_lm.cu (20 B)


class ClusterPlan(NamedTuple):
    cluster: int         # G CTAs a problem
    threads: int         # threads a CTA
    cap: int             # points a CTA can hold: ceil(N / G)
    smem_bytes: int      # dynamic shared memory a CTA; 0: points in scratch
    scratch_floats: int  # global scratch the wrapper allocates


def cluster_plan(B: int, N: int, planes: int) -> ClusterPlan:
    """The largest power-of-two cluster, at most MAX_CLUSTER, that keeps all
    B clusters on the SMs at once (B G <= SM_COUNT) and a CTA's share of N
    at least MIN_POINTS_PER_CTA. A CTA's points take ``planes`` floats each
    of shared memory while ceil(N / G) of them fit; beyond, a global
    scratch."""
    G = 1
    while (G < MAX_CLUSTER and 2 * G * B <= SM_COUNT
           and N >= 2 * G * MIN_POINTS_PER_CTA):
        G *= 2
    cap = max(1, -(-N // G))
    threads = min(MAX_THREADS, -(-cap // 32) * 32)
    smem = 4 * planes * cap
    if smem + SMEM_RESERVE <= SMEM_LIMIT:
        return ClusterPlan(G, threads, cap, smem, 0)
    return ClusterPlan(G, threads, cap, 0, B * G * planes * cap)


def launch_plan(B: int, N: int) -> ClusterPlan:
    """The plan of ``pose_lm_batched`` for B problems of N points."""
    return cluster_plan(B, N, PLANES)


class PoseLMBatch(NamedTuple):
    T: torch.Tensor          # (B, 4, 4)
    chi2: torch.Tensor       # (B, N) unrobustified chi2 at the final T
    num_iters: torch.Tensor  # (B,) int32


# float32 operations of the kernel's arithmetic, an FMA counted as 2, for the
# roofline bound of chip_smoke.py. Per point (point_terms): the two
# transforms 36, projection and chi2 12 ...
FLOPS_CHI2 = 48
# ... then, in a normal-equation pass, the weights and cost 3, the Jacobian
# rows 44 (projection derivative 8, the two rows through Rpre 18, the
# rotation columns 18) and 21 H + 6 g entries 120 ...
FLOPS_NORMAL_EQS = 167
# ... and the Huber weight and rho, only when huber_delta is set.
FLOPS_HUBER = 6
# Per problem and iteration: damping, the 6x6 Cholesky solve, exp-compose
# and the gain ratio, about (counted once, though every thread of the
# kernel repeats them).
FLOPS_STEP = 470


def operations(valid: torch.Tensor, num_iters: torch.Tensor,
               huber_delta: Optional[float]) -> int:
    """float32 operations a call's solves need on these inputs: a
    normal-equation pass over each problem's valid points at the start and
    after every iteration's step, then the chi2 of every point at the final
    T (the invalid points add nothing to H, g or the cost)."""
    per_point = FLOPS_CHI2 + FLOPS_NORMAL_EQS \
        + (FLOPS_HUBER if huber_delta is not None else 0)
    n_valid = valid.sum(-1).to(torch.int64)
    its = num_iters.to(torch.int64)
    return (int(((its + 1) * n_valid).sum()) * per_point
            + int(its.sum()) * FLOPS_STEP + valid.numel() * FLOPS_CHI2)


def _full_batch(x: torch.Tensor, B: int) -> torch.Tensor:
    return x.expand((B,) + x.shape) if x.ndim == 2 else x


def _chol_solve6(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky solve of (B, 6, 6) S x = b (B, 6), pivots floored
    as sqrt(max(., 1e-20)) like the kernel's."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = S[:, j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-20))
        for i in range(j + 1, n):
            s2 = S[:, i, j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _exp_se3_compose(d: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """exp(d) T for (B, 6) d and (B, 4, 4) T, with the kernel's series
    switch at theta^2 < 1e-12."""
    w = d[:, 3:]
    th2 = torch.sum(w * w, dim=-1)
    th = torch.sqrt(torch.clamp(th2, min=1e-24))
    small = th2 < 1e-12
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-24))
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / torch.clamp(th2 * th, min=1e-24))
    w0, w1, w2 = w[:, 0], w[:, 1], w[:, 2]
    z = torch.zeros_like(w0)
    h = torch.stack([torch.stack([z, -w2, w1], -1),
                     torch.stack([w2, z, -w0], -1),
                     torch.stack([-w1, w0, z], -1)], -2)
    h2 = h @ h
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    Rd = eye + A[:, None, None] * h + B[:, None, None] * h2
    V = eye + B[:, None, None] * h + C[:, None, None] * h2
    out = T.clone()
    out[:, :3, :3] = Rd @ T[:, :3, :3]
    out[:, :3, 3] = (Rd @ T[:, :3, 3:])[..., 0] + (V @ d[:, :3, None])[..., 0]
    return out


def pose_lm_batched_ref(T_init, T_pre, pts3d, obs, valid, cam: Camera, *,
                        huber_delta: Optional[float] = None,
                        max_iters: int = 100, init_lambda: float = 1e-5,
                        gain_tol: float = 1e-9,
                        rel_tol: float = 1e-5) -> PoseLMBatch:
    """Plain PyTorch version of the kernel: all B problems step together,
    a per-problem ``done`` mask freezes the finished ones."""
    B, N = valid.shape
    pts = _full_batch(pts3d, B)
    ob = _full_batch(obs, B)
    val = valid.to(torch.float32)
    Rp = T_pre[:, :3, :3]
    tp = T_pre[:, :3, 3]

    def normal_eqs(T):
        pw = pts @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
        pc = pw @ Rp.transpose(-1, -2) + tp[:, None]
        pcx, pcy, pcz = pc[..., 0], pc[..., 1], pc[..., 2]
        iz = 1.0 / torch.where(torch.abs(pcz) < 1e-6,
                               torch.full_like(pcz, 1e-6), pcz)
        ru = cam.fx * pcx * iz + cam.cx - ob[..., 0]
        rv = cam.fy * pcy * iz + cam.cy - ob[..., 1]
        chi2 = ru * ru + rv * rv
        if huber_delta is not None:
            d2 = huber_delta * huber_delta
            s = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w_rob = torch.where(chi2 <= d2, torch.ones_like(chi2),
                                huber_delta / s)
            rho = torch.where(chi2 <= d2, chi2, 2.0 * huber_delta * s - d2)
        else:
            w_rob, rho = torch.ones_like(chi2), chi2
        w = w_rob * val
        cost = torch.sum(rho * val, dim=-1)
        a = cam.fx * iz
        c = -cam.fx * pcx * iz * iz
        e = cam.fy * iz
        f = -cam.fy * pcy * iz * iz
        gu = a[..., None] * Rp[:, None, 0] + c[..., None] * Rp[:, None, 2]
        gv = e[..., None] * Rp[:, None, 1] + f[..., None] * Rp[:, None, 2]
        # rotation columns: g . (column j of -hat(pw)) == (pw x g)_j
        Ju = torch.cat([gu, torch.linalg.cross(pw, gu, dim=-1)], dim=-1)
        Jv = torch.cat([gv, torch.linalg.cross(pw, gv, dim=-1)], dim=-1)
        wJu = w[..., None] * Ju
        wJv = w[..., None] * Jv
        H = wJu.transpose(-1, -2) @ Ju + wJv.transpose(-1, -2) @ Jv
        g = torch.sum(wJu * ru[..., None] + wJv * rv[..., None], dim=1)
        return H, g, cost, chi2

    T = T_init.clone()
    H, g, cost, _ = normal_eqs(T)
    lam0 = torch.clamp(init_lambda * torch.diagonal(H, dim1=-2,
                                                    dim2=-1).max(-1).values,
                       min=1e-30)
    lam = lam0.clone()
    ni = torch.full_like(lam, 2.0)
    done = cost <= gain_tol
    its = torch.zeros(B, dtype=torch.int32, device=T.device)
    for _ in range(max_iters):
        active = ~done
        if not bool(active.any()):
            break
        dH = torch.diagonal(H, dim1=-2, dim2=-1)
        floor = 1e-6 * torch.clamp(dH.max(-1).values, min=1e-12)
        dscale = torch.maximum(dH, floor[:, None])
        Hd = H + torch.diag_embed(lam[:, None] * dscale)
        delta = _chol_solve6(Hd, -g)
        bad = ~torch.isfinite(delta.sum(-1))
        delta = torch.where(bad[:, None], torch.zeros_like(delta), delta)
        T_new = _exp_se3_compose(delta, T)
        H_new, g_new, cost_new, _ = normal_eqs(T_new)
        pred = 0.5 * torch.sum(delta * (lam[:, None] * dscale * delta - g),
                               dim=-1)
        rho = (cost - cost_new) / torch.clamp(pred, min=1e-20)
        accept = (cost_new < cost) & ~bad
        lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                    min=1.0 / 3.0)
        lam_new = torch.where(accept, lam_acc, lam * ni)
        ni_new = torch.where(accept, torch.full_like(ni, 2.0), ni * 2.0)
        cmax = torch.clamp(cost, min=1e-20)
        done_new = ((accept & (pred < gain_tol * cmax))
                    | (accept & (cost - cost_new < rel_tol * cmax))
                    | (lam_new > 1e10 * torch.clamp(lam0, min=1e-30)))
        take = active & accept
        T = torch.where(take[:, None, None], T_new, T)
        H = torch.where(take[:, None, None], H_new, H)
        g = torch.where(take[:, None], g_new, g)
        cost = torch.where(take, cost_new, cost)
        lam = torch.where(active, lam_new, lam)
        ni = torch.where(active, ni_new, ni)
        done = done | (active & done_new)
        its = its + active.to(torch.int32)
    _, _, _, chi2 = normal_eqs(T)
    return PoseLMBatch(T=T, chi2=chi2, num_iters=its)


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


_launch_fn = None


def _launch(args, cam: Camera, plan: ClusterPlan, out: PoseLMBatch, *,
            huber_delta: Optional[float] = None, max_iters: int = 100,
            init_lambda: float = 1e-5, gain_tol: float = 1e-9,
            rel_tol: float = 1e-5) -> int:
    """Launches the kernel on the current stream for
    args = (T_init, T_pre, pts3d, obs, valid) with `plan`, writing into
    `out`; returns the launcher's CUDA error (cudaErrorInvalidValue for a
    plan it cannot run), 0 on success."""
    global _launch_fn
    if _launch_fn is None:
        P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
            ctypes.c_longlong
        fn = cuda_build.load("pose_lm").pose_lm_batched_launch
        fn.argtypes = [P, P, P, LL, P, LL, P, P, P, P, P, I, I, I, I, I, I,
                       F, F, F, F, F, F, I, F, F, F, P]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    T_init, T_pre, pts3d, obs, valid = args
    B, N = valid.shape
    dev = T_init.device
    scratch = (torch.empty((plan.scratch_floats,), dtype=torch.float32,
                           device=dev) if plan.scratch_floats else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return _launch_fn(
            T_init.data_ptr(), T_pre.data_ptr(), pts3d.data_ptr(),
            0 if pts3d.ndim == 2 else N * 3, obs.data_ptr(),
            0 if obs.ndim == 2 else N * 2, valid.data_ptr(),
            *(t.data_ptr() for t in out),
            0 if scratch is None else scratch.data_ptr(), B, N,
            plan.cluster, plan.threads, plan.cap, plan.smem_bytes,
            cam.fx, cam.fy, cam.cx, cam.cy,
            -1.0 if huber_delta is None else float(huber_delta),
            # delta^2 rounded to float32 once, as the plain version's
            # Python-number threshold is
            0.0 if huber_delta is None else float(huber_delta) ** 2,
            int(max_iters), init_lambda, gain_tol, rel_tol, stream)


def empty_batch(B: int, N: int, device) -> PoseLMBatch:
    """Uninitialised outputs of B solves over N points, as the kernel
    writes them."""
    return PoseLMBatch(
        T=torch.empty((B, 4, 4), dtype=torch.float32, device=device),
        chi2=torch.empty((B, N), dtype=torch.float32, device=device),
        num_iters=torch.empty((B,), dtype=torch.int32, device=device))


def pose_lm_batched(T_init, T_pre, pts3d, obs, valid, cam: Camera, *,
                    huber_delta: Optional[float] = None,
                    max_iters: int = 100, init_lambda: float = 1e-5,
                    gain_tol: float = 1e-9,
                    rel_tol: float = 1e-5) -> PoseLMBatch:
    """B LM solves. T_init, T_pre (B, 4, 4); pts3d (B, N, 3) or shared
    (N, 3); obs (B, N, 2) or shared (N, 2); valid (B, N) bool."""
    tensors = (T_init, T_pre, pts3d, obs, valid)
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return pose_lm_batched_ref(
            T_init, T_pre, pts3d, obs, valid, cam, huber_delta=huber_delta,
            max_iters=max_iters, init_lambda=init_lambda, gain_tol=gain_tol,
            rel_tol=rel_tol)
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError("pose_lm_batched: all tensors must be on the CPU or "
                         "all on one CUDA device")
    B, N = valid.shape
    _check("T_init", T_init, torch.float32, (B, 4, 4))
    _check("T_pre", T_pre, torch.float32, (B, 4, 4))
    _check("pts3d", pts3d, torch.float32,
           (N, 3) if pts3d.ndim == 2 else (B, N, 3))
    _check("obs", obs, torch.float32, (N, 2) if obs.ndim == 2 else (B, N, 2))
    _check("valid", valid, torch.bool, (B, N))
    out = empty_batch(B, N, T_init.device)
    rc = _launch(tensors, cam, launch_plan(B, N), out,
                 huber_delta=huber_delta, max_iters=max_iters,
                 init_lambda=init_lambda, gain_tol=gain_tol, rel_tol=rel_tol)
    if rc != 0:
        raise RuntimeError(f"pose_lm kernel launch failed: CUDA error {rc}")
    pose_lm_batched.launches += 1
    return out


# kernel launches since the last reset (the wrapper adds one per launch)
pose_lm_batched.launches = 0
