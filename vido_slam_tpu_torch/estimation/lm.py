"""Generic Levenberg-Marquardt engine for small dense problems, and the
robust-kernel weight shared by the solvers — counterpart of
``vido_slam_tpu/estimation/lm.py`` (``lm_solve``, ``_solve_spd``,
``huber_weight``). The inertial initialization runs on it; the per-frame
pose solves run in ``lm_kernel`` and the window BA has its own Schur
solver.

The JAX ``lax.while_loop`` is a host loop here that reads the stop test
each iteration: the problems it serves are tiny and run on the CPU
(``tracking.py`` says why). The iteration is the JAX one: g2o's Levenberg
policy with Marquardt-scaled damping, one linearisation an iteration, the
gain-ratio accept/reject with ``ni`` doubling. ``gn_solve`` and
``dogleg_solve`` are g2o's other two algorithms on the same interface;
nothing in the tracker calls them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.linalg
import scipy.linalg.blas
import torch


class LMResult(NamedTuple):
    x: torch.Tensor          # final parameters (or state, with retract_fn)
    cost: torch.Tensor       # robust cost at x
    chi2: torch.Tensor       # (N,) per-block squared error (unrobustified)
    num_iters: int           # iterations taken
    lam: torch.Tensor        # final damping


def huber_weight(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    """g2o RobustKernelHuber weight rho'(chi2): 1 for chi2 <= delta^2,
    else delta / sqrt(chi2)."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta * delta, torch.ones_like(chi2),
                       delta / torch.sqrt(safe))


def require_cpu(t: torch.Tensor, who: str) -> None:
    """Refuse a tensor off the CPU: the IMU-side math (this engine, the
    inertial init's LAPACK solves) runs on the host by design, on explicit
    ``device="cpu"`` tensors (``tracking.py`` says why), and a card tensor
    here would mean a host round trip every iteration."""
    if t.device.type != "cpu":
        raise ValueError(f"{who} runs on the CPU (the IMU math's device "
                         f"rule); got a tensor on {t.device}")


def cholesky_or_nan(H: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of (a batch of) SPD H; NaN where H is not positive
    definite, as the JAX package's CPU ``cholesky`` gives."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def lu_solve_trsm(lu: np.ndarray, piv: np.ndarray, b: np.ndarray
                  ) -> np.ndarray:
    """x from LAPACK LU factors (getrf's lu, piv) by the row swaps and two
    BLAS trsm, the sequence of the JAX package's CPU ``lu_solve``."""
    perm = np.arange(lu.shape[0])
    for i, p in enumerate(piv):
        perm[i], perm[p] = perm[p], perm[i]
    y = scipy.linalg.blas.strsm(1.0, lu, b[perm][:, None], lower=1, diag=1)
    return scipy.linalg.blas.strsm(1.0, lu, y, lower=0)[:, 0]


def _lapack_cho_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """H x = g as the JAX package's CPU ``_solve_spd`` for P > 8 does, to
    the bit: LAPACK's potrf (through scipy, whose LAPACK JAX's CPU kernels
    call) and two BLAS trsm, the second on the transposed factor. NaN where
    H is not positive definite, as JAX gives."""
    try:
        L = scipy.linalg.cholesky(H.detach().numpy(), lower=True)
    except np.linalg.LinAlgError:
        return torch.full_like(g, float("nan"))
    y = scipy.linalg.blas.strsm(1.0, L, g.detach().numpy()[:, None], lower=1)
    x = scipy.linalg.blas.strsm(1.0, np.ascontiguousarray(L.T), y, lower=0)
    return torch.from_numpy(x[:, 0])


def _solve_spd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g for a small SPD H (P, P). For P <= 8 the Cholesky
    factorisation and both triangular solves are scalar arithmetic in the
    JAX package's order, so they round as it does; above, LAPACK's."""
    n = H.shape[0]
    if n > 8:
        return _lapack_cho_solve(H, g)
    Hs = [list(row.unbind()) for row in H.unbind()]
    gs = list(g.unbind())
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = Hs[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = torch.sqrt(torch.clamp(s, min=1e-20))
        L[j][j] = Ljj
        for i in range(j + 1, n):
            s2 = Hs[i][j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 / Ljj
    y = [None] * n
    for i in range(n):
        s = gs[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def lm_solve(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    *,
    max_iters: int = 100,
    huber_delta: Optional[float] = None,
    init_lambda: float = 1e-5,
    gain_tol: float = 1e-9,
    rel_tol: float = 1e-5,
    jac_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    retract_fn: Optional[Callable] = None,
    tangent_dim: Optional[int] = None,
) -> LMResult:
    """Minimise 0.5 * sum_n w_n * rho(|r_n(x)|^2) over x.

    ``residual_fn``: x (P,) -> residuals (N, d), written with functional
    torch ops (``torch.func.jacfwd`` differentiates it). ``mask`` (N,)
    bool drops blocks; ``weights`` (N,) or (N, d) are information weights;
    ``huber_delta`` robustifies (g2o semantics, threshold on sqrt(chi2));
    ``init_lambda`` is the first damping as a fraction of max diag(H);
    stop on a predicted gain below ``gain_tol`` or an accepted step whose
    relative improvement is below ``rel_tol`` (g2o's terminate action), or
    when the damping explodes. ``jac_fn`` x -> (N, d, P) replaces autodiff
    (``torch.func.jacfwd``). With ``retract_fn`` (x, delta) ->
    x the state may be any tensor (e.g. a (4, 4) pose), ``tangent_dim``
    fixes P, and the chart is re-centred every iteration (g2o's oplus).
    CPU tensors only (``require_cpu``)."""
    x0 = torch.as_tensor(x0)
    require_cpu(x0, "lm_solve")
    if retract_fn is None:
        P = x0.shape[0]
        chart = False

        def retract_fn(x, d):
            return x + d
    else:
        if tangent_dim is None:
            raise ValueError("lm_solve: tangent_dim is required with "
                             "retract_fn")
        P = tangent_dim
        chart = True
    if jac_fn is None:
        if chart:
            def jac_fn(x):
                return torch.func.jacfwd(
                    lambda d: residual_fn(retract_fn(x, d)))(
                        torch.zeros(P, dtype=torch.float32,
                                    device=x0.device))
        else:
            jac_fn = torch.func.jacfwd(residual_fn)

    def block_stats(x):
        r = residual_fn(x)
        if weights is None:
            w_info = torch.ones_like(r)
        else:
            w_info = weights if weights.ndim == r.ndim else weights[..., None]
        chi2 = torch.sum(r * r * w_info, dim=-1)
        if huber_delta is None:
            w_rob = torch.ones_like(chi2)
            rho = chi2
        else:
            w_rob = huber_weight(chi2, huber_delta)
            d2 = huber_delta * huber_delta
            rho = torch.where(
                chi2 <= d2, chi2,
                2.0 * huber_delta * torch.sqrt(torch.clamp(chi2, min=1e-12))
                - d2)
        if mask is not None:
            w_rob = torch.where(mask, w_rob, torch.zeros_like(w_rob))
            rho = torch.where(mask, rho, torch.zeros_like(rho))
        return r, w_info, chi2, w_rob, torch.sum(rho)

    def normal_eqs(x):
        r, w_info, chi2, w_rob, cost = block_stats(x)
        J = jac_fn(x)
        Jw = J * (w_info * w_rob[..., None])[..., None]
        H = torch.einsum("ndp,ndq->pq", Jw, J)
        g = torch.einsum("ndp,nd->p", Jw, r)
        return H, g, cost

    x = x0
    H, g, cost = normal_eqs(x0)
    # an all-masked problem has H == 0; the floor keeps the damping exit
    # reachable
    lam = torch.clamp(init_lambda * torch.max(torch.diagonal(H)), min=1e-30)
    lam_stop = 1e10 * torch.clamp(lam, min=1e-30)
    ni = torch.tensor(2.0, device=lam.device)
    done = bool(cost <= gain_tol)
    it = 0
    while it < max_iters and not done:
        # Marquardt scaling with a floor for null directions
        dH = torch.diagonal(H)
        D = torch.clamp(dH, min=1e-6 * torch.clamp(torch.max(dH), min=1e-12))
        delta = _solve_spd(H + lam * torch.diag(D), -g)
        bad = bool(torch.isnan(delta).any())
        if bad:
            delta = torch.zeros_like(delta)
        x_new = retract_fn(x, delta)
        H_new, g_new, cost_new = normal_eqs(x_new)
        pred = 0.5 * torch.dot(delta, lam * D * delta - g)
        if bool(cost_new < cost) and not bad:
            rho = (cost - cost_new) / torch.clamp(pred, min=1e-20)
            lam = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                    min=1.0 / 3.0)
            ni = torch.tensor(2.0, device=lam.device)
            floor_cost = torch.clamp(cost, min=1e-20)
            done = (bool(pred < gain_tol * floor_cost)
                    or bool(cost - cost_new < rel_tol * floor_cost))
            x, cost, H, g = x_new, cost_new, H_new, g_new
        else:
            lam = lam * ni
            ni = ni * 2.0
        done = done or bool(lam > lam_stop)
        it += 1
    _, _, chi2, _, final_cost = block_stats(x)
    return LMResult(x=x, cost=final_cost, chi2=chi2, num_iters=it, lam=lam)


def gn_solve(residual_fn, x0, mask=None, weights=None, *, max_iters: int = 20,
             huber_delta: Optional[float] = None, rel_tol: float = 1e-6,
             jac_fn=None, retract_fn=None,
             tangent_dim: Optional[int] = None) -> LMResult:
    """Plain Gauss-Newton, g2o's OptimizationAlgorithmGaussNewton:
    undamped normal-equation steps; stop when a step does not improve the
    cost, on a relative improvement below ``rel_tol``, or on NaN.
    ``lm_solve``'s interface; CPU tensors only."""
    return _lm_like(residual_fn, x0, mask, weights, max_iters=max_iters,
                    huber_delta=huber_delta, rel_tol=rel_tol, jac_fn=jac_fn,
                    retract_fn=retract_fn, tangent_dim=tangent_dim,
                    algorithm="gn")


def dogleg_solve(residual_fn, x0, mask=None, weights=None, *,
                 max_iters: int = 50, huber_delta: Optional[float] = None,
                 rel_tol: float = 1e-6, trust_radius: float = 1.0,
                 jac_fn=None, retract_fn=None,
                 tangent_dim: Optional[int] = None) -> LMResult:
    """Powell's Dogleg, g2o's OptimizationAlgorithmDogleg: the Cauchy
    point, the Gauss-Newton step or their blend inside a trust region whose
    radius follows the gain ratio. ``lm_solve``'s interface plus the first
    ``trust_radius``; CPU tensors only. ``LMResult.lam`` is the final
    radius."""
    return _lm_like(residual_fn, x0, mask, weights, max_iters=max_iters,
                    huber_delta=huber_delta, rel_tol=rel_tol, jac_fn=jac_fn,
                    retract_fn=retract_fn, tangent_dim=tangent_dim,
                    algorithm="dogleg", trust_radius=trust_radius)


def _lm_like(residual_fn, x0, mask, weights, *, max_iters, huber_delta,
             rel_tol, jac_fn, retract_fn, tangent_dim, algorithm,
             trust_radius: float = 1.0) -> LMResult:
    """The GN / Dogleg iteration of the JAX package's ``_lm_like``
    (lm.py:316-427) as a host loop. Its cost is sum(chi2 * w_robust), not
    ``lm_solve``'s sum of rho."""
    x0 = torch.as_tensor(x0)
    require_cpu(x0, algorithm + "_solve")
    if retract_fn is None:
        P = x0.shape[0]

        def retract_fn(x, d):
            return x + d
    else:
        if tangent_dim is None:
            raise ValueError(f"{algorithm}_solve: tangent_dim is required "
                             f"with retract_fn")
        P = tangent_dim
    if jac_fn is None:
        def jac_fn(x):
            return torch.func.jacfwd(lambda d: residual_fn(retract_fn(x, d)))(
                torch.zeros(P, dtype=torch.float32))

    def stats(x):
        r = residual_fn(x)
        if weights is None:
            w_info = torch.ones_like(r)
        else:
            w_info = weights if weights.ndim == r.ndim else weights[..., None]
        chi2 = torch.sum(r * r * w_info, dim=-1)
        w_rob = (torch.ones_like(chi2) if huber_delta is None
                 else huber_weight(chi2, huber_delta))
        if mask is not None:
            w_rob = torch.where(mask, w_rob, torch.zeros_like(w_rob))
        return r, w_info, chi2, w_rob, torch.sum(chi2 * w_rob)

    def normal_eqs(x):
        r, w_info, chi2, w_rob, cost = stats(x)
        J = jac_fn(x)
        Jw = J * (w_info * w_rob[..., None])[..., None]
        return (torch.einsum("ndp,ndq->pq", Jw, J),
                torch.einsum("ndp,nd->p", Jw, r), cost)

    H, g, cost = normal_eqs(x0)
    eye = torch.eye(H.shape[0], dtype=H.dtype)
    floor0 = 1e-12 * torch.clamp(torch.max(torch.abs(H)), min=1e-20)

    def step(H, g, radius):
        Hd = H + floor0 * eye
        d_gn = _solve_spd(Hd, -g)
        if algorithm == "gn":
            return d_gn
        gHg = torch.dot(g, Hd @ g)
        alpha = torch.dot(g, g) / torch.clamp(gHg, min=1e-20)
        d_sd = -alpha * g                           # the Cauchy point
        n_gn = torch.linalg.norm(d_gn)
        n_sd = torch.linalg.norm(d_sd)
        diff = d_gn - d_sd
        a = torch.dot(diff, diff)
        b = 2.0 * torch.dot(d_sd, diff)
        c = torch.dot(d_sd, d_sd) - radius * radius
        disc = torch.sqrt(torch.clamp(b * b - 4 * a * c, min=0.0))
        beta = (-b + disc) / torch.clamp(2 * a, min=1e-20)
        d_mix = d_sd + torch.clamp(beta, 0.0, 1.0) * diff
        return torch.where(
            n_gn <= radius, d_gn,
            torch.where(n_sd >= radius,
                        d_sd * (radius / torch.clamp(n_sd, min=1e-20)), d_mix))

    x = x0
    radius = torch.tensor(trust_radius, dtype=torch.float32)
    done = bool(cost <= 1e-20)
    it = 0
    while it < max_iters and not done:
        delta = step(H, g, radius)
        bad = bool(torch.isnan(delta).any())
        if bad:
            delta = torch.zeros_like(delta)
        x_new = retract_fn(x, delta)
        H_new, g_new, cost_new = normal_eqs(x_new)
        accept = bool(cost_new < cost) and not bad
        if algorithm == "dogleg":
            # the model reduction of cost = sum(w r^2): -(2 g.d + d'H d)
            pred = -(2.0 * torch.dot(g, delta) + torch.dot(delta, H @ delta))
            rho = (cost - cost_new) / torch.clamp(pred, min=1e-20)
            if bool(rho > 0.75):
                radius = torch.maximum(radius, 3.0 * torch.linalg.norm(delta))
            elif bool(rho < 0.25):
                radius = radius * 0.5
            done = bool(radius < 1e-12)
        else:
            done = not accept
        if accept:
            done = done or bool(cost - cost_new
                                < rel_tol * torch.clamp(cost, min=1e-20))
            x, cost, H, g = x_new, cost_new, H_new, g_new
        it += 1
    _, _, chi2, _, final_cost = stats(x)
    return LMResult(x=x, cost=final_cost, chi2=chi2, num_iters=it, lam=radius)
