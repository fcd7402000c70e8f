"""The port's generic LM engine (``estimation/lm.py::lm_solve``) and inertial
initialization (``estimation/imu_init.py``) against the JAX package's, on
the CPU with the same numpy-seeded inputs.

Tolerances: ``lm_solve`` takes the same number of iterations as JAX's and
lands within 1e-5 of its x on small problems (linear, Huber with a mask,
weighted, a 12-parameter Cholesky solve, the caller's analytic
``jac_fn``, and SE(3) with ``retract_fn``; the last two at a rel_tol that
stops them on a step above the float32 noise of their cost, where at the
default their last step moves the cost by that noise only and the two
packages' accept decisions part). Each init stage, and ``initialize_imu`` on
tests/test_imu.py's ``TestInertialInit`` problems (with and without gyro
bias, and two whose stage-B scale is rejected): the scale within 1e-4
relative, ``Rwg`` within 1e-4 rad, the biases within 1e-5, velocities
within 1e-4. One bar is wider, at what the JAX package's own float32
arithmetic decides: the scale of the problem rejected after stage A, within
1e-3 relative. Stage B's normal equations have condition ~1e7; the port
solves them with JAX's LAPACK calls to the bit, but forms A^T b with
another summation order than XLA's (a few ulp apart), and stage A's gyro
bias differs in its last bits, which moves that float32 scale by ~7e-4. The
decision (rejected, below 0.1) is the same."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_imu import make_vio_problem, stack_pre
from vido_slam_tpu.estimation import imu_init as J
from vido_slam_tpu.estimation.lm import lm_solve as j_lm_solve
from vido_slam_tpu.geometry.se3 import exp_se3 as j_exp_se3
from vido_slam_tpu_torch.estimation import imu_init as T
from vido_slam_tpu_torch.estimation.lm import lm_solve
from vido_slam_tpu_torch.geometry.se3 import exp_se3

torch.set_num_threads(1)


def _rot_angle(Ra, Rb) -> float:
    """The angle of Ra^T Rb, from its skew part (accurate near 0)."""
    R = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(w))))


# ---------------------------------------------------------------------------
# lm_solve
# ---------------------------------------------------------------------------

def _linear(rng, P, N, d):
    A = rng.normal(size=(N, d, P)).astype(np.float32)
    x_true = rng.normal(size=P).astype(np.float32)
    b = (np.einsum("ndp,p->nd", A, x_true)
         + 0.01 * rng.normal(size=(N, d))).astype(np.float32)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    return (lambda x: (At @ x) - bt, lambda x: (Aj @ x) - bj,
            np.zeros(P, np.float32), A)


def _line_fit(rng):
    """A line through 40 points, 6 of them gross outliers."""
    t = np.linspace(-2.0, 2.0, 40).astype(np.float32)
    y = (0.7 * t - 0.3 + 0.02 * rng.normal(size=40)).astype(np.float32)
    y[::7] += 3.0
    tt, yt = torch.from_numpy(t), torch.from_numpy(y)
    tj, yj = jnp.asarray(t), jnp.asarray(y)
    return (lambda x: (yt - (x[0] + x[1] * tt))[:, None],
            lambda x: (yj - (x[0] + x[1] * tj))[:, None],
            np.zeros(2, np.float32))


def _problem(name, rng):
    """(torch residual, JAX residual, x0, lm_solve keyword arguments as
    numpy arrays or plain values; a "jac_fn" array is the constant
    Jacobian)."""
    if name == "linear":
        return (*_linear(rng, 3, 10, 2)[:3], {})
    if name == "linear P=12 (Cholesky)":
        return (*_linear(rng, 12, 30, 3)[:3], {})
    if name == "linear, analytic jac_fn":
        f_t, f_j, x0, A = _linear(rng, 4, 6, 2)
        # stop on the second step, which still gains 1.2 %: the third
        # moves the cost by its float32 noise (1e-5 of it: the residuals
        # cancel to 1 % of their terms), where JAX accepts and the port not
        return f_t, f_j, x0, {"jac_fn": A, "rel_tol": 2e-2}
    if name == "huber with mask":
        mask = np.ones(40, bool)
        mask[5:9] = False
        return (*_line_fit(rng), {"huber_delta": 0.1, "mask": mask})
    if name == "weighted (N,)":
        w = rng.uniform(0.5, 4.0, 40).astype(np.float32)
        return (*_line_fit(rng), {"weights": w})
    if name == "weighted (N, d)":
        w = rng.uniform(0.5, 4.0, (10, 2)).astype(np.float32)
        return (*_linear(rng, 3, 10, 2)[:3], {"weights": w})
    raise KeyError(name)


def _to(kw, conv):
    out = {k: conv(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    if "jac_fn" in out:
        J = out["jac_fn"]
        out["jac_fn"] = lambda x: J
    return out


@pytest.mark.parametrize("name", [
    "linear", "linear P=12 (Cholesky)", "linear, analytic jac_fn",
    "huber with mask",
    "weighted (N,)", "weighted (N, d)"])
def test_lm_solve_matches_jax(name):
    rng = np.random.RandomState(7)
    f_t, f_j, x0, kw = _problem(name, rng)
    rj = j_lm_solve(f_j, jnp.asarray(x0), **_to(kw, jnp.asarray))
    rt = lm_solve(f_t, torch.from_numpy(x0), **_to(kw, torch.from_numpy))
    assert rt.num_iters == int(rj.num_iters) > 0
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-5)
    np.testing.assert_allclose(rt.chi2.numpy(), np.asarray(rj.chi2),
                               rtol=1e-4, atol=1e-6)
    assert float(rt.cost) == pytest.approx(float(rj.cost), rel=1e-4,
                                           abs=1e-7)


def test_lm_solve_retract_se3_matches_jax():
    """A (4, 4) pose aligning 30 points, stepped by Exp(delta) T (g2o's
    oplus), with a Huber kernel. rel_tol 1e-3 (the reference window BA's,
    Optimizer.cc:182-184) stops on a step well above the float32 floor of
    the cost: at the default 1e-5 the fourth step improves the cost by
    about an ulp, which JAX's reduction order accepts and the port's
    rejects, and only the iteration counts part."""
    rng = np.random.RandomState(3)
    p = rng.uniform(-2.0, 2.0, (30, 3)).astype(np.float32)
    xi = np.array([0.1, -0.2, 0.05, 0.3, -0.1, 0.2], np.float32)
    T_true = np.asarray(j_exp_se3(jnp.asarray(xi)))
    q = (p @ T_true[:3, :3].T + T_true[:3, 3]
         + 0.005 * rng.normal(size=(30, 3))).astype(np.float32)
    pt, qt = torch.from_numpy(p), torch.from_numpy(q)
    pj, qj = jnp.asarray(p), jnp.asarray(q)

    def res_t(T):
        return pt @ T[:3, :3].T + T[:3, 3] - qt

    def res_j(T):
        return pj @ T[:3, :3].T + T[:3, 3] - qj

    kw = dict(huber_delta=0.05, tangent_dim=6, rel_tol=1e-3)
    rj = j_lm_solve(res_j, jnp.eye(4), retract_fn=lambda T, d:
                    j_exp_se3(d) @ T, **kw)
    rt = lm_solve(res_t, torch.eye(4), retract_fn=lambda T, d:
                  exp_se3(d[None])[0] @ T, **kw)
    assert rt.num_iters == int(rj.num_iters) > 0
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-5)


def test_lm_solve_all_masked_stops_at_once():
    f_t, f_j, x0, _ = _problem("linear", np.random.RandomState(1))
    mask = np.zeros(10, bool)
    rj = j_lm_solve(f_j, jnp.asarray(x0), mask=jnp.asarray(mask))
    rt = lm_solve(f_t, torch.from_numpy(x0), mask=torch.from_numpy(mask))
    assert rt.num_iters == int(rj.num_iters) == 0
    np.testing.assert_array_equal(rt.x.numpy(), x0)


def _off_cpu_calls(device):
    """lm_solve and linear_alignment on tensors on ``device``."""
    _, a = _arrays(ACCEPTED[0])
    names = ("Rwb", "twb", "dts", "dV", "dP", "pair_valid")

    def on(x):
        return torch.from_numpy(np.array(x)).to(device)
    return {
        "lm_solve": lambda: lm_solve(lambda x: x[:, None] * 2.0,
                                     torch.zeros(3, device=device)),
        "linear_alignment": lambda: T.linear_alignment(
            *_args(a, names, on), torch.eye(3, device=device)),
    }


@pytest.mark.parametrize("which", ["lm_solve", "linear_alignment"])
def test_off_cpu_tensors_are_refused(which):
    """The IMU math runs on the CPU by its device rule; a tensor elsewhere
    raises instead of being copied to the host and back every iteration
    (``meta`` tensors stand in for the card's here; on the card,
    tests/test_torch_vio_gpu.py)."""
    with pytest.raises(ValueError, match="CPU"):
        _off_cpu_calls("meta")[which]()


# ---------------------------------------------------------------------------
# the init stages on tests/test_imu.py's problems
# ---------------------------------------------------------------------------

ACCEPTED = [dict(), dict(with_bias=True)]
ACCEPTED_IDS = ["no bias", "gyro bias"]


def _arrays(kw):
    prob = make_vio_problem(**kw)
    pp = {k: np.asarray(v) for k, v in stack_pre(prob["pre"]).items()}
    return kw, dict(Rwb=np.asarray(prob["Rwb"]), twb=np.asarray(prob["twb"]),
                    pair_valid=np.ones(len(prob["pre"]), bool), **pp)


@pytest.fixture(scope="module", params=ACCEPTED + [
    dict(scale_gt=0.05), dict(scale_gt=0.09)], ids=ACCEPTED_IDS + [
        "rejected at the gate", "rejected after stage A"])
def problem(request):
    return _arrays(request.param)


@pytest.fixture(scope="module", params=ACCEPTED, ids=ACCEPTED_IDS)
def accepted_problem(request):
    return _arrays(request.param)


def _args(arrays, names, conv):
    return [conv(np.array(arrays[n])) for n in names]


def test_gravity_direction_matches_jax(problem):
    _, a = problem
    names = ("Rwb", "dV", "pair_valid")
    Rj = J.estimate_gravity_direction(*_args(a, names, jnp.asarray))
    Rt = T.estimate_gravity_direction(*_args(a, names, torch.from_numpy))
    assert _rot_angle(Rj, Rt.numpy()) <= 1e-4


def test_gyro_bias_matches_jax(problem):
    _, a = problem
    names = ("Rwb", "dR", "JRg", "pair_valid")
    bj = J.estimate_gyro_bias(*_args(a, names, jnp.asarray))
    bt = T.estimate_gyro_bias(*_args(a, names, torch.from_numpy))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-5)


def test_linear_alignment_matches_jax(problem):
    _, a = problem
    names = ("Rwb", "twb", "dts", "dV", "dP", "pair_valid")
    Rj0 = J.estimate_gravity_direction(*_args(
        a, ("Rwb", "dV", "pair_valid"), jnp.asarray))
    Uj, sj, Rj, _ = J.linear_alignment(*_args(a, names, jnp.asarray), Rj0)
    Ut, st, Rt, _ = T.linear_alignment(
        *_args(a, names, torch.from_numpy),
        torch.from_numpy(np.array(Rj0)))
    assert float(st) == pytest.approx(float(sj), rel=1e-4)
    assert _rot_angle(Rj, Rt.numpy()) <= 1e-4
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj),
                               atol=1e-4 * max(1.0, np.abs(Uj).max()))


def test_inertial_optimization_matches_jax(accepted_problem):
    """Stage C alone from the same cold start (finite-difference
    velocities, unit scale, the true gravity)."""
    _, a = accepted_problem
    names = ("Rwb", "twb", "dts", "dR", "dV", "dP", "JRg", "JVg", "JVa",
             "JPg", "JPa", "C9", "pair_valid")
    Rwg0 = np.asarray(make_vio_problem()["Rwg_gt"], np.float32)
    n = a["Rwb"].shape[0]
    rj = J.inertial_optimization(*_args(a, names, jnp.asarray),
                                 jnp.asarray(Rwg0), max_iters=100)
    rt = T.inertial_optimization(*_args(a, names, torch.from_numpy),
                                 torch.from_numpy(Rwg0), max_iters=100)
    assert rt.velocities.shape == (n, 3)
    assert float(rt.scale) == pytest.approx(float(rj.scale), rel=1e-4)
    assert _rot_angle(rj.Rwg, rt.Rwg.numpy()) <= 1e-4
    np.testing.assert_allclose(rt.bg.numpy(), np.asarray(rj.bg), atol=1e-5)
    np.testing.assert_allclose(rt.ba.numpy(), np.asarray(rj.ba), atol=1e-5)
    np.testing.assert_allclose(rt.velocities.numpy(),
                               np.asarray(rj.velocities), atol=1e-4)


def test_initialize_imu_matches_jax(problem):
    kw, a = problem
    names = ("Rwb", "twb", "dts", "dR", "dV", "dP", "JRg", "JVg", "JVa",
             "JPg", "JPa", "C9")
    rj = jax.device_get(J.initialize_imu(
        *_args(a, names, jnp.asarray),
        pair_valid=jnp.asarray(a["pair_valid"])))
    rt = T.initialize_imu(*_args(a, names, torch.from_numpy),
                          pair_valid=torch.from_numpy(a["pair_valid"]))
    rejected = "scale_gt" in kw
    after_a = kw.get("scale_gt") == 0.09
    assert float(rt.scale) == pytest.approx(float(rj.scale),
                                            rel=1e-3 if after_a else 1e-4)
    assert _rot_angle(rj.Rwg, rt.Rwg.numpy()) <= 1e-4
    np.testing.assert_allclose(rt.bg.numpy(), np.asarray(rj.bg), atol=1e-5)
    np.testing.assert_allclose(rt.ba.numpy(), np.asarray(rj.ba), atol=1e-5)
    np.testing.assert_allclose(rt.velocities.numpy(),
                               np.asarray(rj.velocities), atol=1e-4)
    assert (float(rt.scale) < 0.1) == rejected
    assert (rt.num_iters == 0) == (int(rj.num_iters) == 0) == rejected
    assert np.isinf(float(rt.cost)) == rejected
