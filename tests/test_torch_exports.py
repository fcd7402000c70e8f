"""What the port adds to complete the JAX package's public surface, each
against its JAX function on the same numpy-seeded inputs:

  - ``estimation/lm.py::gn_solve`` and ``dogleg_solve`` (g2o's GaussNewton
    and Powell's Dogleg) on the problems of tests/test_estimation.py:80-124:
    the solution within 1e-5, the cost within 1e-5 of its size, the same
    iteration count (within one where the residual reaches zero: the step
    that ends the run then compares costs of 1e-12, float32 rounding of a
    zero residual);
  - the single-problem estimators ``estimate_object_motion``,
    ``object_motion_optimization`` and ``estimate_object_motion_joint``
    (B=1 calls of the batched kernels): the bars of
    tests/test_torch_estimation.py and test_torch_flow_joint.py
    (|log(T_a^-1 T_b)| < 1e-4, at most 3 inlier flips, flows within 1e-2);
  - ``geometry/se3.py::adjoint_se3`` within 1e-6, ``Camera.K`` equal,
    ``Camera.distort`` within 1e-6, ``io/synthetic.py::depth_noise``
    bit-equal from one ``RandomState``;
  - the ``estimation`` and ``geometry`` package re-exports: the JAX names.
"""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vido_slam_tpu.estimation as j_estimation
import vido_slam_tpu.geometry as j_geometry
import vido_slam_tpu_torch.estimation as t_estimation
import vido_slam_tpu_torch.geometry as t_geometry
from vido_slam_tpu.estimation import flow_joint as j_fj
from vido_slam_tpu.estimation import lm as j_lm
from vido_slam_tpu.estimation import pose as j_pose
from vido_slam_tpu.geometry import se3 as jse3
from vido_slam_tpu.geometry import so3 as jso3
from vido_slam_tpu.geometry.camera import Camera as JCamera
from vido_slam_tpu.io.synthetic import depth_noise as j_depth_noise
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.estimation import flow_joint, lm, pose
from vido_slam_tpu_torch.geometry.se3 import (adjoint_se3, exp_se3,
                                              inverse_se3, log_se3)
from vido_slam_tpu_torch.io.synthetic import depth_noise
from vido_slam_tpu_torch.utils import prng

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pose_err(Ta, Tb):
    return float(torch.linalg.norm(log_se3(inverse_se3(_t(Ta)) @ _t(Tb))))


def _T(w, t):
    return np.asarray(jse3.make_se3(jso3.exp_so3(jnp.asarray(w, jnp.float32)),
                                    jnp.asarray(t, jnp.float32)))


# ---------------------------------------------------------------------------
# GaussNewton and Dogleg
# ---------------------------------------------------------------------------

def _exp_fit(solver, xs, **kw):
    x = np.linspace(0, 1, 50).astype(np.float32)
    y = (2.0 * np.exp(-1.3 * x) + 0.05 * np.sin(37 * x)).astype(np.float32)
    X, Y = xs(x), xs(y)
    exp = jnp.exp if solver.__module__.startswith("vido_slam_tpu.") \
        else torch.exp
    return solver(lambda p: (p[0] * exp(-p[1] * X) - Y)[:, None],
                  xs(np.array([1.0, 0.0], np.float32)), max_iters=50, **kw)


def _line_fit(solver, xs, **kw):
    x = np.linspace(0, 1, 50).astype(np.float32)
    y = (2.0 * x + 1.0).astype(np.float32)
    y[0] = 100.0
    mask = np.ones(50, bool)
    mask[0] = False
    X, Y = xs(x), xs(y)
    return solver(lambda p: (p[0] * X + p[1] - Y)[:, None],
                  xs(np.zeros(2, np.float32)), mask=xs(mask), max_iters=50,
                  **kw)


SOLVER_CASES = [
    ("gn", _exp_fit, {}), ("dogleg", _exp_fit, {}),
    ("dogleg", _exp_fit, {"trust_radius": 1e-3}),
    ("gn", _line_fit, {}), ("gn", _line_fit, {"huber_delta": 0.5}),
    ("dogleg", _line_fit, {"huber_delta": 0.5}),
]


@pytest.mark.parametrize("algo,problem,kw", SOLVER_CASES,
                         ids=["gn_exp", "dogleg_exp", "dogleg_tiny_radius",
                              "gn_mask", "gn_mask_huber",
                              "dogleg_mask_huber"])
def test_gn_and_dogleg_match_jax(algo, problem, kw):
    jsolve = getattr(j_lm, f"{algo}_solve")
    tsolve = getattr(lm, f"{algo}_solve")
    want = problem(jsolve, jnp.asarray, **kw)
    got = problem(tsolve, torch.from_numpy, **kw)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-5,
                               rtol=0)
    assert abs(float(got.cost) - float(want.cost)) \
        <= 1e-5 * max(1.0, float(want.cost))
    if float(want.cost) > 1e-10:
        assert got.num_iters == int(want.num_iters)
    else:
        assert abs(got.num_iters - int(want.num_iters)) <= 1
    np.testing.assert_allclose(float(got.lam), float(want.lam), rtol=1e-5)
    np.testing.assert_allclose(got.chi2.numpy(), np.asarray(want.chi2),
                               atol=1e-5, rtol=1e-4)


def test_gn_and_dogleg_reach_the_lm_optimum():
    r_lm = _exp_fit(lm.lm_solve, torch.from_numpy)
    for solver in (lm.gn_solve, lm.dogleg_solve):
        r = _exp_fit(solver, torch.from_numpy)
        np.testing.assert_allclose(r.x.numpy(), r_lm.x.numpy(), atol=1e-3)


def test_gn_and_dogleg_refuse_tensors_off_the_cpu():
    x0 = torch.zeros(2, device="meta")
    for solver in (lm.gn_solve, lm.dogleg_solve):
        with pytest.raises(ValueError, match="CPU"):
            solver(lambda p: p[:, None], x0)


# ---------------------------------------------------------------------------
# single-problem object estimators
# ---------------------------------------------------------------------------

def _object_scene(seed, n=400, noise=0.2):
    """One object's points (5-40 m), seen after the object moved by H with
    the camera at Tcw; ``noise`` px of noise and 8 % of +30 px outliers."""
    jcam = JCamera.create(fx=408.2, fy=408.7, cx=304.1, cy=133.3, width=640,
                          height=192, bf=193.8)
    rng = np.random.RandomState(seed)
    uv = np.stack([rng.uniform(30, 610, n), rng.uniform(20, 172, n)], -1)
    z = rng.uniform(5.0, 40.0, n)
    pts = np.asarray(jcam.backproject(jnp.asarray(uv, jnp.float32),
                                      jnp.asarray(z, jnp.float32)))
    Tcw = _T([0.0, 0.02, 0.0], [0.1, 0.0, 0.2])
    H = _T([0.0, 0.01, 0.0], [0.5, 0.0, 0.3])
    pc = np.asarray(jse3.transform_points(jnp.asarray(Tcw @ H),
                                          jnp.asarray(pts)))
    obs = np.asarray(jcam.project(jnp.asarray(pc))) + noise * rng.randn(n, 2)
    obs[rng.rand(n) < 0.08] += 30.0
    valid = rng.rand(n) < 0.9
    return (jcam, convert.camera_from_numpy(jcam), pts,
            uv.astype(np.float32), obs.astype(np.float32), valid, Tcw, H, pc)


@pytest.mark.parametrize("has_mm", [True, False])
def test_estimate_object_motion_matches_jax(has_mm):
    """At the 0.03 px noise of tests/test_torch_estimation.py: at 0.2 px the
    LM stops on a flat cost, and the JAX package's own jitted estimator and
    its ``object_motion_optimization`` from the same start part by 1.3e-3
    (the port stays within 4e-5 of the latter there)."""
    jcam, cam, pts, _, obs, valid, Tcw, H, pc = _object_scene(3, noise=0.03)
    H_mm = _T([0.0, 0.0, 0.0], [0.45, 0.0, 0.28])
    je = j_pose.estimate_object_motion(
        jax.random.PRNGKey(4), jnp.asarray(Tcw), jnp.asarray(pts),
        jnp.asarray(obs), jnp.asarray(valid), jcam, jnp.asarray(H_mm),
        jnp.asarray(has_mm), jnp.asarray(pc))
    te = pose.estimate_object_motion(
        prng.PRNGKey(4), _t(Tcw), _t(pts), _t(obs), _t(valid), cam,
        _t(H_mm), has_mm, _t(pc))
    assert _pose_err(je.T, te.T) < 1e-4
    assert _pose_err(H, te.T) < 1e-2
    assert int(np.sum(te.inliers.numpy() != np.asarray(je.inliers))) <= 3
    assert int(te.num_inliers) == int(te.inliers.sum()) > 250
    both = te.inliers.numpy() & np.asarray(je.inliers)
    np.testing.assert_allclose(te.chi2.numpy()[both],
                               np.asarray(je.chi2)[both], atol=1e-4)


def test_object_motion_optimization_matches_jax():
    jcam, cam, pts, _, obs, valid, Tcw, H, _ = _object_scene(5)
    H0 = _T([0.0, 0.0, 0.0], [0.45, 0.0, 0.28])
    inl = valid & (np.abs(obs - np.asarray(jcam.project(jse3.transform_points(
        jnp.asarray(Tcw @ H), jnp.asarray(pts))))).max(-1) < 5)
    je = j_pose.object_motion_optimization(
        jnp.asarray(H0), jnp.asarray(Tcw), jnp.asarray(pts),
        jnp.asarray(obs), jnp.asarray(inl), jcam)
    te = pose.object_motion_optimization(_t(H0), _t(Tcw), _t(pts), _t(obs),
                                         _t(inl), cam)
    assert _pose_err(je.T, te.T) < 1e-4
    assert int(np.sum(te.inliers.numpy() != np.asarray(je.inliers))) <= 3


@pytest.mark.parametrize("has_mm", [True, False])
def test_estimate_object_motion_joint_matches_jax(has_mm):
    jcam, cam, pts, obs_last, cur_uv, valid, Tcw, H, pc = _object_scene(6)
    # the joint solve's world is the last camera frame: obs_last are the
    # points' own pixels, cur_uv their flow-propagated positions
    obs_last = np.asarray(jcam.project(jnp.asarray(pts)))
    H_mm = _T([0.0, 0.0, 0.0], [0.45, 0.0, 0.28])
    je, jflow = j_fj.estimate_object_motion_joint(
        jax.random.PRNGKey(8), jnp.asarray(Tcw), jnp.asarray(pts),
        jnp.asarray(obs_last), jnp.asarray(cur_uv), jnp.asarray(valid),
        jcam, jnp.asarray(H_mm), jnp.asarray(has_mm), jnp.asarray(pc))
    te, tflow = flow_joint.estimate_object_motion_joint(
        prng.PRNGKey(8), _t(Tcw), _t(pts), _t(obs_last), _t(cur_uv),
        _t(valid), cam, _t(H_mm), has_mm, _t(pc))
    assert _pose_err(je.T, te.T) < 1e-4
    assert _pose_err(H, te.T) < 1e-2
    jinl = np.asarray(je.inliers)
    assert int(np.sum(te.inliers.numpy() != jinl)) <= 3
    assert int(te.num_inliers) > 250
    both = te.inliers.numpy() & jinl
    assert float(np.abs(tflow.numpy() - np.asarray(jflow))[both].max()) \
        < 1e-2


# ---------------------------------------------------------------------------
# geometry, camera, synthetic
# ---------------------------------------------------------------------------

def test_adjoint_se3_matches_jax():
    rng = np.random.RandomState(9)
    T = np.stack([_T(rng.randn(3) * 0.5, rng.randn(3)) for _ in range(5)])
    want = np.asarray(jse3.adjoint_se3(jnp.asarray(T)))
    got = adjoint_se3(_t(T))
    assert got.shape == (5, 6, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # exp(Ad(T) xi) = T exp(xi) T^-1
    xi = _t(rng.randn(5, 6).astype(np.float32) * 0.1)
    lhs = exp_se3((got @ xi[..., None])[..., 0])
    rhs = _t(T) @ exp_se3(xi) @ inverse_se3(_t(T))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-5)


def test_camera_k_and_distort_match_jax():
    dist = [0.12, -0.05, 0.001, -0.002, 0.01]
    jcam = JCamera.create(fx=816.402, fy=817.38, cx=608.2658, cy=266.688,
                          dist=np.asarray(dist), width=1280, height=560,
                          bf=387.57)
    cam = convert.camera_from_numpy(jcam)
    assert cam.K.dtype == torch.float32
    np.testing.assert_array_equal(cam.K.numpy(), np.asarray(jcam.K))
    xy = np.random.RandomState(10).uniform(-0.8, 0.8, (7, 3, 2)).astype(
        np.float32)
    np.testing.assert_allclose(cam.distort(_t(xy)).numpy(),
                               np.asarray(jcam.distort(jnp.asarray(xy))),
                               atol=1e-6, rtol=0)


def test_depth_noise_equals_jax():
    z = np.random.RandomState(11).uniform(1, 40, (16, 24)).astype(np.float32)
    got = depth_noise(np.random.RandomState(12), z)
    want = j_depth_noise(np.random.RandomState(12), z)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("port,jax_pkg", [
    (t_estimation, j_estimation), (t_geometry, j_geometry)],
    ids=["estimation", "geometry"])
def test_package_exports_are_the_jax_names(port, jax_pkg):
    """The names the JAX package's ``__init__.py`` imports, read from its
    source (a package's attributes also hold whatever submodules other
    code imported before)."""
    def exported(pkg):
        with open(pkg.__file__) as f:
            tree = ast.parse(f.read())
        return {a.asname or a.name for node in tree.body
                if isinstance(node, ast.ImportFrom) for a in node.names}
    want = exported(jax_pkg)
    assert want and want == exported(port)
    for name in want:
        assert callable(getattr(port, name)) or hasattr(
            getattr(port, name), "__file__"), name
