"""Estimation of the PyTorch port against the JAX package: RANSAC with the
same key, the plain LM (``pose_lm_batched_ref``) against the Pallas kernel
in interpret mode and against the ``lm_solve`` path, the pose estimators,
and the window BA. Scenes and bars follow tests/test_estimation.py:230-309
(|log(T_a^-1 T_b)| < 1e-4, chi2 within 1e-4, <= 3 inlier flips)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.estimation import pose as j_pose
from vido_slam_tpu.estimation.lm_pallas import pose_lm_batched_pallas
from vido_slam_tpu.estimation.ransac import _dlt_pose as j_dlt_pose
from vido_slam_tpu.estimation.ransac import pnp_ransac as j_ransac
from vido_slam_tpu.estimation import window_ba as j_window_ba
from vido_slam_tpu.estimation.window_ba import solve_window_ba as j_wba
from vido_slam_tpu.geometry import se3 as jse3
from vido_slam_tpu.geometry import so3 as jso3
from vido_slam_tpu.geometry.camera import Camera as JCamera
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.estimation import lm_kernel, pose, ransac
from vido_slam_tpu_torch.estimation import window_ba
from vido_slam_tpu_torch.estimation.window_ba import solve_window_ba
from vido_slam_tpu_torch.geometry.se3 import inverse_se3, log_se3
from vido_slam_tpu_torch.utils import prng

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pose_err(Ta, Tb):
    return float(torch.linalg.norm(log_se3(inverse_se3(_t(Ta)) @ _t(Tb))))


def _scene(seed, n):
    """Random points seen from the identity camera (numpy-seeded)."""
    jcam = JCamera.create(fx=408.2, fy=408.7, cx=304.1, cy=133.3, width=640,
                          height=192, bf=193.8)
    rng = np.random.RandomState(seed)
    uv = np.stack([rng.uniform(30, 610, n), rng.uniform(20, 172, n)], -1)
    z = rng.uniform(5.0, 40.0, n)
    pts = np.asarray(jcam.backproject(jnp.asarray(uv, jnp.float32),
                                      jnp.asarray(z, jnp.float32)))
    return jcam, convert.camera_from_numpy(jcam), pts, rng


def _T(w, t):
    return np.asarray(jse3.make_se3(jso3.exp_so3(jnp.asarray(w, jnp.float32)),
                                    jnp.asarray(t, jnp.float32)))


def _project(jcam, T, pts):
    return np.asarray(jcam.project(jse3.transform_points(jnp.asarray(T),
                                                         jnp.asarray(pts))))


def test_lm_ref_camera_matches_pallas_and_lm_solve():
    jcam, cam, pts, rng = _scene(0, 400)
    T_true = _T([0.01, 0.03, -0.02], [0.3, -0.1, 0.5])
    obs = (_project(jcam, T_true, pts)
           + 0.05 * rng.randn(400, 2)).astype(np.float32)
    obs[::25] += 4.0  # outliers for the Huber kernel
    valid = rng.rand(400) < 0.95
    T0 = _T([0.0, 0.02, 0.0], [0.25, 0.0, 0.45])
    pal = pose_lm_batched_pallas(
        jnp.asarray(T0)[None], jnp.eye(4)[None], jnp.asarray(pts)[None],
        jnp.asarray(obs)[None], jnp.asarray(valid)[None], jcam,
        huber_delta=j_pose.HUBER_DELTA_POSE, max_iters=100, interpret=True)
    xla = j_pose.pose_optimization(jnp.asarray(T0), jnp.asarray(pts),
                                   jnp.asarray(obs), jnp.asarray(valid), jcam)
    ref = lm_kernel.pose_lm_batched_ref(
        _t(T0)[None], torch.eye(4)[None], _t(pts), _t(obs), _t(valid)[None],
        cam, huber_delta=pose.HUBER_DELTA_POSE, max_iters=100)
    for T_other, chi2_other in ((pal.T[0], pal.chi2[0]), (xla.T, xla.chi2)):
        assert _pose_err(T_other, ref.T[0]) < 1e-4
        # rtol for the outliers' chi2 (~30 px^2, float32 rounding ~1e-5)
        np.testing.assert_allclose(ref.chi2[0].numpy(), np.asarray(chi2_other),
                                   atol=1e-4, rtol=1e-4)
    # the wrapper on CPU tensors is the plain version
    est = pose.pose_optimization(_t(T0), _t(pts), _t(obs), _t(valid), cam)
    np.testing.assert_array_equal(est.T.numpy(), ref.T[0].numpy())


def test_lm_ref_object_batch_matches_pallas_and_lm_solve():
    jcam, cam, pts, rng = _scene(2, 300)
    Tcw = _T([0.0, 0.05, 0.0], [0.1, 0.0, 0.3])
    K = 3
    obss, valids, H0s = [], [], []
    for b in range(K):
        H_true = _T([0.0, 0.01 * b, 0.0], [0.4 + 0.1 * b, 0.0, -0.2])
        o = _project(jcam, Tcw @ H_true, pts) + 0.03 * rng.randn(300, 2)
        obss.append(o.astype(np.float32))
        valids.append(np.arange(300) % (b + 2) != 0)
        H0s.append(_T([0.0, 0.0, 0.0], [0.35 + 0.1 * b, 0.0, -0.15]))
    obss, valids, H0s = np.stack(obss), np.stack(valids), np.stack(H0s)
    pal = pose_lm_batched_pallas(
        jnp.asarray(H0s), jnp.broadcast_to(jnp.asarray(Tcw), (K, 4, 4)),
        jnp.asarray(pts), jnp.asarray(obss), jnp.asarray(valids), jcam,
        huber_delta=None, max_iters=100, interpret=True)
    ref = lm_kernel.pose_lm_batched_ref(
        _t(H0s), _t(Tcw).expand(K, 4, 4), _t(pts), _t(obss), _t(valids), cam,
        huber_delta=None, max_iters=100)
    for b in range(K):
        xla = j_pose.object_motion_optimization(
            jnp.asarray(H0s[b]), jnp.asarray(Tcw), jnp.asarray(pts),
            jnp.asarray(obss[b]), jnp.asarray(valids[b]), jcam)
        ref_inl = (ref.chi2[b] <= pose.RP_THRES).numpy() & valids[b]
        for T_other, inl_other in (
                (pal.T[b], (np.asarray(pal.chi2[b]) <= pose.RP_THRES)
                 & valids[b]),
                (xla.T, np.asarray(xla.inliers))):
            assert _pose_err(T_other, ref.T[b]) < 1e-4, b
            assert int(np.sum(ref_inl != inl_other)) <= 3, b
        np.testing.assert_allclose(ref.chi2[b].numpy(),
                                   np.asarray(pal.chi2[b]), atol=1e-4)


def test_lm_ref_object_batch_main_path_layout_matches_pallas():
    """The layout estimate_object_motions_batched passes: one observation
    array shared by all objects, each object's points picked out by a
    disjoint mask (and one object with no points)."""
    jcam, cam, pts, rng = _scene(4, 300)
    Tcw = _T([0.0, 0.05, 0.0], [0.1, 0.0, 0.3])
    K = 4
    owner = rng.randint(-1, K - 1, 300)
    obs = np.zeros((300, 2), np.float32)
    H0s = []
    for b in range(K):
        H_true = _T([0.0, 0.01 * b, 0.0], [0.4 - 0.1 * b, 0.0, -0.2])
        o = _project(jcam, Tcw @ H_true, pts)
        obs[owner == b] = o[owner == b]
        H0s.append(_T([0.0, 0.0, 0.0], [0.35 - 0.1 * b, 0.0, -0.15]))
    obs = (obs + 0.03 * rng.randn(300, 2)).astype(np.float32)
    valids = np.stack([owner == b for b in range(K)])
    H0s = np.stack(H0s)
    pal = pose_lm_batched_pallas(
        jnp.asarray(H0s), jnp.broadcast_to(jnp.asarray(Tcw), (K, 4, 4)),
        jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(valids), jcam,
        huber_delta=None, max_iters=100, interpret=True)
    ref = lm_kernel.pose_lm_batched_ref(
        _t(H0s), _t(Tcw).expand(K, 4, 4), _t(pts), _t(obs), _t(valids), cam,
        huber_delta=None, max_iters=100)
    assert int(ref.num_iters[K - 1]) == 0
    for b in range(K):
        assert _pose_err(pal.T[b], ref.T[b]) < 1e-4, b
        ref_inl = (ref.chi2[b] <= pose.RP_THRES).numpy() & valids[b]
        pal_inl = (np.asarray(pal.chi2[b]) <= pose.RP_THRES) & valids[b]
        assert int(np.sum(ref_inl != pal_inl)) <= 3, b
        np.testing.assert_allclose(ref.chi2[b].numpy()[valids[b]],
                                   np.asarray(pal.chi2[b])[valids[b]],
                                   atol=1e-4)


def test_lm_ref_degenerate_problems_stop():
    """An all-invalid problem (cost 0) stops at once; the others still
    converge in the same batch."""
    jcam, cam, pts, rng = _scene(3, 200)
    obs = _project(jcam, np.eye(4, dtype=np.float32), pts).astype(np.float32)
    valid = np.ones((2, 200), bool)
    valid[1] = False
    T0 = np.stack([_T([0.0, 0.01, 0.0], [0.1, 0.0, 0.0])] * 2)
    ref = lm_kernel.pose_lm_batched_ref(
        _t(T0), torch.eye(4).expand(2, 4, 4), _t(pts), _t(obs), _t(valid),
        cam, max_iters=100)
    assert int(ref.num_iters[1]) == 0
    np.testing.assert_array_equal(ref.T[1].numpy(), T0[1])
    assert _pose_err(np.eye(4, dtype=np.float32), ref.T[0]) < 1e-4


@pytest.mark.parametrize("n,use_pc", [(600, True), (150, True), (80, False)])
def test_pnp_ransac_same_key(n, use_pc):
    """Same key -> the same samples; the winning hypothesis and its inliers
    agree (150 points need several sort tiles; without camera-frame points
    the DLT solver runs)."""
    jcam, cam, pts, rng = _scene(4, n)
    T_true = _T([0.01, -0.02, 0.01], [0.2, 0.05, 0.6])
    obs = (_project(jcam, T_true, pts)
           + 0.05 * rng.randn(n, 2)).astype(np.float32)
    obs[: n // 5] += rng.uniform(3, 30, (n // 5, 2)).astype(np.float32)
    valid = rng.rand(n) < 0.9
    pc = np.asarray(jse3.transform_points(jnp.asarray(T_true),
                                          jnp.asarray(pts)))
    kj = jax.random.PRNGKey(5)
    jr = j_ransac(kj, jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(valid),
                  jcam, jnp.asarray(pc) if use_pc else None,
                  num_hypotheses=100)
    tr = ransac.pnp_ransac(prng.PRNGKey(5)[None], _t(pts), _t(obs),
                           _t(valid)[None], cam, _t(pc) if use_pc else None,
                           num_hypotheses=100)
    assert abs(int(tr.num_inliers[0]) - int(jr.num_inliers)) <= 1
    assert int(np.sum(tr.inliers[0].numpy() != np.asarray(jr.inliers))) <= 1
    # the DLT hypotheses: JAX's float32 eigensolve lands ~1e-3 off (see
    # test_dlt_pose)
    np.testing.assert_allclose(tr.T[0].numpy(), np.asarray(jr.T),
                               atol=1e-3 if use_pc else 5e-3)


def test_dlt_pose():
    jcam, _, pts, rng = _scene(6, 8)
    T_true = _T([0.02, -0.01, 0.03], [0.1, 0.2, 0.5])
    pc = np.asarray(jse3.transform_points(jnp.asarray(T_true),
                                          jnp.asarray(pts)))
    xn = (pc[:, :2] / pc[:, 2:]).astype(np.float32)
    T = ransac._dlt_pose(_t(pts)[None], _t(xn)[None])[0]
    # the JAX float32 DLT itself lands ~1e-3 from the truth here
    np.testing.assert_allclose(
        T.numpy(), np.asarray(j_dlt_pose(jnp.asarray(pts), jnp.asarray(xn))),
        atol=3e-3)
    np.testing.assert_allclose(T.numpy(), T_true, atol=1e-4)


def test_estimators_match_jax():
    """estimate_camera_pose / estimate_object_motions_batched against the
    JAX estimators (lm_solve path) with the same keys."""
    jcam, cam, pts, rng = _scene(7, 500)
    T_true = _T([0.0, 0.02, 0.0], [0.05, 0.0, 0.5])
    obs = (_project(jcam, T_true, pts)
           + 0.03 * rng.randn(500, 2)).astype(np.float32)
    valid = rng.rand(500) < 0.9
    pc = np.asarray(jse3.transform_points(jnp.asarray(T_true),
                                          jnp.asarray(pts)))
    T_mm = _T([0.0, 0.021, 0.0], [0.05, 0.0, 0.49])
    je = j_pose.estimate_camera_pose(
        jax.random.PRNGKey(1), jnp.asarray(pts), jnp.asarray(obs),
        jnp.asarray(valid), jcam, jnp.asarray(T_mm), jnp.asarray(pc))
    te = pose.estimate_camera_pose(prng.PRNGKey(1), _t(pts), _t(obs),
                                   _t(valid), cam, _t(T_mm), _t(pc))
    assert _pose_err(je.T, te.T) < 1e-4
    assert int(np.sum(te.inliers.numpy() != np.asarray(je.inliers))) <= 3

    K = 4
    masks = np.stack([(np.arange(500) % K == k) & valid for k in range(K)])
    masks[3] = False  # an empty slot
    H_mm = np.stack([np.eye(4, dtype=np.float32)] * K)
    has_mm = np.array([True, False, True, False])
    Tcw = np.eye(4, dtype=np.float32)
    jk = jax.random.split(jax.random.PRNGKey(2), K)
    jH, jinl, jn = j_pose.estimate_object_motions_batched(
        jk, jnp.asarray(Tcw), jnp.asarray(pts), jnp.asarray(obs),
        jnp.asarray(masks), jcam, jnp.asarray(H_mm), jnp.asarray(has_mm),
        jnp.asarray(pc))
    tH, tinl, tn = pose.estimate_object_motions_batched(
        prng.split(prng.PRNGKey(2), K), _t(Tcw), _t(pts), _t(obs), _t(masks),
        cam, _t(H_mm), _t(has_mm), _t(pc))
    for k in range(K):
        assert _pose_err(jH[k], tH[k]) < 1e-4, k
        assert abs(int(tn[k]) - int(jn[k])) <= 3, k


def test_solve_window_ba_matches_jax():
    rng = np.random.RandomState(0)
    W, P = 6, 60
    Twc = [np.eye(4)]
    for _ in range(1, W):
        Twc.append(Twc[-1] @ _T(rng.randn(3) * 0.01, [0.02, 0.0, 0.4]))
    Twc = np.stack(Twc).astype(np.float32)
    X = (rng.rand(P, 3) * [10, 4, 20] + [-5, -2, 5]).astype(np.float32)
    obs = np.stack([X @ np.linalg.inv(T)[:3, :3].T + np.linalg.inv(T)[:3, 3]
                    for T in Twc]).astype(np.float32)
    obs += (rng.randn(*obs.shape) * 0.02).astype(np.float32)
    odom = np.stack([np.linalg.inv(Twc[i]) @ Twc[i + 1]
                     for i in range(W - 1)]).astype(np.float32)
    Twc0 = Twc.copy()
    Twc0[1:, :3, 3] += (rng.randn(W - 1, 3) * 0.05).astype(np.float32)
    X0 = X + (rng.randn(P, 3) * 0.1).astype(np.float32)
    ov = rng.rand(W, P) > 0.2
    pv = np.ones(P, bool)
    pv[:3] = False
    odv = np.ones(W - 1, bool)
    odv[2] = False
    fv = np.ones(W, bool)
    fv[0] = False
    args = (Twc0, odom, odv, X0, obs, ov, pv, fv)
    rj = j_wba(*(jnp.asarray(a) for a in args), max_iters=10)
    rt = solve_window_ba(*(_t(a) for a in args), max_iters=10)
    assert rt.num_iters == int(rj.num_iters)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-4)
    np.testing.assert_allclose(rt.Twc.numpy(), np.asarray(rj.Twc), atol=1e-5)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points),
                               atol=1e-4)


@pytest.mark.parametrize("scale", [1e-4, 1e-2, 0.2])
def test_odometry_jacobians_match_jacfwd(scale):
    """The closed-form odometry-edge Jacobians against jax.jacfwd of the
    JAX residual, for residuals up to 0.2 (far beyond a window's)."""
    rng = np.random.RandomState(1)
    Tp = np.asarray(jse3.exp_se3(jnp.asarray(rng.randn(7, 6), jnp.float32)))
    Tc = np.asarray(jse3.exp_se3(jnp.asarray(rng.randn(7, 6), jnp.float32)))
    noise = np.asarray(jse3.exp_se3(jnp.asarray(rng.randn(7, 6) * scale,
                                                jnp.float32)))
    M = (np.linalg.inv(Tp) @ Tc @ noise).astype(np.float32)
    z = jnp.zeros(6)
    Ja, Jb = jax.vmap(lambda a, b, m: j_window_ba._odom_jac(z, z, a, b, m))(
        jnp.asarray(Tp), jnp.asarray(Tc), jnp.asarray(M))
    r = window_ba._odom_residual(_t(Tp), _t(Tc), _t(M))
    np.testing.assert_allclose(
        r.numpy(), np.asarray(jax.vmap(
            lambda a, b, m: j_window_ba._odom_edge_residual(z, z, a, b, m))(
                jnp.asarray(Tp), jnp.asarray(Tc), jnp.asarray(M))),
        atol=1e-5)
    ta, tb = window_ba._odom_jac(r, _t(M))
    np.testing.assert_allclose(ta.numpy(), np.asarray(Ja), atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(Jb), atol=1e-5)
