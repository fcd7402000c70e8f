"""The joint flow+pose solve of the PyTorch port against the JAX package:
the plain kernel-2 version (``flow_joint_batched_ref``) against the vmapped
XLA ``flow_joint_optimization`` and against ``flow_joint_batched_pallas`` in
interpret mode, on numpy-seeded problems (the construction of
tests/test_flow_joint.py:159-176, B=1 and 3) and on an object batch laid
out as the main path lays it out; then the behavioural cases of
tests/test_flow_joint.py:40-118 and the camera and object estimators with
the same keys.

Bars (tests/test_flow_joint.py:190-200): per problem |log(T_ref^-1 T)| <
1e-4; inlier sets differ by at most max(3, 1 %) of the points; the flows of
common inliers agree within 1e-2 px."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.estimation import flow_joint as j_fj
from vido_slam_tpu.estimation.flow_joint_pallas import (
    flow_joint_batched_pallas)
from vido_slam_tpu.geometry import se3 as jse3
from vido_slam_tpu.geometry import so3 as jso3
from vido_slam_tpu.geometry.camera import Camera as JCamera
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.estimation import flow_joint, flow_joint_kernel
from vido_slam_tpu_torch.estimation.flow_joint_kernel import (
    flow_joint_batched, flow_joint_batched_ref)
from vido_slam_tpu_torch.geometry.se3 import inverse_se3, log_se3
from vido_slam_tpu_torch.utils import cuda_build, prng

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pose_err(Ta, Tb):
    return float(torch.linalg.norm(log_se3(inverse_se3(_t(Ta)) @ _t(Tb))))


def _jcam():
    return JCamera.create(fx=816.402, fy=817.38, cx=608.2658, cy=266.688,
                          width=1280, height=560, bf=387.57)


def _pose(tx=0.3, ty=-0.1, tz=0.5, rx=0.01, ry=0.03, rz=-0.02):
    return np.asarray(jse3.make_se3(jso3.exp_so3(jnp.array([rx, ry, rz])),
                                    jnp.array([tx, ty, tz])))


def _scene(rng, n):
    """Points 5-40 m away; the world is the last camera frame."""
    jcam = _jcam()
    uv = np.stack([rng.uniform(50.0, jcam.width - 50.0, n),
                   rng.uniform(50.0, jcam.height - 50.0, n)],
                  -1).astype(np.float32)
    z = rng.uniform(5.0, 40.0, n).astype(np.float32)
    pts = np.asarray(jcam.backproject(jnp.asarray(uv), jnp.asarray(z)))
    return jcam, convert.camera_from_numpy(jcam), pts, uv


def _project(jcam, T, pts):
    return np.asarray(jcam.project(jse3.transform_points(jnp.asarray(T),
                                                         jnp.asarray(pts))))


def _batch_problem(seed, B):
    """tests/test_flow_joint.py:159-176 with numpy draws: 300 points, per
    problem a pose, 0.3 px flow noise and 8 % of +30 px outliers."""
    rng = np.random.RandomState(seed)
    jcam, cam, pts, obs_last = _scene(rng, 300)
    Ts, flows = [], []
    for b in range(B):
        T_true = _pose(tx=0.3 + 0.05 * b, ry=0.03 - 0.01 * b)
        fm = _project(jcam, T_true, pts) - obs_last
        fm = fm + 0.3 * rng.randn(*fm.shape)
        out = rng.uniform(size=300) < 0.08
        fm[out] += 30.0
        flows.append(fm.astype(np.float32))
        Ts.append(_pose(tx=0.25 + 0.05 * b, ry=0.02))
    return (jcam, cam, pts, obs_last, np.stack(Ts), np.stack(flows),
            np.ones((B, 300), bool))


def _object_problem(seed, K=3, n=300):
    """The object batch as the main path lays it out: one (N, 3) point set,
    one (N, 2) observation and one (N, 2) flow array shared by the K
    problems, each object's points picked out by a disjoint mask (slot K-1
    empty), M_init = Tcw H perturbed."""
    rng = np.random.RandomState(seed)
    jcam, cam, pts, obs_last = _scene(rng, n)
    Tcw = _pose(tx=0.1, ty=0.0, tz=0.2, rx=0.0, ry=0.02, rz=0.0)
    owner = rng.randint(-1, K - 1, n)
    fm = np.zeros((n, 2), np.float32)
    z_cur = np.array(jse3.transform_points(jnp.asarray(Tcw),
                                           jnp.asarray(pts)))[:, 2]
    M0 = []
    for k in range(K):
        H = _pose(tx=0.6 - 0.2 * k, ty=0.0, tz=0.3, rx=0.0, ry=0.01 * k,
                  rz=0.0)
        fk = _project(jcam, Tcw @ H, pts) - obs_last
        fm[owner == k] = fk[owner == k]
        z_cur[owner == k] = np.asarray(jse3.transform_points(
            jnp.asarray(Tcw @ H), jnp.asarray(pts)))[owner == k, 2]
        M0.append(Tcw @ _pose(tx=0.55 - 0.2 * k, ty=0.0, tz=0.25, rx=0.0,
                              ry=0.0, rz=0.0))
    fm = (fm + 0.2 * rng.randn(n, 2)).astype(np.float32)
    masks = np.stack([owner == k for k in range(K)])
    return (jcam, cam, pts, obs_last, Tcw, np.stack(M0).astype(np.float32),
            fm, masks, z_cur)


def _check_against(ref_T, ref_inl, ref_flow, T, inl, flow):
    B = ref_T.shape[0]
    for b in range(B):
        assert _pose_err(ref_T[b], T[b]) < 1e-4, b
    ref_inl, inl = np.asarray(ref_inl), np.asarray(inl)
    assert int(np.sum(ref_inl != inl)) <= max(3, int(0.01 * ref_inl.size))
    both = ref_inl & inl
    err = np.abs(np.asarray(ref_flow) - np.asarray(flow))[both]
    assert float(err.max()) < 1e-2


@pytest.mark.parametrize("B", [1, 3])
def test_plain_matches_xla_and_pallas(B):
    jcam, cam, pts, obs_last, T0, fm, valid = _batch_problem(11, B)
    xla = jax.vmap(lambda T, f, v: j_fj.flow_joint_optimization(
        T, jnp.asarray(pts), jnp.asarray(obs_last), f, v, jcam))(
            jnp.asarray(T0), jnp.asarray(fm), jnp.asarray(valid))
    pal = flow_joint_batched_pallas(
        jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(obs_last),
        jnp.asarray(fm), jnp.asarray(valid), jcam, interpret=True)
    ref = flow_joint_batched_ref(_t(T0), _t(pts), _t(obs_last), _t(fm),
                                 _t(valid), cam)
    for other in (xla, pal):
        _check_against(other.T, other.inliers, other.flow, ref.T.numpy(),
                       ref.inliers.numpy(), ref.flow.numpy())
    np.testing.assert_array_equal(ref.num_inliers.numpy(),
                                  ref.inliers.sum(-1).numpy())
    # every round iterates, and none past the cap
    its = ref.num_iters.numpy()
    assert its.shape == (B, 4) and (its >= 1).all() and (its <= 10).all()
    # the gross outliers end outside the inlier set
    assert int(ref.num_inliers.min()) > 250


def test_plain_matches_pallas_object_layout():
    """Shared point, observation and flow arrays; disjoint masks, one of
    them empty (no step is ever taken there)."""
    jcam, cam, pts, obs_last, _, M0, fm, masks, _ = _object_problem(5)
    pal = flow_joint_batched_pallas(
        jnp.asarray(M0), jnp.asarray(pts), jnp.asarray(obs_last),
        jnp.asarray(fm), jnp.asarray(masks), jcam, interpret=True)
    xla = jax.vmap(lambda T, v: j_fj.flow_joint_optimization(
        T, jnp.asarray(pts), jnp.asarray(obs_last), jnp.asarray(fm), v,
        jcam))(jnp.asarray(M0), jnp.asarray(masks))
    ref = flow_joint_batched_ref(_t(M0), _t(pts), _t(obs_last), _t(fm),
                                 _t(masks), cam)
    for other in (xla, pal):
        _check_against(other.T, other.inliers, other.flow, ref.T.numpy(),
                       ref.inliers.numpy(), ref.flow.numpy())
    np.testing.assert_array_equal(ref.T[-1].numpy(), M0[-1])
    assert not ref.inliers[-1].any()
    assert (ref.inliers & ~_t(masks)).sum() == 0
    # the empty slot rejects every step until the cap
    assert (ref.num_iters[-1] == 10).all()


def test_recovers_pose_and_denoises_flow():
    rng = np.random.RandomState(0)
    jcam, cam, pts, obs_last = _scene(rng, 200)
    T_true = _pose()
    flow_true = _project(jcam, T_true, pts) - obs_last
    flow_meas = flow_true + 0.5 * rng.randn(*flow_true.shape)
    out = rng.uniform(size=200) < 0.10
    flow_meas[out] += 40.0
    flow_meas = flow_meas.astype(np.float32)
    valid = np.ones(200, bool)
    T_init = _pose(tx=0.25, ty=-0.05, tz=0.4, ry=0.02)
    je = j_fj.flow_joint_optimization(
        jnp.asarray(T_init), jnp.asarray(pts), jnp.asarray(obs_last),
        jnp.asarray(flow_meas), jnp.asarray(valid), jcam)
    est = flow_joint.flow_joint_optimization(
        _t(T_init), _t(pts), _t(obs_last), _t(flow_meas), _t(valid), cam)
    _check_against(np.asarray(je.T)[None], np.asarray(je.inliers)[None],
                   np.asarray(je.flow)[None], est.T[None].numpy(),
                   est.inliers[None].numpy(), est.flow[None].numpy())
    assert _pose_err(T_true, est.T) < 5e-3
    inl = est.inliers.numpy()
    e_meas = np.linalg.norm(flow_meas - flow_true, axis=-1)
    e_opt = np.linalg.norm(est.flow.numpy() - flow_true, axis=-1)
    assert e_opt[inl].mean() < 0.8 * e_meas[inl].mean()
    assert out[inl].sum() == 0
    assert int(est.num_inliers) > 150


def test_prior_anchors_outlier_flow():
    """An outlier fails the chi2 gate and keeps only its prior, so its flow
    relaxes back toward the measurement."""
    rng = np.random.RandomState(2)
    jcam, cam, pts, obs_last = _scene(rng, 50)
    T_true = _pose()
    flow = _project(jcam, T_true, pts) - obs_last
    flow[7] += [60.0, -25.0]
    flow = flow.astype(np.float32)
    valid = np.ones(50, bool)
    je = j_fj.flow_joint_optimization(
        jnp.asarray(T_true), jnp.asarray(pts), jnp.asarray(obs_last),
        jnp.asarray(flow), jnp.asarray(valid), jcam)
    est = flow_joint.flow_joint_optimization(
        _t(T_true), _t(pts), _t(obs_last), _t(flow), _t(valid), cam)
    assert not bool(est.inliers[7]) and not bool(je.inliers[7])
    np.testing.assert_allclose(est.flow[7].numpy(), flow[7], atol=0.5)
    assert _pose_err(T_true, est.T) < 1e-3
    assert _pose_err(je.T, est.T) < 1e-4


def test_camera_estimator_matches_jax():
    rng = np.random.RandomState(3)
    jcam, cam, pts, obs_last = _scene(rng, 200)
    T_true = _pose()
    pc = np.asarray(jse3.transform_points(jnp.asarray(T_true),
                                          jnp.asarray(pts)))
    cur_uv = (_project(jcam, T_true, pts)
              + 0.3 * rng.randn(200, 2)).astype(np.float32)
    valid = np.ones(200, bool)
    obs_pc = np.asarray(jcam.backproject(jnp.asarray(cur_uv),
                                         jnp.asarray(pc[:, 2])))
    je, jflow = j_fj.estimate_camera_pose_joint(
        jax.random.PRNGKey(4), jnp.asarray(pts), jnp.asarray(obs_last),
        jnp.asarray(cur_uv), jnp.asarray(valid), jcam, jnp.eye(4),
        jnp.asarray(obs_pc))
    te, tflow = flow_joint.estimate_camera_pose_joint(
        prng.PRNGKey(4), _t(pts), _t(obs_last), _t(cur_uv), _t(valid), cam,
        torch.eye(4), _t(obs_pc))
    assert _pose_err(T_true, te.T) < 5e-3
    assert tflow.shape == (200, 2)
    _check_against(np.asarray(je.T)[None], np.asarray(je.inliers)[None],
                   np.asarray(jflow)[None], te.T[None].numpy(),
                   te.inliers[None].numpy(), tflow[None].numpy())


def test_object_estimator_matches_jax():
    """estimate_object_motions_joint_batched on the main path's layout,
    with the same keys: one slot with a motion model, one without, one
    empty."""
    jcam, cam, pts, obs_last, Tcw, _, fm, masks, z_cur = _object_problem(6)
    K = masks.shape[0]
    cur_uv = (obs_last + fm).astype(np.float32)
    obs_pc = np.asarray(jcam.backproject(jnp.asarray(cur_uv),
                                         jnp.asarray(z_cur, jnp.float32)))
    H_mm = np.stack([_pose(tx=0.6, ty=0.0, tz=0.3, rx=0.0, ry=0.0, rz=0.0),
                     np.eye(4, dtype=np.float32),
                     np.eye(4, dtype=np.float32)]).astype(np.float32)
    has_mm = np.array([True, False, False])
    jH, jinl, jn, jflow = j_fj.estimate_object_motions_joint_batched(
        jax.random.split(jax.random.PRNGKey(7), K), jnp.asarray(Tcw),
        jnp.asarray(pts), jnp.asarray(obs_last), jnp.asarray(cur_uv),
        jnp.asarray(masks), jcam, jnp.asarray(H_mm), jnp.asarray(has_mm),
        jnp.asarray(obs_pc))
    tH, tinl, tn, tflow = flow_joint.estimate_object_motions_joint_batched(
        prng.split(prng.PRNGKey(7), K), _t(Tcw), _t(pts), _t(obs_last),
        _t(cur_uv), _t(masks), cam, _t(H_mm), _t(has_mm), _t(obs_pc))
    _check_against(np.asarray(jH), np.asarray(jinl), np.asarray(jflow),
                   tH.numpy(), tinl.numpy(), tflow.numpy())
    np.testing.assert_array_equal(tn.numpy(), tinl.sum(-1).numpy())
    for k in range(K - 1):
        H_true = _pose(tx=0.6 - 0.2 * k, ty=0.0, tz=0.3, rx=0.0,
                       ry=0.01 * k, rz=0.0)
        assert _pose_err(H_true, tH[k]) < 1e-2, k
        assert int(tn[k]) > 50, k
    assert int(tn[K - 1]) == 0


def test_operations_count_valid_points_and_iterations():
    valid = torch.tensor([[True] * 10 + [False] * 6, [False] * 16])
    its = torch.tensor([[3, 2, 1, 1], [10, 10, 10, 10]], dtype=torch.int32)
    k = flow_joint_kernel
    per_iter = k.FLOPS_NORMAL_EQS + k.FLOPS_TRIAL
    expect = (10 * ((3 + 2 + 1) * (per_iter + k.FLOPS_HUBER_ITER)
                    + 1 * per_iter + 4 * k.FLOPS_COST
                    + 3 * k.FLOPS_HUBER_COST + 3 * k.FLOPS_GATE)
              + 47 * k.FLOPS_STEP + 32 * k.FLOPS_GATE)
    assert k.operations(valid, its) == expect


def test_wrapper_refuses_mixed_devices():
    cam = convert.camera_from_numpy(_jcam())
    args = [torch.eye(4)[None].to("meta"), torch.zeros(5, 3),
            torch.zeros(5, 2), torch.zeros(5, 2),
            torch.ones(1, 5, dtype=torch.bool)]
    with pytest.raises(ValueError, match="CPU"):
        flow_joint_batched(*args, cam)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No nvcc on PATH and a CUDA_HOME without one: the build raises (and
    loading a kernel with it) instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    assert set(cuda_build.sources()) >= {"flow_joint", "pose_lm"}
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("flow_joint")
