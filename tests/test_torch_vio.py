"""The VIO slice as a whole: the port's ``Tracker(use_imu=True)`` and
``System`` with the IMU_RGBD sensor against the JAX package's on the CPU.

The scene is tests/test_vio_e2e.py's (:41-97): 24 frames at 192x120 of a
textured ground plane, the camera on an accelerating, gently yawing path,
depth fed at 1/2.5 of metric (the monocular scale ambiguity) times the
tracker's IMU scale, and the analytic 200 Hz IMU of the path. Rendered once
with the JAX package's renderer; both packages read the same arrays.

Bars: both trackers initialize at the same frame after the same number of
attempts. With the host-assembled window BA (the default): ``imu_scale``
within 1e-3 relative, every frame's returned pose, before and after the
rescale, and every map pose within 1e-3 m and 1e-3 rad. With the fused
window BA: the returned poses before the init, and the map poses with each
tracker's own init transform (gravity rotation, scale) undone, at the same
bars, and ``imu_scale`` within 4e-3 relative: there the JAX package's own
init is decided by the last bits of its inputs (FUSED_SCALE_REL says how).
``System`` IMU_RGBD through ``TrackRGBDWithIMUArray`` (which calls
``TrackRGBD``) on KAIST raw depth against the JAX ``System.TrackRGBD`` at
the host-assembled bars. The online path as IMU_RGBD is
tests/test_torch_vio_online.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.config import config_from_dict as j_config_from_dict
from vido_slam_tpu.estimation import imu_init as j_imu_init
from vido_slam_tpu.geometry.camera import Camera as JCamera
from vido_slam_tpu.geometry.se3 import inverse_se3 as j_inverse_se3
from vido_slam_tpu.geometry.se3 import make_se3 as j_make_se3
from vido_slam_tpu.geometry.so3 import exp_so3 as j_exp_so3
from vido_slam_tpu.imu.preintegration import GRAVITY_VALUE
from vido_slam_tpu.io.synthetic import (SyntheticScene, flow_between,
                                        render_frame)
from vido_slam_tpu.system import ImuPoint as JImuPoint
from vido_slam_tpu.system import Sensor as JSensor
from vido_slam_tpu.system import System as JSystem
from vido_slam_tpu.tracking import Tracker as JTracker
from vido_slam_tpu_torch import tracking as t_tracking
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.estimation import imu_init as t_imu_init
from vido_slam_tpu_torch.system import ImuPoint, Sensor, System
from vido_slam_tpu_torch.tracking import Tracker

torch.set_num_threads(1)

SCALE_GT = 2.5
FPS = 10.0
IMU_HZ = 200.0
N_FRAMES = 24
W, H = 192, 120
CFG = {"Camera.width": W, "Camera.height": H, "Camera.fx": 150.0,
       "Camera.fy": 150.0, "Camera.cx": W / 2, "Camera.cy": H / 2,
       "Camera.bf": 30.0, "Camera.fps": FPS, "ThDepthBG": 80.0,
       "MaxTrackPointBG": 800, "WINDOW_SIZE": 8, "IMU.NoiseGyro": 1e-4,
       "IMU.NoiseAcc": 1e-4, "IMU.GyroWalk": 1e-6, "IMU.AccWalk": 1e-5,
       "IMU.Frequency": IMU_HZ}
TRACKER_KW = dict(n_bg=800, n_obj=500, max_objects=2, seed=0, local_ba=True,
                  ba_max_points=600, imu_max_frames=32)
# KAIST raw depth of the System runs: metric = bf / (raw / DepthMapFactor)
RAW_F = 500.0 * 30.0


def analytic_pose(t):
    p = np.array([0.9 * np.sin(1.8 * t), 0.15 * np.sin(1.3 * t), 1.0 * t])
    R = np.asarray(j_exp_so3(jnp.asarray([0.0, 0.04 * t, 0.0])))
    return R, p


def analytic_acc(t):
    return np.array([-0.9 * 1.8 * 1.8 * np.sin(1.8 * t),
                     -0.15 * 1.3 * 1.3 * np.sin(1.3 * t), 0.0])


@pytest.fixture(scope="module")
def scene():
    """Per frame: (depth / SCALE_GT, flow, mask, Tcw_gt, timestamp, the IMU
    samples (a, w, t) since the previous frame)."""
    cam = JCamera.create(fx=150.0, fy=150.0, cx=W / 2, cy=H / 2, width=W,
                         height=H, bf=30.0)
    sc = SyntheticScene(cam=cam, ground_y=1.5, boxes=())
    g_w = np.array([0.0, GRAVITY_VALUE, 0.0])
    omega = np.array([0.0, 0.04, 0.0], np.float32)
    Tcws = []
    for i in range(N_FRAMES):
        R, p = analytic_pose(i / FPS)
        Tcws.append(np.asarray(j_inverse_se3(j_make_se3(
            jnp.asarray(R, jnp.float32), jnp.asarray(p, jnp.float32)))))
    frames, imu_t = [], 0.0
    for i in range(N_FRAMES):
        t = i / FPS
        depth, mask = render_frame(sc, jnp.asarray(Tcws[i]), [])
        if i + 1 < N_FRAMES:
            flow = flow_between(sc, jnp.asarray(Tcws[i]),
                                jnp.asarray(Tcws[i + 1]), depth, mask, [])
        else:
            flow = jnp.zeros(depth.shape + (2,), jnp.float32)
        meas = []
        while imu_t <= t + 1e-9:
            R, _ = analytic_pose(imu_t)
            a_b = R.T @ (analytic_acc(imu_t) - g_w)
            meas.append((a_b.astype(np.float32), omega, imu_t))
            imu_t += 1.0 / IMU_HZ
        frames.append((np.asarray(depth) / SCALE_GT, np.asarray(flow),
                       np.asarray(mask), Tcws[i], t, meas))
    return frames


def _run(tracker, frames, point):
    """Feed every frame; returns each frame's (returned pose,
    imu_initialized, imu_init_attempts, imu_scale)."""
    out = []
    for depth, flow, mask, gt, t, meas in frames:
        tracker.grab_imu_data([point(a, w, tt) for a, w, tt in meas])
        T = tracker.track(depth * tracker.imu_scale, flow, mask, Tcw_gt=gt,
                          timestamp=t)
        out.append((np.asarray(T, np.float32), tracker.imu_initialized,
                    tracker.imu_init_attempts, tracker.imu_scale))
    return out


def _rot_err(A, B):
    """The angle of Ra^T Rb, from its skew part (accurate near 0)."""
    R = np.asarray(A, np.float64)[:3, :3].T @ np.asarray(B, np.float64)[:3, :3]
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(w))))


class Snapshot:
    """A tracker's map poses, gravity rotation and scale after the run (the
    refinement test goes on to change the trackers), and the
    ``initialize_imu`` calls it made as (inputs, scale)."""

    def __init__(self, tracker, init_calls=()):
        self.poses = [np.array(rec.Tcw) for rec in tracker.map.frames]
        self.Rwg = np.array(tracker.Rwg, np.float64)
        self.imu_scale = tracker.imu_scale
        self.init_calls = list(init_calls)

    def undo_init(self, k):
        """Map pose k with the init's gravity rotation and scale undone
        (Map::ApplyScaledRotation backwards)."""
        T = np.asarray(self.poses[k], np.float64).copy()
        T[:3, :3] = T[:3, :3] @ self.Rwg.T
        T[:3, 3] /= self.imu_scale
        return T


def _assert_same_run(rj, rt, jt, tt, scale_rel=1e-3):
    """The same init frame and attempts, the scale within ``scale_rel``,
    the poses within 1e-3 m and 1e-3 rad: the returned ones before the
    init, and the map's with each tracker's own init transform undone.
    With ``scale_rel`` at 1e-3 also every returned pose and the map's as
    they stand."""
    init_j = [k for k, r in enumerate(rj) if r[1]]
    init_t = [k for k, r in enumerate(rt) if r[1]]
    assert init_j and init_t and init_t[0] == init_j[0]
    k0 = init_j[0]
    assert [r[2] for r in rt] == [r[2] for r in rj]
    assert rt[-1][3] == pytest.approx(rj[-1][3], rel=scale_rel)
    strict = scale_rel <= 1e-3
    for k, (a, b) in enumerate(zip(rj, rt)):
        if k < k0 or strict:
            assert np.abs(a[0][:3, 3] - b[0][:3, 3]).max() <= 1e-3, k
            assert _rot_err(a[0], b[0]) <= 1e-3, k
    assert len(jt.poses) == len(tt.poses) == N_FRAMES
    for k, (a, b) in enumerate(zip(jt.poses, tt.poses)):
        A, B = jt.undo_init(k), tt.undo_init(k)
        assert np.abs(A[:3, 3] - B[:3, 3]).max() <= 1e-3, k
        assert _rot_err(A, B) <= 1e-3, k
        if strict:
            assert np.abs(a[:3, 3] - b[:3, 3]).max() <= 1e-3, k
            assert _rot_err(a, b) <= 1e-3, k
    return k0


# the fused BA's scale bar: on this run the JAX package's own init at
# frame 20 gives 2.4946 or 2.5037 (stride-3 candidate, its stage-C LM stuck
# at the start or run 29 iterations) as one body position moves by one
# float32 ulp; the two packages' inputs differ by ~1e-6 m there
# (test_init_inputs_decide_the_scale shows both)
FUSED_SCALE_REL = 4e-3


def _recording(fn, calls):
    """``fn`` (either package's ``initialize_imu``), appending each call's
    inputs as numpy arrays and its scale to ``calls``."""
    def rec(*args, **kw):
        res = fn(*args, **kw)
        inputs = dict(zip(("Rwb", "twb"), args), **kw)
        calls.append(({k: np.array(v) if hasattr(v, "shape") else v
                       for k, v in inputs.items()}, float(res.scale)))
        return res
    return rec


@pytest.fixture(scope="module", params=[(False, 1e-3),
                                        (True, FUSED_SCALE_REL)],
                ids=["host-assembled BA", "fused BA"])
def vio_runs(request, scene):
    """Both trackers over the scene: (JAX tracker, port tracker, their
    per-frame records, their snapshots, the scale bar)."""
    fused_ba, scale_rel = request.param
    jt = JTracker(j_config_from_dict(CFG), use_imu=True, lm_pallas=False,
                  fused_ba=fused_ba, **TRACKER_KW)
    tt = Tracker(config_from_dict(CFG), use_imu=True, fused_ba=fused_ba,
                 device="cpu", **TRACKER_KW)
    calls_j, calls_t = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_imu_init, "initialize_imu",
                   _recording(j_imu_init.initialize_imu, calls_j))
        mp.setattr(t_tracking, "initialize_imu",
                   _recording(t_tracking.initialize_imu, calls_t))
        rj = _run(jt, scene, lambda a, w, t: JImuPoint(a=a, w=w, t=t))
        rt = _run(tt, scene, lambda a, w, t: ImuPoint(a=a, w=w, t=t))
    return (jt, tt, rj, rt, Snapshot(jt, calls_j), Snapshot(tt, calls_t),
            scale_rel)


def test_vio_tracker_matches_jax(vio_runs):
    _, tt, rj, rt, sj, st, scale_rel = vio_runs
    k = _assert_same_run(rj, rt, sj, st, scale_rel)
    # the scale is recovered (test_vio_e2e.py's bar) and the state moved
    assert st.imu_scale == pytest.approx(SCALE_GT, rel=0.1)
    assert _rot_err(st.Rwg, sj.Rwg) <= 1e-3
    assert tt.state.Tcw.device.type == "cpu"
    print(f"VIO {'fused' if tt.fused_ba else 'host'} BA: init at frame {k}, "
          f"attempts {tt.imu_init_attempts}, scale {st.imu_scale:.6f} "
          f"(JAX {sj.imu_scale:.6f})")


def test_init_inputs_decide_the_scale(vio_runs):
    """The init's scale is a function of its inputs that both packages
    compute alike: each package's ``initialize_imu`` on the other's
    recorded inputs gives the other's scale within 1e-4, candidate by
    candidate. Where the run's bar is wider than 1e-3 (the fused BA), the
    JAX package's own accepted scale moves by more than 1e-3 as one body
    position of its inputs moves by one float32 ulp, and stays within the
    bar."""
    _, _, _, _, sj, st, scale_rel = vio_runs
    assert len(sj.init_calls) == len(st.init_calls) > 0

    def scale_of(fn, conv, inputs):
        return float(fn(**{k: conv(v) if isinstance(v, np.ndarray) else v
                           for k, v in inputs.items()}).scale)

    def j_scale(inputs):
        return scale_of(j_imu_init.initialize_imu, jnp.asarray, inputs)

    def t_scale(inputs):
        return scale_of(t_imu_init.initialize_imu, torch.from_numpy, inputs)

    for (in_j, s_j), (in_t, s_t) in zip(sj.init_calls, st.init_calls):
        assert t_scale(in_j) == pytest.approx(s_j, rel=1e-4)
        assert j_scale(in_t) == pytest.approx(s_t, rel=1e-4)
    if scale_rel <= 1e-3:
        return
    in_j, s_j = max(sj.init_calls, key=lambda c: c[1])
    moved = []
    for c in range(3):
        twb = in_j["twb"].copy()
        twb[0, c] = np.nextafter(twb[0, c], np.float32(np.inf))
        moved.append(j_scale(dict(in_j, twb=twb)))
    flips = [s for s in moved if abs(s / s_j - 1.0) > 1e-3]
    print(f"JAX init scale {s_j:.7f}; with twb[0] one ulp up, per axis: "
          + ", ".join(f"{s:.7f}" for s in moved))
    assert flips
    assert all(abs(s / s_j - 1.0) <= scale_rel for s in moved)


def test_scale_refinement_matches_jax(vio_runs):
    """ScaleRefinement 10 s after the init, on the trackers' own maps and
    preintegrations: one run each, the same scale within the run's bar,
    and the state's pose moved as the map's last record."""
    jt, tt, _, _, _, _, scale_rel = vio_runs
    t = jt._last_scale_refine_t + 10.0
    assert tt._last_scale_refine_t == jt._last_scale_refine_t
    s_j, s_t = jt.imu_scale, tt.imu_scale
    # the 10 s gate: a moment earlier, neither tracker runs
    jt._vio_update(t - 1e-3)
    tt._vio_update(t - 1e-3)
    assert tt.imu_refine_runs == jt.imu_refine_runs == 0
    assert tt.imu_scale == s_t
    jt._vio_update(t)
    tt._vio_update(t)
    assert tt.imu_refine_runs == jt.imu_refine_runs == 1
    assert tt._last_scale_refine_t == jt._last_scale_refine_t == t
    assert tt.imu_scale / s_t == pytest.approx(jt.imu_scale / s_j,
                                               rel=scale_rel)
    assert tt.imu_scale != s_t
    np.testing.assert_allclose(tt.state.Tcw.numpy(), tt.map.frames[-1].Tcw,
                               atol=1e-5)


def test_vio_system_matches_jax(scene):
    """IMU_RGBD ``System``s on KAIST raw depth: JAX's ``TrackRGBD`` with
    ``ImuPoint``s, the port's ``TrackRGBDWithIMUArray`` with (N, 7) rows;
    both convert the raw depth at their live scale."""
    d = dict(CFG, ChooseData=3, DepthMapFactor=500)
    js, ts = JSystem(), System()
    js.init_from_config(j_config_from_dict(d), JSensor.IMU_RGBD,
                        lm_pallas=False, **TRACKER_KW)
    ts.init_from_config(config_from_dict(d), Sensor.IMU_RGBD, device="cpu",
                        **TRACKER_KW)
    assert ts.tracker.use_imu and not ts.tracker.fused_ba
    rj, rt = [], []
    for depth, flow, mask, gt, t, meas in scene:
        raw = np.where(depth > 0, RAW_F / np.maximum(depth, 1e-6), 0.0)
        Tj = js.TrackRGBD(None, raw, flow, mask, mTcw_gt=gt, timestamp=t,
                          imu_measurements=[JImuPoint(a=a, w=w, t=tt)
                                            for a, w, tt in meas])
        rows = np.array([[*a, *w, tt] for a, w, tt in meas], np.float64)
        Tt = ts.TrackRGBDWithIMUArray(None, raw, flow, mask, gt, t,
                                      imu_rows=rows)
        for r, s, T in ((rj, js, Tj), (rt, ts, Tt)):
            r.append((np.asarray(T, np.float32), s.tracker.imu_initialized,
                      s.tracker.imu_init_attempts, s.scale))
    _assert_same_run(rj, rt, Snapshot(js.tracker), Snapshot(ts.tracker))
    assert ts.scale == ts.tracker.imu_scale != 1.0


def test_imu_array_rows_become_points(scene):
    """``TrackRGBDWithIMUArray`` queues the rows as float32 ``ImuPoint``s,
    as ``TrackRGBD`` queues the points; an RGBD system queues nothing."""
    depth, flow, mask, gt, t, meas = scene[1]
    raw = np.where(depth > 0, RAW_F / np.maximum(depth, 1e-6), 0.0)
    rows = np.array([[*a, *w, tt] for a, w, tt in meas], np.float64)
    queued = []
    for sensor in (Sensor.IMU_RGBD, Sensor.RGBD):
        s = System()
        s.init_from_config(config_from_dict(CFG), sensor, device="cpu",
                           **TRACKER_KW)
        s.tracker.grab_imu_data = queued.append
        s.TrackRGBDWithIMUArray(None, raw, flow, mask, gt, t, imu_rows=rows)
    assert len(queued) == 1 and len(queued[0]) == len(meas)
    for p, (a, w, tt) in zip(queued[0], meas):
        assert isinstance(p, ImuPoint) and p.a.dtype == np.float32
        np.testing.assert_array_equal(p.a, a)
        np.testing.assert_array_equal(p.w, w)
        assert p.t == tt
