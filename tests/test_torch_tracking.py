"""The slices as a whole: the port's ``_track_step``, ``Tracker`` and
``System`` on the CPU against the JAX package on the same rendered frames
and seed, with the fused window BA (slice 1), at the defaults (the
host-assembled window BA) and in the bJoint mode (``joint_flow=True``).

Tolerances: one step from the same converted state must reproduce the JAX
step's selections, masks and counts exactly and its floats to float32
rounding (poses 1e-5, BA points 1e-4); a 6-frame run keeps every
per-frame pose within 1e-3 m and 1e-3 rad of the JAX ``Tracker`` (its
XLA solvers, ``lm_pallas=False``), the same per-object ``obj_ok`` flags and
track ids; the port's two window-BA modes stay within the JAX package's
fused-vs-host bar (tests/test_tracking_e2e.py:189-193)."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.config import config_from_dict as j_config_from_dict
from vido_slam_tpu.estimation.assembly import (
    assemble_static_window as j_assemble_static_window)
from vido_slam_tpu.geometry.se3 import make_se3 as j_make_se3
from vido_slam_tpu.geometry.so3 import exp_so3 as j_exp_so3
from vido_slam_tpu.io.synthetic import SyntheticSequence, simple_scene
from vido_slam_tpu.system import Sensor as JSensor
from vido_slam_tpu.system import System as JSystem
from vido_slam_tpu.tracking import Tracker as JTracker
from vido_slam_tpu.tracking import _track_step as j_track_step
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.estimation import flow_joint_kernel, lm_kernel
from vido_slam_tpu_torch.estimation.assembly import assemble_static_window
from vido_slam_tpu_torch.metrics import ate_rmse
from vido_slam_tpu_torch.system import Sensor, System
from vido_slam_tpu_torch.tracking import StepOutputs, Tracker, _track_step
from vido_slam_tpu_torch.utils.transfer import to_host

torch.set_num_threads(1)

N_FRAMES = 6


def _cfg_dict(scene, **extra):
    cam = scene.cam
    d = {"Camera.width": cam.width, "Camera.height": cam.height,
         "Camera.fx": float(cam.fx), "Camera.fy": float(cam.fy),
         "Camera.cx": float(cam.cx), "Camera.cy": float(cam.cy),
         "Camera.bf": float(cam.bf), "ThDepthBG": 80.0, "ThDepthOBJ": 60.0,
         "MaxTrackPointBG": 1200, "MaxTrackPointOBJ": 800,
         "WINDOW_SIZE": 6}
    d.update(extra)
    return d


BASE_KW = dict(n_bg=1200, n_obj=3000, max_objects=4, seed=0)
TRACKER_KW = dict(BASE_KW, fused_ba=True)
STEP_KW = dict(n_bg=1200, n_obj=3000, max_objects=4, th_depth_bg=80.0,
               th_depth_obj=60.0, sf_mg_thres=0.12, sf_ds_thres=0.3,
               height=160, width=256, ba_window=6, ba_points=1000,
               ba_iters=15, record_light=False)


@pytest.fixture(scope="module")
def sequence():
    scene = simple_scene(width=256, height=160, moving_box=True,
                         box_speed=0.6)
    dT = np.asarray(j_make_se3(j_exp_so3(jnp.array([0.0, 0.01, 0.0])),
                               jnp.array([0.02, 0.0, -0.4])))
    return scene, SyntheticSequence(scene, [dT], n_frames=N_FRAMES)


def _jax_run(sequence, **kw):
    scene, seq = sequence
    jt = JTracker(j_config_from_dict(_cfg_dict(scene)), lm_pallas=False,
                  **kw)
    states = []
    for fr in seq.frames:
        jt.track(fr.depth, fr.flow, fr.mask, Tcw_gt=fr.Tcw_gt)
        states.append(jax.device_get(jt.state))
    return jt, states


def _port_run(sequence, **kw):
    """The port's run and the kernel launches it made (none on the CPU)."""
    scene, seq = sequence
    tt = Tracker(config_from_dict(_cfg_dict(scene)), device="cpu", **kw)
    counters = (lm_kernel.pose_lm_batched, flow_joint_kernel.flow_joint_batched)
    before = [c.launches for c in counters]
    for fr in seq.frames:
        tt.track(fr.depth, fr.flow, fr.mask, Tcw_gt=fr.Tcw_gt)
    return tt, sum(c.launches for c in counters) - sum(before)


@pytest.fixture(scope="module")
def jax_run(sequence):
    return _jax_run(sequence, **TRACKER_KW)


@pytest.fixture(scope="module")
def port_run(sequence):
    return _port_run(sequence, **TRACKER_KW)


@pytest.fixture(scope="module")
def jax_default_run(sequence):
    return _jax_run(sequence, **BASE_KW)


@pytest.fixture(scope="module")
def port_default_run(sequence):
    return _port_run(sequence, **BASE_KW)


@pytest.fixture(scope="module")
def jax_joint_run(sequence):
    return _jax_run(sequence, joint_flow=True, **BASE_KW)


@pytest.fixture(scope="module")
def port_joint_run(sequence):
    return _port_run(sequence, joint_flow=True, **BASE_KW)


def _rot_err(A, B):
    R = np.asarray(A, np.float64)[:3, :3].T @ np.asarray(B, np.float64)[:3, :3]
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(w))))


def _compare(name, a, b, atol=None):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind == "f":
        if atol is None:
            atol = 1e-4 if name in ("ba_points", "obj_centroid",
                                    "mean_depth") else 2e-5
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-5,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(a, b, err_msg=name)


def _compare_one_step(sequence, jt, states, depth_atol=None, **mode):
    """Frame 3 from the JAX tracker's state after frame 2, in both;
    ``depth_atol`` overrides the bar of the depth fields."""
    scene, seq = sequence
    fr = seq[3]
    kw = dict(STEP_KW, **mode)
    jstep = jax.jit(lambda s, d, f, m: j_track_step(
        s, d, f, m, jnp.zeros((160, 256)), jt.cam, use_fast=False,
        lm_pallas=False, **kw))
    jstate, jout = jax.device_get(jstep(states[2], jnp.asarray(fr.depth),
                                        jnp.asarray(fr.flow),
                                        jnp.asarray(fr.mask, jnp.int32)))
    tstate, tout = _track_step(
        convert.track_state_from_numpy(states[2], "cpu"),
        torch.from_numpy(fr.depth.copy()), torch.from_numpy(fr.flow.copy()),
        torch.from_numpy(fr.mask.astype(np.int32)),
        convert.camera_from_numpy(jt.cam), **kw)
    tout, tstate = to_host(tout), to_host(tstate)
    assert int(tout.obj_num_inliers[0]) > 100
    for name in StepOutputs._fields:
        if name == "stats":
            for sname in tout.stats._fields:
                _compare(sname, getattr(tout.stats, sname),
                         getattr(jout.stats, sname))
        else:
            _compare(name, getattr(tout, name), getattr(jout, name),
                     depth_atol if name.endswith("depth") else None)
    for name in tstate._fields:
        t, j = getattr(tstate, name), getattr(jstate, name)
        if name in ("stat", "obj"):
            for f in t._fields:
                _compare(f"{name}.{f}", getattr(t, f), getattr(j, f),
                         depth_atol if f == "depth" else None)
        elif name == "key":
            np.testing.assert_array_equal(t, np.asarray(j, np.int64))
        else:
            _compare(name, t, j)


def test_one_track_step_from_converted_state(sequence, jax_run):
    jt, states = jax_run
    _compare_one_step(sequence, jt, states, joint_flow=False, fused_ba=True)


def test_one_joint_track_step_from_converted_state(sequence, jax_joint_run):
    """The bJoint step: the joint solves' flows move the keypoints, and
    every selection, mask and count still matches exactly. The depths are
    re-read by the bilinear gather at the moved keypoints: on the object's
    silhouette, where the gather blends taps up to 5x apart in depth, one
    float32 ulp of a keypoint (3e-5 px at u = 132) moves the depth by up to
    7.2e-4 m (4 of the 3000 object points in this frame), so the depth
    fields are held to 1e-3 m."""
    jt, states = jax_joint_run
    _compare_one_step(sequence, jt, states, depth_atol=1e-3,
                      joint_flow=True, fused_ba=False)


def _assert_same_run(jt, tt):
    assert len(tt.map) == len(jt.map) == N_FRAMES
    for a, b in zip(jt.map.frames, tt.map.frames):
        dt = np.abs(a.Tcw[:3, 3] - b.Tcw[:3, 3]).max()
        assert dt <= 1e-3, (a.frame_id, dt)
        assert _rot_err(a.Tcw, b.Tcw) <= 1e-3, a.frame_id
        assert [o.status for o in a.objects] == \
            [o.status for o in b.objects], a.frame_id
        assert [o.track_id for o in a.objects] == \
            [o.track_id for o in b.objects], a.frame_id
    assert sum(o.status for f in tt.map.frames for o in f.objects) >= 4


def test_whole_slice_matches_jax_tracker(sequence, jax_run, port_run):
    jt, _ = jax_run
    tt, launches = port_run
    _assert_same_run(jt, tt)
    # the CPU run never reaches the kernel
    assert launches == 0


def test_default_tracker_matches_jax_default(jax_default_run,
                                             port_default_run):
    """Tracker() runs the host-assembled window BA, as the JAX package's
    default does; its write-back of refined points into the records'
    stat_3d matches too."""
    jt, _ = jax_default_run
    tt, launches = port_default_run
    assert not tt.fused_ba and not tt.record_light and tt.local_ba
    _assert_same_run(jt, tt)
    assert launches == 0
    assert len(tt.map.lba_time) == len(jt.map.lba_time) == N_FRAMES - 2
    for a, b in zip(jt.map.frames, tt.map.frames):
        v = a.stat_valid
        np.testing.assert_allclose(b.stat_3d[v], a.stat_3d[v], atol=1e-3,
                                   err_msg=str(a.frame_id))


def test_joint_flow_tracker_matches_jax(jax_joint_run, port_joint_run):
    jt, _ = jax_joint_run
    tt, launches = port_joint_run
    assert tt.joint_flow and not tt.fused_ba
    _assert_same_run(jt, tt)
    assert launches == 0
    # the optimized flows moved the recorded keypoints as in JAX
    for a, b in zip(jt.map.frames, tt.map.frames):
        np.testing.assert_allclose(b.stat_uv, a.stat_uv, atol=1e-3)
        np.testing.assert_allclose(b.obj_uv, a.obj_uv, atol=1e-3)


def test_fused_and_host_ba_agree(sequence, port_run, port_default_run):
    """The port's two window-BA modes, held to the JAX package's own bar
    between them (tests/test_tracking_e2e.py:187-193)."""
    _, seq = sequence
    fused, _ = port_run
    host, _ = port_default_run
    gt = np.stack([f.Tcw_gt for f in seq.frames])
    assert ate_rmse(fused.map.poses, gt, align=False) < 0.05
    assert ate_rmse(host.map.poses, gt, align=False) < 0.05
    assert np.abs(fused.map.poses - host.map.poses).max() < 0.03


@pytest.mark.parametrize("window,max_points", [(6, 1000), (10, 60)])
def test_assemble_static_window_matches_jax(port_default_run, window,
                                            max_points):
    """The same map records through both assemblies: every array equal
    (a window longer than the map is front-padded; 60 points cap the
    tracks)."""
    tt, _ = port_default_run
    jp = j_assemble_static_window(tt.map, tt.cam, window, max_points)
    tp = assemble_static_window(tt.map, tt.cam, window, max_points)
    assert tp.frame_ids == jp.frame_ids and tp.pad == jp.pad
    assert tp.pad == max(0, window - N_FRAMES)
    assert tp.point_valid.any()
    for name in tp._fields:
        if name in ("frame_ids", "pad"):
            continue
        a, b = getattr(tp, name), getattr(jp, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_record_full_matches_light(sequence, port_run):
    """record="full" keeps the per-point fields and the BA points and
    tracks exactly as the light mode does."""
    scene, seq = sequence
    light, _ = port_run
    tt = Tracker(config_from_dict(_cfg_dict(scene)), device="cpu",
                 record="full", **TRACKER_KW)
    assert not tt.record_light and light.record_light
    for fr in seq.frames:
        tt.track(fr.depth, fr.flow, fr.mask, Tcw_gt=fr.Tcw_gt)
    for a, b in zip(light.map.frames, tt.map.frames):
        np.testing.assert_array_equal(a.Tcw, b.Tcw)
        assert [o.status for o in a.objects] == [o.status for o in b.objects]
    last = tt.map.frames[-1]
    assert last.stat_uv.shape == (1200, 2) and last.obj_label.shape == (3000,)
    assert np.isfinite(last.stat_3d[last.stat_valid]).all()
    assert light.map.frames[-1].stat_uv.shape == (0, 2)


def test_system_trackrgbd_and_results(sequence, tmp_path):
    scene, seq = sequence
    d = _cfg_dict(scene, ChooseData=1, DepthMapFactor=100)
    js = JSystem()
    js.init_from_config(j_config_from_dict(d), JSensor.RGBD, lm_pallas=False,
                        **TRACKER_KW)
    ts = System()
    ts.init_from_config(config_from_dict(d), Sensor.RGBD, device="cpu",
                        **TRACKER_KW)
    for fr in seq.frames:
        raw = fr.depth * 100.0  # OMD raw value: metric * DepthMapFactor
        Tj = js.TrackRGBD(None, raw, fr.flow, fr.mask, mTcw_gt=fr.Tcw_gt)
        Tt = ts.TrackRGBD(None, raw, fr.flow, fr.mask, mTcw_gt=fr.Tcw_gt)
        assert np.abs(np.asarray(Tj) - Tt).max() < 1e-3
    oj, ot = js.GetFrameOutput(), ts.GetFrameOutput()
    assert [o.tracking_id for o in oj.objects] == \
        [o.tracking_id for o in ot.objects]
    np.testing.assert_allclose(ot.camera_position, oj.camera_position,
                               atol=1e-3)
    js.SaveResultsIJRR2020(str(tmp_path / "jax_"))
    ts.SaveResultsIJRR2020(str(tmp_path / "torch_"))
    names = sorted(p.name[len("jax_"):] for p in tmp_path.glob("jax_*"))
    assert names == sorted(p.name[len("torch_"):]
                           for p in tmp_path.glob("torch_*"))
    assert "obj_mot_rgbd_new.txt" in names
    for n in names:
        if os.path.getsize(tmp_path / f"jax_{n}") == 0:
            assert os.path.getsize(tmp_path / f"torch_{n}") == 0, n
            continue
        a = np.loadtxt(tmp_path / f"jax_{n}", ndmin=2)
        b = np.loadtxt(tmp_path / f"torch_{n}", ndmin=2)
        assert a.shape == b.shape, n
        np.testing.assert_allclose(b, a, atol=2e-3, err_msg=n)


def test_system_defaults_match_jax_system(sequence):
    """System.init_from_config with no tracker arguments: the host-assembled
    window BA in both packages, frame by frame."""
    scene, seq = sequence
    d = _cfg_dict(scene, ChooseData=1, DepthMapFactor=100)
    js = JSystem()
    js.init_from_config(j_config_from_dict(d), JSensor.RGBD)
    ts = System()
    ts.init_from_config(config_from_dict(d), Sensor.RGBD, device="cpu")
    assert not ts.tracker.fused_ba and not js.tracker.fused_ba
    for fr in seq.frames:
        raw = fr.depth * 100.0
        Tj = js.TrackRGBD(None, raw, fr.flow, fr.mask, mTcw_gt=fr.Tcw_gt)
        Tt = ts.TrackRGBD(None, raw, fr.flow, fr.mask, mTcw_gt=fr.Tcw_gt)
        assert np.abs(np.asarray(Tj)[:3, 3] - Tt[:3, 3]).max() <= 1e-3
        assert _rot_err(np.asarray(Tj), Tt) <= 1e-3
    for a, b in zip(js.map.frames, ts.map.frames):
        assert np.abs(a.Tcw[:3, 3] - b.Tcw[:3, 3]).max() <= 1e-3
        assert [(o.status, o.track_id) for o in a.objects] == \
            [(o.status, o.track_id) for o in b.objects], a.frame_id


def test_unported_modes_raise(sequence):
    """The pipelined modes are ported (tests/test_torch_pipelined.py):
    ``pipelined=True`` builds a pipelined tracker, except VIO with the
    host-assembled window BA, which runs unpipelined as in the JAX
    package (tracking.py:568 there)."""
    scene, _ = sequence
    cfg = config_from_dict(_cfg_dict(scene))
    assert Tracker(cfg, device="cpu", pipelined=True).pipelined
    assert not Tracker(cfg, device="cpu", pipelined=True,
                       use_imu=True).pipelined
    assert Tracker(cfg, device="cpu", pipelined=True, use_imu=True,
                   fused_ba=True).pipelined


def test_vio_mode_runs(sequence):
    """``use_imu=True`` builds and tracks: without IMU samples each
    interval's preintegration is None and the init never fires, so the
    poses are the VO tracker's to the bit."""
    scene, seq = sequence
    cfg = config_from_dict(_cfg_dict(scene))
    vio = Tracker(cfg, device="cpu", use_imu=True, **TRACKER_KW)
    vo = Tracker(cfg, device="cpu", **TRACKER_KW)
    for k, fr in enumerate(seq.frames[:3]):
        Tv = vio.track(fr.depth, fr.flow, fr.mask, timestamp=0.1 * k)
        To = vo.track(fr.depth, fr.flow, fr.mask, timestamp=0.1 * k)
        np.testing.assert_array_equal(Tv, To)
    assert vio._preints == [None, None]
    assert not vio.imu_initialized and vio.imu_init_attempts == 0


def test_unported_entry_points_raise(sequence):
    scene, _ = sequence
    t = Tracker(config_from_dict(_cfg_dict(scene, UseSampleFeature=0)),
                device="cpu")
    # two frames a call needs a perception model, the pipeline and the
    # fused BA, as the JAX package asserts
    with pytest.raises(RuntimeError, match="attach_perception"):
        t.track_frames_pair(None, None, None)
    t.attach_perception(SimpleNamespace(device=torch.device("cpu")), "kaist")
    with pytest.raises(ValueError, match="pipelined=True, fused_ba=True"):
        t.track_frames_pair(None, None, None)
    # the full batch is ported (tests/test_torch_full_ba.py); like the JAX
    # package's it refuses light records
    light = Tracker(config_from_dict(_cfg_dict(scene)), device="cpu",
                    fused_ba=True, record="light")
    with pytest.raises(ValueError, match="record='full'"):
        light.run_full_batch()
    # the IMU_RGBD sensor is ported: it builds a VIO tracker
    s = System()
    s.init_from_config(config_from_dict(_cfg_dict(scene)), Sensor.IMU_RGBD,
                       device="cpu")
    assert s.tracker.use_imu and s.scale == 1.0


def test_bad_arguments_raise(sequence):
    scene, seq = sequence
    with pytest.raises(ValueError, match="record"):
        Tracker(config_from_dict(_cfg_dict(scene)), device="cpu",
                record="verbose")
    # the host-assembled window BA reads per-point records
    with pytest.raises(ValueError, match="light"):
        Tracker(config_from_dict(_cfg_dict(scene)), device="cpu",
                record="light")
    with pytest.raises(RuntimeError, match="Init"):
        System().TrackRGBD(None, seq[0].depth, seq[0].flow, seq[0].mask)


def test_cuda_without_card_raises(sequence):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene, _ = sequence
    with pytest.raises(RuntimeError, match="cuda"):
        Tracker(config_from_dict(_cfg_dict(scene)))


def test_kernel_wrapper_refuses_mixed_devices():
    args = [torch.eye(4)[None], torch.eye(4)[None], torch.zeros(5, 3),
            torch.zeros(5, 2), torch.ones(1, 5, dtype=torch.bool)]
    args[0] = args[0].to("meta")
    cam = convert.camera_from_numpy(simple_scene().cam)
    with pytest.raises(ValueError):
        lm_kernel.pose_lm_batched(*args, cam)


@pytest.mark.slow
def test_long_sequence_against_golden():
    """110 frames with object births and deaths: the port's fused-BA
    trajectory stays within 0.02 m of the JAX package's committed golden
    run (the bar of test_long_sequence.py). The golden file is only read."""
    from test_long_sequence import GOLDEN, N_FRAMES as N_LONG
    from test_long_sequence import long_scene, make_config

    scene = long_scene()
    dT = np.asarray(j_make_se3(j_exp_so3(jnp.array([0.0, 0.002, 0.0])),
                               jnp.array([0.015, 0.0, -0.4])))
    seq = SyntheticSequence(scene, [dT], n_frames=N_LONG)
    cfg = config_from_dict(make_config(scene).raw)
    tt = Tracker(cfg, n_bg=1200, n_obj=3000, max_objects=4, seed=0,
                 local_ba=True, fused_ba=True, ba_max_points=600,
                 ba_iters=10, device="cpu")
    for fr in seq.frames:
        tt.track(fr.depth, fr.flow, fr.mask, Tcw_gt=fr.Tcw_gt)
    golden = np.load(GOLDEN)
    poses = np.asarray(tt.map.poses, np.float32)
    assert golden.shape == poses.shape
    drift = np.linalg.norm(poses[:, :3, 3] - golden[:, :3, 3], axis=1)
    assert float(drift.max()) < 0.02, drift.max()
    assert os.path.exists(GOLDEN)
