"""The slice as a whole: the port's ``_track_step``, ``Tracker`` and
``System`` on the CPU against the JAX package on the same rendered frames
and seed.

Tolerances: one step from the same converted state must reproduce the JAX
step's selections, masks and counts exactly and its floats to float32
rounding (poses 1e-5, BA points 1e-4); a 6-frame run keeps every
per-frame pose within 1e-3 m and 1e-3 rad of the JAX ``Tracker`` (its
``lm_solve`` path, ``lm_pallas=False``) and the same per-object ``obj_ok``
flags."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.config import config_from_dict as j_config_from_dict
from vido_slam_tpu.geometry.se3 import make_se3 as j_make_se3
from vido_slam_tpu.geometry.so3 import exp_so3 as j_exp_so3
from vido_slam_tpu.io.synthetic import SyntheticSequence, simple_scene
from vido_slam_tpu.system import Sensor as JSensor
from vido_slam_tpu.system import System as JSystem
from vido_slam_tpu.tracking import Tracker as JTracker
from vido_slam_tpu.tracking import _track_step as j_track_step
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.estimation import lm_kernel
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


TRACKER_KW = dict(n_bg=1200, n_obj=3000, max_objects=4, seed=0,
                  fused_ba=True)


@pytest.fixture(scope="module")
def sequence():
    scene = simple_scene(width=256, height=160, moving_box=True,
                         box_speed=0.6)
    dT = np.asarray(j_make_se3(j_exp_so3(jnp.array([0.0, 0.01, 0.0])),
                               jnp.array([0.02, 0.0, -0.4])))
    return scene, SyntheticSequence(scene, [dT], n_frames=N_FRAMES)


@pytest.fixture(scope="module")
def jax_run(sequence):
    scene, seq = sequence
    jt = JTracker(j_config_from_dict(_cfg_dict(scene)), lm_pallas=False,
                  **TRACKER_KW)
    states = []
    for fr in seq.frames:
        jt.track(fr.depth, fr.flow, fr.mask, Tcw_gt=fr.Tcw_gt)
        states.append(jax.device_get(jt.state))
    return jt, states


@pytest.fixture(scope="module")
def port_run(sequence):
    scene, seq = sequence
    tt = Tracker(config_from_dict(_cfg_dict(scene)), device="cpu",
                 **TRACKER_KW)
    before = lm_kernel.pose_lm_batched.launches
    for fr in seq.frames:
        tt.track(fr.depth, fr.flow, fr.mask, Tcw_gt=fr.Tcw_gt)
    return tt, lm_kernel.pose_lm_batched.launches - before


def _rot_err(A, B):
    R = np.asarray(A, np.float64)[:3, :3].T @ np.asarray(B, np.float64)[:3, :3]
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(w))))


def _compare(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind == "f":
        atol = 1e-4 if name in ("ba_points", "obj_centroid",
                                "mean_depth") else 2e-5
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-5,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_one_track_step_from_converted_state(sequence, jax_run):
    """Frame 3 from the JAX tracker's state after frame 2, in both."""
    scene, seq = sequence
    jt, states = jax_run
    fr = seq[3]
    kw = dict(n_bg=1200, n_obj=3000, max_objects=4, th_depth_bg=80.0,
              th_depth_obj=60.0, sf_mg_thres=0.12, sf_ds_thres=0.3,
              height=160, width=256, fused_ba=True, ba_window=6,
              ba_points=1000, ba_iters=15, record_light=False)
    jstep = jax.jit(lambda s, d, f, m: j_track_step(
        s, d, f, m, jnp.zeros((160, 256)), jt.cam, use_fast=False,
        joint_flow=False, lm_pallas=False, **kw))
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
            _compare(name, getattr(tout, name), getattr(jout, name))
    for name in tstate._fields:
        t, j = getattr(tstate, name), getattr(jstate, name)
        if name in ("stat", "obj"):
            for f in t._fields:
                _compare(f"{name}.{f}", getattr(t, f), getattr(j, f))
        elif name == "key":
            np.testing.assert_array_equal(t, np.asarray(j, np.int64))
        else:
            _compare(name, t, j)


def test_whole_slice_matches_jax_tracker(sequence, jax_run, port_run):
    jt, _ = jax_run
    tt, launches = port_run
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
    # the CPU run never reaches the kernel
    assert launches == 0


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


@pytest.mark.parametrize("kw,what", [
    (dict(joint_flow=True), "joint_flow"),
    (dict(use_imu=True), "use_imu"),
    (dict(pipelined=True), "pipelined"),
    (dict(fused_ba=False), "host-assembled"),
])
def test_unported_modes_raise(sequence, kw, what):
    scene, _ = sequence
    with pytest.raises(NotImplementedError, match=what):
        Tracker(config_from_dict(_cfg_dict(scene)), device="cpu", **kw)


def test_unported_entry_points_raise(sequence):
    scene, seq = sequence
    fr = seq[0]
    t = Tracker(config_from_dict(_cfg_dict(scene, UseSampleFeature=0)),
                device="cpu")
    with pytest.raises(NotImplementedError, match="FAST"):
        t.track(fr.depth, fr.flow, fr.mask, image=fr.depth)
    with pytest.raises(NotImplementedError, match="perception"):
        t.attach_perception(None, "kaist")
    with pytest.raises(NotImplementedError, match="full-batch"):
        t.run_full_batch()
    with pytest.raises(NotImplementedError, match="VIO"):
        System().init_from_config(config_from_dict(_cfg_dict(scene)),
                                  Sensor.IMU_RGBD, device="cpu")


def test_bad_arguments_raise(sequence):
    scene, seq = sequence
    with pytest.raises(ValueError, match="record"):
        Tracker(config_from_dict(_cfg_dict(scene)), device="cpu",
                record="verbose")
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
