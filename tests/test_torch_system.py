"""The port's ``System`` and ``Tracker`` take the JAX package's arguments:
``lm_pallas`` and the three ``imu_*`` arguments build in both packages; an
RGBD system given IMU measurements ignores them, as the JAX one does, and
tracks the same poses; an IMU_RGBD system queues them and tracks the JAX
one's poses (the init's gates stay shut over 3 frames; tests/test_torch_vio.py
runs the init)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.config import config_from_dict as j_config_from_dict
from vido_slam_tpu.geometry.se3 import make_se3 as j_make_se3
from vido_slam_tpu.geometry.so3 import exp_so3 as j_exp_so3
from vido_slam_tpu.io.synthetic import SyntheticSequence, simple_scene
from vido_slam_tpu.system import ImuPoint
from vido_slam_tpu.system import Sensor as JSensor
from vido_slam_tpu.system import System as JSystem
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.system import Sensor, System
from vido_slam_tpu_torch.tracking import Tracker

torch.set_num_threads(1)

N_FRAMES = 3
JAX_TRACKER_KW = dict(n_bg=1200, n_obj=3000, max_objects=4, seed=0,
                      imu_max_frames=32, imu_max_segments=64,
                      imu_init_stride=3)


@pytest.fixture(scope="module")
def sequence():
    scene = simple_scene(width=256, height=160, moving_box=True,
                         box_speed=0.6)
    dT = np.asarray(j_make_se3(j_exp_so3(jnp.array([0.0, 0.01, 0.0])),
                               jnp.array([0.02, 0.0, -0.4])))
    return scene, SyntheticSequence(scene, [dT], n_frames=N_FRAMES)


def _cfg_dict(scene):
    cam = scene.cam
    return {"Camera.width": cam.width, "Camera.height": cam.height,
            "Camera.fx": float(cam.fx), "Camera.fy": float(cam.fy),
            "Camera.cx": float(cam.cx), "Camera.cy": float(cam.cy),
            "Camera.bf": float(cam.bf), "ThDepthBG": 80.0,
            "ThDepthOBJ": 60.0, "MaxTrackPointBG": 1200,
            "MaxTrackPointOBJ": 800, "WINDOW_SIZE": 6, "ChooseData": 1,
            "DepthMapFactor": 100}


def _imu(k):
    """Ten seeded IMU samples of the 0.1 s before frame k."""
    rng = np.random.RandomState(k)
    return [ImuPoint(a=rng.normal(0, 0.1, 3) + [0.0, 9.81, 0.0],
                     w=rng.normal(0, 0.01, 3), t=0.1 * (k - 1) + 0.01 * i)
            for i in range(1, 11)]


@pytest.mark.parametrize("lm_pallas", [False, True, None])
def test_init_takes_the_jax_tracker_arguments(sequence, lm_pallas):
    scene, _ = sequence
    d = _cfg_dict(scene)
    js = JSystem()
    js.init_from_config(j_config_from_dict(d), JSensor.RGBD,
                        lm_pallas=lm_pallas, **JAX_TRACKER_KW)
    ts = System()
    ts.init_from_config(config_from_dict(d), Sensor.RGBD, device="cpu",
                        lm_pallas=lm_pallas, **JAX_TRACKER_KW)
    assert ts.tracker.n_obj == js.tracker.n_obj == 3000
    assert not ts.tracker.fused_ba and not js.tracker.fused_ba


def test_rgbd_system_ignores_imu_measurements(sequence):
    """Frames with IMU measurements on an RGBD system: the same poses as the
    JAX package's (1e-3 m, 1e-3 rad), and as the port's without them."""
    scene, seq = sequence
    d = _cfg_dict(scene)
    js = JSystem()
    js.init_from_config(j_config_from_dict(d), JSensor.RGBD,
                        lm_pallas=False, **JAX_TRACKER_KW)
    ts, plain = System(), System()
    ts.init_from_config(config_from_dict(d), Sensor.RGBD, device="cpu",
                        lm_pallas=False, **JAX_TRACKER_KW)
    plain.init_from_config(config_from_dict(d), Sensor.RGBD, device="cpu")
    for k, fr in enumerate(seq.frames):
        raw = fr.depth * 100.0  # OMD raw value: metric * DepthMapFactor
        imu = _imu(k)
        Tj = np.asarray(js.TrackRGBD(None, raw, fr.flow, fr.mask,
                                     mTcw_gt=fr.Tcw_gt, timestamp=0.1 * k,
                                     imu_measurements=imu))
        Tt = ts.TrackRGBD(None, raw, fr.flow, fr.mask, mTcw_gt=fr.Tcw_gt,
                          timestamp=0.1 * k, imu_measurements=imu)
        Tp = plain.TrackRGBD(None, raw, fr.flow, fr.mask, mTcw_gt=fr.Tcw_gt,
                             timestamp=0.1 * k)
        assert np.abs(Tj[:3, 3] - Tt[:3, 3]).max() <= 1e-3, k
        R = Tj[:3, :3].astype(np.float64).T @ Tt[:3, :3]
        assert np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)) <= 1e-3, k
        np.testing.assert_array_equal(Tt, Tp)
    assert js.tracker._imu_queue == [] and js.scale == 1.0


def test_vio_is_accepted_and_runs(sequence):
    """``Tracker(use_imu=True)`` and an IMU_RGBD ``System`` build; the system
    queues the measurements and tracks the JAX IMU_RGBD system's poses
    (1e-3 m, 1e-3 rad) at scale 1, one preintegration a tracked frame."""
    scene, seq = sequence
    d = _cfg_dict(scene)
    assert Tracker(config_from_dict(d), device="cpu", use_imu=True,
                   imu_max_frames=32).use_imu
    js, ts = JSystem(), System()
    js.init_from_config(j_config_from_dict(d), JSensor.IMU_RGBD,
                        lm_pallas=False, **JAX_TRACKER_KW)
    ts.init_from_config(config_from_dict(d), Sensor.IMU_RGBD, device="cpu",
                        lm_pallas=False, **JAX_TRACKER_KW)
    for k, fr in enumerate(seq.frames):
        raw = fr.depth * 100.0
        imu = _imu(k)
        Tj = np.asarray(js.TrackRGBD(None, raw, fr.flow, fr.mask,
                                     mTcw_gt=fr.Tcw_gt, timestamp=0.1 * k,
                                     imu_measurements=imu))
        Tt = ts.TrackRGBD(None, raw, fr.flow, fr.mask, mTcw_gt=fr.Tcw_gt,
                          timestamp=0.1 * k, imu_measurements=imu)
        assert np.abs(Tj[:3, 3] - Tt[:3, 3]).max() <= 1e-3, k
        R = Tj[:3, :3].astype(np.float64).T @ Tt[:3, :3]
        assert np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)) <= 1e-3, k
    assert len(ts.tracker._preints) == len(js.tracker._preints) == 2
    assert len(ts.tracker._imu_queue) == len(js.tracker._imu_queue) > 0
    assert ts.scale == js.scale == 1.0
