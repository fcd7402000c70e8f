"""The online path as IMU_RGBD: the port's ``System.TrackFrames`` against
the JAX package's on the CPU, at tests/test_torch_perception.py's 64x96
size with random nets (every class bias lowered), past the inertial init's
gates (22 calls, 2.1 s), with the analytic IMU of ``driving_imu`` up to
each call's timestamp.

Bars: the same init attempts and initialized flags call by call, each
call's depth converted at the live IMU scale, finite poses, and poses within
5e-3 over the first 4 calls, test_torch_perception.py's bar for the online
path (random nets' tracking parts later, in the RGBD mode as well)."""

import numpy as np
import torch

from test_torch_perception import (CFG as ONLINE_CFG, H as OH,
                                   TRACKER_KW as ONLINE_KW, W as OW,
                                   port_model, with_class_bias)
from vido_slam_tpu.config import config_from_dict as j_config_from_dict
from vido_slam_tpu.models import layers as j_layers
from vido_slam_tpu.models.maskrcnn import model as jm
from vido_slam_tpu.models.perception import PerceptionModel as JPerception
from vido_slam_tpu.system import ImuPoint as JImuPoint
from vido_slam_tpu.system import Sensor as JSensor
from vido_slam_tpu.system import System as JSystem
from vido_slam_tpu_torch import tracking as t_tracking
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.geometry.camera import convert_depth
from vido_slam_tpu_torch.io.synthetic import driving_imu
from vido_slam_tpu_torch.models import liteflownet as t_lfn
from vido_slam_tpu_torch.models import monodepth2 as t_md
from vido_slam_tpu_torch.models.maskrcnn import model as t_mm
from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNNConfig
from vido_slam_tpu_torch.system import ImuPoint, Sensor, System

torch.set_num_threads(1)


def test_track_frames_imu_rgbd_matches_jax(monkeypatch):
    """The online path as IMU_RGBD past the init's gates (10 frames, 2 s).
    The random nets' depth has no metric structure, so what the two inits
    recover there is not compared; that they run on the same calls is, and
    that each call's depth converts at the live IMU scale."""
    used = []

    def recording(*args, scale, **kw):
        used.append(float(scale))
        return convert_depth(*args, scale=scale, **kw)

    monkeypatch.setattr(t_tracking, "convert_depth", recording)
    gen = torch.Generator().manual_seed(0)
    d, f, m = ({k: np.asarray(j_layers.convert_tensor(k, v), np.float32)
                for k, v in p.items()}
               for p in (t_md.init_monodepth2_params(gen),
                         t_lfn.init_liteflownet_params(gen),
                         t_mm.init_maskrcnn_params(
                             gen, MaskRCNNConfig(input_h=OH, input_w=OW))))
    lowered = (d, f, with_class_bias(m, -1e4, slice(1, None)))
    js = JSystem()
    js.init_from_config(j_config_from_dict(ONLINE_CFG), JSensor.IMU_RGBD,
                        lm_pallas=False, **ONLINE_KW)
    js.AttachPerception(JPerception(
        OH, OW, jm.MaskRCNNConfig(input_h=OH, input_w=OW),
        depth_params=lowered[0], flow_params=lowered[1],
        mask_params=lowered[2], use_pallas=False))
    ts = System()
    ts.init_from_config(config_from_dict(ONLINE_CFG), Sensor.IMU_RGBD,
                        device="cpu", **ONLINE_KW)
    ts.AttachPerception(port_model(lowered))
    rng = np.random.RandomState(0)
    frames = [(rng.rand(OH, OW, 3) * 255).astype(np.float32)
              for _ in range(23)]
    imu_t = 0.0
    attempts, scales = [], []
    for i in range(22):
        t = i / 10.0
        ts_ = np.arange(imu_t + 0.005, t + 1e-9, 0.005)
        acc, gyro = driving_imu(ts_)
        if len(ts_):
            imu_t = float(ts_[-1])
        Pj = np.asarray(js.TrackFrames(
            frames[i], frames[i + 1], timestamp=t,
            imu_measurements=[JImuPoint(a=a, w=w, t=float(tt))
                              for a, w, tt in zip(acc, gyro, ts_)]))
        Pt = ts.TrackFrames(frames[i], frames[i + 1], timestamp=t,
                            imu_measurements=[ImuPoint(a=a, w=w, t=float(tt))
                                              for a, w, tt in
                                              zip(acc, gyro, ts_)])
        if i < 4:
            np.testing.assert_allclose(Pt, Pj, atol=5e-3, err_msg=str(i))
        assert np.isfinite(Pt).all()
        assert (ts.tracker.imu_init_attempts
                == js.tracker.imu_init_attempts), i
        assert (ts.tracker.imu_initialized
                == js.tracker.imu_initialized), i
        attempts.append(ts.tracker.imu_init_attempts)
        scales.append(np.float32(ts.tracker.imu_scale))
    # the gate opens at call 20 (t = 2.0 s)
    assert attempts[:20] == [0] * 20 and attempts[20] == 1
    assert len(ts.tracker._preints) == 21
    # calls 1-21 convert their depth at the scale the previous call left
    assert used == [float(x) for x in scales[:-1]]
    assert ts.scale == ts.tracker.imu_scale
