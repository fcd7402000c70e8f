"""The port's online path on its own (``Tracker.attach_perception``/
``track_frames``, ``System.AttachPerception``/``TrackFrames``,
``PerceptionModel``) at 64 x 96 on seeded BGR frames in 0..255, with the
port's seeded networks (class 3's score bias lifted to 30, so that the
detector labels pixels and objects are tracked). The comparison with the
JAX package is tests/test_torch_perception.py.

Bars: exact. ``track_frames`` equals, bit for bit, ``track`` on
``make_slam_forward``'s outputs with the online step's gray image (FAST on,
UseSampleFeature=0): the first frame initialises from the perception alone
without the gray image, later frames take 0.299 R + 0.587 G + 0.114 B of the
current frame. ``TrackFramesPair`` refuses a tracker without the pipeline;
``TrackFrames`` before ``AttachPerception`` and
``AttachPerception`` before ``Init`` raise ``RuntimeError``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNNConfig
from vido_slam_tpu_torch.models.perception import PerceptionModel
from vido_slam_tpu_torch.system import Sensor, System
from vido_slam_tpu_torch.tracking import Tracker, bgr_to_gray

torch.set_num_threads(1)

H, W = 64, 96
CFG = {"Camera.width": W, "Camera.height": H, "Camera.fx": 80.0,
       "Camera.fy": 80.0, "Camera.cx": W / 2, "Camera.cy": H / 2,
       "Camera.bf": 32.0, "ChooseData": 3, "DepthMapFactor": 500,
       "WINDOW_SIZE": 4, "UseSampleFeature": 0}
TRACKER_KW = dict(n_bg=200, n_obj=400, max_objects=2, seed=0, local_ba=True,
                  fused_ba=True, ba_max_points=100, ba_iters=3)


@pytest.fixture(scope="module")
def model():
    m = PerceptionModel(H, W, MaskRCNNConfig(input_h=H, input_w=W), seed=0,
                        device="cpu")
    with torch.no_grad():
        m.mask_model.roi_heads.box.predictor.cls_score.bias[3] = 30.0
    return m


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    return [(rng.rand(H, W, 3) * 255).astype(np.float32) for _ in range(4)]


def test_track_frames_is_track_on_slam_forward(model, frames):
    cfg = config_from_dict(CFG)
    # full records: the per-point slots of every frame are compared too
    online, offline = (Tracker(cfg, device="cpu", record="full",
                               **TRACKER_KW) for _ in range(2))
    online.attach_perception(model, "kaist", cfg.system.depth_map_factor,
                             cfg.camera.bf)
    perceive = model.make_slam_forward("kaist", cfg.system.depth_map_factor,
                                       cfg.camera.bf)
    offline.initialize(*perceive(frames[0], frames[1]))
    online.track_frames(frames[0], frames[1])
    labelled = 0
    for i in range(1, 3):
        depth, flow, mask = perceive(frames[i], frames[i + 1])
        labelled += int((mask > 0).sum())
        gray = bgr_to_gray(torch.from_numpy(frames[i + 1]))
        np.testing.assert_array_equal(
            online.track_frames(frames[i], frames[i + 1]),
            offline.track(depth, flow, mask, image=gray))
    assert labelled > 0 and online.use_fast and offline.use_fast
    assert online.map.frames[-1].obj_valid.any()
    assert len(online.map) == len(offline.map) == 3
    for a, b in zip(online.map.frames, offline.map.frames):
        assert a.timestamp == b.timestamp
        for f in ("Tcw", "stat_uv", "stat_valid", "obj_uv", "obj_sem"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)


def test_system_track_frames(model, frames):
    ts = System()
    ts.init_from_config(config_from_dict(CFG), Sensor.RGBD, device="cpu",
                        **TRACKER_KW)
    with pytest.raises(RuntimeError, match="attach_perception"):
        ts.TrackFrames(frames[0], frames[1])
    ts.AttachPerception(model)
    for i in range(2):
        P = ts.TrackFrames(frames[i], frames[i + 1], timestamp=i / 10.0,
                           imu_measurements=[object()])
        assert np.isfinite(P).all()
    out = ts.GetFrameOutput(-1)
    assert out.timestamp == 0.1 and np.isfinite(out.camera_position).all()


def test_unported_options_raise():
    """TrackFramesPair is ported (tests/test_torch_pipelined.py) and
    refuses a tracker without the pipeline, as the JAX package asserts.
    The dtype options are ported (tests/test_torch_bf16.py); a dtype other
    than float32 or bfloat16 raises."""
    for kw in ("compute_dtype", "mask_dtype", "flow_dtype"):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            PerceptionModel(H, W, device="cpu", **{kw: torch.float16})
    ts = System()
    ts.init_from_config(config_from_dict(CFG), Sensor.RGBD, device="cpu",
                        **TRACKER_KW)
    ts.AttachPerception(SimpleNamespace(device=torch.device("cpu")))
    with pytest.raises(ValueError, match="pipelined=True, fused_ba=True"):
        ts.TrackFramesPair(None, None, None)
    with pytest.raises(RuntimeError, match="Init"):
        System().AttachPerception(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PerceptionModel(H, W)
