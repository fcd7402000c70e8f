"""The online path of the port (``models/perception.py``,
``Tracker.attach_perception``/``track_frames``, ``System.AttachPerception``/
``TrackFrames``) against the JAX package, at the JAX package's own test size
(64 x 96 frames, tests/test_perception.py:15-25): seeded BGR frames in
0..255, the same three parameter dicts in the JAX layout given to the JAX
functions and, through ``convert.perception_model_from_numpy``, to the
port.

Bars.
  - Branches: ``PerceptionModel`` against JAX ``perception_forward``
    (``use_pallas=False``; the XLA route computes the same function):
    ``depth_u16`` within 1e-5 x 65536 (the disparity to float32 rounding,
    then a resize and a min-max); the flow within 1e-3 x max(1, max
    |flow|); the mask equal on every pixel that the JAX paste leaves
    unchanged when its threshold moves by 1e-4 (the rule of
    tests/test_torch_maskrcnn.py), class 3's score bias lifted so that
    there are detections.
  - The whole slice: the port's ``System.TrackFrames`` against the JAX
    ``System.TrackFrames`` over 4 frames with FAST on (UseSampleFeature=0),
    every class score bias lowered so that neither detector passes
    anything: poses within 5e-3, the JAX package's own bar for this path
    (tests/test_perception.py:76-85), and maps of equal length.

The port's own plumbing of the online path (``track_frames`` against
``track``) and its refusals are in tests/test_torch_online.py: this file
compiles the JAX perception graph three times (about 60 s of its ~85 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.config import config_from_dict as j_config_from_dict
from vido_slam_tpu.models import layers as j_layers
from vido_slam_tpu.models.maskrcnn import model as jm
from vido_slam_tpu.models.perception import PerceptionModel as JPerception
from vido_slam_tpu.models.perception import perception_forward
from vido_slam_tpu.system import Sensor as JSensor
from vido_slam_tpu.system import System as JSystem
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.models import liteflownet as t_lfn
from vido_slam_tpu_torch.models import monodepth2 as t_md
from vido_slam_tpu_torch.models.maskrcnn import model as t_mm
from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNNConfig
from vido_slam_tpu_torch.system import Sensor, System

torch.set_num_threads(1)

H, W = 64, 96
CLS_BIAS = "roi_heads.box.predictor.cls_score.bias"
CFG = {"Camera.width": W, "Camera.height": H, "Camera.fx": 80.0,
       "Camera.fy": 80.0, "Camera.cx": W / 2, "Camera.cy": H / 2,
       "Camera.bf": 32.0, "ChooseData": 3, "DepthMapFactor": 500,
       "WINDOW_SIZE": 4, "UseSampleFeature": 0}
TRACKER_KW = dict(n_bg=200, n_obj=400, max_objects=2, seed=0, local_ba=True,
                  fused_ba=True, ba_max_points=100, ba_iters=3)


@pytest.fixture(scope="module")
def jax_params():
    """The three parameter dicts in the JAX layout (numpy): the port's
    seeded inits, which draw what the JAX inits draw (conv and fc weights
    N(0, 1/fan_in), zero biases, identity batch norms) from a
    ``torch.Generator``, put in the JAX layout by the JAX package's own
    checkpoint converter (``layers.convert_tensor``). The jitted JAX inits
    would take 30 s of this file's time."""
    gen = torch.Generator().manual_seed(0)
    cfg = MaskRCNNConfig(input_h=H, input_w=W)
    return tuple({k: np.asarray(j_layers.convert_tensor(k, v), np.float32)
                  for k, v in p.items()}
                 for p in (t_md.init_monodepth2_params(gen),
                           t_lfn.init_liteflownet_params(gen),
                           t_mm.init_maskrcnn_params(gen, cfg)))


def with_class_bias(mask_params, value, classes):
    m = dict(mask_params)
    m[CLS_BIAS] = np.array(m[CLS_BIAS])
    m[CLS_BIAS][classes] = value
    return m


@pytest.fixture(scope="module")
def lifted(jax_params):
    """Class 3's score bias at 30, as tests/test_torch_maskrcnn.py."""
    d, f, m = jax_params
    return d, f, with_class_bias(m, 30.0, [3])


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    return [(rng.rand(H, W, 3) * 255).astype(np.float32) for _ in range(5)]


def port_model(params):
    return convert.perception_model_from_numpy(
        H, W, *params, mask_cfg=MaskRCNNConfig(input_h=H, input_w=W),
        device="cpu")


def test_branches_match_jax(lifted, frames):
    cfg = jm.MaskRCNNConfig(input_h=H, input_w=W)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in lifted]
    want = jax.device_get(perception_forward(
        *jp, jnp.asarray(frames[0]), jnp.asarray(frames[1]), height=H,
        width=W, mask_cfg=cfg, use_pallas=False))
    got = port_model(lifted)(frames[0], frames[1])
    assert got.depth_u16.shape == (H, W) and got.flow.shape == (H, W, 2)
    d_err = float(np.abs(got.depth_u16.numpy() - want.depth_u16).max())
    assert d_err <= 1e-5 * 65536
    f_scale = max(1.0, float(np.abs(want.flow).max()))
    f_err = float(np.abs(got.flow.numpy() - want.flow).max())
    assert f_err <= 1e-3 * f_scale
    # the mask: stable pixels of the JAX paste of the JAX detections
    x = jax.image.resize(jnp.asarray(frames[1])[None, :, :, ::-1],
                         (1, H, W, 3), method="bilinear")
    det = jm.maskrcnn_inference(jp[2], x, cfg)
    lo, mid, hi = (np.asarray(jm.paste_semantic_mask(det, H, W, H, W, t))
                   for t in (0.5 - 1e-4, 0.5, 0.5 + 1e-4))
    np.testing.assert_array_equal(mid, want.mask)
    stable = lo == hi
    assert got.mask.dtype == torch.uint8 and got.mask.shape == (H, W)
    assert stable.mean() > 0.95 and (mid > 0).any()
    np.testing.assert_array_equal(got.mask.numpy()[stable], mid[stable])
    print(f"branches {H}x{W}: depth_u16 error {d_err:.3e}, flow error "
          f"{f_err:.3e} of max |flow| {f_scale:.3f}, mask labelled "
          f"{int((mid > 0).sum())} px, stable {100 * stable.mean():.2f} %")


def test_track_frames_matches_jax(jax_params, frames):
    d, f, m = jax_params
    lowered = (d, f, with_class_bias(m, -1e4, slice(1, None)))
    js = JSystem()
    js.init_from_config(j_config_from_dict(CFG), JSensor.RGBD,
                        lm_pallas=False, **TRACKER_KW)
    js.AttachPerception(JPerception(
        H, W, jm.MaskRCNNConfig(input_h=H, input_w=W),
        depth_params=lowered[0], flow_params=lowered[1],
        mask_params=lowered[2], use_pallas=False))
    ts = System()
    ts.init_from_config(config_from_dict(CFG), Sensor.RGBD, device="cpu",
                        **TRACKER_KW)
    model = port_model(lowered)
    ts.AttachPerception(model)
    assert js.tracker.use_fast and ts.tracker.use_fast
    for i in range(4):
        Pj = np.asarray(js.TrackFrames(frames[i], frames[i + 1]))
        Pt = ts.TrackFrames(frames[i], frames[i + 1])
        np.testing.assert_allclose(Pt, Pj, atol=5e-3, err_msg=str(i))
    assert len(ts.map) == len(js.map) == 4
    assert not (model(frames[3], frames[4]).mask > 0).any()
    assert np.isfinite(ts.GetFrameOutput(-1).camera_position).all()
