"""The port's FAST corners (``ops/fast.py``) and the FAST branch of the
background sampler (``frontend/features.py``, ``score_map``) against the
JAX package on the same numpy-seeded gray images, keys and maps, and FAST
in the tracker: ``System.TrackRGBD`` with UseSampleFeature=0 and a BGR
frame (its channel mean is the gray image) against the JAX ``System``.

Bars: every one exact except the poses. The score map is equal bit for
bit at both thresholds (every step is a comparison, an absolute difference
or a sum in circle order); ``detect_fast_features`` gives the same uv,
valid and score; the sampler given a score map the same slots for the same
key (the same threefry draw, the same stable ranks). The tracker's first
frame selects the same features; its poses stay within 1e-3 m and 1e-3 rad
of the JAX tracker's (the bar of tests/test_torch_tracking.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.config import config_from_dict as j_config_from_dict
from vido_slam_tpu.frontend.features import (
    sample_background_features as j_sample_bg)
from vido_slam_tpu.geometry.se3 import make_se3 as j_make_se3
from vido_slam_tpu.geometry.so3 import exp_so3 as j_exp_so3
from vido_slam_tpu.io.synthetic import SyntheticSequence, simple_scene
from vido_slam_tpu.ops import fast as j_fast
from vido_slam_tpu.system import Sensor as JSensor
from vido_slam_tpu.system import System as JSystem
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.frontend.features import sample_background_features
from vido_slam_tpu_torch.ops import fast as t_fast
from vido_slam_tpu_torch.system import Sensor, System

torch.set_num_threads(1)

H, W = 160, 256


def textured_bgr(seed, h=H, w=W):
    """(h, w, 3) float32 BGR in 0..255: 200 seeded rectangles of random
    shades on a mid-gray ground, with 2-level noise, so that FAST finds
    corners at both thresholds and ties among scores."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w, 3), 128.0)
    for _ in range(200):
        y0, x0 = rng.randint(0, h - 4), rng.randint(0, w - 4)
        y1 = min(h, y0 + rng.randint(3, 20))
        x1 = min(w, x0 + rng.randint(3, 20))
        img[y0:y1, x0:x1] = rng.uniform(0, 255, 3)
    img += rng.randint(0, 2, (h, w, 1)) * 3.0
    return np.clip(img, 0, 255).astype(np.float32)


def gray_of(bgr):
    return bgr.mean(axis=-1).astype(np.float32)


@pytest.mark.parametrize("threshold", [20, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_score_map_is_jax_bit_for_bit(seed, threshold):
    g = gray_of(textured_bgr(seed))
    want = np.asarray(j_fast.fast_score_map(jnp.asarray(g),
                                            threshold=threshold))
    got = t_fast.fast_score_map(torch.from_numpy(g), threshold=threshold)
    assert got.dtype == torch.float32
    assert (want > 0).sum() > 100
    np.testing.assert_array_equal(got.numpy(), want)


def test_detect_fast_features_matches_jax():
    g = gray_of(textured_bgr(2))
    kw = dict(n=2000, threshold=20, min_threshold=7, grid=20)
    want = [np.asarray(a) for a in j_fast.detect_fast_features(
        jnp.asarray(g), **kw)]
    got = [a.numpy() for a in t_fast.detect_fast_features(
        torch.from_numpy(g), **kw)]
    assert want[2].sum() > 200 and (~want[2]).any()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sampler_with_score_map_matches_jax():
    rng = np.random.RandomState(3)
    g = gray_of(textured_bgr(3))
    mask = np.zeros((H, W), np.int32)
    mask[40:90, 60:120] = 2
    depth = rng.uniform(1.0, 90.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.1] = 0.0
    flow = rng.normal(0, 3, (H, W, 2)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    score = np.array(j_fast.fast_score_map(jnp.asarray(g)))
    want = j_sample_bg(key, jnp.asarray(mask), jnp.asarray(depth),
                       jnp.asarray(flow), jnp.asarray(score), n=1000,
                       th_depth=80.0)
    got = sample_background_features(
        convert.key_from_numpy(np.asarray(key), "cpu"),
        torch.from_numpy(mask), torch.from_numpy(depth),
        torch.from_numpy(flow), torch.from_numpy(score), n=1000,
        th_depth=80.0)
    assert 200 < int(np.asarray(want.valid).sum()) < 1000
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_track_rgbd_with_fast_matches_jax():
    scene = simple_scene(width=W, height=H, moving_box=True, box_speed=0.6)
    dT = np.asarray(j_make_se3(j_exp_so3(jnp.array([0.0, 0.01, 0.0])),
                               jnp.array([0.02, 0.0, -0.4])))
    seq = SyntheticSequence(scene, [dT], n_frames=3)
    cam = scene.cam
    d = {"Camera.width": W, "Camera.height": H, "Camera.fx": float(cam.fx),
         "Camera.fy": float(cam.fy), "Camera.cx": float(cam.cx),
         "Camera.cy": float(cam.cy), "Camera.bf": float(cam.bf),
         "ThDepthBG": 80.0, "ThDepthOBJ": 60.0, "MaxTrackPointBG": 800,
         "MaxTrackPointOBJ": 800, "WINDOW_SIZE": 6, "ChooseData": 1,
         "DepthMapFactor": 100, "UseSampleFeature": 0}
    kw = dict(n_bg=800, n_obj=2000, max_objects=4, seed=0)
    js = JSystem()
    js.init_from_config(j_config_from_dict(d), JSensor.RGBD, lm_pallas=False,
                        **kw)
    ts = System()
    ts.init_from_config(config_from_dict(d), Sensor.RGBD, device="cpu", **kw)
    assert ts.tracker.use_fast and js.tracker.use_fast
    for k, fr in enumerate(seq.frames):
        raw = fr.depth * 100.0  # OMD raw value: metric * DepthMapFactor
        im = textured_bgr(10 + k)
        Tj = np.asarray(js.TrackRGBD(im, raw, fr.flow, fr.mask,
                                     mTcw_gt=fr.Tcw_gt))
        Tt = ts.TrackRGBD(im, raw, fr.flow, fr.mask, mTcw_gt=fr.Tcw_gt)
        assert np.abs(Tj[:3, 3] - Tt[:3, 3]).max() <= 1e-3, k
        R = Tj[:3, :3].astype(np.float64).T @ Tt[:3, :3]
        assert np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)) <= 1e-3, k
    a, b = js.map.frames[0], ts.map.frames[0]
    assert a.stat_valid.sum() > 100
    np.testing.assert_array_equal(b.stat_uv, a.stat_uv)
    np.testing.assert_array_equal(b.stat_valid, a.stat_valid)
    assert ts.tracker.use_fast and js.tracker.use_fast
