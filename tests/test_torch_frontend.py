"""Frontend of the PyTorch port against the JAX package: the same rendered
frames (JAX's synthetic renderer) and numpy-seeded inputs through both.

Selections, masks and integer results must be identical; float gathers
agree to float32 rounding; the object depth means are scatter-added in
another order and agree to 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.frontend import association as j_assoc
from vido_slam_tpu.frontend import features as j_feat
from vido_slam_tpu.frontend import objects as j_obj
from vido_slam_tpu.frontend import renewal as j_ren
from vido_slam_tpu.frontend import sceneflow as j_sf
from vido_slam_tpu.geometry.se3 import make_se3 as j_make_se3
from vido_slam_tpu.geometry.so3 import exp_so3 as j_exp_so3
from vido_slam_tpu.io.synthetic import SyntheticSequence, simple_scene
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.frontend import association, features, objects
from vido_slam_tpu_torch.frontend import renewal, sceneflow
from vido_slam_tpu_torch.utils import prng

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    scene = simple_scene(width=256, height=160, moving_box=True,
                         box_speed=0.6)
    dT = np.asarray(j_make_se3(j_exp_so3(jnp.array([0.0, 0.01, 0.0])),
                               jnp.array([0.02, 0.0, -0.4])))
    return scene, SyntheticSequence(scene, [dT], n_frames=3)


def _t(x):
    return torch.as_tensor(np.array(x))


def _same_features(t, j, exact_float=False):
    j = jax.device_get(j)
    for name in features.FeatureSet._fields:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        if a.dtype.kind == "f" and not exact_float:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_gathers(frames):
    _, seq = frames
    fr = seq[0]
    uv = np.random.RandomState(0).uniform(-3, 260, (500, 2)).astype(
        np.float32)
    uv[:10] = np.round(uv[:10]) + 0.5  # halfway points: round half to even
    for tf, jf, img in ((features.gather_nearest, j_feat.gather_nearest,
                         fr.mask),
                        (features.gather_depth_bilinear,
                         j_feat.gather_depth_bilinear, fr.depth),
                        (features.gather_bilinear, j_feat.gather_bilinear,
                         fr.flow)):
        np.testing.assert_allclose(tf(_t(img), _t(uv)).numpy(),
                                   np.asarray(jf(jnp.asarray(img),
                                                 jnp.asarray(uv))),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_sample_background_features_same_key(frames, seed):
    _, seq = frames
    fr = seq[0]
    kj = jax.random.split(jax.random.PRNGKey(seed))[1]
    kt = prng.split(prng.PRNGKey(seed))[1]
    j = j_feat.sample_background_features(
        kj, jnp.asarray(fr.mask), jnp.asarray(fr.depth), jnp.asarray(fr.flow),
        None, n=700, th_depth=80.0)
    t = features.sample_background_features(
        kt, _t(fr.mask), _t(fr.depth), _t(fr.flow), n=700, th_depth=80.0)
    _same_features(t, j, exact_float=True)


def test_sample_object_points(frames):
    _, seq = frames
    fr = seq[1]
    for n in (50, 3000):
        j = j_feat.sample_object_points(jnp.asarray(fr.mask),
                                        jnp.asarray(fr.depth),
                                        jnp.asarray(fr.flow), n=n)
        t = features.sample_object_points(_t(fr.mask), _t(fr.depth),
                                          _t(fr.flow), n=n)
        _same_features(t, j, exact_float=True)


def test_propagate_features(frames):
    _, seq = frames
    f0, f1 = seq[0], seq[1]
    j0 = j_feat.sample_object_points(jnp.asarray(f0.mask),
                                     jnp.asarray(f0.depth),
                                     jnp.asarray(f0.flow), n=1500)
    j = j_feat.propagate_features(j0, jnp.asarray(f1.depth),
                                  jnp.asarray(f1.mask), jnp.asarray(f1.flow),
                                  th_depth=60.0)
    t = features.propagate_features(
        convert.feature_set_from_numpy(jax.device_get(j0), "cpu"), _t(f1.depth),
        _t(f1.mask), _t(f1.flow), th_depth=60.0)
    _same_features(t, j)


def test_update_mask_recovers_and_keeps(frames):
    _, seq = frames
    f0, f1 = seq[0], seq[1]
    cur = f1.mask.copy()
    cur[cur == 2] = 0  # the detector misses the box this frame
    for c in (cur, f1.mask):
        j = j_assoc.update_mask(jnp.asarray(c), jnp.asarray(f0.mask),
                                jnp.asarray(f0.flow))
        t = association.update_mask(_t(c), _t(f0.mask), _t(f0.flow))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (t.numpy() == 2).any()


def test_scene_flow_and_object_stats(frames):
    scene, seq = frames
    f0, f1 = seq[0], seq[1]
    jcam = scene.cam
    cam = convert.camera_from_numpy(jcam)
    j0 = j_feat.sample_object_points(jnp.asarray(f0.mask),
                                     jnp.asarray(f0.depth),
                                     jnp.asarray(f0.flow), n=1500)
    j1 = j_feat.propagate_features(j0, jnp.asarray(f1.depth),
                                   jnp.asarray(f1.mask), jnp.asarray(f1.flow),
                                   th_depth=60.0)
    T0, T1 = jnp.asarray(f0.Tcw_gt), jnp.asarray(f1.Tcw_gt)
    jf, jn, jok = j_sf.scene_flow_world(jcam, j0.uv, j0.depth, T0, j1.uv,
                                        j1.depth, T1, j0.sem, j1.sem,
                                        j0.valid & j1.valid)
    t0 = convert.feature_set_from_numpy(jax.device_get(j0), "cpu")
    t1 = convert.feature_set_from_numpy(jax.device_get(j1), "cpu")
    tf, tn, tok = sceneflow.scene_flow_world(
        cam, t0.uv, t0.depth, _t(f0.Tcw_gt), t1.uv, t1.depth, _t(f1.Tcw_gt),
        t0.sem, t1.sem, t0.valid & t1.valid)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-5)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    kw = dict(height=160, width=256, sf_mg_thres=0.12, sf_ds_thres=0.3,
              th_depth_obj=60.0)
    js = j_obj.compute_object_stats(j1.uv, j1.sem, j0.sem, jn, j1.depth, jok,
                                    **kw)
    ts = objects.compute_object_stats(t1.uv, t1.sem, t0.sem, tn, t1.depth,
                                      tok, **kw)
    for name in objects.ObjectStats._fields:
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        if name == "mean_depth":
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert ts.is_tracked[2]
    ids = np.arange(objects.MAX_SEM, dtype=np.int32) * 3
    np.testing.assert_array_equal(
        objects.assign_point_labels(t1.sem, tok, ts, _t(ids)).numpy(),
        np.asarray(j_obj.assign_point_labels(j1.sem, jok, js,
                                             jnp.asarray(ids))))
    # host id bookkeeping over two frames, with a failure in between
    jt, tt = j_obj.ObjectTracker(), objects.ObjectTracker()
    hj, ht = jax.device_get(js), ts
    for _ in range(2):
        a, b = tt.assign_ids(ht), jt.assign_ids(hj)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == [tuple(o) for o in b[1]]
        tt.mark_failed(2)
        jt.mark_failed(2)


def test_renew_features(frames):
    _, seq = frames
    f0, f1 = seq[0], seq[1]
    rng = np.random.RandomState(2)
    kj = jax.random.PRNGKey(4)
    jbg = j_feat.sample_background_features(
        kj, jnp.asarray(f0.mask), jnp.asarray(f0.depth),
        jnp.asarray(f0.flow), None, n=600)
    jcur = j_feat.propagate_features(jbg, jnp.asarray(f1.depth),
                                     jnp.asarray(f1.mask),
                                     jnp.asarray(f1.flow))
    jfresh = j_feat.sample_background_features(
        jax.random.PRNGKey(9), jnp.asarray(f1.mask), jnp.asarray(f1.depth),
        jnp.asarray(f1.flow), None, n=600)
    inl = rng.rand(600) < 0.7
    jr, jnew = j_ren.renew_features(jcur, jnp.asarray(inl), jfresh,
                                    height=160, width=256)
    tr, tnew = renewal.renew_features(
        convert.feature_set_from_numpy(jax.device_get(jcur), "cpu"), _t(inl),
        convert.feature_set_from_numpy(jax.device_get(jfresh), "cpu"),
        height=160, width=256)
    _same_features(tr, jr, exact_float=True)
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
