"""The port's FBNet detectors (``models/maskrcnn/fbnet.py``) against the
JAX package's, on the same numpy-seeded inputs and the JAX parameters
carried across by ``convert.maskrcnn_state_dict_from_numpy``
(tests/test_fbnet.py's cases: the IRF block with and without its residual,
every registered arch's trunk, ``fbnet_inference``).

Bars: the IRF blocks and trunks within 1e-4 of their output's magnitude;
``fbnet_inference`` at 128 x 160 with equal validity and labels, boxes
within 5e-3 px (the GN detector's bar) and scores within 1e-5. Random
weights leave every class near 1/81, so class 3's score bias is lifted to
30 in both packages: its probability is then exactly 1.0 (ties that
float32 noise cannot reorder). The detector's images are 0..0.01: at
init the net has no bias and zero BN means, so its outputs scale with the
image, and nothing renormalises them as trained BN statistics would; on a
0..1 image the RPN deltas reach 52, the decoded boxes collapse onto the
image's border (median width 0 px) and the box decode multiplies the
deltas' float32 noise by the anchors' widths (9.6e-3 px against JAX). At
0.01 the boxes are 27-42 px wide and agree to 8e-5 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.models.maskrcnn import fbnet as jf
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models.maskrcnn import fbnet as tf

torch.set_num_threads(1)

H, W = 128, 160
LIFT = 30.0
IMAGE_SCALE = 0.01


def nchw(a):
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def close_to_scale(got, want, rel):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rel * scale, (err, scale)
    return err


def params(arch, seed=0, stats=False):
    """The port's seeded init in the JAX layout (numpy), optionally with BN
    statistics away from the init's identity, as a trained net has them.
    (Drawn by the port: the JAX init compiles for ~10 s an arch; its keys
    and shapes are checked against the port's below.)"""
    init = tf.init_fbnet_params(torch.Generator().manual_seed(seed), arch)
    p = convert.convert_state_dict(init)
    if stats:
        rng = np.random.RandomState(seed + 1)
        for k in p:
            if k.endswith("bn.running_mean"):
                p[k] = rng.uniform(-0.3, 0.3, p[k].shape).astype(np.float32)
            elif k.endswith("bn.running_var"):
                p[k] = rng.uniform(0.5, 1.5, p[k].shape).astype(np.float32)
    return p


def port_model(arch, p):
    m = tf.FBNet(arch, device="cpu")
    m.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
        p, device="cpu"), strict=True)
    return m


@pytest.mark.parametrize("cin,cout,t,stride,k", [(16, 16, 6, 1, 3),
                                                 (16, 24, 6, 2, 3),
                                                 (24, 24, 4, 1, 7),
                                                 (32, 48, 5, 2, 5)])
def test_irf_block_matches_jax(cin, cout, t, stride, k):
    rng = np.random.RandomState(cin + k)
    mid = cin * t
    p = {}
    for name, a, b, kk, g in (("pw", cin, mid, 1, 1), ("dw", mid, mid, k, mid),
                              ("pwl", mid, cout, 1, 1)):
        p[f"b.{name}.conv.weight"] = (rng.randn(kk, kk, a // g, b)
                                      * (2.0 / (kk * kk * a // g)) ** 0.5
                                      ).astype(np.float32)
        p[f"b.{name}.bn.weight"] = rng.uniform(0.5, 1.5, b).astype(np.float32)
        p[f"b.{name}.bn.bias"] = rng.uniform(-0.2, 0.2, b).astype(np.float32)
        p[f"b.{name}.bn.running_mean"] = rng.uniform(-0.3, 0.3, b).astype(
            np.float32)
        p[f"b.{name}.bn.running_var"] = rng.uniform(0.5, 1.5, b).astype(
            np.float32)
    x = rng.randn(1, 10, 12, cin).astype(np.float32)
    want = np.asarray(jf.irf_block({k_: jnp.asarray(v) for k_, v in p.items()},
                                   "b", jnp.asarray(x), cin, cout, t, stride))
    block = tf.IRFBlock(cin, cout, t, stride, k)
    block.load_state_dict({k_[2:]: v for k_, v in
                           convert.maskrcnn_state_dict_from_numpy(
                               p, device="cpu").items()}, strict=True)
    assert block.residual == (stride == 1 and cin == cout)
    with torch.no_grad():
        got = nhwc(block(nchw(x)))
    assert got.shape == want.shape
    close_to_scale(got, want, 1e-4)


@pytest.mark.parametrize("arch", list(jf.MODEL_ARCH))
def test_trunk_matches_jax(arch):
    """Every registered arch: the trunk at stride 16, its width, the
    depthwise kernel sizes in the stored weights, and the init's keys and
    shapes against the JAX init's."""
    assert tf.MODEL_ARCH[arch] == jf.MODEL_ARCH[arch]
    p = params(arch, stats=True)
    shapes = jax.eval_shape(lambda k: jf.init_fbnet_params(k, arch),
                            jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in shapes.items()} == \
        {k: v.shape for k, v in p.items()}
    model = port_model(arch, p)
    x = np.random.RandomState(1).uniform(0, 1, (1, 64, 80, 3)).astype(
        np.float32)
    want = np.asarray(jf.fbnet_trunk({k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x), arch))
    with torch.no_grad():
        got = nhwc(tf.fbnet_trunk(model, nchw(x)))
    assert got.shape == (1, 4, 5, jf.MODEL_ARCH[arch].backbone[-1][-1][1])
    err = close_to_scale(got, want, 1e-4)
    print(f"{arch}: trunk error {err:.2e} of {np.abs(want).max():.1f}")
    assert hasattr(model.rpn, "stage") == (arch != "mobilenet_v2")
    if arch == "cham_v1a":
        sd = model.state_dict()
        assert sd["backbone.stage1.0.dw.conv.weight"].shape[-1] == 7
        assert sd["backbone.stage3.0.dw.conv.weight"].shape[-1] == 5
        assert sd["backbone.stage3.7.dw.conv.weight"].shape[-1] == 3


@pytest.mark.parametrize("arch", ["default", "mobilenet_v2"])
def test_fbnet_inference_matches_jax(arch):
    p = params(arch)
    p["bbox.cls_score.bias"][3] = LIFT
    img = np.random.RandomState(1).uniform(0, IMAGE_SCALE, (1, H, W, 3)) \
        .astype(np.float32)
    want = jax.tree_util.tree_map(np.asarray, jf.fbnet_inference(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(img), H, W,
        arch=arch))
    got = tf.fbnet_inference(port_model(arch, p), nchw(img), H, W)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    v = want.valid
    assert v.sum() >= 10 and set(want.labels[v]) == {3}
    assert np.median(want.boxes[v, 2] - want.boxes[v, 0]) > 10
    err = float(np.abs(got.boxes.numpy()[v] - want.boxes[v]).max())
    print(f"{arch}: {int(v.sum())} detections, box error {err:.3e} px")
    assert err <= 5e-3
    np.testing.assert_allclose(got.scores.numpy()[v], want.scores[v],
                               atol=1e-5, rtol=0)


def test_pooler_is_one_level_of_the_multilevel_roi_align(monkeypatch):
    """The box head pools through ``roi_align_multilevel`` once, one level,
    every ROI at level 0, 6 x 6 on the trunk at 1/16."""
    calls = []

    def spy(feats, rois, levels, scales, res, ratio):
        calls.append((len(feats), int(levels.abs().sum()), tuple(scales),
                      res, ratio, rois.shape))
        return real(feats, rois, levels, scales, res, ratio)

    real = tf.roi_align_multilevel
    monkeypatch.setattr(tf, "roi_align_multilevel", spy)
    model = tf.FBNet("default", device="cpu")
    img = torch.rand(1, 3, 64, 96) * 255
    det = tf.fbnet_inference(model, img, 64, 96)
    assert calls == [(1, 0, (1 / 16,), 6, 2, (200, 4))]
    assert det.boxes.shape == (100, 4) and det.labels.dtype == torch.int64
    with pytest.raises(ValueError):
        tf.fbnet_inference(model, img, 64, 64)
