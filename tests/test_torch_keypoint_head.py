"""The port's Keypoint R-CNN head (``models/maskrcnn/keypoint_head.py``)
against the JAX package's, on the same numpy-seeded inputs
(tests/test_keypoint_head.py's forward and deconv cases).

Bars: the transposed conv and the resize within 1e-5 of their magnitude;
the head's heatmaps within 1e-4 of theirs (eight 3x3 convs over 512
channels, summed in another order); the argmax cells equal, the keypoint
positions within 1e-4 px, the probabilities within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.models.maskrcnn import keypoint_head as jk
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models.layers import ConvTranspose2d
from vido_slam_tpu_torch.models.maskrcnn import keypoint_head as tk
from vido_slam_tpu_torch.ops.warp import resize_bilinear

torch.set_num_threads(1)

H, W = 128, 160
PREFIX = "roi_heads.keypoint."


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


def port_head(params):
    head = tk.KeypointHead(device="cpu")
    head.load_state_dict({k[len(PREFIX):]: v for k, v in
                          convert.maskrcnn_state_dict_from_numpy(
                              params, device="cpu").items()}, strict=True)
    return head


def test_deconv_layout_round_trip_and_parity():
    """The stored (kh, kw, cout, cin) deconv weight carried into torch's
    (cin, cout, kh, kw) and back bit for bit, and the layer equal to the
    JAX package's flipped-kernel ``_deconv4x2``."""
    rng = np.random.RandomState(0)
    w_jax = rng.randn(4, 4, 5, 8).astype(np.float32)     # (kh, kw, cout, cin)
    b = rng.randn(5).astype(np.float32)
    sd = convert.maskrcnn_state_dict_from_numpy(
        {"p.weight": w_jax, "p.bias": b}, device="cpu")
    assert tuple(sd["p.weight"].shape) == (8, 5, 4, 4)
    back = convert.convert_state_dict(sd)
    np.testing.assert_array_equal(back["p.weight"], w_jax)
    layer = ConvTranspose2d(8, 5, 4, 2, 1)
    layer.load_state_dict({"weight": sd["p.weight"], "bias": sd["p.bias"]})
    x = rng.randn(2, 7, 9, 8).astype(np.float32)
    want = np.asarray(jk._deconv4x2(jnp.asarray(x), jnp.asarray(w_jax),
                                    jnp.asarray(b)))
    with torch.no_grad():
        got = nhwc(layer(nchw(x)))
    assert got.shape == want.shape == (2, 14, 18, 5)
    close_to_scale(got, want, 1e-5)


def test_upsample_is_jax_linear_resize():
    x = np.random.RandomState(1).randn(3, 28, 28, 17).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, 56, 56, 17),
                                       "linear"))
    got = nhwc(resize_bilinear(nchw(x), 56, 56))
    close_to_scale(got, want, 1e-5)


@pytest.fixture(scope="module")
def head_case():
    """JAX params (its init), P2-P5 of a 128 x 160 image, 24 boxes over all
    four FPN levels, and both packages' heatmaps."""
    p = jk.init_keypoint_params(jax.random.PRNGKey(0))
    p = {k: np.array(v) for k, v in p.items()}
    rng = np.random.RandomState(2)
    feats = [rng.uniform(0, 1, (H // s, W // s, 256)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    x1 = rng.uniform(-10, W - 20, 24)
    y1 = rng.uniform(-10, H - 20, 24)
    side = np.exp(rng.uniform(np.log(8), np.log(400), (2, 24)))
    boxes = np.stack([x1, y1, x1 + side[0], y1 + side[1]], 1).astype(
        np.float32)
    boxes[:2] = [[-50.0, -40.0, 500.0, 420.0], [3.0, 2.0, 470.5, 450.25]]
    want = np.asarray(jk.keypoint_head_forward(
        {k: jnp.asarray(v) for k, v in p.items()},
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes)))
    head = port_head(p)
    got = tk.keypoint_head_forward(head, [nchw(f[None]) for f in feats],
                                   torch.from_numpy(boxes))
    return p, boxes, want, got


def test_keypoint_head_matches_jax(head_case):
    p, boxes, want, got = head_case
    assert tuple(got.shape) == (24, tk.NUM_KEYPOINTS, tk.HEATMAP, tk.HEATMAP)
    assert want.shape == (24, 56, 56, 17)
    err = close_to_scale(got.numpy().transpose(0, 2, 3, 1), want, 1e-4)
    print(f"heatmaps: max error {err:.2e} of {np.abs(want).max():.3f}")
    # the levels the boxes pool from: all four
    from vido_slam_tpu_torch.models.maskrcnn.roi_heads import assign_fpn_level
    assert set(assign_fpn_level(torch.from_numpy(boxes)).tolist()) == \
        {0, 1, 2, 3}
    init = tk.init_keypoint_params(torch.Generator().manual_seed(0))
    sd = convert.maskrcnn_state_dict_from_numpy(p, device="cpu")
    assert {k: v.shape for k, v in init.items()} == \
        {k: v.shape for k, v in sd.items()}


def test_keypoints_from_heatmaps_match_jax(head_case):
    _, boxes, want, got = head_case
    jw = jk.keypoints_from_heatmaps(jnp.asarray(want), jnp.asarray(boxes))
    tw = tk.keypoints_from_heatmaps(got, torch.from_numpy(boxes))
    cell = boxes[:, None, 2:] - boxes[:, None, :2]
    j_cells = np.round((np.asarray(jw.xy) - boxes[:, None, :2])
                       / np.maximum(cell, 1) * 56 - 0.5)
    t_cells = np.round((tw.xy.numpy() - boxes[:, None, :2])
                       / np.maximum(cell, 1) * 56 - 0.5)
    np.testing.assert_array_equal(t_cells, j_cells)
    np.testing.assert_allclose(tw.xy.numpy(), np.asarray(jw.xy), atol=1e-4,
                               rtol=0)
    close_to_scale(tw.logits.numpy(), np.asarray(jw.logits), 1e-4)
    np.testing.assert_allclose(tw.probs.numpy(), np.asarray(jw.probs),
                               atol=1e-5, rtol=0)


def test_planted_maximum_and_ties_take_the_first_cell():
    """Peaks planted at known cells come back at their cell centres; two
    equal maxima give the first cell (row-major), as ``jnp.argmax``."""
    rng = np.random.RandomState(3)
    logits = rng.uniform(-5, 0, (2, 56, 56, 17)).astype(np.float32)
    cells = rng.randint(0, 56, (2, 17, 2))
    for r in range(2):
        for k in range(17):
            logits[r, cells[r, k, 0], cells[r, k, 1], k] = 10.0
    # keypoint 0 of ROI 0: a second, later peak of the same value
    later = (min(cells[0, 0, 0] + 3, 55), cells[0, 0, 1])
    logits[0, later[0], later[1], 0] = 10.0
    boxes = np.asarray([[10.0, 20.0, 66.0, 104.0], [0.0, 0.0, 5.0, 300.0]],
                       np.float32)
    want = jk.keypoints_from_heatmaps(jnp.asarray(logits), jnp.asarray(boxes))
    got = tk.keypoints_from_heatmaps(nchw(logits), torch.from_numpy(boxes))
    w = np.maximum(boxes[:, 2] - boxes[:, 0], 1)[:, None]
    h = np.maximum(boxes[:, 3] - boxes[:, 1], 1)[:, None]
    expect = np.stack([(cells[..., 1] + 0.5) * w / 56 + boxes[:, :1],
                       (cells[..., 0] + 0.5) * h / 56 + boxes[:, 1:2]], -1)
    np.testing.assert_allclose(got.xy.numpy(), expect, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
    assert got.logits.eq(10.0).all()
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs),
                               atol=1e-6, rtol=0)


def test_head_gradient_on_an_all_zero_roi_matches_jax_grad():
    """The head's parameter gradients where every pooled value is 0 (zero
    features, zero conv biases): each relu meets an exact 0, where JAX's
    ``jnp.maximum(x, 0)`` passes half the gradient. Every key within 1e-4
    of its max |g|."""
    p = jk.init_keypoint_params(jax.random.PRNGKey(1))
    p = {k: np.array(v) for k, v in p.items()}
    for k in p:
        if "conv_fcn" in k and k.endswith("bias"):
            p[k][:] = 0.0
    feats = [np.zeros((H // s, W // s, 256), np.float32)
             for s in (4, 8, 16, 32)]
    boxes = np.asarray([[10.0, 12.0, 60.0, 70.0], [40.0, 30.0, 150.0, 120.0]],
                       np.float32)
    wts = np.random.RandomState(6).uniform(-1, 1, (2, 56, 56, 17)).astype(
        np.float32)
    want = jax.jit(jax.grad(lambda q: jnp.sum(jk.keypoint_head_forward(
        q, [jnp.asarray(f) for f in feats], jnp.asarray(boxes)) * wts)))(
        {k: jnp.asarray(v) for k, v in p.items()})
    head = port_head(p)
    out = tk.keypoint_head_logits(head, [nchw(f[None]) for f in feats],
                                  torch.from_numpy(boxes))
    (out * nchw(wts)).sum().backward()
    got = convert.convert_state_dict(
        {PREFIX + k: v.grad for k, v in head.named_parameters()})
    assert set(got) == set(want)
    assert np.abs(np.asarray(
        want[PREFIX + "feature_extractor.conv_fcn1.bias"])).max() > 0
    for k, g in got.items():
        w = np.asarray(want[k])
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()) or err == 0.0, (k, err)
