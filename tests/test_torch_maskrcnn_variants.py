"""The detector variants of the port against the JAX package: GroupNorm
(``layers.GroupNorm``, ``ResNetConfig(norm="gn")``), the one-pass RPN
head (``rpn_head_concat``, ``MaskRCNNConfig(rpn_concat=True)``; the JAX
package's ``VIDO_RPN_CONCAT``), and X-101-32x8d-FPN at full depth.

Bars, from tests/test_torch_maskrcnn.py: GroupNorm and the backbones
within 1e-5 of the output's magnitude (the statistics are summed in
another order), RPN head outputs within 1e-5 of theirs; the whole
detector's validity and labels exactly and masks28 within 1e-4. Boxes:
within 1e-3 px for the one-pass RPN head against the per-level one (one
implementation, the convolutions summed in another order); for the GN and
X-101 detectors against JAX, within 1e-4 of the input's larger side, the
head outputs' bar carried through the box decode (measured: 5.0e-3 px for
GN, 1.3e-3 px for X-101 at 128 x 160, where R-50 stays under 1e-3 px:
GroupNorm divides by each group's spread, and X-101 is 33 blocks deep).
Inputs are 0..1 images with class 3's score bias lifted to 30 (that file
says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.models import layers as j_layers
from vido_slam_tpu.models.maskrcnn import backbone as jb
from vido_slam_tpu.models.maskrcnn import model as jm
from vido_slam_tpu.models.maskrcnn import rpn as jr
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models import layers as t_layers
from vido_slam_tpu_torch.models.maskrcnn import backbone as tb
from vido_slam_tpu_torch.models.maskrcnn import model as tm
from vido_slam_tpu_torch.models.maskrcnn import rpn as tr

torch.set_num_threads(1)

H, W = 128, 160
LIFT = 30.0
GN = jb.ResNetConfig(norm="gn")
X101 = jm.RESNEXT101_FPN.resnet


def nchw(a):
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def close_to_scale(got, want, rel):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rel * scale, (err, scale)


def jax_params(resnet, seed):
    cfg = jm.MaskRCNNConfig(resnet=resnet, input_h=H, input_w=W)
    p = jax.jit(jm.init_maskrcnn_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)
    p = {k: np.array(v) for k, v in p.items()}
    p["roi_heads.box.predictor.cls_score.bias"][3] = LIFT
    return cfg, p


def port_model(resnet, params, **kw):
    m = tm.MaskRCNN(tm.MaskRCNNConfig(resnet=tb.ResNetConfig(*resnet),
                                      input_h=H, input_w=W, **kw),
                    device="cpu")
    m.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
        params, device="cpu"), strict=True)
    return m


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(2).uniform(
        0, 1, (1, H, W, 3)).astype(np.float32)


def _same_detections(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    v = want.valid
    assert v.sum() >= 20
    err = float(np.abs(got.boxes.numpy()[v] - want.boxes[v]).max())
    print(f"{int(v.sum())} detections, box error {err:.3e} px")
    assert err <= 1e-4 * max(H, W)
    np.testing.assert_allclose(got.masks28.numpy(), want.masks28, atol=1e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# GroupNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 7, 64), (1, 9, 3, 256)])
def test_group_norm_matches_jax(shape):
    rng = np.random.RandomState(shape[-1])
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    g = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, shape[-1]).astype(np.float32)
    want = np.asarray(j_layers.group_norm(jnp.asarray(x), jnp.asarray(g),
                                          jnp.asarray(b)))
    gn = t_layers.GroupNorm(shape[-1])
    gn.load_state_dict({"weight": torch.from_numpy(g),
                        "bias": torch.from_numpy(b)})
    assert set(gn.state_dict()) == {"weight", "bias"}
    close_to_scale(nhwc(gn(nchw(x))), want, 1e-5)


def test_gn_backbone_matches_jax(image):
    """The GN stem and bottlenecks (no running statistics) and the FPN."""
    p = jax.jit(jb.init_resnet_fpn_params, static_argnums=1)(
        jax.random.PRNGKey(5), GN)
    assert not any(k.endswith("running_mean") for k in p)
    want = jax.jit(lambda p, x: jb.fpn_forward(
        p, jb.resnet_stages(p, x, GN)))(p, jnp.asarray(image))
    net = tb.Backbone(tb.ResNetConfig(*GN))
    net.load_state_dict({k[len("backbone."):]: v for k, v in
                         convert.maskrcnn_state_dict_from_numpy(
                             p, device="cpu").items()}, strict=True)
    assert isinstance(net.body.layer3[0].bn2, t_layers.GroupNorm)
    with torch.no_grad():
        got = net(nchw(image))
    for g, w in zip(got, want):
        close_to_scale(nhwc(g), np.asarray(w), 1e-5)


def test_gn_detector_matches_jax(image):
    cfg, params = jax_params(GN, 0)
    want = jax.tree_util.tree_map(np.asarray, jm.maskrcnn_inference(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(image),
        cfg))
    model = port_model(GN, params)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    want_feats = jax.jit(lambda p, x: jb.fpn_forward(
        p, jb.resnet_stages(p, x, GN)))(p, jnp.asarray(image))
    with torch.no_grad():
        feats = model.backbone(nchw(image))
    for g, w in zip(feats, want_feats):
        close_to_scale(nhwc(g), np.asarray(w), 1e-5)
    init = tm.init_maskrcnn_params(torch.Generator().manual_seed(0),
                                   model.cfg)
    assert set(init) == set(params) == set(model.state_dict())
    _same_detections(model(nchw(image)), want)


# ---------------------------------------------------------------------------
# the one-pass RPN head
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def r50(image):
    cfg, params = jax_params(jm.RESNET50_FPN.resnet, 1)
    model = port_model(jm.RESNET50_FPN.resnet, params)
    with torch.no_grad():
        feats = model.backbone(nchw(image))
    return params, model, feats


def test_rpn_head_concat_matches_per_level_and_jax(r50):
    params, model, feats = r50
    with torch.no_grad():
        per_level = [model.rpn.head(f) for f in feats]
        concat = tr.rpn_head_concat(model.rpn.head, feats)
    p = {k: jnp.asarray(v) for k, v in params.items() if k.startswith("rpn")}
    want = jr.rpn_head_concat(p, [jnp.asarray(nhwc(f)) for f in feats], 3)
    for (lo, dl), (co, cd), (jo, jd) in zip(per_level, concat, want):
        assert co.shape == lo.shape and cd.shape == dl.shape
        close_to_scale(co.numpy(), lo.numpy(), 1e-5)
        close_to_scale(cd.numpy(), dl.numpy(), 1e-5)
        close_to_scale(co.numpy(), np.asarray(jo[0]).reshape(-1), 1e-5)
        close_to_scale(cd.numpy(), np.asarray(jd[0]).reshape(-1, 4), 1e-5)


def test_rpn_concat_detector_makes_the_same_detections(r50, image):
    """The option on the whole detector, against the per-level head (the
    JAX package's default, and its VIDO_RPN_CONCAT path computes the same
    function)."""
    params, model, _ = r50
    concat = port_model(jm.RESNET50_FPN.resnet, params, rpn_concat=True)
    assert concat.cfg.rpn_concat and not model.cfg.rpn_concat
    a, b = model(nchw(image)), concat(nchw(image))
    np.testing.assert_array_equal(a.valid.numpy(), b.valid.numpy())
    np.testing.assert_array_equal(a.labels.numpy(), b.labels.numpy())
    assert int(a.valid.sum()) >= 20
    v = a.valid.numpy()
    assert float((a.boxes - b.boxes).abs().numpy()[v].max()) <= 1e-3
    np.testing.assert_allclose(b.masks28.numpy(), a.masks28.numpy(),
                               atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# X-101-32x8d at full depth
# ---------------------------------------------------------------------------

def test_x101_detector_at_full_depth_matches_jax(image):
    """The reference node's X-101-32x8d-FPN, all 33 bottlenecks, through
    the JAX package's grouped-conv supergroups and the port's
    ``nn.Conv2d(groups=32)``."""
    cfg, params = jax_params(X101, 2)
    assert sum(1 for k in params if k.endswith(".conv2.weight")) == 33
    p = {k: jnp.asarray(v) for k, v in params.items()}
    want_feats = jax.jit(lambda p, x: jb.fpn_forward(
        p, jb.resnet_stages(p, x, X101)))(p, jnp.asarray(image))
    want = jax.tree_util.tree_map(np.asarray, jm.maskrcnn_inference(
        p, jnp.asarray(image), cfg))
    model = port_model(X101, params)
    with torch.no_grad():
        feats = model.backbone(nchw(image))
    for g, w in zip(feats, want_feats):
        close_to_scale(nhwc(g), np.asarray(w), 1e-5)
    _same_detections(model(nchw(image)), want)
