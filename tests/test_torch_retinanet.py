"""The port's RetinaNet (``models/maskrcnn/retinanet.py``) against the JAX
package's on the same numpy-seeded inputs, the way ``tools/infer_nets.py``
runs it (R-50-FPN, seeded random weights), at 128 x 160.

Bars: the anchors equal; the head's outputs within 1e-4 of their
magnitude; ``retinanet_inference`` with equal validity and labels, boxes
within 5e-3 px and scores within 1e-6. The prior bias (-4.6) leaves every
random-weight score near 0.01, under the 0.05 threshold, so two classes'
biases are lifted to 30 in both packages (class 3 on anchors 0-4, class 7
on anchors 5-8): their scores are then exactly 1.0, so the top-k's tie
order (``lax.top_k``'s) decides which candidates survive, and the
class-aware NMS sees two labels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.models.maskrcnn import backbone as jb
from vido_slam_tpu.models.maskrcnn import retinanet as jr
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models.maskrcnn import retinanet as tr
from vido_slam_tpu_torch.models.maskrcnn.backbone import ResNetConfig

torch.set_num_threads(1)

H, W = 128, 160
LIFT = 30.0
LIFTED = [(a, 2) for a in range(5)] + [(a, 6) for a in range(5, 9)]


def nchw(a):
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def close_to_scale(got, want, rel):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rel * scale, (err, scale)
    return err


@pytest.fixture(scope="module")
def case():
    """Both packages' models on the port's seeded init (carried into the
    JAX layout; the JAX init's keys and shapes checked against it), two
    classes lifted, and a 0..1 image."""
    model = tr.RetinaNet(ResNetConfig(), device="cpu")
    p = convert.convert_state_dict(model.state_dict())
    shapes = jax.eval_shape(lambda k: jr.init_retinanet_params(
        k, jb.ResNetConfig()), jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in shapes.items()} == \
        {k: v.shape for k, v in p.items()}
    for a, c in LIFTED:
        p["rpn.head.cls_logits.bias"][a * 80 + c] = LIFT
    model.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
        p, device="cpu"), strict=True)
    image = np.random.RandomState(3).uniform(0, 1, (1, H, W, 3)).astype(
        np.float32)
    return model, p, image


def test_cell_anchors_equal_jax():
    for level in range(5):
        np.testing.assert_array_equal(tr.retina_cell_anchors(level),
                                      jr.retina_cell_anchors(level))


def test_head_matches_jax(case):
    model, p, image = case
    rng = np.random.RandomState(4)
    feat = rng.randn(1, 8, 10, 256).astype(np.float32)
    jcls, jbox = jr.retinanet_head({k: jnp.asarray(v) for k, v in p.items()
                                    if k.startswith("rpn.")},
                                   jnp.asarray(feat))
    with torch.no_grad():
        cls, box = model.rpn.head(nchw(feat))
    close_to_scale(cls.numpy(), np.asarray(jcls[0]).reshape(-1, 80), 1e-4)
    close_to_scale(box.numpy(), np.asarray(jbox[0]).reshape(-1, 4), 1e-4)
    assert float(torch.sigmoid(cls).max()) == 1.0


def test_retinanet_inference_matches_jax(case):
    model, p, image = case
    want = jax.tree_util.tree_map(np.asarray, jr.retinanet_inference(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(image),
        jb.ResNetConfig(), H, W))
    got = tr.retinanet_inference(model, nchw(image), H, W)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    v = want.valid
    assert v.sum() >= 50 and set(want.labels[v]) == {3, 7}
    err = float(np.abs(got.boxes.numpy()[v] - want.boxes[v]).max())
    print(f"{int(v.sum())} detections, box error {err:.3e} px")
    assert err <= 5e-3
    np.testing.assert_allclose(got.scores.numpy(), want.scores, atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError):
        tr.retinanet_inference(model, nchw(image), W, H)


def test_entry_points_take_the_card_unless_asked():
    """The new modules' constructors default to ``cuda``: without a card
    they raise unless given ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would take it")
    from vido_slam_tpu_torch.models.maskrcnn import fbnet, keypoint_head
    from vido_slam_tpu_torch.ops.deform_conv import init_dcn_offsets

    for make in (lambda: tr.RetinaNet(),
                 lambda: fbnet.FBNet("mobilenet_v2"),
                 lambda: keypoint_head.KeypointHead(),
                 lambda: init_dcn_offsets((1, 18, 4, 4))):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
