"""``PerceptionModel.from_pretrained`` of the port against the JAX
package's, on ``depth``/``flow``/``mask`` bundles that the test writes with
``numpy.savez`` from the JAX package's own initialised parameters (the
layout ``tools/convert_weights.py`` writes), at the JAX package's test size
(64 x 96 frames).

Bars (those of tests/test_torch_perception.py): ``depth_u16`` within
1e-5 x 65536, the flow within 1e-3 x max(1, max |flow|), the mask equal on
every pixel the JAX paste leaves unchanged when its threshold moves by
1e-4 (class 3's score bias lifted to 30 in the bundle so that there are
detections). A missing bundle keeps that net's seeded init; a bundle that
does not fit its net raises, naming the key.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.models.maskrcnn import model as jm
from vido_slam_tpu.models.perception import PerceptionModel as JPerception
from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNNConfig
from vido_slam_tpu_torch.models.perception import PerceptionModel

torch.set_num_threads(1)

H, W = 64, 96
CLS_BIAS = "roi_heads.box.predictor.cls_score.bias"


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The JAX package's seeded parameters (seed 3) as .npz bundles."""
    jmodel = JPerception(H, W, jm.MaskRCNNConfig(input_h=H, input_w=W),
                         seed=3, use_pallas=False)
    d = tmp_path_factory.mktemp("weights")
    params = {"depth": jmodel.depth_params, "flow": jmodel.flow_params,
              "mask": dict(jmodel.mask_params)}
    bias = np.array(params["mask"][CLS_BIAS])
    bias[3] = 30.0
    params["mask"][CLS_BIAS] = bias
    for name, p in params.items():
        np.savez(str(d / name) + ".npz",
                 **{k: np.asarray(v) for k, v in p.items()})
    return str(d)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(0)
    return [(rng.rand(H, W, 3) * 255).astype(np.float32) for _ in range(2)]


def test_from_pretrained_matches_jax(bundles, frames):
    jcfg = jm.MaskRCNNConfig(input_h=H, input_w=W)
    jmodel = JPerception.from_pretrained(bundles, H, W, jcfg,
                                         use_pallas=False)
    want = jax.device_get(jmodel(frames[0], frames[1]))
    model = PerceptionModel.from_pretrained(
        bundles, H, W, MaskRCNNConfig(input_h=H, input_w=W), device="cpu")
    got = model(frames[0], frames[1])
    d_err = float(np.abs(got.depth_u16.numpy() - want.depth_u16).max())
    assert d_err <= 1e-5 * 65536
    f_scale = max(1.0, float(np.abs(want.flow).max()))
    assert float(np.abs(got.flow.numpy() - want.flow).max()) \
        <= 1e-3 * f_scale
    x = jax.image.resize(jnp.asarray(frames[1])[None, :, :, ::-1],
                         (1, H, W, 3), method="bilinear")
    det = jm.maskrcnn_inference(jmodel.mask_params, x, jcfg)
    lo, mid, hi = (np.asarray(jm.paste_semantic_mask(det, H, W, H, W, t))
                   for t in (0.5 - 1e-4, 0.5, 0.5 + 1e-4))
    np.testing.assert_array_equal(mid, want.mask)
    stable = lo == hi
    assert stable.mean() > 0.95 and (mid > 0).any()
    np.testing.assert_array_equal(got.mask.numpy()[stable], mid[stable])


def test_missing_bundle_keeps_the_seeded_init(bundles, tmp_path):
    """Only the depth bundle: the flow and mask nets are the seeded
    model's, bit for bit."""
    only = tmp_path / "only_depth"
    only.mkdir()
    os.symlink(os.path.join(bundles, "depth.npz"), only / "depth.npz")
    cfg = MaskRCNNConfig(input_h=H, input_w=W)
    model = PerceptionModel.from_pretrained(str(only), H, W, cfg, seed=5,
                                            device="cpu")
    seeded = PerceptionModel(H, W, cfg, seed=5, device="cpu")
    for net in ("flow_net", "mask_model"):
        a = getattr(model, net).state_dict()
        b = getattr(seeded, net).state_dict()
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (net, k)
    with np.load(os.path.join(bundles, "depth.npz")) as z:
        w = z["encoder.conv1.weight"]
    np.testing.assert_array_equal(
        model.depth_net.state_dict()["encoder.conv1.weight"].numpy(),
        w.transpose(3, 2, 0, 1))


def test_bundle_that_does_not_fit_raises(bundles, tmp_path):
    bad = tmp_path / "bad"
    bad.mkdir()
    with np.load(os.path.join(bundles, "depth.npz")) as z:
        p = {k: z[k] for k in z.files}
    p["encoder.conv1.weight"] = p["encoder.conv1.weight"][:, :, :, :8]
    np.savez(str(bad / "depth.npz"), **p)
    with pytest.raises(RuntimeError, match="encoder.conv1.weight"):
        PerceptionModel.from_pretrained(str(bad), H, W, device="cpu")
    del p["encoder.conv1.weight"]
    np.savez(str(bad / "depth.npz"), **p)
    with pytest.raises(RuntimeError, match="encoder.conv1.weight"):
        PerceptionModel.from_pretrained(str(bad), H, W, device="cpu")


def test_device_defaults_to_the_card(bundles):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PerceptionModel.from_pretrained(bundles, H, W)
