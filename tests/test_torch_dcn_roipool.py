"""The port's deformable convolution (``ops/deform_conv.py``), its DCN
ResNeXt backbone and detector (``DFConv2d``, ``RESNEXT101_FPN_DCN``, the
c2 loader on a DCN model) and ROIPool (``ops/roi_pool.py``) against the
JAX package, on the same numpy-seeded inputs (tests/test_dcn_roipool.py's
cases, and random non-zero offsets).

Bars: ``deform_conv2d`` and its gradient w.r.t. the offsets within 1e-4 of
max(1, max |JAX|) (the contractions sum in another order); the DCN
bottleneck and backbone within 1e-5 of their magnitude, as the other
backbones (tests/test_torch_maskrcnn_variants.py); the small DCN detector
with equal validity and labels, boxes within 5e-3 px (the GN detector's
bar) and masks28 within 1e-4; the c2 loader's lists and loaded state equal
to the JAX loader's; ``roi_pool`` bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from test_torch_c2_loading import make_c2_blobs
from vido_slam_tpu.models.maskrcnn import backbone as jb
from vido_slam_tpu.models.maskrcnn import c2_loading as jc2
from vido_slam_tpu.models.maskrcnn import model as jm
from vido_slam_tpu.ops.deform_conv import deform_conv2d as j_deform
from vido_slam_tpu.ops.roi_pool import roi_pool as j_roi_pool
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models.maskrcnn import backbone as tb
from vido_slam_tpu_torch.models.maskrcnn import model as tm
from vido_slam_tpu_torch.models.perception import PerceptionModel
from vido_slam_tpu_torch.ops.deform_conv import deform_conv2d, init_dcn_offsets
from vido_slam_tpu_torch.ops.roi_pool import roi_pool

torch.set_num_threads(1)

H, W = 128, 160
LIFT = 30.0
OFFSET_STD = 0.05   # the offset convs' weights: offsets of a few pixels


def nchw(a):
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(3, 2, 0, 1)))


def close_to_scale(got, want, rel):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rel * scale, (err, scale)
    return err


# ---------------------------------------------------------------------------
# deform_conv2d
# ---------------------------------------------------------------------------

# (name, N, H, W, Cin, Cout, stride, padding, dilation, groups, offset
# scale, modulated)
DCN_CASES = [
    ("fractional", 2, 10, 12, 6, 4, 1, 1, 1, 1, 0.7, False),
    ("outside the image", 1, 9, 11, 5, 3, 1, 1, 1, 1, 6.0, False),
    ("stride 2", 1, 13, 11, 4, 6, 2, 1, 1, 1, 1.5, False),
    ("dilation 2", 1, 13, 11, 3, 5, 1, 2, 2, 1, 1.5, False),
    ("groups 32", 1, 8, 9, 64, 64, 1, 1, 1, 32, 1.5, False),
    ("modulated", 2, 8, 8, 4, 2, 1, 1, 1, 1, 1.5, True),
    ("modulated, groups 32, stride 2", 1, 11, 10, 64, 128, 2, 1, 1, 32,
     2.0, True),
]


def dcn_inputs(case, seed):
    (_, N, h, w, cin, cout, stride, pad, dil, groups, scale, mod) = case
    rng = np.random.RandomState(seed)
    ho = (h + 2 * pad - dil * 2 - 1) // stride + 1
    wo = (w + 2 * pad - dil * 2 - 1) // stride + 1
    x = rng.randn(N, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin // groups, cout) * 0.2).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    off = (rng.randn(N, ho, wo, 18) * scale).astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.randn(N, ho, wo, 9)))).astype(np.float32) \
        if mod else None
    kw = dict(stride=stride, padding=pad, dilation=dil, groups=groups)
    return x, off, wt, b, mask, kw


def port_dcn(x, off, wt, b, mask, kw):
    return deform_conv2d(nchw(x), nchw(off), oihw(wt), torch.from_numpy(b),
                         mask=None if mask is None else nchw(mask), **kw)


@pytest.mark.parametrize("case", DCN_CASES, ids=[c[0] for c in DCN_CASES])
def test_deform_conv_matches_jax(case):
    x, off, wt, b, mask, kw = dcn_inputs(case, seed=len(case[0]))
    want = np.asarray(j_deform(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt), jnp.asarray(b),
        mask=None if mask is None else jnp.asarray(mask), **kw))
    got = nhwc(port_dcn(x, off, wt, b, mask, kw))
    assert got.shape == want.shape
    err = close_to_scale(got, want, 1e-4)
    print(f"{case[0]}: max error {err:.2e}")
    # the offsets really move the samples
    zero = nhwc(port_dcn(x, 0 * off, wt, b, mask, kw))
    assert float(np.abs(zero - got).max()) > 1e-2


@pytest.mark.parametrize("case", [DCN_CASES[0], DCN_CASES[6]],
                         ids=["plain", "modulated grouped strided"])
def test_deform_conv_offset_gradient_matches_jax(case):
    x, off, wt, b, mask, kw = dcn_inputs(case, seed=7)
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jax.grad(lambda o: jnp.sum(j_deform(
        jnp.asarray(x), o, jnp.asarray(wt), jnp.asarray(b), mask=jmask,
        **kw) ** 2))(jnp.asarray(off)))
    o = nchw(off).requires_grad_(True)
    out = deform_conv2d(nchw(x), o, oihw(wt), torch.from_numpy(b),
                        mask=None if mask is None else nchw(mask), **kw)
    (out ** 2).sum().backward()
    got = nhwc(o.grad)
    assert np.abs(want).max() > 0
    err = close_to_scale(got, want, 1e-4)
    print(f"offset gradient {case[0]}: max error {err:.2e} of "
          f"{np.abs(want).max():.3f}")


@pytest.mark.parametrize("stride,pad,dil,groups", [(1, 1, 1, 1),
                                                   (2, 2, 2, 4)])
def test_zero_offsets_are_the_plain_conv(stride, pad, dil, groups):
    rng = np.random.RandomState(stride + groups)
    x = torch.from_numpy(rng.randn(2, 8, 13, 11).astype(np.float32))
    w = torch.from_numpy(rng.randn(12, 8 // groups, 3, 3).astype(np.float32))
    want = F.conv2d(x, w, None, stride, pad, dil, groups)
    off = init_dcn_offsets((2, 18) + tuple(want.shape[2:]), device="cpu")
    assert off.device.type == "cpu" and not off.any()
    got = deform_conv2d(x, off, w, stride=stride, padding=pad,
                        dilation=dil, groups=groups)
    close_to_scale(got.numpy(), want.numpy(), 1e-5)


def test_deform_conv_refuses_bf16():
    """bf16 input (it was refused until item 19c) returns float32, as the
    JAX function does, with JAX's values (within 1e-5 of their scale,
    tests/test_torch_dcn_bf16.py's bar); float16 is refused."""
    rng = np.random.RandomState(6)
    x, off, wt = (rng.randn(*s).astype(np.float32) for s in
                  ((1, 6, 6, 4), (1, 6, 6, 18), (3, 3, 4, 4)))
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, off, wt)]
    want = j_deform(*j)
    assert want.dtype == jnp.float32
    x, off, wt = (np.asarray(a.astype(jnp.float32)) for a in j)
    got = deform_conv2d(nchw(x).to(torch.bfloat16),
                        nchw(off).to(torch.bfloat16),
                        oihw(wt).to(torch.bfloat16))
    assert got.dtype == torch.float32
    close_to_scale(nhwc(got), np.asarray(want), 1e-5)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        deform_conv2d(nchw(x).half(), nchw(off), oihw(wt))


# ---------------------------------------------------------------------------
# the DCN ResNeXt: bottleneck, backbone, detector, c2 loader
# ---------------------------------------------------------------------------

SMALL_DCN = jm.RESNEXT101_FPN_DCN.resnet._replace(stage_blocks=(1, 1, 1, 1))


def lift_offsets(p, seed):
    """Seeded non-zero offset convs (the init's are zero), so the sampling
    really deforms."""
    rng = np.random.RandomState(seed)
    for k in p:
        if ".conv2.offset." in k:
            p[k] = (rng.randn(*p[k].shape) * OFFSET_STD).astype(np.float32)
    return p


def test_dcn_bottleneck_matches_jax():
    """One modulated DCN bottleneck of the X-101 stage 3 widths (stride 2,
    32 groups) against the JAX ``_bottleneck``."""
    cfg = jb.ResNetConfig(stage_blocks=(1, 1, 1, 1), num_groups=32,
                          width_per_group=8, stride_in_1x1=False,
                          stage_with_dcn=(False, True, False, False),
                          with_modulated_dcn=True)
    p = jax.jit(jb.init_resnet_fpn_params, static_argnums=1)(
        jax.random.PRNGKey(3), cfg)
    pre = "backbone.body.layer2.0"
    p = lift_offsets({k: np.array(v) for k, v in p.items()
                      if k.startswith(pre)}, 4)
    assert p[f"{pre}.conv2.offset.weight"].shape == (3, 3, 512, 27)
    x = np.random.RandomState(5).randn(1, 16, 20, 256).astype(np.float32)
    want = np.asarray(jb._bottleneck(
        {k: jnp.asarray(v) for k, v in p.items()}, pre, jnp.asarray(x), 2,
        32, False, dcn=True, modulated_dcn=True))
    block = tb.Bottleneck(256, 512, 512, 2, 32, False, dcn=True,
                          modulated_dcn=True)
    block.load_state_dict({k[len(pre) + 1:]: v for k, v in
                           convert.maskrcnn_state_dict_from_numpy(
                               p, device="cpu").items()}, strict=True)
    assert isinstance(block.conv2, tb.DFConv2d)
    with torch.no_grad():
        got = nhwc(block(nchw(x)))
    close_to_scale(got, want, 1e-5)


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(2).uniform(
        0, 1, (1, H, W, 3)).astype(np.float32)


def test_small_dcn_detector_matches_jax(image):
    """A DCN ResNeXt detector (X-101-32x8d-DCN widths, one block a stage)
    at 128 x 160, with non-zero offset convs and class 3 lifted."""
    cfg = jm.MaskRCNNConfig(resnet=SMALL_DCN, input_h=H, input_w=W)
    p = jax.jit(jm.init_maskrcnn_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    p = lift_offsets({k: np.array(v) for k, v in p.items()}, 1)
    p["roi_heads.box.predictor.cls_score.bias"][3] = LIFT
    assert sum(1 for k in p if k.endswith(".conv2.offset.bias")) == 3
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_feats = jax.jit(lambda p, x: jb.fpn_forward(
        p, jb.resnet_stages(p, x, SMALL_DCN)))(jp, jnp.asarray(image))
    want = jax.tree_util.tree_map(np.asarray, jm.maskrcnn_inference(
        jp, jnp.asarray(image), cfg))
    model = tm.MaskRCNN(tm.MaskRCNNConfig(resnet=tb.ResNetConfig(*SMALL_DCN),
                                          input_h=H, input_w=W),
                        device="cpu")
    init = tm.init_maskrcnn_params(torch.Generator().manual_seed(0),
                                   model.cfg)
    assert set(init) == set(p) == set(model.state_dict())
    assert not init["backbone.body.layer2.0.conv2.offset.weight"].any()
    model.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
        p, device="cpu"), strict=True)
    with torch.no_grad():
        feats = model.backbone(nchw(image))
    for g, w in zip(feats, want_feats):
        close_to_scale(nhwc(g), np.asarray(w), 1e-5)
    got = model(nchw(image))
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    v = want.valid
    assert v.sum() >= 20
    err = float(np.abs(got.boxes.numpy()[v] - want.boxes[v]).max())
    print(f"{int(v.sum())} detections, box error {err:.3e} px")
    assert err <= 5e-3
    np.testing.assert_allclose(got.masks28.numpy(), want.masks28, atol=1e-4,
                               rtol=0)


def test_dcn_configs_build_and_refuse_bf16():
    cfg = tm.RESNEXT101_FPN_DCN
    assert cfg.resnet == tb.ResNetConfig(*jm.RESNEXT101_FPN_DCN.resnet)
    small = cfg._replace(resnet=tb.ResNetConfig(*SMALL_DCN), input_h=64,
                         input_w=64)
    model = PerceptionModel(64, 96, small, device="cpu")
    assert isinstance(model.mask_model.backbone.body.layer4[0].conv2,
                      tb.DFConv2d)
    # float32 spelled out is float32
    PerceptionModel(64, 96, small, device="cpu", mask_dtype=torch.float32)
    # in bf16 (refused until item 19c) both options run, and the detector
    # equals JAX's bf16 detector on the same weights (seeded non-zero
    # offset convs, class 3 lifted): validity and labels slot by slot
    # except within a bf16 margin of a threshold, 80 % of the boxes
    # matched at IoU >= 0.9 (tests/test_torch_bf16.py's bar)
    jcfg = jm.RESNEXT101_FPN_DCN._replace(resnet=SMALL_DCN, input_h=64,
                                          input_w=64)
    p = jax.jit(jm.init_maskrcnn_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    p = lift_offsets({k: np.array(v) for k, v in p.items()}, 2)
    p["roi_heads.box.predictor.cls_score.bias"][3] = LIFT
    img = np.random.RandomState(3).uniform(0, 1, (1, 64, 64, 3)) \
        .astype(np.float32)
    want = jm.maskrcnn_inference(
        {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()},
        jnp.asarray(img).astype(jnp.bfloat16), jcfg)
    want = {k: np.asarray(getattr(want, k).astype(jnp.float32))
            if k in ("boxes", "scores") else np.asarray(getattr(want, k))
            for k in ("boxes", "scores", "labels", "valid")}
    state = convert.maskrcnn_state_dict_from_numpy(p, device="cpu")
    for option in ("mask_dtype", "compute_dtype"):
        model = PerceptionModel(64, 96, small, device="cpu", mask_state=state,
                                **{option: torch.bfloat16})
        got = model.mask_model(nchw(img))
        got = {k: getattr(got, k).float().numpy()
               if k in ("boxes", "scores") else getattr(got, k).numpy()
               for k in ("boxes", "scores", "labels", "valid")}
        report = chip_smoke.match_detections(got, want,
                                             small.confidence_threshold)
        print(f"{option} bf16 against JAX bf16: {report}")
        assert report["boxes_matched"] >= 0.8 * min(report["valid"]) > 0 \
            and not report["unexplained"], (option, report)


def test_load_c2_on_a_dcn_model():
    """``MaskRCNN.load_c2`` on a DCN model (an X-50-32x4d-DCN, R-50's
    Detectron blob names): the deformable 3x3s take the conv2 blobs, the
    offset convs are listed as filled and keep the model's zeros, exactly
    as the JAX loader aligns them."""
    resnet = jb.ResNetConfig(num_groups=32, width_per_group=4,
                             stride_in_1x1=False,
                             stage_with_dcn=(False, True, True, True),
                             with_modulated_dcn=True)
    jcfg = jm.MaskRCNNConfig(resnet=resnet)
    blobs = make_c2_blobs("R-50", 32, 4, seed=3)
    state = jc2.translate_c2_blobs(blobs, "R-50-FPN",
                                   stage_with_dcn=resnet.stage_with_dcn)
    init = jax.jit(jm.init_maskrcnn_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    jparams, jfilled, junmatched = jc2.align_c2_to_model(state, init)
    model = tm.MaskRCNN(tm.MaskRCNNConfig(resnet=tb.ResNetConfig(*resnet)),
                        seed=1, device="cpu")
    filled, unmatched = model.load_c2(blobs, "R-50-FPN")
    assert sorted(filled) == sorted(jfilled)
    assert unmatched == junmatched
    assert sorted(unmatched) == ["fc1000.bias", "fc1000.weight"]
    offsets = [k for k in model.state_dict() if ".conv2.offset." in k]
    assert len(offsets) == 2 * (4 + 6 + 3) and sorted(filled) == \
        sorted(offsets)
    want = convert.maskrcnn_state_dict_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    got = model.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_array_equal(
        got["backbone.body.layer3.2.conv2.conv.weight"].numpy(),
        blobs["res4_2_branch2b_w"])


# ---------------------------------------------------------------------------
# ROIPool
# ---------------------------------------------------------------------------

def roi_pool_cases():
    rng = np.random.RandomState(0)
    feat = rng.randn(16, 20, 3).astype(np.float32)
    rois = np.asarray([
        [4.0, 8.0, 60.0, 50.0],
        [0.0, 0.0, 79.0, 63.0],
        [30.0, 20.0, 34.0, 25.0],        # tiny: some bins empty
        [-20.0, -12.0, 6.0, 10.0],        # reaches past the top left
        [70.0, 56.0, 140.0, 90.0],        # past the bottom right
        [2.0, 6.0, 10.0, 14.0],           # corners at half: 0.5, 1.5, 2.5, 3.5
        [10.0, 18.0, 26.0, 42.0],         # 2.5, 4.5, 6.5, 10.5
        [0.0, 0.0, 0.0, 0.0],
    ], np.float32)
    rand = rng.uniform(-10, 90, (40, 4)).astype(np.float32)
    rand[:, 2:] = rand[:, :2] + rng.uniform(0, 40, (40, 2))
    return [("edge cases 7x7", feat, rois, 0.25, 7),
            ("random 7x7", feat, rand, 0.25, 7),
            ("random 14x14 scale 0.5", rng.randn(9, 12, 5).astype(np.float32),
             rand, 0.5, 14)]


@pytest.mark.parametrize("case", roi_pool_cases(), ids=lambda c: c[0])
def test_roi_pool_bit_equal_to_jax(case):
    _, feat, rois, scale, res = case
    want = np.asarray(j_roi_pool(jnp.asarray(feat), jnp.asarray(rois), scale,
                                 res))
    got = roi_pool(nchw(feat[None]), torch.from_numpy(rois), scale, res)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)


def test_roi_pool_half_corners_round_to_even_and_empty_bins_are_zero():
    feat = torch.arange(64, dtype=torch.float32).reshape(1, 1, 8, 8) - 100.0
    # x0 = 0.5 -> 0 and x1 = 2.5 -> 2 (half to even), y0 = 1.5 -> 2
    got = roi_pool(feat, torch.tensor([[1.0, 3.0, 5.0, 3.0]]), 0.5, 2)
    # rows {2}, columns {0, 1} and {1, 2}: the max is the larger column
    assert got[0, 0].tolist() == [[-83.0, -82.0], [-83.0, -82.0]]
    # the bins left of the map are empty
    empty = roi_pool(torch.ones(1, 1, 8, 8), torch.tensor([[-8.0, 0, 3, 7]]),
                     1.0, 7)
    assert empty[0, 0, :, 0].eq(0).all() and empty[0, 0, :, 4:].eq(1).all()
    # a ROI wholly outside the map: every bin empty
    out = roi_pool(feat, torch.tensor([[40.0, 40.0, 60.0, 60.0]]), 1.0, 3)
    assert not out.any()


def test_roi_pool_chunks_alike(monkeypatch):
    from vido_slam_tpu_torch.ops import roi_pool as mod

    _, feat, rois, scale, res = roi_pool_cases()[1]
    whole = roi_pool(nchw(feat[None]), torch.from_numpy(rois), scale, res)
    monkeypatch.setattr(mod, "CHUNK_BYTES", 1)
    assert torch.equal(roi_pool(nchw(feat[None]), torch.from_numpy(rois),
                                scale, res), whole)
