"""The deformable detector in bf16 (``ops/deform_conv.py`` on bf16 tensors,
the DCN ResNeXt cast to bf16) against the JAX package's bf16 functions on
the CPU, on the same numpy-seeded inputs cast to bf16 the same way in both
packages (round to nearest even).

How the dtypes flow, in both packages: the sample coordinates are float32,
so each tap's bilinear samples of bf16 texels are float32 and so is its
contraction with the bf16 weights (widened), and ``deform_conv2d`` returns
float32; the norm and relu after it run in float32 against the bf16
FrozenBN parameters; the 1x1 after them casts back to the weights' dtype,
so the stage output, the FPN and kernel 5 stay bf16.

Bars and why:
  - ``deform_conv2d``: JAX's dtype (float32) and values within 1e-5 of
    max(1, max |out|): the same float32 products, summed in another order.
  - one DCN bottleneck in bf16: within one bf16 step plus 1e-5 of
    max(1, max |out|) (``chip_smoke.bf16_bar``), the output being bf16.
  - the one-block-a-stage X-101-DCN detector at 128x160 (seeded non-zero
    offset convs, class 3's score bias lifted to 30 on a 0..1 image, as
    the float32 parity test feeds it): validity and labels equal slot by
    slot except within a bf16 margin of a threshold, and at least 80 % of
    the valid boxes matched one to one at IoU >= 0.9
    (``chip_smoke.match_detections``, as tests/test_torch_bf16.py holds
    the bf16 R-50-FPN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_dcn_roipool import LIFT, SMALL_DCN, lift_offsets, nchw, nhwc
from vido_slam_tpu.models.maskrcnn import backbone as jb
from vido_slam_tpu.models.maskrcnn import model as jm
from vido_slam_tpu.models.maskrcnn import roi_heads as jh
from vido_slam_tpu.ops.deform_conv import deform_conv2d as j_deform
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models.maskrcnn import backbone as tb
from vido_slam_tpu_torch.models.maskrcnn import model as tm
from vido_slam_tpu_torch.models.perception import PerceptionModel
from vido_slam_tpu_torch.ops import roi_align as t_roi
from vido_slam_tpu_torch.ops.deform_conv import deform_conv2d

torch.set_num_threads(2)
BF = jnp.bfloat16
TB = torch.bfloat16
H, W = 128, 160


def bf(a):
    """A float32 numpy array as (JAX bf16, numpy float32 of the same bf16
    values)."""
    j = jnp.asarray(np.asarray(a, np.float32)).astype(BF)
    return j, np.asarray(j.astype(jnp.float32))


def tbf(a, perm):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(perm))).to(TB)


@pytest.mark.parametrize("groups", [1, 32])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("modulated", [False, True],
                         ids=["v1", "modulated"])
def test_deform_conv_bf16_matches_jax(groups, stride, modulated):
    rng = np.random.RandomState(10 * groups + 3 * stride + modulated)
    N, h, w, cin, cout = 2, 11, 13, 64, 64
    ho = (h + 2 - 2 - 1) // stride + 1
    wo = (w + 2 - 2 - 1) // stride + 1
    jx, x = bf(rng.randn(N, h, w, cin))
    jo, off = bf(rng.randn(N, ho, wo, 18) * 1.5)
    jw, wt = bf(rng.randn(3, 3, cin // groups, cout) * 0.2)
    jm_ = m = None
    if modulated:
        # the mask as DFConv2d makes it: the sigmoid of bf16 logits, in bf16
        logits = jnp.asarray(rng.randn(N, ho, wo, 9).astype(np.float32)) \
            .astype(BF)
        jm_ = jax.nn.sigmoid(logits)
        t_logits = tbf(np.asarray(logits.astype(jnp.float32)), (0, 3, 1, 2))
        m = 1 / (1 + torch.exp(-t_logits))
        # a place where the two may part: the sigmoid of a bf16 logit, as
        # DFConv2d computes it, equals JAX's to the bit (torch.sigmoid,
        # which rounds once, does not)
        np.testing.assert_array_equal(
            np.asarray(jm_.astype(jnp.float32)).transpose(0, 3, 1, 2),
            m.float().numpy())
    want = j_deform(jx, jo, jw, stride=stride, padding=1, mask=jm_,
                    groups=groups)
    assert want.dtype == jnp.float32
    got = deform_conv2d(tbf(x, (0, 3, 1, 2)), tbf(off, (0, 3, 1, 2)),
                        tbf(wt, (3, 2, 0, 1)), stride=stride, padding=1,
                        mask=m, groups=groups)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    got = nhwc(got)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    print(f"groups {groups} stride {stride} modulated {modulated}: max "
          f"error {err:.2e} of {scale:.2f}")
    assert err <= 1e-5 * scale


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("modulated", [False, True],
                         ids=["v1", "modulated"])
def test_deform_conv_bf16_on_texels_and_past_the_border(stride, modulated):
    """Where two implementations of a bf16 DCN may part: integer bf16
    offsets, so that every sample lands exactly on a texel (one bilinear
    weight 1, three 0), some of them past the border (the corners' offsets
    all -1 or all +1 beside the padding), and the modulated mask of
    DFConv2d at logits 0 (sigmoid 0.5 in bf16). Bar as
    test_deform_conv_bf16_matches_jax."""
    rng = np.random.RandomState(20 + 2 * stride + modulated)
    N, h, w, cin, cout = 1, 9, 11, 32, 32
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    jx, x = bf(rng.randn(N, h, w, cin))
    off = rng.randint(-3, 4, (N, ho, wo, 18)).astype(np.float32)
    off[0, 0, 0, :] = -1.0
    off[0, -1, -1, :] = 1.0
    jo, off = bf(off)
    jw, wt = bf(rng.randn(3, 3, cin, cout) * 0.2)
    jm_ = m = None
    if modulated:
        jm_ = jax.nn.sigmoid(jnp.zeros((N, ho, wo, 9), BF))
        m = 1 / (1 + torch.exp(-torch.zeros((N, 9, ho, wo), dtype=TB)))
        np.testing.assert_array_equal(
            np.asarray(jm_.astype(jnp.float32)).transpose(0, 3, 1, 2),
            m.float().numpy())
        assert float(m[0, 0, 0, 0]) == 0.5
    want = np.asarray(j_deform(jx, jo, jw, stride=stride, padding=1,
                               mask=jm_))
    got = nhwc(deform_conv2d(tbf(x, (0, 3, 1, 2)), tbf(off, (0, 3, 1, 2)),
                             tbf(wt, (3, 2, 0, 1)), stride=stride,
                             padding=1, mask=m))
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("res", [7, 14])
def test_roi_align_bf16_at_the_image_edges_matches_jax(res):
    """The bf16 DCN detector's pooler (kernel 5's plain version in bf16) on
    ROIs along the edges of a 128x160 image, each level in turn: the whole
    image, boxes ending exactly on its last row and column, boxes reaching
    past them; equal to JAX's bf16 ROIAlign to the bit."""
    rng = np.random.RandomState(res)
    sizes = [(32, 40), (16, 20), (8, 10), (4, 5)]
    feats = [rng.randn(hh, ww, 8).astype(np.float32) for hh, ww in sizes]
    rois = np.array([[0, 0, 160, 128], [0, 0, 159, 127], [150, 120, 160, 128],
                     [-4, -4, 4, 4], [156, 124, 164, 132], [0, 100, 160, 128],
                     [140, 0, 160, 128], [-1, -1, 161, 129]] * 4, np.float32)
    levels = np.repeat(np.arange(4), 8).astype(np.int32)
    want = jh.roi_align_multilevel(
        tuple(jnp.asarray(f).astype(BF) for f in feats), jnp.asarray(rois),
        jnp.asarray(levels), jh.POOLER_SCALES, res, 2)
    got = t_roi.roi_align_multilevel(
        [tbf(f, (2, 0, 1))[None] for f in feats], torch.from_numpy(rois),
        torch.from_numpy(levels), jh.POOLER_SCALES, res, 2)
    assert got.dtype == TB
    np.testing.assert_array_equal(
        got.float().numpy().transpose(0, 2, 3, 1),
        np.asarray(want.astype(jnp.float32)))


def test_dcn_bottleneck_bf16_matches_jax():
    """One modulated DCN bottleneck of the X-101 stage 3 widths (stride 2,
    32 groups, seeded non-zero offset convs), parameters and input in
    bf16, against the JAX ``_bottleneck`` on the same bf16 values."""
    cfg = jb.ResNetConfig(stage_blocks=(1, 1, 1, 1), num_groups=32,
                          width_per_group=8, stride_in_1x1=False,
                          stage_with_dcn=(False, True, False, False),
                          with_modulated_dcn=True)
    p = jax.jit(jb.init_resnet_fpn_params, static_argnums=1)(
        jax.random.PRNGKey(3), cfg)
    pre = "backbone.body.layer2.0"
    p = lift_offsets({k: np.array(v) for k, v in p.items()
                      if k.startswith(pre)}, 4)
    jx, x = bf(np.random.RandomState(5).randn(1, 16, 20, 256))
    want = jb._bottleneck({k: jnp.asarray(v).astype(BF)
                           for k, v in p.items()}, pre, jx, 2, 32, False,
                          dcn=True, modulated_dcn=True)
    assert want.dtype == BF
    block = tb.Bottleneck(256, 512, 512, 2, 32, False, dcn=True,
                          modulated_dcn=True)
    block.load_state_dict({k[len(pre) + 1:]: v for k, v in
                           convert.maskrcnn_state_dict_from_numpy(
                               p, device="cpu").items()}, strict=True)
    block.to(TB)
    dcn_out = []
    block.conv2.register_forward_hook(lambda m, i, o: dcn_out.append(o))
    with torch.no_grad():
        got = block(nchw(x).to(TB))
    assert got.dtype == TB and dcn_out[0].dtype == torch.float32
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32))
                            .transpose(0, 3, 1, 2).copy())
    d = (got.float() - want).abs()
    print(f"DCN bottleneck bf16: max error {float(d.max()):.3e}, "
          f"{int((d > 0).sum())} of {d.numel()} outputs differ")
    assert bool((d <= chip_smoke.bf16_bar(want)).all()), float(d.max())


def _dets(d):
    return {k: np.asarray(getattr(d, k), np.float32)
            if k in ("boxes", "scores") else np.asarray(getattr(d, k))
            for k in ("boxes", "scores", "labels", "valid")}


def test_small_dcn_detector_bf16_matches_jax():
    """The X-101-DCN detector, one block a stage, at 128x160 with bf16
    parameters against JAX's bf16 detector on the same bf16 values."""
    cfg = jm.MaskRCNNConfig(resnet=SMALL_DCN, input_h=H, input_w=W)
    p = jax.jit(jm.init_maskrcnn_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    p = lift_offsets({k: np.array(v) for k, v in p.items()}, 1)
    p["roi_heads.box.predictor.cls_score.bias"][3] = LIFT
    img = np.random.RandomState(2).uniform(0, 1, (1, H, W, 3)) \
        .astype(np.float32)
    want = jm.maskrcnn_inference({k: jnp.asarray(v).astype(BF)
                                  for k, v in p.items()},
                                 jnp.asarray(img).astype(BF), cfg)
    want = jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32))
        if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x), want)
    model = tm.MaskRCNN(tm.MaskRCNNConfig(resnet=tb.ResNetConfig(*SMALL_DCN),
                                          input_h=H, input_w=W),
                        device="cpu")
    model.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
        p, device="cpu"), strict=True)
    model.to(TB)
    before = t_roi.roi_align_multilevel.launches
    got = model(nchw(img))
    assert t_roi.roi_align_multilevel.launches == before
    assert got.boxes.dtype == torch.float32 and got.masks28.dtype == TB
    report = chip_smoke.match_detections(_dets(got), _dets(want),
                                         cfg.confidence_threshold)
    print(f"DCN detector bf16 against JAX bf16: {report}")
    assert report["boxes_matched"] >= 0.8 * min(report["valid"]) >= 16 \
        and not report["unexplained"], report


@pytest.mark.parametrize("option", ["mask_dtype", "compute_dtype"])
def test_perception_model_dcn_bf16_runs(option):
    """``PerceptionModel`` with a DCN config and the detector in bf16: the
    whole model runs on a pair, the detector's weights are bf16 and its
    detections finite."""
    small = tm.RESNEXT101_FPN_DCN._replace(
        resnet=tb.ResNetConfig(*SMALL_DCN), input_h=64, input_w=64)
    model = PerceptionModel(64, 96, small, device="cpu", **{option: TB})
    assert next(model.mask_model.parameters()).dtype == TB
    assert (next(model.depth_net.parameters()).dtype == TB) \
        == (option == "compute_dtype")
    with torch.no_grad():
        model.mask_model.roi_heads.box.predictor.cls_score.bias[3] = LIFT
    rng = np.random.RandomState(0)
    prev, cur = (torch.from_numpy(rng.randint(0, 256, (64, 96, 3))
                                  .astype(np.float32)) for _ in range(2))
    out = model(prev, cur)
    assert out.mask.shape == (64, 96) and bool((out.mask > 0).any())
    assert bool(torch.isfinite(out.flow).all())
