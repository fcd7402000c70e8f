"""The port's Mask R-CNN (``models/maskrcnn``, ``models/perception.py::
perception_mask``, ``convert.maskrcnn_state_dict_from_numpy``) against the
JAX package, stage by stage and whole, on the same numpy-seeded inputs and
the same parameters (the JAX init at the full R-50-FPN depth, carried
across with ``maskrcnn_state_dict_from_numpy``).

Discrete stages (RPN selection, NMS, per-class selection) are fed the JAX
stage's own inputs and must make the same selection: validity exactly, the
selected boxes within 1e-3 px (the same index gives the same box to float32
rounding), scores within 1e-6. Continuous stages: layers 1e-5 of the
output's magnitude, FPN features 1e-5 of theirs, head outputs 1e-4 of
theirs, masks28 1e-4. Semantic masks: equal on every pixel whose value the
JAX paste leaves unchanged when the threshold moves by 1e-4.

The whole-model input is a 0..1 image with class 3's score bias lifted to
30. The random backbone is positively homogeneous (zero biases), so a raw
0..255 image only scales every feature by 255; at that scale the float32
noise of two implementations reaches 1e-2 px in the box deltas. The lift
makes class 3's probability exactly 1.0 in float32 for every proposal, so
the per-class and final top-k meet exact ties and the tie rule (the lower
index first) decides them; a lift of 12 leaves scores near 0.9997, where
scores share their last bits and two softmax implementations order them
differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.models import layers as j_layers
from vido_slam_tpu.models.maskrcnn import backbone as jb
from vido_slam_tpu.models.maskrcnn import model as jm
from vido_slam_tpu.models.maskrcnn import roi_heads as jh
from vido_slam_tpu.models.maskrcnn import rpn as jr
from vido_slam_tpu.ops.roi_align import roi_align_multilevel as j_roi_ml
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models import layers as t_layers
from vido_slam_tpu_torch.models.maskrcnn import backbone as tb
from vido_slam_tpu_torch.models.maskrcnn import model as tm
from vido_slam_tpu_torch.models.maskrcnn import roi_heads as th
from vido_slam_tpu_torch.models.maskrcnn import rpn as tr
from vido_slam_tpu_torch.models.perception import perception_mask
from vido_slam_tpu_torch.ops import nms as t_nms
from vido_slam_tpu_torch.ops import roi_align as t_roi

torch.set_num_threads(1)

H, W = 128, 160
LIFT = 30.0


def nchw(a):
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def close_to_scale(got, want, rel):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rel * scale, (err, scale)


@pytest.fixture(scope="module")
def params():
    """The JAX init of the full R-50-FPN detector (numpy), class 3
    lifted."""
    cfg = jm.MaskRCNNConfig(input_h=H, input_w=W)
    p = jax.jit(jm.init_maskrcnn_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    p = {k: np.array(v) for k, v in p.items()}
    p["roi_heads.box.predictor.cls_score.bias"][3] = LIFT
    return p


@pytest.fixture(scope="module")
def model(params):
    m = tm.MaskRCNN(tm.MaskRCNNConfig(input_h=H, input_w=W), device="cpu")
    m.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
        params, device="cpu"), strict=True)
    return m


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(1).uniform(
        0, 1, (1, H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run(params, image):
    """The JAX detector stage by stage (model.py:89-125), each stage's
    inputs and outputs as numpy."""
    cfg = jm.MaskRCNNConfig(input_h=H, input_w=W)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    feats = jax.jit(lambda p, x: jb.fpn_forward(
        p, jb.resnet_stages(p, x, cfg.resnet)))(p, jnp.asarray(image))
    run = {"feats": [np.asarray(f) for f in feats], "levels": []}
    sel = []
    for li, f in enumerate(feats):
        stride = jr.ANCHOR_STRIDES[li]
        cell = jr.generate_cell_anchors(stride, jr.ANCHOR_SIZES[li])
        anchors = jr.grid_anchors(f.shape[1], f.shape[2], stride, cell)
        logits, deltas = jr.rpn_head(p, f, cell.shape[0])
        obj = logits[0].reshape(-1)
        dl = deltas[0].reshape(-1, 4)
        out = jr.select_proposals_level(obj, dl, jnp.asarray(anchors), H, W)
        sel.append(out)
        run["levels"].append(dict(
            obj=np.asarray(obj), deltas=np.asarray(dl), anchors=anchors,
            out=[np.asarray(a) for a in out]))
    props, pscores, pvalid = jr.select_over_all_levels(*zip(*sel))
    run["proposals"] = [np.asarray(a) for a in (props, pscores, pvalid)]
    p2_p5 = [f[0] for f in feats[:4]]
    logits, deltas = jh.box_head_forward(p, p2_p5, props)
    run["box_head"] = (np.asarray(logits), np.asarray(deltas))
    det = jh.postprocess_detections(logits, deltas, props, pvalid, H, W)
    run["det"] = [np.asarray(a) for a in det]
    det = det._replace(valid=det.valid & (det.scores > cfg.confidence_threshold))
    run["masks28"] = np.asarray(jh.mask_head_forward(p, p2_p5, det))
    whole = jm.maskrcnn_inference(p, jnp.asarray(image), cfg)
    run["whole"] = jax.tree_util.tree_map(np.asarray, whole)
    return run


# ---------------------------------------------------------------------------
# layers and the backbone
# ---------------------------------------------------------------------------

def test_frozen_bn_and_max_pool_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 9, 6).astype(np.float32)
    w, b, mean = (rng.randn(6).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.01, 2, 6).astype(np.float32)
    bn = t_layers.FrozenBatchNorm2d(6)
    bn.load_state_dict({"weight": t32(w), "bias": t32(b),
                        "running_mean": t32(mean), "running_var": t32(var)})
    want = np.asarray(j_layers.batch_norm(x, w, b, mean, var, eps=0.0))
    close_to_scale(nhwc(bn(nchw(x))), want, 1e-5)
    np.testing.assert_array_equal(
        nhwc(t_layers.max_pool(nchw(x), 3, 2, 1)),
        np.asarray(j_layers.max_pool(jnp.asarray(x), 3, 2, 1)))


def _block_params(rng, cin, planes, cout, groups):
    """JAX-layout parameters of one bottleneck with random FrozenBN
    statistics (tests/test_maskrcnn.py:71-113)."""
    p = {}

    def conv(name, ci, co, k, g=1):
        p[f"{name}.weight"] = (rng.randn(k, k, ci // g, co)
                               / np.sqrt(ci // g * k * k)).astype(np.float32)

    def bn(name, c):
        p[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        p[f"{name}.bias"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
        p[f"{name}.running_mean"] = rng.uniform(-0.5, 0.5, c).astype(
            np.float32)
        p[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)

    conv("conv1", cin, planes, 1)
    bn("bn1", planes)
    conv("conv2", planes, planes, 3, groups)
    bn("bn2", planes)
    conv("conv3", planes, cout, 1)
    bn("bn3", cout)
    conv("downsample.0", cin, cout, 1)
    bn("downsample.1", cout)
    return p


@pytest.mark.parametrize("stride_in_1x1", [True, False])
def test_bottleneck_matches_jax(stride_in_1x1):
    rng = np.random.RandomState(int(stride_in_1x1))
    p = _block_params(rng, 32, 16, 64, 4)
    x = rng.randn(1, 8, 8, 32).astype(np.float32)
    want = np.asarray(jb._bottleneck(
        {f"b.{k}": jnp.asarray(v) for k, v in p.items()}, "b",
        jnp.asarray(x), 2, 4, stride_in_1x1))
    block = tb.Bottleneck(32, 16, 64, 2, 4, stride_in_1x1)
    block.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
        p, device="cpu"), strict=True)
    with torch.no_grad():
        got = nhwc(block(nchw(x)))
    assert got.shape == want.shape == (1, 4, 4, 64)
    close_to_scale(got, want, 1e-5)


def test_resnext_backbone_matches_jax():
    """The ROS node's block layout (32 groups of 8, stride on the 3x3) one
    block a stage, through the JAX package's grouped-conv supergroups and
    the port's ``nn.Conv2d(groups=32)``, then the FPN, at 72 x 88 (sides
    that halve to odd sizes, so the top-down resizes are not exact 2x)."""
    cfg = jb.ResNetConfig(stage_blocks=(1, 1, 1, 1), num_groups=32,
                          width_per_group=8, stride_in_1x1=False)
    p = jax.jit(jb.init_resnet_fpn_params, static_argnums=1)(
        jax.random.PRNGKey(3), cfg)
    x = np.random.RandomState(3).uniform(0, 1, (1, 72, 88, 3)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jb.fpn_forward(
        p, jb.resnet_stages(p, x, cfg)))(p, jnp.asarray(x))
    net = tb.Backbone(tb.ResNetConfig(*cfg))
    net.load_state_dict({k[len("backbone."):]: v for k, v in
                         convert.maskrcnn_state_dict_from_numpy(
                             p, device="cpu").items()}, strict=True)
    with torch.no_grad():
        got = net(nchw(x))
    assert [tuple(g.shape[2:]) for g in got] \
        == [(18, 22), (9, 11), (5, 6), (3, 3), (2, 2)]
    for g, w in zip(got, want):
        close_to_scale(nhwc(g), np.asarray(w), 1e-5)


def test_fpn_matches_jax_features(model, image, jax_run):
    with torch.no_grad():
        got = model.backbone(nchw(image))
    for g, w in zip(got, jax_run["feats"]):
        assert nhwc(g).shape == w.shape
        close_to_scale(nhwc(g), w, 1e-5)


def test_unported_configs_raise():
    """Deformable stages are ported (tests/test_torch_dcn_roipool.py), in
    float32 and bf16 (item 19c: a bf16 input gives float32, as the JAX
    function returns). GroupNorm is ported
    (tests/test_torch_maskrcnn_variants.py) and another norm is refused."""
    from vido_slam_tpu.ops.deform_conv import deform_conv2d as j_deform
    from vido_slam_tpu_torch.ops.deform_conv import deform_conv2d

    with pytest.raises(ValueError, match="frozen_bn"):
        tb.ResNet(tb.ResNetConfig(norm="sync_bn"))
    with torch.device("meta"):
        net = tb.ResNet(tb.ResNetConfig(stage_with_dcn=(False, True, True,
                                                        True)))
    assert isinstance(net.layer2[0].conv2, tb.DFConv2d)
    assert not isinstance(net.layer1[0].conv2, tb.DFConv2d)
    got = deform_conv2d(torch.ones(1, 4, 6, 6, dtype=torch.bfloat16),
                        torch.zeros(1, 18, 6, 6), torch.ones(4, 4, 3, 3))
    want = j_deform(jnp.ones((1, 6, 6, 4), jnp.bfloat16),
                    jnp.zeros((1, 6, 6, 18)), jnp.ones((3, 3, 4, 4)))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# RPN
# ---------------------------------------------------------------------------

def test_anchors_match_jax():
    for stride, size in zip(tr.ANCHOR_STRIDES, tr.ANCHOR_SIZES):
        cell = tr.generate_cell_anchors(stride, size)
        np.testing.assert_array_equal(
            cell, jr.generate_cell_anchors(stride, size))
        np.testing.assert_array_equal(tr.grid_anchors(5, 7, stride, cell),
                                      jr.grid_anchors(5, 7, stride, cell))


def test_rpn_head_matches_jax(params, jax_run):
    f = jax_run["feats"][2]
    p = {k: jnp.asarray(v) for k, v in params.items() if k.startswith("rpn")}
    lg, dl = jr.rpn_head(p, jnp.asarray(f), 3)
    head = tr.RPNHead()
    head.load_state_dict({k[len("rpn.head."):]: v for k, v in
                          convert.maskrcnn_state_dict_from_numpy(
                              params, device="cpu").items()
                          if k.startswith("rpn.head.")})
    with torch.no_grad():
        obj, deltas = head(nchw(f))
    close_to_scale(obj.numpy(), np.asarray(lg[0]).reshape(-1), 1e-5)
    close_to_scale(deltas.numpy(), np.asarray(dl[0]).reshape(-1, 4), 1e-5)


def _same_selection(got, want):
    """(boxes, scores, valid) of the port against the JAX stage's: validity
    exactly; boxes within 1e-3 px and scores within 1e-6, slot by slot,
    padded slots included."""
    gb, gs, gv = (a.numpy() for a in got)
    wb, ws, wv = want
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gb, wb, atol=1e-3, rtol=0)
    np.testing.assert_allclose(gs, ws, atol=1e-6, rtol=0)


@pytest.mark.parametrize("level", range(5))
def test_select_proposals_level_matches_jax(jax_run, level):
    lv = jax_run["levels"][level]
    got = tr.select_proposals_level(t32(lv["obj"]), t32(lv["deltas"]),
                                    t32(lv["anchors"]), H, W)
    assert lv["out"][2].sum() > 0
    _same_selection(got, lv["out"])


def test_rpn_nms_matches_jax(jax_run):
    """The NMS of level 0's top 1000 (chains of many overlapping
    proposals) on the JAX stage's boxes and scores: the same indices."""
    from vido_slam_tpu.ops.nms import decode_boxes, clip_boxes, nms

    lv = jax_run["levels"][0]
    scores = jax.nn.sigmoid(jnp.asarray(lv["obj"]))
    vals, idx = jax.lax.top_k(scores, 1000)
    boxes = clip_boxes(decode_boxes(jnp.asarray(lv["deltas"])[idx],
                                    jnp.asarray(lv["anchors"])[idx]), H, W)
    ok = np.ones(1000, bool)
    ok[::7] = False
    want_i, want_v = nms(boxes, vals, jnp.asarray(ok), 0.7, 1000)
    got_i, got_v = t_nms.nms(t32(boxes), t32(vals), torch.from_numpy(ok),
                             0.7, 1000)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert 0 < int(got_v.sum()) < 857


def test_select_over_all_levels_matches_jax(jax_run):
    outs = [[t32(a) if a.dtype != bool else torch.from_numpy(a)
             for a in lv["out"]] for lv in jax_run["levels"]]
    got = tr.select_over_all_levels(*zip(*outs))
    _same_selection(got, jax_run["proposals"])


# ---------------------------------------------------------------------------
# ROI heads
# ---------------------------------------------------------------------------

def test_assign_fpn_level_matches_jax_at_the_boundaries():
    """The boxes of tests/test_maskrcnn.py:55-68 and boxes whose +1 side is
    exactly 112, 224 or 448, and one ulp of a side either way."""
    rois = [[0, 0, 55, 55], [0, 0, 111, 111], [0, 0, 223, 223],
            [0, 0, 447, 447], [0, 0, 1000, 1000], [0, 0, 0, 0],
            [5, 5, 4, 4]]
    for side in (112.0, 224.0, 448.0):
        for s in (np.nextafter(np.float32(side), 0), np.float32(side),
                  np.nextafter(np.float32(side), 1e4)):
            rois.append([10.0, 10.0, 10.0 + s - 1, 10.0 + s - 1])
    rois = np.asarray(rois, np.float32)
    want = np.asarray(jh.assign_fpn_level(jnp.asarray(rois)))
    got = th.assign_fpn_level(t32(rois)).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[:5]) == [0, 1, 2, 3, 3]


@pytest.mark.parametrize("res", [7, 14])
def test_pooled_features_match_jax(jax_run, res):
    """The heads' pooling on the JAX FPN levels and proposals (the plain
    version for CPU tensors) against the JAX multilevel ROIAlign."""
    feats = jax_run["feats"][:4]
    rois = jax_run["proposals"][0][:300]
    want = np.asarray(j_roi_ml(
        tuple(jnp.asarray(f[0]) for f in feats), jnp.asarray(rois),
        jh.assign_fpn_level(jnp.asarray(rois)), jh.POOLER_SCALES, res, 2))
    got = th.pooled_features([nchw(f) for f in feats], t32(rois), res)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=2e-5, rtol=1e-5)
    assert t_roi.roi_align_multilevel.launches == 0


def test_box_head_matches_jax(model, jax_run):
    feats = [nchw(f) for f in jax_run["feats"][:4]]
    with torch.no_grad():
        logits, deltas = th.box_head_forward(
            model.roi_heads.box, feats, t32(jax_run["proposals"][0]))
    close_to_scale(logits.numpy(), jax_run["box_head"][0], 1e-4)
    close_to_scale(deltas.numpy(), jax_run["box_head"][1], 1e-4)


def test_postprocess_detections_matches_jax(jax_run):
    logits, deltas = jax_run["box_head"]
    props, _, pvalid = jax_run["proposals"]
    got = th.postprocess_detections(t32(logits), t32(deltas), t32(props),
                                    torch.from_numpy(pvalid), H, W)
    want = jax_run["det"]
    np.testing.assert_array_equal(got.labels.numpy(), want[2])
    _same_selection((got.boxes, got.scores, got.valid),
                    (want[0], want[1], want[3]))
    assert want[3].sum() >= 20 and (want[1][want[3]] == 1.0).all()


def test_mask_head_matches_jax(model, jax_run):
    feats = [nchw(f) for f in jax_run["feats"][:4]]
    b, s, lab, v = jax_run["det"]
    det = th.Detections(t32(b), t32(s), torch.from_numpy(lab.astype(np.int64)),
                        torch.from_numpy(v))
    with torch.no_grad():
        got = th.mask_head_forward(model.roi_heads.mask, feats, det)
    np.testing.assert_allclose(got.numpy(), jax_run["masks28"], atol=1e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# the whole detector and the perception mask branch
# ---------------------------------------------------------------------------

def test_state_dict_keys_are_the_checkpoints(params, model):
    assert set(model.state_dict()) == set(params)
    assert "backbone.body.layer1.0.conv1.weight" in params
    assert tuple(model.roi_heads.mask.predictor.conv5_mask.weight.shape) \
        == (256, 256, 2, 2)
    own = tm.init_maskrcnn_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} \
        == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sum(v.numel() for v in own.values()) == 44_453_813
    x101 = tm.init_maskrcnn_params(torch.Generator().manual_seed(0),
                                   tm.RESNEXT101_FPN)
    jx = jax.eval_shape(lambda k: jm.init_maskrcnn_params(
        k, jm.RESNEXT101_FPN), jax.random.PRNGKey(0))
    assert set(x101) == set(jx)
    for k, v in jx.items():
        assert tuple(x101[k].shape) == convert.maskrcnn_state_dict_from_numpy(
            {k: np.zeros(v.shape, np.float32)}, device="cpu")[k].shape, k


def test_whole_inference_matches_jax(model, image, jax_run):
    want = jax_run["whole"]
    got = model(nchw(image))
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    v = want.valid
    assert v.sum() >= 20
    err = float(np.abs(got.boxes.numpy()[v] - want.boxes[v]).max())
    print(f"whole detector {H}x{W}: {v.sum()} valid, box error {err:.3e} px, "
          f"masks28 error "
          f"{np.abs(got.masks28.numpy() - want.masks28).max():.3e}")
    assert err <= 1e-3
    np.testing.assert_allclose(got.masks28.numpy(), want.masks28, atol=1e-4,
                               rtol=0)
    # the paste on the same detections
    _same_semantic_mask(tm.paste_semantic_mask(got, H, W, 60, 90),
                        want, H, W, 60, 90)


def _same_semantic_mask(got, det, in_h, in_w, out_h, out_w):
    """Equal on every pixel that the JAX paste leaves unchanged when the
    threshold moves by 1e-4 either way."""
    lo, mid, hi = (np.asarray(jm.paste_semantic_mask(det, in_h, in_w, out_h,
                                                     out_w, t))
                   for t in (0.5 - 1e-4, 0.5, 0.5 + 1e-4))
    stable = lo == hi
    assert got.dtype == torch.uint8 and got.shape == (out_h, out_w)
    assert stable.mean() > 0.95 and (mid > 0).any()
    np.testing.assert_array_equal(got.numpy()[stable], mid[stable])


def test_perception_mask_matches_jax(params, model):
    """perception.py:97-109 on a 60 x 90 BGR frame: RGB at its raw values,
    resized to the 128 x 160 input, the detector, pasted back at 60 x 90."""
    cfg = jm.MaskRCNNConfig(input_h=H, input_w=W)
    bgr = np.random.RandomState(7).uniform(0, 1, (60, 90, 3)).astype(
        np.float32)
    x = jax.image.resize(jnp.asarray(bgr)[None, :, :, ::-1], (1, H, W, 3),
                         method="bilinear")
    det = jm.maskrcnn_inference({k: jnp.asarray(v) for k, v in
                                 params.items()}, x, cfg)
    got = perception_mask(model, torch.from_numpy(bgr), device="cpu")
    _same_semantic_mask(got, jax.tree_util.tree_map(np.asarray, det), H, W,
                        60, 90)


def test_cuda_entry_points_raise_without_a_card(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.MaskRCNN()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perception_mask(model, np.zeros((8, 8, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.maskrcnn_state_dict_from_numpy({"b": np.zeros(2)})
    with pytest.raises(ValueError, match="expected"):
        model(torch.zeros((1, 3, 64, 64)))
