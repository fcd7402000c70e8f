"""The bf16 perception options (ROADMAP.md item 15b) against the JAX
package on the CPU: kernels 3, 4 and 5 in bfloat16 (their plain versions,
which the kernels' bf16 builds are held to on the card) and the three
networks cast to bf16, from one seeded float32 parameter dict (the port's
init, in the JAX layout by ``convert.convert_state_dict``) cast the same
way in both packages.

Bars and why:
  - kernels 3, 4, 5: each output within one bf16 step plus 1e-5 of
    max(1, max |out|) of the JAX function on the same bf16 inputs (XLA's
    ``correlation``, ``dist_weighted_flow`` and ``roi_align_multilevel``,
    and the Pallas kernels 3 and 4 in interpret mode;
    ``chip_smoke.bf16_bar``). Both compute in float32 and round once
    (three times for kernel 5, at the same places); only the order of the
    float32 sums differs, by at most the float32 bar where a sum cancels,
    which moves a rounding by at most one step more. Measured: equal for
    kernels 3 and 4, 2 of 376,320 kernel 5 outputs one step apart.
  - LiteFlowNet at 64x64: the JAX package's own bar for bf16 against f32,
    max|diff| / max(|flow|, 1) < 0.02 (tests/test_liteflownet.py:54-64), for
    the port's bf16 net against the port's f32 net and against JAX's bf16
    net (measured 2.2e-4 and 1.5e-4).
  - MonoDepth2 at 64x192: disparity (in (0, 1)) within 0.02 of JAX's bf16
    net and of the port's f32 net: a few bf16 ulps of 0.5 (2^-9) through
    20 convolutions and batch norms (measured 0.0078 and 0.0051; JAX's own
    bf16 against f32 0.0068).
  - R-50-FPN at 128x160 (random weights, a 0..1 image and class 3's
    score bias lifted to 30, as the f32 parity tests feed it; every score
    saturates at 1.0): the bf16 detector against JAX's bf16 detector and
    against the port's f32 detector by ``chip_smoke.match_detections``:
    validity and labels equal slot by slot, except slots whose detection
    lies within a bf16 margin of a threshold (its score within 2^-7 of the
    confidence threshold or of its class's lowest kept score, or its IoU
    with another kept box within 0.1 of the NMS threshold 0.5: with every
    score tied, the top-k cuts among the candidates are ties that a bf16
    shift of a proposal decides); and at least 80 % of the valid boxes
    matched one to one at IoU >= 0.9 (measured: 41 of 44 against JAX, 37
    of 44 against f32). The heads on the same inputs: box logits within
    0.05 of the largest, masks within 0.02 (bf16 sums of 12,544 and 2,304
    products).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vido_slam_tpu.models import liteflownet as j_lfn
from vido_slam_tpu.models import monodepth2 as j_md
from vido_slam_tpu.models.maskrcnn import model as jm
from vido_slam_tpu.models.maskrcnn import roi_heads as jh
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models import liteflownet as t_lfn
from vido_slam_tpu_torch.models import monodepth2 as t_md
from vido_slam_tpu_torch.models.maskrcnn import model as tm
from vido_slam_tpu_torch.models.maskrcnn import roi_heads as th
from vido_slam_tpu_torch.models.perception import PerceptionModel
from vido_slam_tpu_torch.ops import correlation as t_corr
from vido_slam_tpu_torch.ops import regularize as t_reg
from vido_slam_tpu_torch.ops import roi_align as t_roi

j_corr = importlib.import_module("vido_slam_tpu.ops.correlation")
j_reg = importlib.import_module("vido_slam_tpu.ops.regularize")
j_roi = importlib.import_module("vido_slam_tpu.ops.roi_align")

torch.set_num_threads(2)
BF = jnp.bfloat16
TB = torch.bfloat16


def within_ulp(got, want):
    """Within ``chip_smoke.bf16_bar``: one bf16 step plus 1e-5 of the
    output's scale (the float32 bar, for sums that cancel)."""
    got = torch.from_numpy(np.array(got, np.float32))
    want = torch.from_numpy(np.array(want, np.float32))
    assert got.shape == want.shape
    d = (got - want).abs()
    assert bool((d <= chip_smoke.bf16_bar(want)).all()), (
        float(d.max()), int((d > 0).sum()))


def tbf(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(TB)


def nchw(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)
                                .transpose(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# the kernels' bf16 plain versions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,C,H,W,s", [(1, 32, 16, 24, 1), (1, 64, 12, 20, 2),
                                       (2, 16, 9, 13, 2)])
def test_correlation_bf16_matches_jax(N, C, H, W, s):
    rng = np.random.RandomState(C + s)
    f1, f2 = (rng.randn(N, H, W, C).astype(np.float32) for _ in range(2))
    j1, j2 = jnp.asarray(f1).astype(BF), jnp.asarray(f2).astype(BF)
    got = t_corr.correlation(tbf(nchw(f1)), tbf(nchw(f2)), s)
    assert got.dtype == TB
    got = got.float().numpy().transpose(0, 2, 3, 1)
    for want in (j_corr.correlation(j1, j2, s),
                 j_corr.correlation_pallas(j1, j2, s, interpret=True)):
        assert want.dtype == BF
        within_ulp(got, want.astype(jnp.float32))


@pytest.mark.parametrize("N,k,H,W", [(1, 7, 16, 24), (1, 5, 12, 20),
                                     (2, 3, 9, 11)])
def test_regularize_bf16_matches_jax(N, k, H, W):
    rng = np.random.RandomState(k)
    K = k * k
    dc = (rng.randn(N, H, W, K) * 2).astype(np.float32)
    u, v = (rng.randn(N, H, W).astype(np.float32) * 3 for _ in range(2))
    wx, wy = (rng.randn(K).astype(np.float32) for _ in range(2))
    bx, by = np.float32(0.3), np.float32(-0.2)
    args = [jnp.asarray(a).astype(BF) for a in (dc, u, v, wx, bx, wy, by)]
    got = t_reg.dist_weighted_flow(
        tbf(nchw(dc)), tbf(np.stack([u, v], 1)), tbf(wx), tbf([bx]),
        tbf(wy), tbf([by]), k)
    assert got.dtype == TB
    for sx, sy in (j_reg.dist_weighted_flow(*args, k),
                   j_reg.dist_weighted_flow_pallas(*args, k, interpret=True)):
        assert sx.dtype == BF
        within_ulp(got.float().numpy(),
                   np.stack([np.asarray(sx.astype(jnp.float32)),
                             np.asarray(sy.astype(jnp.float32))], 1))


@pytest.mark.parametrize("res", [7, 14])
def test_roi_align_bf16_matches_jax(res):
    """The four levels of a 128x160 image, ROIs from sub-pixel to larger
    than the image and past its edges, each level forced in turn."""
    rng = np.random.RandomState(res)
    sizes = [(32, 40), (16, 20), (8, 10), (4, 5)]
    C, R = 16, 120
    feats = [rng.randn(h, w, C).astype(np.float32) for h, w in sizes]
    x1, y1 = rng.uniform(-20, 160, R), rng.uniform(-20, 128, R)
    ww, hh = np.exp(rng.uniform(np.log(1), np.log(200), (2, R)))
    rois = np.stack([x1, y1, x1 + ww, y1 + hh], 1).astype(np.float32)
    levels = rng.randint(0, 4, R).astype(np.int32)
    want = j_roi.roi_align_multilevel(
        tuple(jnp.asarray(f).astype(BF) for f in feats), jnp.asarray(rois),
        jnp.asarray(levels), jh.POOLER_SCALES, res, 2)
    assert want.dtype == BF
    got = t_roi.roi_align_multilevel(
        [tbf(f.transpose(2, 0, 1)[None]) for f in feats],
        torch.from_numpy(rois), torch.from_numpy(levels.copy()),
        jh.POOLER_SCALES,
        res, 2)
    assert got.dtype == TB
    within_ulp(got.float().numpy().transpose(0, 2, 3, 1),
               want.astype(jnp.float32))


def test_kernel_wrappers_refuse_mixed_and_half_dtypes():
    """On the CPU as on the card: float16, or float32 beside bf16, raises
    TypeError; nothing is cast quietly. ROIs stay float32."""
    f = torch.randn(1, 8, 6, 10)
    with pytest.raises(TypeError, match="one dtype"):
        t_corr.correlation(f, f.to(TB), 1)
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        t_corr.correlation(f.half(), f.half(), 1)
    w, b = torch.randn(9), torch.zeros(1)
    dc, flow = torch.randn(1, 9, 6, 10), torch.randn(1, 2, 6, 10)
    with pytest.raises(TypeError, match="one dtype"):
        t_reg.dist_weighted_flow(dc.to(TB), flow.to(TB), w, b, w, b, 3)
    with pytest.raises(TypeError):
        t_reg.dist_weighted_flow(*(t.half() for t in (dc, flow, w, b, w, b)),
                                 3)
    feats = [torch.randn(1, 4, 16, 20), torch.randn(1, 4, 8, 10)]
    rois = torch.tensor([[1.0, 2.0, 30.0, 40.0]])
    levels = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="one dtype"):
        t_roi.roi_align_multilevel([feats[0], feats[1].to(TB)], rois, levels,
                                   (0.25, 0.125))
    with pytest.raises(TypeError):
        t_roi.roi_align_multilevel([x.half() for x in feats], rois, levels,
                                   (0.25, 0.125))
    with pytest.raises(TypeError, match="rois must be float32"):
        t_roi.roi_align_multilevel([x.to(TB) for x in feats], rois.to(TB),
                                   levels, (0.25, 0.125))
    out = t_roi.roi_align_multilevel([x.to(TB) for x in feats], rois, levels,
                                     (0.25, 0.125))
    assert out.dtype == TB


def test_group_norm_bf16_matches_jax():
    """GroupNorm in bf16: statistics and normalisation in float32, the
    affine in bf16 (layers.py:164-168); within one bf16 step of JAX."""
    from vido_slam_tpu.models import layers as j_layers
    from vido_slam_tpu_torch.models import layers as t_layers
    rng = np.random.RandomState(0)
    x = (rng.randn(1, 6, 7, 64) * 3 + 1).astype(np.float32)
    g, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    want = j_layers.group_norm(*(jnp.asarray(a).astype(BF) for a in (x, g, b)))
    gn = t_layers.GroupNorm(64)
    gn.weight.copy_(torch.from_numpy(g))
    gn.bias.copy_(torch.from_numpy(b))
    got = gn.to(TB)(tbf(nchw(x)))
    assert want.dtype == BF and got.dtype == TB
    within_ulp(got.float().numpy().transpose(0, 2, 3, 1),
               want.astype(jnp.float32))


# ---------------------------------------------------------------------------
# weights carried across in bf16
# ---------------------------------------------------------------------------

def test_bf16_casts_give_the_same_bits():
    """jnp.astype(bfloat16) and Tensor.to(torch.bfloat16) both round to
    nearest even: one seeded float32 dict gives the same bf16 weights in
    both packages, whether convert casts the float32 arrays or reads the
    bf16 ones (ml_dtypes)."""
    rng = np.random.RandomState(0)
    a = np.concatenate([rng.randn(5000).astype(np.float32),
                        np.float32([1 + 2 ** -8, 1 + 3 * 2 ** -8, -0.0,
                                    3.4e38, 1e-40])])
    j = np.asarray(jnp.asarray(a).astype(BF)).view(np.uint16)
    t = torch.from_numpy(a).to(TB).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(j, t)
    params = {"w.weight": rng.randn(3, 3, 2, 4).astype(np.float32),
              "b.bias": rng.randn(4).astype(np.float32)}
    from_f32 = convert.liteflownet_state_dict_from_numpy(params, dtype=TB)
    from_bf16 = convert.liteflownet_state_dict_from_numpy(
        {k: np.asarray(jnp.asarray(v).astype(BF)) for k, v in params.items()})
    for k in params:
        assert from_f32[k].dtype == from_bf16[k].dtype == TB
        assert torch.equal(from_f32[k], from_bf16[k])
    for fn in (convert.monodepth2_state_dict_from_numpy,
               convert.maskrcnn_state_dict_from_numpy):
        out = fn(params, device="cpu", dtype=TB)
        assert torch.equal(out["w.weight"], from_f32["w.weight"])


# ---------------------------------------------------------------------------
# the networks in bf16
# ---------------------------------------------------------------------------

def _jax_params(net):
    """The port's seeded parameters in the JAX package's layout."""
    return convert.convert_state_dict(net.state_dict())


def test_liteflownet_bf16():
    net = t_lfn.LiteFlowNet(device="cpu")
    p = _jax_params(net)
    rng = np.random.RandomState(0)
    a, b = (rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(j_lfn.liteflownet_forward(
        {k: jnp.asarray(v).astype(BF) for k, v in p.items()},
        jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(nchw(a)), torch.from_numpy(nchw(b))
    f32 = net(ta, tb).numpy().transpose(0, 2, 3, 1)
    net.to(TB)
    before = (t_corr.correlation.launches,
              t_reg.dist_weighted_flow.launches)
    f16 = net(ta, tb)
    assert f16.dtype == torch.float32       # the flow pinned to float32
    assert (t_corr.correlation.launches,
            t_reg.dist_weighted_flow.launches) == before   # plain on the CPU
    f16 = f16.numpy().transpose(0, 2, 3, 1)
    scale = max(float(np.abs(f32).max()), 1.0)
    print(f"LiteFlowNet bf16: against f32 "
          f"{np.abs(f16 - f32).max() / scale:.2e}, against JAX bf16 "
          f"{np.abs(f16 - want).max() / scale:.2e}")
    assert np.abs(f16 - f32).max() / scale < 0.02
    assert np.abs(f16 - want).max() / scale < 0.02


def test_monodepth2_bf16():
    net = t_md.MonoDepth2(device="cpu")
    p = _jax_params(net)
    img = np.random.RandomState(1).uniform(0, 1, (1, 64, 192, 3)) \
        .astype(np.float32)
    want = np.asarray(j_md.monodepth2_disp(
        {k: jnp.asarray(v).astype(BF) for k, v in p.items()},
        jnp.asarray(img).astype(BF)).astype(jnp.float32))
    x = torch.from_numpy(nchw(img))
    f32 = t_md.monodepth2_disp(net, x).numpy().transpose(0, 2, 3, 1)
    net.to(TB)
    d16 = t_md.monodepth2_disp(net, x)
    assert d16.dtype == TB
    d16 = d16.float().numpy().transpose(0, 2, 3, 1)
    print(f"MonoDepth2 bf16: against f32 {np.abs(d16 - f32).max():.2e}, "
          f"against JAX bf16 {np.abs(d16 - want).max():.2e}")
    assert np.abs(d16 - f32).max() < 0.02
    assert np.abs(d16 - want).max() < 0.02


H, W = 128, 160


@pytest.fixture(scope="module")
def detector():
    """The port's seeded R-50-FPN detector at 128x160, class 3 lifted, in
    float32 and in bf16; its parameters in the JAX layout, cast to bf16;
    a 0..1 image."""
    models = []
    for dtype in (None, TB):
        m = tm.MaskRCNN(tm.MaskRCNNConfig(input_h=H, input_w=W), device="cpu")
        with torch.no_grad():
            m.roi_heads.box.predictor.cls_score.bias[3] = 30.0
        models.append(m if dtype is None else m.to(dtype))
    p = _jax_params(models[0])
    img = np.random.RandomState(1).uniform(0, 1, (1, H, W, 3)) \
        .astype(np.float32)
    return jm.MaskRCNNConfig(input_h=H, input_w=W), \
        {k: jnp.asarray(v).astype(BF) for k, v in p.items()}, models, img


def _dets(d):
    return {k: np.asarray(getattr(d, k), np.float32)
            if k in ("boxes", "scores") else np.asarray(getattr(d, k))
            for k in ("boxes", "scores", "labels", "valid")}


def test_detector_bf16(detector):
    cfg, jp, (m32, m16), img = detector
    want = jm.maskrcnn_inference(jp, jnp.asarray(img).astype(BF), cfg)
    want = jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32))
        if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x), want)
    x = torch.from_numpy(nchw(img))
    before = t_roi.roi_align_multilevel.launches
    got = m16(x)
    assert t_roi.roi_align_multilevel.launches == before
    assert got.boxes.dtype == got.scores.dtype == torch.float32
    assert got.masks28.dtype == TB
    ref = m32(x)
    for other, what in ((want, "JAX bf16"), (ref, "port f32")):
        report = chip_smoke.match_detections(
            _dets(got), _dets(other), cfg.confidence_threshold)
        print(f"detector bf16 against {what}: {report}")
        assert report["boxes_matched"] >= 0.8 * min(report["valid"]) >= 16 \
            and not report["unexplained"], report


@torch.no_grad()
def test_detector_heads_bf16_on_the_same_inputs(detector):
    """Box and mask heads fed JAX's bf16 FPN features and proposals."""
    cfg, jp, (_, m16), img = detector
    from vido_slam_tpu.models.maskrcnn import backbone as jb
    from vido_slam_tpu.models.maskrcnn import rpn as jr
    feats = jax.jit(lambda p, x: jb.fpn_forward(
        p, jb.resnet_stages(p, x, cfg.resnet)))(jp, jnp.asarray(img)
                                                 .astype(BF))
    props = jnp.asarray(np.random.RandomState(2).uniform(
        0, 1, (200, 4)).cumsum(1).astype(np.float32) * [40, 30, 90, 80])
    p2_p5 = [f[0] for f in feats[:4]]
    jl, _ = jh.box_head_forward(jp, p2_p5, props)
    tfeats = [torch.from_numpy(np.asarray(f.astype(jnp.float32))
                               .transpose(0, 3, 1, 2).copy()).to(TB)
              for f in feats[:4]]
    tl, _ = th.box_head_forward(m16.roi_heads.box, tfeats,
                                torch.from_numpy(np.array(props)))
    jl = np.asarray(jl.astype(jnp.float32))
    assert tl.dtype == TB
    err = np.abs(tl.float().numpy() - jl).max() / np.abs(jl).max()
    assert err < 0.05, err
    det = th.Detections(boxes=torch.from_numpy(np.array(props[:20])),
                        scores=torch.ones(20), labels=torch.full((20,), 3),
                        valid=torch.ones(20, dtype=torch.bool))
    jdet = jh.Detections(boxes=props[:20], scores=jnp.ones(20),
                         labels=jnp.full((20,), 3, jnp.int32),
                         valid=jnp.ones(20, bool))
    jmask = np.asarray(jh.mask_head_forward(jp, p2_p5, jdet)
                       .astype(jnp.float32))
    tmask = th.mask_head_forward(m16.roi_heads.mask, tfeats, det)
    assert np.abs(tmask.float().numpy() - jmask).max() < 0.02


def test_perception_model_options(tmp_path):
    """compute_dtype casts the depth net and the detector, mask_dtype the
    detector, flow_dtype LiteFlowNet; the defaults stay float32;
    from_pretrained passes the options on."""
    kw = dict(mask_cfg=tm.MaskRCNNConfig(input_h=64, input_w=96),
              device="cpu")

    def dtypes(m):
        return tuple(next(n.parameters()).dtype for n in
                     (m.depth_net, m.flow_net, m.mask_model))
    f32 = torch.float32
    assert dtypes(PerceptionModel(64, 96, **kw)) == (f32, f32, f32)
    assert dtypes(PerceptionModel(64, 96, compute_dtype=TB, **kw)) == (
        TB, f32, TB)
    assert dtypes(PerceptionModel(64, 96, mask_dtype=TB, **kw)) == (
        f32, f32, TB)
    m = PerceptionModel(64, 96, flow_dtype=TB, mask_dtype=TB, **kw)
    assert dtypes(m) == (f32, TB, TB)
    rng = np.random.RandomState(0)
    frames = rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32)
    out = m(frames[0], frames[1])
    assert out.flow.dtype == out.depth_u16.dtype == torch.float32
    assert out.mask.dtype == torch.uint8 and out.flow.shape == (64, 96, 2)
    assert np.isfinite(out.flow.numpy()).all()
    m = PerceptionModel.from_pretrained(str(tmp_path), 64, 96,
                                        compute_dtype=TB, **kw)
    assert dtypes(m) == (TB, f32, TB)
