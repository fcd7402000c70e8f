"""The port's LiteFlowNet (``models/liteflownet.py``), its two kernels' plain
versions (``ops/correlation.py``, ``ops/regularize.py``), its layers,
warps and the perception flow branch against the JAX package on the same
numpy-seeded inputs and the same parameters (the JAX init, carried across
with ``convert.liteflownet_state_dict_from_numpy``).

Tolerances: the kernels' plain versions atol 1e-5 (correlation, the bar of
tests/test_ops.py:98-110) and rtol = atol = 1e-5 (regularization, that of
tests/test_regularize.py); layers and warps 1e-5; one Matching, Subpixel or
Regularization level 1e-4 of the output's largest magnitude; the whole net
and the flow branch 1e-3 x max(1, max |flow|). Measured on this CPU: the
whole net at 64x96 differs by ~1e-6 of max |flow| (printed by the test).
JAX's Pallas kernels run in interpret mode; the whole JAX net runs its XLA
route (``use_pallas=False``), which computes the same function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.io import synthetic as j_syn
from vido_slam_tpu.models import layers as j_layers
from vido_slam_tpu.models import liteflownet as j_lfn
from vido_slam_tpu.ops import regularize as j_reg
from vido_slam_tpu.ops import warp as j_warp
from vido_slam_tpu.ops.correlation import correlation as j_correlation
from vido_slam_tpu.ops.correlation import correlation_pallas
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.io import synthetic as t_syn
from vido_slam_tpu_torch.models import layers as t_layers
from vido_slam_tpu_torch.models import liteflownet as t_lfn
from vido_slam_tpu_torch.models.perception import ceil32, perception_flow
from vido_slam_tpu_torch.ops import correlation as t_corr
from vido_slam_tpu_torch.ops import regularize as t_reg
from vido_slam_tpu_torch.ops import warp as t_warp

torch.set_num_threads(1)


def nchw(a):
    """NHWC numpy / JAX array -> NCHW float32 torch tensor."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def nets():
    """(JAX params, the port's net on the CPU with the same parameters)."""
    # jitted: one compile instead of ~100 eager random draws (15 s vs 26 s)
    p = jax.jit(j_lfn.init_liteflownet_params)(jax.random.PRNGKey(0))
    net = t_lfn.LiteFlowNet(device="cpu")
    net.load_state_dict(convert.liteflownet_state_dict_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}), strict=True)
    return p, net


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(0)
    return (rng.uniform(size=(1, 64, 96, 3)).astype(np.float32),
            rng.uniform(size=(1, 64, 96, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_flow(nets, pair):
    p, _ = nets
    return np.asarray(j_lfn.liteflownet_forward(
        p, jnp.asarray(pair[0]), jnp.asarray(pair[1]), use_pallas=False))


# ---------------------------------------------------------------------------
# kernel 3: the cost volume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,H,W,C", [
    (1, 16, 12, 8),
    (2, 32, 24, 8),
    (1, 13, 20, 64),     # 13 rows: no 3-4 row tile divides them
    (2, 18, 40, 64),     # 6-row Pallas tiles
    (2, 17, 23, 8),      # odd H and W at stride 2: ceil(H/2) outputs
])
def test_correlation_ref_matches_jax(stride, H, W, C):
    rng = np.random.RandomState(H * C + stride)
    f1 = rng.randn(2, H, W, C).astype(np.float32)
    f2 = rng.randn(2, H, W, C).astype(np.float32)
    got = t_corr.correlation_ref(nchw(f1), nchw(f2), stride)
    assert got.shape == (2, 49, -(-H // stride), -(-W // stride))
    want = np.asarray(j_correlation(jnp.asarray(f1), jnp.asarray(f2),
                                    stride=stride))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)
    pallas = np.asarray(correlation_pallas(
        jnp.asarray(f1), jnp.asarray(f2), stride=stride, row_tile=4,
        interpret=True))
    np.testing.assert_allclose(nhwc(got), pallas, atol=1e-5)


def test_correlation_counts_at_kaist_level_2():
    """The bound's counts at level 2 of a 1280x576 pair (64 channels at
    288 x 640, stride 2): 144 x 320 x 49 x (2 x 64 + 1) operations; the
    stride phase of both inputs read and the volume written."""
    f1 = torch.empty((1, 64, 288, 640), device="meta")
    assert t_corr.operations(f1, 2) == 144 * 320 * 49 * 129
    assert t_corr.nbytes(f1, 2) == 4 * 144 * 320 * (2 * 64 + 49)


# ---------------------------------------------------------------------------
# kernel 4: the regularization tail
# ---------------------------------------------------------------------------

def _reg_case(rng, N, H, W, k, scale=1.0):
    K = k * k
    return ((rng.randn(N, H, W, K) * scale).astype(np.float32),
            (rng.randn(N, H, W, 2) * 3).astype(np.float32),
            rng.randn(K).astype(np.float32), np.float32(0.3),
            rng.randn(K).astype(np.float32), np.float32(-0.2))


def _port_reg(dc, flow, wx, bx, wy, by, k):
    out = t_reg.dist_weighted_flow(
        nchw(dc), nchw(flow), torch.from_numpy(wx),
        torch.tensor([bx]), torch.from_numpy(wy), torch.tensor([by]), k)
    return nhwc(out)


@pytest.mark.parametrize("N,H,W,k,scale", [
    pytest.param(*case, 1.0, id="-".join(map(str, case))) for case in (
        (1, 12, 40, 3), (1, 24, 40, 5), (1, 12, 20, 7), (3, 12, 40, 3),
        (3, 9, 14, 7))] + [
    # peaked logits (dc x 10): one tap takes nearly all the weight
    pytest.param(1, 12, 20, 7, 10.0, id="1-12-20-7-peaked"),
    # ragged: neither side a multiple of the kernel's 4 x 32 tile, an image
    # narrower than the window, two images
    pytest.param(1, 37, 53, 7, 1.0, id="1-37-53-7"),
    pytest.param(1, 5, 3, 3, 1.0, id="1-5-3-3"),
    pytest.param(2, 9, 6, 7, 1.0, id="2-9-6-7"),
])
def test_dist_weighted_flow_ref_matches_jax(N, H, W, k, scale):
    rng = np.random.RandomState(N * 100 + k)
    dc, flow, wx, bx, wy, by = _reg_case(rng, N, H, W, k, scale)
    got = _port_reg(dc, flow, wx, bx, wy, by, k)
    jargs = (jnp.asarray(dc), jnp.asarray(flow[..., 0]),
             jnp.asarray(flow[..., 1]), jnp.asarray(wx), jnp.asarray(bx),
             jnp.asarray(wy), jnp.asarray(by), k)
    for fn in (j_reg.dist_weighted_flow,
               lambda *a: j_reg.dist_weighted_flow_pallas(*a,
                                                         interpret=True)):
        sx, sy = fn(*jargs)
        want = np.stack([np.asarray(sx), np.asarray(sy)], -1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dist_weighted_flow_zero_padding():
    """Uniform logits and unit weights: the interior is the flow itself,
    the corner only 4 of 9 taps (tests/test_regularize.py)."""
    H, W, k = 12, 40, 3
    dc = torch.zeros((1, 9, H, W))
    flow = torch.stack([torch.full((1, H, W), 2.0),
                        torch.full((1, H, W), -1.0)], 1)
    w = torch.ones(9)
    out = t_reg.dist_weighted_flow(dc, flow, w, torch.zeros(1), w,
                                   torch.zeros(1), k)
    np.testing.assert_allclose(out[0, 0, 1:-1, 1:-1].numpy(), 2.0, rtol=1e-6)
    np.testing.assert_allclose(out[0, 1, 1:-1, 1:-1].numpy(), -1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(float(out[0, 0, 0, 0]), 2.0 * 4 / 9,
                               rtol=1e-6)


def test_dist_weighted_flow_counts_at_kaist_level_2():
    dc = torch.empty((1, 49, 288, 640), device="meta")
    assert t_reg.nbytes(dc) == 4 * (288 * 640 * (49 + 4) + 2 * 49 + 2)
    assert t_reg.operations(dc) == 288 * 640 * (11 * 49 + 5)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _wrapper_inputs():
    rng = np.random.RandomState(5)
    f = torch.from_numpy(rng.randn(1, 8, 10, 12).astype(np.float32))
    dc, flow, wx, bx, wy, by = _reg_case(rng, 1, 10, 12, 3)
    reg = (nchw(dc), nchw(flow), torch.from_numpy(wx), torch.tensor([bx]),
           torch.from_numpy(wy), torch.tensor([by]))
    return f, reg


def test_wrappers_take_the_plain_version_for_cpu_tensors(monkeypatch):
    f, reg = _wrapper_inputs()
    before = (t_corr.correlation.launches, t_reg.dist_weighted_flow.launches)
    torch.testing.assert_close(t_corr.correlation(f, f.flip(2).contiguous(),
                                                  2),
                               t_corr.correlation_ref(f, f.flip(2), 2),
                               rtol=0, atol=0)
    torch.testing.assert_close(t_reg.dist_weighted_flow(*reg, 3),
                               t_reg.dist_weighted_flow_ref(*reg, 3),
                               rtol=0, atol=0)
    assert (t_corr.correlation.launches,
            t_reg.dist_weighted_flow.launches) == before

    def refuse(name):
        raise AssertionError(f"{name} built a kernel for CPU tensors")

    monkeypatch.setattr("vido_slam_tpu_torch.utils.cuda_build.load", refuse)
    t_corr.correlation(f, f, 1)
    t_reg.dist_weighted_flow(*reg, 3)


def test_wrappers_reject_bad_inputs():
    f, reg = _wrapper_inputs()
    meta = torch.empty(f.shape, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        t_corr.correlation(f, meta, 1)
    with pytest.raises(TypeError):
        t_corr.correlation(f.double(), f.double(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        t_corr.correlation(f.transpose(2, 3), f.transpose(2, 3), 1)
    with pytest.raises(ValueError):
        t_corr.correlation(f, f[:, :4].contiguous(), 1)
    with pytest.raises(ValueError, match="one CUDA device"):
        t_reg.dist_weighted_flow(reg[0], torch.empty(reg[1].shape,
                                                     device="meta"),
                                 *reg[2:], 3)
    with pytest.raises(TypeError):
        t_reg.dist_weighted_flow(reg[0].double(), *reg[1:], 3)
    with pytest.raises(ValueError, match="contiguous"):
        t_reg.dist_weighted_flow(
            reg[0], reg[1].transpose(2, 3).contiguous().transpose(2, 3),
            *reg[2:], 3)
    with pytest.raises(ValueError):
        t_reg.dist_weighted_flow(*reg, 5)


@pytest.mark.parametrize("bad", ["window 4", "dc taps", "flow shape",
                                 "wx size", "by size"])
def test_dist_weighted_flow_rejects_bad_shapes(bad):
    _, reg = _wrapper_inputs()
    dc, flow, wx, bx, wy, by = reg
    k = 3
    if bad == "window 4":
        k = 4
    elif bad == "dc taps":
        dc = dc[:, :8].contiguous()
    elif bad == "flow shape":
        flow = flow[:, :, :9].contiguous()
    elif bad == "wx size":
        wx = wx[:8].contiguous()
    else:
        by = torch.zeros(2)
    with pytest.raises(ValueError, match="dist_weighted_flow"):
        t_reg.dist_weighted_flow(dc, flow, wx, bx, wy, by, k)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_lfn.LiteFlowNet()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_syn.driving_clip(height=16, width=32, n_frames=1)


# ---------------------------------------------------------------------------
# layers and warps
# ---------------------------------------------------------------------------

def test_deconv_grouped_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 7, 5).astype(np.float32)
    w = rng.randn(4, 4, 1, 5).astype(np.float32)
    want = np.asarray(j_layers.deconv_grouped(jnp.asarray(x), jnp.asarray(w)))
    wt = convert.liteflownet_state_dict_from_numpy({"w": w})["w"]
    got = t_layers.deconv_grouped(nchw(x), wt)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


@pytest.mark.parametrize("k", [3, 7])
def test_unfold_channels_matches_jax(k):
    x = np.random.RandomState(k).randn(2, 6, 9, 1).astype(np.float32)
    want = np.asarray(j_layers.unfold_channels(jnp.asarray(x), k))
    np.testing.assert_array_equal(
        nhwc(t_layers.unfold_channels(nchw(x), k)), want)


def test_backwarp_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, 16, 5).astype(np.float32)
    flow = (rng.randn(2, 12, 16, 2) * 4).astype(np.float32)
    want = np.asarray(j_warp.backwarp(jnp.asarray(x), jnp.asarray(flow)))
    got = t_warp.backwarp(nchw(x), nchw(flow))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


@pytest.mark.parametrize("src,dst", [
    ((36, 80), (18, 40)),     # the image pyramid: both sides shrink
    ((32, 48), (60, 90)),     # the flow back to the frame: both grow
    ((56, 90), (64, 96)),     # the frame to the net's multiple of 32
    ((40, 64), (20, 96)),     # one side shrinks, one grows
])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.RandomState(3).randn(1, *src, 3).astype(np.float32)
    want = np.asarray(j_warp.resize_bilinear(jnp.asarray(x), *dst))
    got = t_warp.resize_bilinear(nchw(x), *dst)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


# ---------------------------------------------------------------------------
# one level of each module
# ---------------------------------------------------------------------------

def _close_to_scale(got, want, rel):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("mi", [0, 1, 4])   # levels 2, 3, 6
def test_one_level_matches_jax(nets, mi):
    p, net = nets
    level = t_lfn.LEVELS[mi]
    h, w = 24, 40
    cf = 32 if level == 2 else t_lfn.REG_FEAT_CIN[level]
    rng = np.random.RandomState(mi)
    im1, im2 = (rng.uniform(size=(1, h, w, 3)).astype(np.float32) - 0.4
                for _ in range(2))
    feat1, feat2 = (rng.randn(1, h, w, cf).astype(np.float32)
                    for _ in range(2))
    coarse = None if level == 6 else \
        rng.randn(1, h // 2, w // 2, 2).astype(np.float32)
    flow = rng.randn(1, h, w, 2).astype(np.float32)
    ja = [jnp.asarray(a) for a in (im1, im2, feat1, feat2)]
    with torch.no_grad():
        want = np.asarray(j_lfn.matching_forward(
            p, mi, level, *ja, None if coarse is None
            else jnp.asarray(coarse), use_pallas=False))
        got = net.netMatching[mi](nchw(feat1), nchw(feat2),
                                  None if coarse is None else nchw(coarse))
        _close_to_scale(nhwc(got), want, 1e-4)
        want = np.asarray(j_lfn.subpixel_forward(p, mi, level, *ja,
                                                 jnp.asarray(flow)))
        got = net.netSubpixel[mi](nchw(feat1), nchw(feat2), nchw(flow))
        _close_to_scale(nhwc(got), want, 1e-4)
        want = np.asarray(j_lfn.regularization_forward(
            p, mi, level, *ja, jnp.asarray(flow), use_pallas=False))
        got = net.netRegularization[mi](nchw(im1), nchw(im2), nchw(feat1),
                                        nchw(flow))
        _close_to_scale(nhwc(got), want, 1e-4)


# ---------------------------------------------------------------------------
# the whole net and the perception flow branch
# ---------------------------------------------------------------------------

def test_state_dict_keys_are_the_checkpoints(nets):
    p, net = nets
    assert set(net.state_dict()) == set(p)
    assert "netMatching.0.netUpcorr.weight" in p
    assert tuple(net.netMatching[0].netUpcorr.weight.shape) == (49, 1, 4, 4)
    assert tuple(net.netRegularization[0].netDist[1].weight.shape) \
        == (49, 49, 1, 7)
    own = t_lfn.init_liteflownet_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} \
        == {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert sum(v.numel() for v in own.values()) == 5_381_969


def test_whole_net_matches_jax(nets, pair, jax_flow):
    _, net = nets
    got = nhwc(t_lfn.liteflownet_forward(net, nchw(pair[0]), nchw(pair[1])))
    assert got.shape == (1, 32, 48, 2) and np.isfinite(got).all()
    err = float(np.abs(got - jax_flow).max())
    scale = max(1.0, float(np.abs(jax_flow).max()))
    print(f"whole net 64x96: max |flow| {np.abs(jax_flow).max():.4f}, "
          f"max error {err:.3e}")
    assert err <= 1e-3 * scale


def test_flow_full_resolution_matches_jax(jax_flow):
    want = np.asarray(j_lfn.flow_full_resolution(jnp.asarray(jax_flow), 60,
                                                 90))
    got = t_lfn.flow_full_resolution(nchw(jax_flow), 60, 90)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4)


def test_perception_flow_branch_matches_jax(nets):
    """perception.py:75-76,89-95 on two 60x90 BGR frames: the net runs at
    64x96 and the flow comes back at 60x90."""
    p, net = nets
    rng = np.random.RandomState(7)
    h, w = 60, 90
    prev = (rng.uniform(size=(h, w, 3)) * 255).astype(np.float32)
    cur = np.roll(prev, 2, axis=1)
    ph, pw = ceil32(h), ceil32(w)
    assert (ph, pw) == (64, 96)

    def j_rgb(bgr):
        x = jnp.asarray(bgr)[None, :, :, ::-1] / 255.0
        return jax.image.resize(x, (1, ph, pw, 3), method="bilinear")

    nf = j_lfn.liteflownet_forward(p, j_rgb(prev), j_rgb(cur),
                                   use_pallas=False)
    want = jax.image.resize(nf, (1, h, w, 2), method="bilinear")[0]
    want = np.asarray(want * jnp.asarray([w / pw, h / ph], jnp.float32))
    got = perception_flow(net, torch.from_numpy(prev),
                          torch.from_numpy(cur)).numpy()
    assert got.shape == (h, w, 2) and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    print(f"flow branch 60x90: max |flow| {np.abs(want).max():.4f}, "
          f"max error {err:.3e}")
    assert err <= 1e-3 * max(1.0, float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the perception input
# ---------------------------------------------------------------------------

def test_driving_clip_matches_jax():
    kw = dict(height=56, width=128, n_frames=3, fx=816.402 / 10,
              fy=817.38 / 10)
    want, want_T = j_syn.driving_clip(return_poses=True, **kw)
    got, got_T = t_syn.driving_clip(return_poses=True, device="cpu", **kw)
    got = got.numpy()
    assert got.shape == want.shape == (3, 56, 128, 3)
    np.testing.assert_array_equal(got_T, want_T)
    agree = np.abs(got - want) <= 1e-3
    assert agree.mean() >= 0.999, agree.mean()
