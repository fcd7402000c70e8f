"""The port's MonoDepth2 (``models/monodepth2.py``), its eval batch norm
(``models/layers.BatchNorm2d``) and
``convert.monodepth2_state_dict_from_numpy`` against the JAX package on
the same numpy-seeded inputs and the same parameters: the jitted JAX
init, its batch-norm statistics then drawn from a seeded numpy generator
(the init leaves every batch norm at the identity), with variances in
[0.5, 2] (down to 1e-3 the random trunk's activations grow to 1e5); the
batch norm alone meets variances down to 0.

Bars: the batch norm 2e-6 of the output's largest magnitude (the same
three roundings; rsqrt may differ by an ulp); one basic block 1e-5 of its
output's magnitude; the five encoder features at 192x640 1e-5 of each
one's magnitude; the four decoder outputs (sigmoids, on the JAX features)
and ``monodepth2_disp`` at 192x640 within 1e-5 absolute;
``disp_to_uint16_depth`` within 1e-5 x 65536 (a resize and a min-max, the
same roundings up to the resize's weights); ``disp_to_depth`` rtol 1e-6;
nearest x2 upsampling equal to ``jax.image.resize(method="nearest")`` bit
for bit. The state dict's keys are the JAX dict's and its shapes the torch
layout of ``jax.eval_shape`` of the JAX init; the port's own init gives the
same keys and shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.models import layers as j_layers
from vido_slam_tpu.models import monodepth2 as j_md
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models import layers as t_layers
from vido_slam_tpu_torch.models import monodepth2 as t_md

torch.set_num_threads(1)

FH, FW = t_md.FEED_HEIGHT, t_md.FEED_WIDTH


def nchw(a):
    a = np.asarray(a, np.float32).transpose(0, 3, 1, 2)
    return torch.from_numpy(np.array(a, order="C"))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def close_to_scale(got, want, rel):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rel * scale, (err, scale)
    return err


def bn_stats(rng, c, var_lo=0.5):
    """(gamma, beta, mean, var), variances from ``var_lo`` to 2."""
    return (rng.uniform(0.5, 1.5, c), rng.normal(0, 0.1, c),
            rng.normal(0, 0.1, c), rng.uniform(var_lo, 2.0, c))


@pytest.fixture(scope="module")
def params():
    p = {k: np.array(v) for k, v in
         jax.jit(j_md.init_monodepth2_params)(jax.random.PRNGKey(0)).items()}
    rng = np.random.RandomState(3)
    for k in sorted(p):
        if k.endswith(".running_var"):
            pre = k[:-len(".running_var")]
            g, b, m, v = bn_stats(rng, p[k].shape[0])
            p[pre + ".weight"], p[pre + ".bias"] = g, b
            p[pre + ".running_mean"], p[k] = m, v
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.fixture(scope="module")
def net(params):
    m = t_md.MonoDepth2(device="cpu")
    m.load_state_dict(convert.monodepth2_state_dict_from_numpy(
        params, device="cpu"), strict=True)
    return m


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(1).uniform(0, 1, (1, FH, FW, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_run(params, image):
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    @jax.jit
    def run(p, x):
        feats = j_md.resnet18_features(p, x)
        return feats, j_md.depth_decoder_forward(p, feats)

    feats, outs = jax.device_get(run(jp, jnp.asarray(image)))
    disp = np.asarray(j_md.monodepth2_disp(jp, jnp.asarray(image)))
    return feats, outs, disp


def test_batch_norm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.normal(0, 2, (2, 9, 11, 16)).astype(np.float32)
    g, b, m, v = (a.astype(np.float32) for a in bn_stats(rng, 16, 1e-3))
    v[:4] = [1e-6, 1e-5, 1e-4, 0.0]
    want = np.asarray(j_layers.batch_norm(*(jnp.asarray(a)
                                            for a in (x, g, b, m, v))))
    bn = t_layers.BatchNorm2d(16)
    bn.load_state_dict({"weight": torch.from_numpy(g),
                        "bias": torch.from_numpy(b),
                        "running_mean": torch.from_numpy(m),
                        "running_var": torch.from_numpy(v)}, strict=True)
    assert list(bn.state_dict()) == ["weight", "bias", "running_mean",
                                     "running_var"]
    close_to_scale(nhwc(bn(nchw(x))), want, 2e-6)


def test_basic_block_matches_jax(params, net):
    """encoder.layer2.0: stride 2 with the projected skip."""
    x = np.random.RandomState(2).normal(0, 1, (1, 24, 40, 64)).astype(
        np.float32)
    want = np.asarray(j_md._basic_block(
        {k: jnp.asarray(v) for k, v in params.items()}, "encoder.layer2.0",
        jnp.asarray(x), 2))
    with torch.no_grad():
        got = nhwc(net.encoder.layer2[0](nchw(x)))
    assert got.shape == want.shape == (1, 12, 20, 128)
    close_to_scale(got, want, 1e-5)


def test_encoder_features_match_jax(net, image, jax_run):
    with torch.no_grad():
        got = net.encoder(nchw(image))
    assert len(got) == 5
    for g, w in zip(got, jax_run[0]):
        assert nhwc(g).shape == w.shape
        close_to_scale(nhwc(g), w, 1e-5)


def test_decoder_outputs_match_jax(net, jax_run):
    feats, outs, _ = jax_run
    with torch.no_grad():
        got = net.decoder([nchw(f) for f in feats])
    assert sorted(got) == sorted(outs) == [0, 1, 2, 3]
    for s in range(4):
        assert nhwc(got[s]).shape == outs[s].shape == (
            1, FH >> s, FW >> s, 1)
        np.testing.assert_allclose(nhwc(got[s]), outs[s], atol=1e-5, rtol=0)


def test_monodepth2_disp_matches_jax(net, image, jax_run):
    got = nhwc(t_md.monodepth2_disp(net, nchw(image)))
    want = jax_run[2]
    assert got.shape == want.shape == (1, FH, FW, 1)
    err = float(np.abs(got - want).max())
    print(f"monodepth2_disp {FH}x{FW}: max error {err:.3e}, disparity "
          f"{want.min():.4f}..{want.max():.4f}")
    assert err <= 1e-5


@pytest.mark.parametrize("out_hw", [(64, 96), (FH, FW), (560, 1280)])
def test_disp_to_uint16_depth_matches_jax(jax_run, out_hw):
    disp = jax_run[2]
    want = np.asarray(j_md.disp_to_uint16_depth(jnp.asarray(disp), *out_hw))
    got = t_md.disp_to_uint16_depth(nchw(disp), *out_hw).numpy()
    assert got.shape == want.shape == (1,) + out_hw
    assert got.min() >= 0.0 and got.max() <= 65536.0
    np.testing.assert_allclose(got, want, atol=1e-5 * 65536, rtol=0)


def test_disp_to_depth_matches_jax():
    disp = np.random.RandomState(4).uniform(0, 1, (1, 8, 12, 1)).astype(
        np.float32)
    for got, want in zip(t_md.disp_to_depth(torch.from_numpy(disp), 0.1,
                                            100.0),
                         j_md.disp_to_depth(jnp.asarray(disp), 0.1, 100.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_upsample2_is_jax_nearest():
    x = np.random.RandomState(5).normal(0, 1, (1, 6, 20, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 12, 40, 3),
                                       method="nearest"))
    np.testing.assert_array_equal(nhwc(t_md.upsample2(nchw(x))), want)


def test_state_dict_keys_and_shapes():
    shapes = jax.eval_shape(j_md.init_monodepth2_params,
                            jax.random.PRNGKey(0))
    torch_layout = {k: (tuple(s.shape[i] for i in (3, 2, 0, 1))
                        if len(s.shape) == 4 else tuple(s.shape))
                    for k, s in shapes.items()}
    sd = t_md.MonoDepth2(device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == torch_layout
    own = t_md.init_monodepth2_params(torch.Generator().manual_seed(1))
    assert {k: tuple(v.shape) for k, v in own.items()} == torch_layout
    assert not any(k.endswith("num_batches_tracked") for k in sd)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_md.MonoDepth2()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.monodepth2_state_dict_from_numpy({"b": np.zeros(2)})
