"""The port's MonoDepth2 training pieces (the layers of
``models/monodepth2_train.py``, the pose nets of ``models/monodepth2.py``,
``parallel/train.py``'s supervised depth step, the depth and pose
metrics) against the JAX package on the same numpy-seeded inputs and the
same parameters (the JAX inits carried across by
``convert.monodepth2_state_dict_from_numpy``), at 64x96, batch 2. The
self-supervised loss and its step: tests/test_torch_train_selfsup.py.

Bars: the pose nets' outputs, ``ssim``, ``get_smooth_loss``,
``transformation_from_parameters`` and ``grid_sample_border`` within 1e-5
of max(1, |value|); one Adam step of the supervised ``make_train_step``
within 1e-5; the depth and pose metrics within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.models import monodepth2 as jmd
from vido_slam_tpu.models import monodepth2_train as jtr
from vido_slam_tpu.parallel import mesh as jmesh
from vido_slam_tpu.parallel import train as jt
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models import monodepth2 as tmd
from vido_slam_tpu_torch.models import monodepth2_train as ttr
from vido_slam_tpu_torch.parallel import train as tt

torch.set_num_threads(1)

N, H, W = 2, 64, 96


def close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def states(params):
    return convert.monodepth2_state_dict_from_numpy(params, device="cpu")


@pytest.fixture(scope="module")
def params():
    p = jax.jit(jtr.init_selfsup_params)(jax.random.PRNGKey(0))
    return {k: np.array(v) for k, v in p.items()}


# ---------------------------------------------------------------------------
# the layers and the pose nets
# ---------------------------------------------------------------------------

def test_pose_nets_match_jax():
    rng = np.random.RandomState(1)
    dec = jax.tree_util.tree_map(np.asarray, jmd.init_pose_decoder_params(
        jax.random.PRNGKey(2), num_input_features=2, num_frames=2))
    feats = [rng.normal(0, 1, (N, 2, 3, 512)).astype(np.float32)
             for _ in range(2)]
    want = jmd.pose_decoder_forward(dec, [jnp.asarray(f) for f in feats],
                                    num_frames=2)
    m = tmd.PoseDecoder(num_input_features=2, num_frames=2)
    m.load_state_dict({k[len("pose_decoder."):]: v
                       for k, v in states(dec).items()}, strict=True)
    got = m([nchw(f) for f in feats])
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w, 1e-5)
    cnn = jax.tree_util.tree_map(np.asarray, jmd.init_pose_cnn_params(
        jax.random.PRNGKey(3), num_input_frames=3))
    x = rng.uniform(0, 1, (N, H, W, 9)).astype(np.float32)
    want = jmd.pose_cnn_forward(cnn, jnp.asarray(x), num_input_frames=3)
    m = tmd.PoseCNN(num_input_frames=3)
    m.load_state_dict({k[len("pose_cnn."):]: v
                       for k, v in states(cnn).items()}, strict=True)
    for g, w in zip(m(nchw(x)), want):
        assert tuple(g.shape) == w.shape
        close(g, w, 1e-5)
    # the port's seeded inits have the JAX inits' keys and shapes
    for mine, theirs in ((tmd.init_pose_decoder_params(
            torch.Generator().manual_seed(0), 2, 2), dec),
            (tmd.init_pose_cnn_params(torch.Generator().manual_seed(0), 3),
             cnn)):
        assert {k: tuple(v.shape) for k, v in states(theirs).items()} == \
            {k: tuple(v.shape) for k, v in mine.items()}


def test_layers_match_jax():
    rng = np.random.RandomState(2)
    x = rng.uniform(0, 1, (N, H, W, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    close(nhwc(ttr.ssim(nchw(x), nchw(y))),
          jtr.ssim(jnp.asarray(x), jnp.asarray(y)), 1e-5)
    close(ttr.reprojection_loss(nchw(x), nchw(y)),
          jtr.reprojection_loss(jnp.asarray(x), jnp.asarray(y)), 1e-5)
    d = rng.uniform(0.1, 1, (N, H, W, 1)).astype(np.float32)
    close(ttr.get_smooth_loss(nchw(d), nchw(x)),
          jtr.get_smooth_loss(jnp.asarray(d), jnp.asarray(x)), 1e-5)
    aa = rng.normal(0, 0.3, (5, 3)).astype(np.float32)
    aa[0] = 0.0
    tr = rng.normal(0, 1, (5, 3)).astype(np.float32)
    for inv in (False, True):
        close(ttr.transformation_from_parameters(
            torch.from_numpy(aa), torch.from_numpy(tr), inv),
            jtr.transformation_from_parameters(jnp.asarray(aa),
                                               jnp.asarray(tr), inv), 1e-5)
    grid = rng.uniform(-1.3, 1.3, (N, 20, 30, 2)).astype(np.float32)
    grid[0, 0, 0] = [-1.0, 1.0]
    close(nhwc(ttr.grid_sample_border(nchw(x), torch.from_numpy(grid))),
          jtr.grid_sample_border(jnp.asarray(x), jnp.asarray(grid)), 1e-5)


# ---------------------------------------------------------------------------
# the supervised depth step
# ---------------------------------------------------------------------------

def test_supervised_depth_step_matches_jax(params):
    rng = np.random.RandomState(4)
    depth_params = {k: v for k, v in params.items()
                    if k.startswith(("encoder.", "decoder."))}
    image = rng.uniform(0, 1, (N, H, W, 3)).astype(np.float32)
    target = rng.uniform(0.01, 1, (N, H, W)).astype(np.float32)
    mesh = jmesh.make_mesh(1, tp=1)
    state = jt.init_train_state({k: jnp.asarray(v) for k, v in
                                 depth_params.items()}, mesh, lr=1e-4)
    state, jloss = jt.make_train_step(mesh, lr=1e-4)(
        state, {"image": jnp.asarray(image), "target": jnp.asarray(target)})
    net = tmd.MonoDepth2(device="cpu")
    net.load_state_dict(states(depth_params), strict=True)
    tstate = tt.init_train_state(net, lr=1e-4)
    tstate, loss = tt.make_train_step()(
        tstate, {"image": nchw(image), "target": torch.from_numpy(target)})
    assert tstate.step == 1
    assert abs(float(loss) - float(jloss)) <= 1e-5 * max(float(jloss), 1.0)
    got = convert.convert_state_dict(net.state_dict())
    for k, v in state.params.items():
        close(got[k], np.asarray(v), 1e-5)


# ---------------------------------------------------------------------------
# the metrics
# ---------------------------------------------------------------------------

def test_depth_and_pose_metrics_match_jax():
    rng = np.random.RandomState(5)
    gt = rng.uniform(1, 70, (40, 60)).astype(np.float32)
    gt[rng.uniform(0, 1, gt.shape) < 0.3] = 0.0
    disp = rng.uniform(0.02, 0.5, (16, 24)).astype(np.float32)
    for med in (True, False):
        want = jtr.evaluate_depth(disp, gt, median_scaling=med)
        got = ttr.evaluate_depth(disp, gt, median_scaling=med)
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), k
    g = rng.uniform(1, 50, 500).astype(np.float32)
    p = (g * rng.uniform(0.8, 1.25, 500)).astype(np.float32)
    want = jtr.compute_depth_errors(jnp.asarray(g), jnp.asarray(p))
    got = ttr.compute_depth_errors(torch.from_numpy(g), torch.from_numpy(p))
    for k in want:
        close(got[k], want[k], 1e-6)
    aa = rng.normal(0, 0.05, (12, 3)).astype(np.float32)
    tr = rng.normal(0, 0.5, (12, 3)).astype(np.float32)
    rel = np.asarray(jtr.transformation_from_parameters(jnp.asarray(aa),
                                                        jnp.asarray(tr)))
    gt_rel = rel.copy()
    gt_rel[:, :3, 3] *= 1.3
    np.testing.assert_array_equal(ttr.dump_xyz(rel), jtr.dump_xyz(rel))
    assert ttr.compute_ate_snippet(ttr.dump_xyz(gt_rel), ttr.dump_xyz(rel)) \
        == jtr.compute_ate_snippet(jtr.dump_xyz(gt_rel), jtr.dump_xyz(rel))
    want = jtr.evaluate_pose_snippets(rel, gt_rel, 5)
    got = ttr.evaluate_pose_snippets(rel, gt_rel, 5)
    assert got[:2] == want[:2] and got[2] == want[2]
