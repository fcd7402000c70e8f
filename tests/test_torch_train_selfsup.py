"""The port's self-supervised MonoDepth2 trainer
(``models/monodepth2_train.py::selfsup_loss``, ``make_selfsup_train_step``)
against the JAX package's on the same numpy-seeded batch (a textured scene
and its neighbours shifted by 2 and 3 px), key and parameters (JAX's
``init_selfsup_params`` carried across by
``convert.monodepth2_state_dict_from_numpy``), at 64x96, batch 2, four
scales, automasking on, stereo off.

Bars: the loss (total and each scale) within 1e-4 relative, the depth
within 1e-5 of its magnitude, the gradient for every key (BatchNorm
statistics included) within 1e-3 of that key's max |g|, the key sets
equal. One Adam step (1e-4): JAX's step is ``value_and_grad`` then
optax's adam (monodepth2_train.py:302-328), here on the JAX fixture's
gradient. The port's step gives the same loss within 1e-4 and parameters
within 1e-5 wherever JAX's gradient exceeds 1e-6 in magnitude; Adam's
first step is -lr g / (|g| + 1e-8), which turns the float32 noise of a
gradient near 1e-8 into a step of either sign, so elsewhere the bar is
2 lr. The optimizer alone, on JAX's gradient, within 1e-6.

The step on a dp 2 mesh of two gloo ranks (``parallel/mesh.py::spawn``;
each rank takes one row of the batch and its rows of the automasking
noise drawn over the whole batch) meets the loss and gradient bars above
against the same JAX reference on the whole batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vido_slam_tpu.models import monodepth2_train as jtr
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models import monodepth2_train as ttr
from vido_slam_tpu_torch.parallel import mesh as tmesh
from vido_slam_tpu_torch.parallel import train as tt
from vido_slam_tpu_torch.utils import prng

torch.set_num_threads(1)

N, H, W = 2, 64, 96
LR = 1e-4


def close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * scale, (err, scale)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def states(params):
    return convert.monodepth2_state_dict_from_numpy(params, device="cpu")


@pytest.fixture(scope="module")
def params():
    p = jax.jit(jtr.init_selfsup_params)(jax.random.PRNGKey(0))
    return {k: np.array(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def batch():
    """A textured scene, its neighbours shifted by 2 and 3 px."""
    rng = np.random.RandomState(3)
    base = rng.rand(N, H, W, 3).astype(np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 40.0
    K[0, 2], K[1, 2] = W / 2, H / 2
    inv_K = np.linalg.inv(K).astype(np.float32)
    return dict(color=base, prev=np.roll(base, 2, axis=2),
                next=np.roll(base, -3, axis=2),
                K=np.broadcast_to(K, (N, 4, 4)).copy(),
                inv_K=np.broadcast_to(inv_K, (N, 4, 4)).copy())


def j_batch(b):
    return jtr.SelfSupBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def t_batch(b):
    return ttr.SelfSupBatch(**{k: nchw(v) if v.ndim == 4 and k not in
                               ("K", "inv_K") else torch.from_numpy(v)
                               for k, v in b.items()})


def t_model(params):
    m = ttr.SelfSupModel(device="cpu")
    m.load_state_dict(states(params), strict=True)
    return m


@pytest.fixture(scope="module")
def jax_ref(params, batch):
    key = jax.random.PRNGKey(7)

    def f(p):
        return jtr.selfsup_loss(p, j_batch(batch), key)

    (loss, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()})
    return dict(loss=float(loss), aux={k: np.asarray(v) for k, v in
                                      aux.items()},
                grads={k: np.asarray(v) for k, v in grads.items()})


# ---------------------------------------------------------------------------
# the self-supervised loss, its gradient and the trainers' steps
# ---------------------------------------------------------------------------

def test_selfsup_loss_and_gradient_match_jax(params, batch, jax_ref):
    m = t_model(params)
    state = tt.trainable_state(m)
    loss, aux = ttr.selfsup_loss(m, t_batch(batch), prng.PRNGKey(7))
    tt.compute_grads(loss, state)
    assert abs(float(loss) - jax_ref["loss"]) <= 1e-4 * jax_ref["loss"]
    for s in range(4):
        want = float(jax_ref["aux"][f"loss/{s}"])
        assert abs(float(aux[f"loss/{s}"]) - want) <= 1e-4 * want, s
    close(aux["depth"], jax_ref["aux"]["depth"], 1e-5)
    got = convert.convert_state_dict({k: v.grad for k, v in state.items()})
    want = jax_ref["grads"]
    assert set(got) == set(want)
    bad = []
    for k in want:
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(got[k] - want[k]).max())
        if err > 1e-3 * scale + 1e-12:
            bad.append((k, err, scale))
    assert not bad, bad
    assert np.abs(got["encoder.bn1.running_mean"]).max() > 0
    assert np.abs(got["pose_decoder.convs.squeeze.weight"]).max() > 0


def jax_adam_step(params, grads):
    opt = optax.adam(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    @jax.jit
    def step(g):
        upd, _ = opt.update(g, opt.init(jp), jp)
        return optax.apply_updates(jp, upd)
    out = step({k: jnp.asarray(v) for k, v in grads.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def test_selfsup_train_step_matches_jax(params, batch, jax_ref):
    want = jax_adam_step(params, jax_ref["grads"])
    m = t_model(params)
    step = ttr.make_selfsup_train_step(m, lr=LR)
    loss = step(t_batch(batch), prng.PRNGKey(7))
    assert abs(float(loss) - jax_ref["loss"]) <= 1e-4 * jax_ref["loss"]
    got = convert.convert_state_dict(m.state_dict())
    for k, v in want.items():
        err = np.abs(got[k] - v)
        big = np.abs(jax_ref["grads"][k]) > 1e-6
        assert err[big].max(initial=0.0) <= 1e-5 * max(1.0, np.abs(v).max()), k
        assert err.max() <= 2.001 * LR, k
    # the optimizer alone, on JAX's gradient
    m = t_model(params)
    state = tt.trainable_state(m)
    tgrads = convert.monodepth2_state_dict_from_numpy(jax_ref["grads"],
                                                      device="cpu")
    for k, v in state.items():
        v.grad = tgrads[k]
    tt.make_optimizer(state, LR).step()
    got = convert.convert_state_dict(m.state_dict())
    for k, v in want.items():
        close(got[k], v, 1e-6)




def test_selfsup_loss_of_rows_draws_the_whole_batch_noise(params, batch):
    """The rows of a batch with ``rows=(first, N)`` add the noise rows of
    the whole batch's draw: their losses average to the whole batch's (the
    loss is a mean over equal rows). On still frames the identity
    reprojection loss is 0 and the minimum takes the noise itself, so a
    row's own draw would move the loss by far more than the rounding."""
    m = t_model(params)
    b = t_batch(dict(batch, prev=batch["color"], next=batch["color"]))

    def row(i):
        return type(b)(*(None if x is None else x[i:i + 1] for x in b))
    key = prng.PRNGKey(7)
    with torch.no_grad():
        whole = float(ttr.selfsup_loss(m, b, key)[0])
        cut = np.mean([float(ttr.selfsup_loss(m, row(i), key,
                                              rows=(i, N))[0])
                       for i in range(N)])
        own = np.mean([float(ttr.selfsup_loss(m, row(i), key)[0])
                       for i in range(N)])
    assert abs(cut - whole) <= 1e-6 * whole, (cut, whole)
    # measured: 0.0 and 2.5e-4 relative
    assert abs(own - whole) > 1e-5 * whole, (own, whole)


def mesh_step_rank(params, batch):
    """One self-supervised step on a dp 2 mesh: the dp-mean loss and the
    reduced gradient (JAX layout)."""
    mesh = tmesh.make_mesh(dp=2)
    m = t_model(params)
    loss = ttr.make_selfsup_train_step(m, lr=LR, mesh=mesh)(
        t_batch(batch), prng.PRNGKey(7))
    return float(loss), convert.convert_state_dict(
        {k: v.grad for k, v in tt.trainable_state(m).items()})


def test_selfsup_step_on_a_dp_2_mesh_matches_jax(params, batch, jax_ref):
    for loss, got in tmesh.spawn(mesh_step_rank, 2, params, batch):
        assert abs(loss - jax_ref["loss"]) <= 1e-4 * jax_ref["loss"]
        want = jax_ref["grads"]
        assert set(got) == set(want)
        bad = []
        for k in want:
            scale = float(np.abs(want[k]).max())
            err = float(np.abs(got[k] - want[k]).max())
            if err > 1e-3 * scale + 1e-12:
                bad.append((k, err, scale))
        assert not bad, bad
