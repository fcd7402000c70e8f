"""The port's (dp, tp) mesh on torch.distributed (``parallel/mesh.py`` and
the mesh form of the supervised depth step) against the JAX package's on
the CPU, the port's ranks gloo processes.

Each world size is spawned once (``mesh.spawn``: a ``file://`` store in a
temporary directory, so no TCP port can collide between test workers), and
each rank runs every check of its world size and returns its results; this
process compares them with JAX's. JAX is imported here only (the ranks are
fresh interpreters that import this module and not JAX).

- Shards: on every rank of a (dp 4, tp 2) mesh of 8 ranks, ``shard_params``
  of MonoDepth2's and the tiny detector's converted parameters is
  bit-equal to the converted data of JAX's ``shard_params`` on virtual
  device r of ``make_mesh(8, tp=2)``, the ConvTranspose2d (whose torch
  layout puts cin, JAX's dim 3, at dim 0) and the Linear weights included.
- The depth step at (dp 2, tp 2) and (dp 4, tp 2) on JAX's parameters and
  a global batch of 4 at 64x64, against JAX's ``value_and_grad`` of
  ``depth_loss`` and its optax Adam update on the whole batch on one device
  (GSPMD's mesh program computes the same function): the loss within 1e-6
  relative, the gradients within 1e-5 of each key's max |g|, after one
  Adam step (1e-4) the parameters within 1e-6 wherever |g_JAX| >= 1e-6 and
  within 2 lr everywhere (Adam's first step is about lr sign(g)); every
  rank holds the same parameters. The same bars against the port's own
  mesh-less step.
"""

import hashlib
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models.maskrcnn.backbone import ResNetConfig
from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNN, MaskRCNNConfig
from vido_slam_tpu_torch.models.monodepth2 import MonoDepth2
from vido_slam_tpu_torch.parallel import mesh as tmesh
from vido_slam_tpu_torch.parallel import train as tt
from vido_slam_tpu_torch.parallel.dryrun import dryrun_multichip

torch.set_num_threads(1)

N, HW = 4, 64
LR = 1e-4
MESHES = [(2, 2), (4, 2)]
TINY = MaskRCNNConfig(resnet=ResNetConfig(stage_blocks=(1, 1, 1, 1),
                                          out_channels=64),
                      input_h=64, input_w=96)


def depth_batch():
    """A global batch of N: images (N, 64, 64, 3) in [0, 1], targets."""
    rng = np.random.RandomState(0)
    return (rng.rand(N, HW, HW, 3).astype(np.float32),
            (0.1 + 0.5 * rng.rand(N, HW, HW)).astype(np.float32))


def torch_batch(image, target):
    return {"image": torch.from_numpy(np.ascontiguousarray(
        image.transpose(0, 3, 1, 2))), "target": torch.from_numpy(target)}


def digest(t) -> tuple:
    a = np.ascontiguousarray(np.asarray(t))
    return a.shape, str(a.dtype), hashlib.sha1(a.tobytes()).hexdigest()


def depth_net(params):
    net = MonoDepth2(device="cpu")
    net.load_state_dict(convert.monodepth2_state_dict_from_numpy(
        params, device="cpu"), strict=True)
    return net


def depth_step_results(net, state, loss):
    """Loss, gradients and parameters after a step, in the JAX layout."""
    whole = tt.trainable_state(net)
    return dict(loss=float(loss),
                grads=convert.convert_state_dict(
                    {k: v.grad for k, v in whole.items()}),
                params=convert.convert_state_dict(net.state_dict()))


def world_rank(dp, tp, depth_params, tiny_params, image, target):
    """Every check of one world size on this rank: the shards' digests (at
    tp 2) and the depth step's results (rank 0's whole, the others'
    parameters as digests)."""
    mesh = tmesh.make_mesh(dp=dp, tp=tp)
    out = {"shards": {}}
    for name, params, conv in (
            ("depth", depth_params, convert.monodepth2_state_dict_from_numpy),
            ("tiny", tiny_params, convert.maskrcnn_state_dict_from_numpy)):
        shards = tmesh.shard_params(conv(params, device="cpu"), mesh)
        out["shards"][name] = {k: digest(v) for k, v in shards.items()}
    net = depth_net(depth_params)
    state = tt.init_train_state(net, LR, mesh=mesh)
    state, loss = tt.make_train_step(mesh=mesh)(state,
                                                torch_batch(image, target))
    res = depth_step_results(net, state, loss)
    res["params_digest"] = {k: digest(v) for k, v in res["params"].items()}
    if mesh.rank != 0:
        del res["grads"], res["params"]
    out["depth"] = res
    return out


@pytest.fixture(scope="module")
def jax_params():
    """JAX's MonoDepth2 (PRNGKey(0)) and tiny detector (PRNGKey(4))
    parameters, as the dry run draws them."""
    import jax

    from vido_slam_tpu.models.maskrcnn import backbone as jb
    from vido_slam_tpu.models.maskrcnn import model as jm
    from vido_slam_tpu.models.monodepth2 import init_monodepth2_params

    tiny = jm.MaskRCNNConfig(resnet=jb.ResNetConfig(stage_blocks=(1, 1, 1, 1),
                                                    out_channels=64),
                             input_h=64, input_w=96)
    return tuple({k: np.array(v) for k, v in p.items()} for p in (
        jax.jit(init_monodepth2_params)(jax.random.PRNGKey(0)),
        jax.jit(jm.init_maskrcnn_params, static_argnums=1)(
            jax.random.PRNGKey(4), tiny)))


@pytest.fixture(scope="module")
def jax_depth_ref(jax_params):
    """JAX's value_and_grad of depth_loss on the global batch and one optax
    Adam step, on one device."""
    import jax
    import jax.numpy as jnp
    import optax

    from vido_slam_tpu.parallel.train import depth_loss

    image, target = depth_batch()
    p = {k: jnp.asarray(v) for k, v in jax_params[0].items()}
    opt = optax.adam(LR)

    @jax.jit
    def step(p):
        loss, g = jax.value_and_grad(depth_loss)(
            p, {"image": jnp.asarray(image), "target": jnp.asarray(target)})
        upd, _ = opt.update(g, opt.init(p), p)
        return loss, g, optax.apply_updates(p, upd)
    loss, g, new = step(p)
    return dict(loss=float(loss), grads={k: np.asarray(v) for k, v in
                                         g.items()},
                params={k: np.asarray(v) for k, v in new.items()})


@pytest.fixture(scope="module")
def port_depth_ref(jax_params):
    """The port's mesh-less step on the global batch."""
    net = depth_net(jax_params[0])
    state = tt.init_train_state(net, LR)
    state, loss = tt.make_train_step()(state, torch_batch(*depth_batch()))
    return depth_step_results(net, state, loss)


@pytest.fixture(scope="module")
def worlds(jax_params):
    depth_params, tiny_params = jax_params
    image, target = depth_batch()
    return {(dp, tp): tmesh.spawn(world_rank, dp * tp, dp, tp, depth_params,
                                  tiny_params, image, target)
            for dp, tp in MESHES}


def test_shards_match_jax_on_every_rank(jax_params, worlds):
    import jax.numpy as jnp

    from vido_slam_tpu.parallel.mesh import make_mesh, shard_params

    mesh = make_mesh(8, tp=2)
    devices = list(mesh.devices.reshape(-1))
    ranks = worlds[(4, 2)]
    for name, params, conv in (
            ("depth", jax_params[0],
             convert.monodepth2_state_dict_from_numpy),
            ("tiny", jax_params[1], convert.maskrcnn_state_dict_from_numpy)):
        sharded = shard_params({k: jnp.asarray(v) for k, v in params.items()},
                               mesh)
        for r, dev in enumerate(devices):
            data = {k: np.asarray(next(s.data for s in v.addressable_shards
                                       if s.device == dev))
                    for k, v in sharded.items()}
            want = {k: digest(v) for k, v in conv(data, device="cpu").items()}
            assert ranks[r]["shards"][name] == want, (name, r)
    # the ConvTranspose2d's block is its dim 0 (cin: JAX's dim 3 of its
    # (kh, kw, cout, cin) layout), a Linear's its dim 0 (out), on rank 0
    tiny = ranks[0]["shards"]["tiny"]
    whole = convert.maskrcnn_state_dict_from_numpy(jax_params[1],
                                                   device="cpu")
    for key in ("roi_heads.mask.predictor.conv5_mask.weight",
                "roi_heads.box.feature_extractor.fc6.weight"):
        w = whole[key]
        assert tiny[key] == digest(w[:w.shape[0] // 2]), key
        assert tiny[key] != digest(w[:, :w.shape[1] // 2]), key


def hold_depth_step(got, want):
    """The module's bars on a step's results against a reference's."""
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        scale = float(np.abs(g).max())
        assert float(np.abs(got["grads"][k] - g).max()) <= 1e-5 * scale, k
    for k, p in want["params"].items():
        err = np.abs(got["params"][k] - p)
        big = np.abs(want["grads"][k]) >= 1e-6
        assert err[big].max(initial=0.0) <= 1e-6, k
        assert err.max() <= 2 * LR, k


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"dp{s[0]}tp{s[1]}")
def test_depth_step_on_the_mesh_matches_jax(shape, worlds, jax_depth_ref):
    ranks = worlds[shape]
    hold_depth_step(ranks[0]["depth"], jax_depth_ref)
    for r in ranks:
        assert r["depth"]["params_digest"] == \
            ranks[0]["depth"]["params_digest"]
        assert r["depth"]["loss"] == ranks[0]["depth"]["loss"]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"dp{s[0]}tp{s[1]}")
def test_depth_step_on_the_mesh_matches_the_single_device_step(
        shape, worlds, port_depth_ref):
    hold_depth_step(worlds[shape][0]["depth"], port_depth_ref)


# ---------------------------------------------------------------------------
# the mesh's rules without ranks
# ---------------------------------------------------------------------------

def test_param_spec_shards_the_elements_jax_shards():
    w = torch.zeros
    # a Conv2d (cout 8, cin 3): cout, JAX's HWIO dim 3
    assert tmesh.param_spec("a.weight", w(8, 3, 3, 3), 2) == 0
    # a ConvTranspose2d (cin 8, cout 4): JAX's (kh, kw, cout, cin) dim 3
    assert tmesh.param_spec("b.weight", w(8, 4, 2, 2), 2) == 0
    # a Linear (out 6, in 10): JAX's (in, out) dim 1
    assert tmesh.param_spec("fc.weight", w(6, 10), 2) == 0
    assert tmesh.param_spec("c.bias", w(6), 2) == 0
    assert tmesh.param_spec("c.bias", w(5), 2) is None
    assert tmesh.param_spec("d.weight", w(7, 3, 1, 1), 2) is None
    assert tmesh.param_spec("e", w(()), 2) is None


def test_batches_that_dp_does_not_divide_raise():
    mesh = SimpleNamespace(dp=2, dp_rank=1)
    got = tmesh.shard_batch({"a": np.arange(4), "b": (torch.arange(6),
                                                      None)}, mesh)
    np.testing.assert_array_equal(got["a"], [2, 3])
    assert got["b"][0].tolist() == [3, 4, 5] and got["b"][1] is None
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(np.arange(3), mesh)


def test_a_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_mesh(1)


def test_init_distributed_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.init_distributed()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(1)
