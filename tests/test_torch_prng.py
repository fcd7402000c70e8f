"""The port's threefry PRNG bit for bit against jax.random (partitionable
threefry), and its order helpers' tie rule against lax.top_k / argsort."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu_torch.utils import prng
from vido_slam_tpu_torch.utils.order import argsort, top_k

torch.set_num_threads(1)


def _bits(x):
    return np.asarray(x).astype(np.float32).view(np.uint32)


def test_partitionable_mode_is_the_reference():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789, 2 ** 31 - 1])
def test_key_and_split(seed):
    kj = jax.random.PRNGKey(seed)
    kt = prng.PRNGKey(seed)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj).astype(np.int64))
    # the tracker's draws: split into 2 (host key), 4 (per frame) and 8
    # (max_objects)
    for n in (2, 4, 8):
        np.testing.assert_array_equal(
            prng.split(kt, n).numpy(),
            np.asarray(jax.random.split(kj, n)).astype(np.int64))


@pytest.mark.parametrize("shape", [(560, 1280), (160, 256), (2000,),
                                   (12000,), (7, 3)])
def test_uniform_bit_equal(shape):
    kj = jax.random.split(jax.random.PRNGKey(3), 4)[2]
    kt = prng.split(prng.PRNGKey(3), 4)[2]
    np.testing.assert_array_equal(
        prng.uniform(kt, shape).numpy().view(np.uint32),
        _bits(jax.random.uniform(kj, shape)))


def test_uniform_batched_keys_match_vmap():
    # the object RANSAC: one (reps*N,) draw per object key
    kj = jax.random.split(jax.random.PRNGKey(11), 8)
    kt = prng.split(prng.PRNGKey(11), 8)
    want = jax.vmap(lambda k: jax.random.uniform(k, (4000,)))(kj)
    np.testing.assert_array_equal(prng.uniform(kt, (4000,)).numpy()
                                  .view(np.uint32), _bits(want))


@pytest.mark.parametrize("seed", [-1, 2 ** 31])
def test_seed_out_of_range_rejected(seed):
    with pytest.raises(ValueError):
        prng.PRNGKey(seed)


def test_top_k_ties_lower_index_first():
    x = np.array([3.0, 1.0, 3.0, -1.0, 3.0, 1.0, -1.0, -1.0], np.float32)
    for k in (1, 3, 5, 8):
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        vt, it = top_k(torch.tensor(x), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_top_k_int_counts_and_inf():
    rng = np.random.RandomState(0)
    counts = rng.randint(-1, 5, 500).astype(np.int32)
    vj, ij = jax.lax.top_k(jnp.asarray(counts), 100)
    vt, it = top_k(torch.tensor(counts), 100)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    prio = np.where(rng.rand(300) < 0.5, -np.inf,
                    -rng.randint(0, 4, 300)).astype(np.float32)
    _, ij = jax.lax.top_k(jnp.asarray(prio), 200)
    _, it = top_k(torch.tensor(prio), 200)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_argsort_stable_on_ties():
    rng = np.random.RandomState(1)
    x = rng.randint(0, 3, (4, 50)).astype(np.float32)
    x[:, :10] = np.inf
    np.testing.assert_array_equal(argsort(torch.tensor(x), dim=1).numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(x),
                                                         axis=1)))
    b = rng.rand(40) < 0.5
    np.testing.assert_array_equal(
        argsort(~torch.tensor(b)).numpy(),
        np.asarray(jnp.argsort(~jnp.asarray(b), stable=True)))
