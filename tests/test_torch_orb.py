"""The port's ORB extractor (``ops/orb.py``) against the JAX package's
``vido_slam_tpu/ops/orb.py``, on the images of tests/test_orb.py (isolated
bright squares, blocky random texture, gradients) made from numpy seeds.

Bars:
  - the level sizes and budgets, the FAST keypoints, their octaves, sizes
    and validity equal; responses within 1e-6 of their magnitude;
  - the pyramid: ``resize_linear`` within 1e-5 of the image's magnitude of
    ``jax.image.resize(..., "linear")`` (XLA fuses and reorders the
    weights' arithmetic and the sums, so not to the bit);
  - angles within 1e-4 rad (taken modulo 2 pi);
  - descriptors bit-equal, except a bit whose test is decided by float32
    rounding: a rotated tap within 1e-3 px of a rounding boundary, or, on
    a level above 0, two taps whose values in the JAX level image differ by
    no more than twice the level's resize error (flat regions make such
    near-ties common there: equal pixels resized come out equal only up to
    rounding). Every differing bit must have one of these causes; the
    counts are printed, and the boundary cases bounded by 1 % of the bits;
  - the matcher equal, index and flag, on the same descriptors (ties to
    the lower index, as ``jnp.argmin``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.ops import orb as jo
from vido_slam_tpu_torch.ops import orb as to

torch.set_num_threads(1)


def textured(h=192, w=256, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
    return np.kron(img, np.ones((8, 8), np.float32))


def squares():
    """Isolated bright squares on a dark ground: their corners are
    L-junctions, which FAST-9 detects."""
    img = np.full((192, 256), 30.0, np.float32)
    for cy in range(40, 180, 48):
        for cx in range(40, 240, 48):
            img[cy:cy + 20, cx:cx + 20] = 220.0
    return img


def wrapped(a, b):
    return np.abs((np.asarray(a, np.float64) - b + np.pi) % (2 * np.pi)
                  - np.pi)


def test_pyramid_shapes_and_budgets_equal_jax():
    for h, w in ((560, 1280), (192, 256), (160, 200), (375, 1242)):
        assert to.level_sizes(h, w) == jo.level_sizes(h, w)
    for n in (300, 500, 800, 2000):
        assert to.features_per_level(n) == jo.features_per_level(n)
    assert np.array_equal(to._PATTERN, jo._PATTERN)


@pytest.mark.parametrize("name", ["textured", "squares"])
def test_resize_matches_jax(name):
    img = textured() if name == "textured" else squares()
    for h, w in to.level_sizes(*img.shape)[1:]:
        want = np.asarray(jax.image.resize(jnp.asarray(img), (h, w),
                                           "linear"))
        got = to.resize_linear(torch.from_numpy(img), h, w).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape", [(12, 9, 40, 31), (5, 30, 7, 64)])
def test_resize_weights_match_jax_when_growing_and_shrinking(shape):
    h_in, h_out, w_in, w_out = shape
    img = np.random.RandomState(4).uniform(0, 255, (h_in, w_in)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (h_out, w_out),
                                       "linear"))
    got = to.resize_linear(torch.from_numpy(img), h_out, w_out).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_resize_weights_take_the_callers_device():
    """The weights had a CPU default device, so a caller on the card that
    left it out got CPU weights; the device is now required."""
    with pytest.raises(TypeError):
        to.resize_weights(10, 5)
    assert to.resize_weights(10, 5, "cpu").shape == (5, 10)


def test_orientation_matches_jax():
    xx = np.tile(np.arange(64, dtype=np.float32), (64, 1))
    for img in (xx, xx.T.copy(), textured(96, 96, seed=3)):
        want = np.asarray(jo.orientation_map(jnp.asarray(img)))
        got = to.orientation_map(torch.from_numpy(img)).numpy()
        inner = (slice(16, -16), slice(16, -16))
        assert wrapped(got[inner], want[inner]).max() <= 1e-4
    a = to.orientation_map(torch.from_numpy(xx)).numpy()[32, 32]
    assert abs(a) < 0.05


def _explained_bits(img, uv, ang_j, ang_t, diff_bits, tie_tol):
    """(boundary, tie) flags of each differing (keypoint, bit): a rotated
    tap within 1e-3 px of a rounding boundary under either angle, or two
    taps whose values in ``img`` differ by at most ``tie_tol``."""
    pat = to._PATTERN.astype(np.float64)
    H, W = img.shape
    boundary, tie = [], []
    for k, i in diff_bits:
        near = False
        vals = []
        for th in (ang_j[k], ang_t[k]):
            ca, sa = np.cos(th), np.sin(th)
            taps = []
            for x, y in pat[i]:
                c = uv[k, 0] + x * ca - y * sa
                r = uv[k, 1] + x * sa + y * ca
                near |= min(abs(c - np.floor(c) - 0.5),
                            abs(r - np.floor(r) - 0.5)) < 1e-3
                taps.append(img[int(np.clip(np.rint(r), 0, H - 1)),
                                int(np.clip(np.rint(c), 0, W - 1))])
            vals.append(taps)
        boundary.append(near)
        tie.append(any(abs(float(a) - float(b)) <= tie_tol for a, b in vals))
    return np.asarray(boundary, bool), np.asarray(tie, bool)


@pytest.mark.parametrize("name,n", [("squares", 500), ("textured", 800)])
def test_orb_extract_matches_jax(name, n):
    img = textured() if name == "textured" else squares()
    want = jax.device_get(jo.orb_extract(jnp.asarray(img), n=n))
    got = to.orb_extract(img, n=n, device="cpu")
    for f in ("uv", "octave", "size", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.descriptor.dtype == torch.uint8
    r_want = np.asarray(want.response)
    assert np.abs(got.response.numpy() - r_want).max() \
        <= 1e-6 * np.abs(r_want).max()
    ok = np.asarray(want.valid)
    assert ok.sum() > 20
    ang_t, ang_j = got.angle.numpy(), np.asarray(want.angle)
    assert wrapped(ang_t[ok], ang_j[ok]).max() <= 1e-4

    # descriptors, level by level, every differing bit explained
    bits_t = np.unpackbits(got.descriptor.numpy(), axis=1,
                           bitorder="little")
    bits_j = np.unpackbits(np.asarray(want.descriptor), axis=1,
                           bitorder="little")
    octave = np.asarray(want.octave)
    sizes = jo.level_sizes(*img.shape)
    n_boundary = n_tie = n_bits = 0
    for lv, (lh, lw) in enumerate(sizes):
        sel = np.nonzero(ok & (octave == lv))[0]
        if sel.size == 0:
            continue
        if lv == 0:
            level, tol = img, 0.0
        else:
            level = np.asarray(jax.image.resize(jnp.asarray(img), (lh, lw),
                                                "linear"))
            err = np.abs(to.resize_linear(torch.from_numpy(img), lh,
                                          lw).numpy() - level).max()
            tol = 2.0 * float(err)
        uv_lv = np.asarray(want.uv)[sel] / (1.2 ** lv)
        diff = np.argwhere(bits_t[sel] != bits_j[sel])
        n_bits += sel.size * 256
        if diff.size == 0:
            continue
        boundary, tie = _explained_bits(level, uv_lv, ang_j[sel],
                                        ang_t[sel], diff, tol)
        assert (boundary | tie).all(), diff[~(boundary | tie)]
        n_boundary += int(boundary.sum())
        n_tie += int((tie & ~boundary).sum())
    print(f"{name}: {int(ok.sum())} keypoints, bits differing: "
          f"{n_boundary} at a rounding boundary, {n_tie} at a near-tie, "
          f"of {n_bits}")
    # near-ties decide most bits of a flat image's upper levels; taps at a
    # rounding boundary are rare
    assert n_boundary <= 0.01 * n_bits


def test_steered_brief_matches_jax_and_the_numpy_oracle():
    """On one image, one set of points and angles: the oracle of
    computeOrbDescriptor's semantics (tests/test_orb.py) and JAX."""
    img = textured(96, 96, seed=11)
    pts = np.asarray([[40.0, 50.0], [60.0, 30.0], [48.0, 48.0]], np.float32)
    angs = np.asarray([0.0, 0.7, -2.1], np.float32)
    got = to.steered_brief(torch.from_numpy(img), torch.from_numpy(pts),
                           torch.from_numpy(angs)).numpy()
    want = np.asarray(jo.steered_brief(jnp.asarray(img), jnp.asarray(pts),
                                       jnp.asarray(angs)))
    np.testing.assert_array_equal(got, want)
    for k, ((u, v), th) in enumerate(zip(pts, angs)):
        ca, sa = np.cos(th), np.sin(th)
        oracle = np.zeros(32, np.uint8)
        for i in range(256):
            vals = []
            for x, y in to._PATTERN[i]:
                c = int(np.rint(u + x * ca - y * sa))
                r = int(np.rint(v + x * sa + y * ca))
                vals.append(img[r, c])
            oracle[i // 8] |= np.uint8(int(vals[0] < vals[1]) << (i % 8))
        np.testing.assert_array_equal(got[k], oracle)


def test_rotation_invariance_and_distinct_points():
    img = textured(128, 128, seed=5)
    rot = np.rot90(img, -1).copy()
    g0, g1 = torch.from_numpy(img), torch.from_numpy(rot)
    a0 = to.orientation_map(g0)[40, 50][None]
    a1 = to.orientation_map(g1)[50, 87][None]
    d0 = to.steered_brief(g0, torch.tensor([[50.0, 40.0]]), a0)
    d1 = to.steered_brief(g1, torch.tensor([[87.0, 50.0]]), a1)
    assert int(to.hamming_distances(d0, d1)[0, 0]) < 60
    img = torch.from_numpy(textured(128, 128, seed=6))
    d = to.steered_brief(img, torch.tensor([[40.0, 40.0], [90.0, 70.0]]),
                         torch.zeros(2))
    assert int(to.hamming_distances(d[:1], d[1:])[0, 0]) > 60


def test_hamming_distances_equal_popcount():
    rng = np.random.RandomState(7)
    a = rng.randint(0, 256, (5, 32)).astype(np.uint8)
    b = rng.randint(0, 256, (6, 32)).astype(np.uint8)
    want = np.asarray(jnp.sum(jax.lax.population_count(
        jnp.bitwise_xor(a[:, None], b[None])).astype(jnp.int32), axis=-1))
    got = to.hamming_distances(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cross_check", [True, False])
def test_match_descriptors_matches_jax(cross_check):
    """Random descriptors with repeated rows (exact ties in both
    directions) and invalid rows, then the translation case of
    tests/test_orb.py."""
    rng = np.random.RandomState(8)
    d1 = rng.randint(0, 256, (40, 32)).astype(np.uint8)
    d2 = np.concatenate([d1[:10] ^ (rng.rand(10, 32) < 0.02).astype(
        np.uint8), d1[5:15], rng.randint(0, 256, (20, 32)).astype(np.uint8)])
    v1 = rng.rand(40) > 0.1
    v2 = rng.rand(40) > 0.1
    want = jo.match_descriptors(jnp.asarray(d1), jnp.asarray(v1),
                                jnp.asarray(d2), jnp.asarray(v2),
                                cross_check=cross_check)
    got = to.match_descriptors(torch.from_numpy(d1), torch.from_numpy(v1),
                               torch.from_numpy(d2), torch.from_numpy(v2),
                               cross_check=cross_check)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].any()


def test_translation_matching():
    img = textured(160, 200, seed=7)
    shifted = np.roll(img, (0, 5), axis=(0, 1))
    f1 = to.orb_extract(img, n=300, device="cpu")
    f2 = to.orb_extract(shifted, n=300, device="cpu")
    idx, ok = to.match_descriptors(f1.descriptor, f1.valid, f2.descriptor,
                                   f2.valid)
    widx, wok = jo.match_descriptors(
        jnp.asarray(f1.descriptor.numpy()), jnp.asarray(f1.valid.numpy()),
        jnp.asarray(f2.descriptor.numpy()), jnp.asarray(f2.valid.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))
    ok = ok.numpy()
    assert ok.sum() > 30
    d = f2.uv.numpy()[idx.numpy()[ok]] - f1.uv.numpy()[ok]
    good = (np.abs(d[:, 0] - 5) < 2) & (np.abs(d[:, 1]) < 2)
    assert good.mean() > 0.8


def test_orb_extract_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            to.orb_extract(squares())
