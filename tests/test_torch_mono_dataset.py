"""The port's depth data pipeline (``data/image_ops.py``,
``data/mono_dataset.py``, ``data/kitti_utils.py``) against the JAX
package's and against the PIL and matplotlib calls it replaces, on the
same numpy-seeded inputs.

Bars: ``resize_lanczos_u8`` bit-equal to ``PIL.Image.resize(...,
LANCZOS)`` and ``rgb_to_hsv``/``hsv_to_rgb`` bit-equal to matplotlib's;
``MonoSequenceDataset``'s clean (read and resized) frames, K and inv_K
bit-equal to JAX's and its jittered frames within 1e-6 (the same numpy
code: they come out equal), draw for draw with the same seed, over a
directory of PNG (8-bit RGB, 16-bit gray, RGBA), JPEG and ``.npy`` frames
of sizes above, below and at the target; ``kitti_utils`` bit-equal to
JAX's on generated calibration and velodyne files.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from vido_slam_tpu.data import kitti_utils as jku
from vido_slam_tpu.data import mono_dataset as jmd
from vido_slam_tpu_torch.data import image_ops
from vido_slam_tpu_torch.data import kitti_utils as tku
from vido_slam_tpu_torch.data import mono_dataset as tmd

torch.set_num_threads(1)

H, W = 32, 64


def test_lanczos_is_pil_to_the_bit():
    rng = np.random.RandomState(0)
    pairs = [tuple(rng.randint(1, 97, 4)) for _ in range(20)]
    pairs += [(375, 1242, 192, 640), (40, 60, 40, 90), (40, 60, 17, 60),
              (5, 3, 80, 70), (192, 640, 384, 1280)]
    for h_in, w_in, h, w in pairs:
        img = rng.randint(0, 256, (h_in, w_in, 3), np.uint8)
        want = np.asarray(Image.fromarray(img).resize((int(w), int(h)),
                                                      Image.LANCZOS))
        got = image_ops.resize_lanczos_u8(img, int(h), int(w))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want,
                                      err_msg=str((h_in, w_in, h, w)))
    with pytest.raises(ValueError):
        image_ops.resize_lanczos_u8(img.astype(np.float32), 4, 4)


def test_hsv_is_matplotlib_to_the_bit():
    import matplotlib.colors as mc
    rng = np.random.RandomState(1)
    rgb = rng.uniform(0, 1, (40, 50, 3)).astype(np.float32)
    rgb[0, :5] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0],
                  [0.2, 0.9, 0.9]]
    rgb[1, :3] = np.round(rgb[1, :3] * 4) / 4     # ties between channels
    for x in (rgb, rgb.astype(np.float64), rgb[0, 0]):
        np.testing.assert_array_equal(image_ops.rgb_to_hsv(x),
                                      mc.rgb_to_hsv(x))
        assert image_ops.rgb_to_hsv(x).dtype == mc.rgb_to_hsv(x).dtype
    hsv = mc.rgb_to_hsv(rgb)
    hsv[..., 0] = (hsv[..., 0] + 0.093) % 1.0
    hsv[2, :6, 0] = np.arange(6) / 6.0              # sector edges
    hsv[3, :4, 1] = 0.0                             # no saturation
    for x in (hsv, hsv.astype(np.float64)):
        got, want = image_ops.hsv_to_rgb(x), mc.hsv_to_rgb(x)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    with pytest.raises(ValueError):
        image_ops.rgb_to_hsv(rgb * 2)


def test_color_jitter_and_draws_equal_jax():
    rng = np.random.RandomState(2)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    for params in [(1.1, 0.9, 1.2, 0.07), (0.85, 1.15, 0.8, -0.1),
                   (1.0, 1.0, 1.0, 0.0)]:
        got = tmd.color_jitter(img, *params)
        want = jmd.color_jitter(img, *params)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    assert [tmd.sample_jitter_params(a) for _ in range(4)] == \
        [jmd.sample_jitter_params(b) for _ in range(4)]


def _frame(rng, h, w):
    return rng.randint(0, 256, (h, w, 3), np.uint8)


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    """Ten frames: PNGs written by the port's own writer (8-bit BGR, 16-bit
    gray, BGRA), JPEGs by PIL, and .npy arrays (0..255 and 0..1), at
    sizes above, below and equal to 32x64."""
    d = str(tmp_path_factory.mktemp("mono"))
    rng = np.random.RandomState(4)
    chip_smoke.write_png(os.path.join(d, "f00.png"), _frame(rng, 48, 100))
    chip_smoke.write_png(os.path.join(d, "f01.png"),
                         rng.randint(0, 1200, (40, 70)).astype(np.uint16))
    Image.fromarray(_frame(rng, 60, 90)).save(os.path.join(d, "f02.jpg"),
                                              quality=85)
    np.save(os.path.join(d, "f03.npy"), _frame(rng, H, W).astype(np.float32))
    chip_smoke.write_png(os.path.join(d, "f04.png"), np.concatenate(
        [_frame(rng, 24, 40), rng.randint(0, 256, (24, 40, 1), np.uint8)],
        -1))
    Image.fromarray(_frame(rng, H, W)).save(os.path.join(d, "f05.jpeg"))
    np.save(os.path.join(d, "f06.npy"),
            rng.uniform(0, 1, (50, 80, 3)).astype(np.float32))
    chip_smoke.write_png(os.path.join(d, "f07.png"), _frame(rng, H, W))
    Image.fromarray(_frame(rng, 33, 65)).save(os.path.join(d, "f08.jpg"))
    chip_smoke.write_png(os.path.join(d, "f09.png"), _frame(rng, 31, 63))
    return d


def _items_equal(got, want):
    for k in ("prev", "color", "next", "K", "inv_K"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("prev_aug", "color_aug", "next_aug"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
        assert got[k].dtype == want[k].dtype


def test_items_equal_jax_draw_for_draw(frame_dir):
    """Every item of two epochs (train mode: flips and jitters drawn from
    the seed) equal to JAX's, and eval mode's too."""
    for train in (True, False):
        t = tmd.MonoSequenceDataset(frame_dir, H, W, is_train=train, seed=7)
        j = jmd.MonoSequenceDataset(frame_dir, H, W, is_train=train, seed=7)
        assert t.items == j.items and len(t) == len(j) == 8
        for _ in range(2):
            for i in range(len(t)):
                _items_equal(t.get_item(i), j.get_item(i))
    assert t.get_item(0)["color"].shape == (H, W, 3)


def test_batches_equal_jax(frame_dir):
    """``epoch_batches`` (the shuffle, then the items in its order) as
    NCHW tensors on the CPU, JAX's NHWC arrays transposed."""
    t = tmd.MonoSequenceDataset(frame_dir, H, W, seed=11)
    j = jmd.MonoSequenceDataset(frame_dir, H, W, seed=11)
    got = list(t.epoch_batches(3, device="cpu"))
    want = list(j.epoch_batches(3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("color", "prev", "next", "color_aug", "prev_aug",
                  "next_aug"):
            x = getattr(g, k)
            assert x.device.type == "cpu" and x.shape == (3, 3, H, W)
            np.testing.assert_allclose(
                x.numpy().transpose(0, 2, 3, 1), np.asarray(getattr(w, k)),
                atol=1e-6 if k.endswith("aug") else 0, rtol=0, err_msg=k)
        for k in ("K", "inv_K"):
            np.testing.assert_array_equal(getattr(g, k).numpy(),
                                          np.asarray(getattr(w, k)))
    b = t.batch([0, 5], device="cpu")
    assert b.stereo is None and b.color.is_contiguous()


def test_arrays_at_the_target_size_skip_the_resize():
    rng = np.random.RandomState(5)
    frames = [rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
              for _ in range(4)]
    t = tmd.MonoSequenceDataset(frames, H, W, is_train=False)
    np.testing.assert_array_equal(t.get_item(1)["color"], frames[2])
    j = jmd.MonoSequenceDataset(frames, 16, 40, is_train=False)
    t = tmd.MonoSequenceDataset(frames, 16, 40, is_train=False)
    np.testing.assert_array_equal(t.get_item(0)["next"],
                                  j.get_item(0)["next"])


def test_batch_takes_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    t = tmd.MonoSequenceDataset([np.zeros((H, W, 3), np.float32)] * 3, H, W)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t.batch([0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(t.epoch_batches(1))


def _kitti_files(d, rng, n_points=4000):
    """A calibration day (a rotated, offset velodyne; a rectification; a
    KITTI-like P_rect_02) and two scans with points in front, behind and
    outside the image, some on one ray."""
    ang = rng.uniform(-0.05, 0.05, 3)
    cz, sz = np.cos(ang[2]), np.sin(ang[2])
    R = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]]) @ np.array(
        [[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    with open(os.path.join(d, "calib_cam_to_cam.txt"), "w") as f:
        f.write("calib_time: 09-Jan-2012 13:57:47\n")
        f.write("S_rect_02: 1.242000e+03 3.750000e+02\n")
        f.write("R_rect_00: " + " ".join(
            f"{v:.6e}" for v in (np.eye(3) + rng.uniform(-1e-3, 1e-3, (3, 3)))
            .ravel()) + "\n")
        f.write("P_rect_02: 7.215377e+02 0.000000e+00 6.095593e+02 "
                "4.485728e+01 0.000000e+00 7.215377e+02 1.728540e+02 "
                "2.163791e-01 0.000000e+00 0.000000e+00 1.000000e+00 "
                "2.745884e-03\n")
    with open(os.path.join(d, "calib_velo_to_cam.txt"), "w") as f:
        f.write("calib_time: 15-Mar-2012 11:37:16\n")
        f.write("R: " + " ".join(f"{v:.6e}" for v in R.ravel()) + "\n")
        f.write("T: -4.069766e-03 -7.631618e-02 -2.717806e-01\n")
    scans = []
    for s in range(2):
        pts = np.concatenate([
            rng.uniform([-5, -20, -2], [60, 20, 2], (n_points, 3)),
            np.repeat(rng.uniform([5, -3, -1], [30, 3, 1], (20, 3)), 3, 0)
            * rng.uniform(1, 1.3, (60, 1))])
        arr = np.concatenate([pts, rng.uniform(0, 1, (len(pts), 1))], 1)
        path = os.path.join(d, f"scan{s}.bin")
        arr.astype(np.float32).tofile(path)
        scans.append(path)
    return scans


def test_kitti_utils_equal_jax(tmp_path):
    d = str(tmp_path)
    scans = _kitti_files(d, np.random.RandomState(6))
    for name in ("calib_cam_to_cam.txt", "calib_velo_to_cam.txt"):
        got = tku.read_calib_file(os.path.join(d, name))
        want = jku.read_calib_file(os.path.join(d, name))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(tku.load_velodyne_points(scans[0]),
                                  jku.load_velodyne_points(scans[0]))
    c2c = jku.read_calib_file(os.path.join(d, "calib_cam_to_cam.txt"))
    v2c = jku.read_calib_file(os.path.join(d, "calib_velo_to_cam.txt"))
    np.testing.assert_array_equal(tku.velo_to_image_projection(c2c, v2c),
                                  jku.velo_to_image_projection(c2c, v2c))
    for vel_depth in (False, True):
        got = tku.generate_depth_map(d, scans[1], 2, vel_depth)
        want = jku.generate_depth_map(d, scans[1], 2, vel_depth)
        assert got.dtype == want.dtype and (want > 0).sum() > 1000
        np.testing.assert_array_equal(got, want)
    frames = [(d, s) for s in scans]
    got = tku.export_gt_depths(frames, os.path.join(d, "t", "gt.npz"))
    want = jku.export_gt_depths(frames, os.path.join(d, "j", "gt.npz"))
    a = np.load(os.path.join(d, "t", "gt.npz"), allow_pickle=True)["data"]
    b = np.load(os.path.join(d, "j", "gt.npz"), allow_pickle=True)["data"]
    assert a.dtype == b.dtype == object and a.shape == b.shape
    for x, y, g, w in zip(a, b, got, want):
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))
        np.testing.assert_array_equal(g, w)
