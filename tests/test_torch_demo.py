"""The slice as a whole: the port's CLI (``python -m
vido_slam_tpu_torch.run_vido ... --device cpu``) against the JAX package's
``demo/run_vido.py`` on the same dataset trees from files.

Trees of a 96x320 synthetic scene (a ground plane and a moving box, the
camera turning and driving forward), 7 frames each (the KITTI tree's run,
with the full batch, is in test_torch_demo_kitti.py):
  - KAIST VO: BayerBG PNG frames written by cv2, ``UseSampleFeature: 0``
    (demosaic and FAST on the path), .flo, 16-bit depth and mask PNGs,
    vTimestampsImage.txt;
  - KAIST VIO: the same tree with ``slam_mode: 1`` and an xsens_imu.csv
    (the init's gates stay shut over 7 frames; the IMU queue and the
    preintegration run every frame);
  - KITTI: BGR PNG frames written by chip_smoke.py's writer, times.txt,
    ``ChooseData: 2``: the StopFrame full batch at the JAX defaults writes
    the refined trajectory.
Bars: each frame of initial_rgbd_new.txt within 1e-3 m / 1e-3 rad of the
JAX CLI's (the tracker's bar), refined_rgbd_new.txt within the same bar
(test_torch_full_ba.py's), and obj_mot_rgbd_new.txt with the same frames
and labels row for row, its motions within the same bar."""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from vido_slam_tpu_torch.geometry.se3 import make_se3
from vido_slam_tpu_torch.geometry.so3 import exp_so3
from vido_slam_tpu_torch.io.synthetic import (SyntheticSequence, render_rgb,
                                              simple_scene)
from vido_slam_tpu_torch.run_vido import main as port_main

torch.set_num_threads(1)

H, W, N_FRAMES = 96, 320, 7
FACTOR = {"kaist": 500.0, "kitti": 256.0}


@pytest.fixture(scope="module")
def scene_frames():
    """The rendered frames: (BGR uint8, metric depth, flow, mask)."""
    scene = simple_scene(width=W, height=H, moving_box=True, box_speed=0.6)
    dT = make_se3(exp_so3(torch.tensor([0.0, 0.01, 0.0])),
                  torch.tensor([0.02, 0.0, -0.4])).numpy()
    seq = SyntheticSequence(scene, [dT], n_frames=N_FRAMES, device="cpu")
    frames = []
    for fr in seq.frames:
        rgb = render_rgb(scene, torch.as_tensor(fr.Tcw_gt),
                         [torch.as_tensor(p) for p in fr.box_poses])
        bgr = np.round(rgb.numpy()[..., ::-1]).astype(np.uint8)
        frames.append((bgr, fr.depth, fr.flow, fr.mask.astype(np.uint8)))
    return scene, frames


def _cv2_png(path, img):
    assert cv2.imwrite(path, img)


def _tree(tmp_path, scene_frames, kind, vio=False, jpg=None):
    """Write the tree and its config (KITTI frames as JPEG by ``jpg(path,
    bgr)`` where it is given); returns the config's path."""
    scene, frames = scene_frames
    cam = scene.cam
    f, bf = FACTOR[kind], float(cam.bf)
    rows = []
    for i, (bgr, depth, flow, mask) in enumerate(frames):
        # raw depth by the dataset's rule: metric = bf / (raw / factor)
        raw = np.where(depth > 0, np.clip(np.round(
            f * bf / np.maximum(depth, 1e-6)), 1, 65535), 0)
        rows.append((bgr, raw.astype(np.uint16), flow, mask, i / 10.0))
    imu = None
    if vio:
        rng = np.random.RandomState(0)
        t = np.arange(1, 20 * N_FRAMES + 1) / 200.0
        acc = (rng.randn(t.size, 3) * 0.05 + [0.0, -9.81, 0.4]) \
            .astype(np.float32)
        gyro = (rng.randn(t.size, 3) * 0.005 + [0.0, 0.1, 0.0]) \
            .astype(np.float32)
        imu = (t, acc, gyro)
    root = str(tmp_path / kind)
    entries = chip_smoke.write_tree(
        root, kind, rows, png=_cv2_png if kind == "kaist" else
        chip_smoke.write_png, imu=imu, jpg=jpg)
    cfg = {"Camera.width": W, "Camera.height": H,
           "Camera.fx": float(cam.fx), "Camera.fy": float(cam.fy),
           "Camera.cx": float(cam.cx), "Camera.cy": float(cam.cy),
           "Camera.bf": bf, "Camera.fps": 10,
           "ChooseData": 3 if kind == "kaist" else 2, "DepthMapFactor": f,
           "MaxTrackPointBG": 600, "MaxTrackPointOBJ": 800,
           "WINDOW_SIZE": 5, "UseSampleFeature": 0,
           "slam_mode": int(vio), "start_index": 0, **entries}
    path = os.path.join(root, "config.yaml")
    chip_smoke.write_config(path, cfg)
    return path


def _run_both(cfg_path, out_root):
    """Both CLIs on one config; returns their output directories."""
    import demo.run_vido as jax_demo

    port_out = os.path.join(out_root, "port", "")
    jax_out = os.path.join(out_root, "jax", "")
    run = port_main([cfg_path, "--output", port_out, "--device", "cpu"])
    assert len(run.read_s) == len(run.track_s) == N_FRAMES
    argv = sys.argv
    sys.argv = ["run_vido.py", cfg_path, "--output", jax_out]
    try:
        jax_demo.main()
    finally:
        sys.argv = argv
    return port_out, jax_out


def _poses(path):
    rows = np.loadtxt(path, ndmin=2)
    return rows[:, 0], rows[:, 1:13].reshape(-1, 3, 4)


def _within_bar(a, b):
    """Translations within 1e-3 m, rotations within 1e-3 rad, row by row."""
    assert a.shape == b.shape
    assert np.abs(a[..., 3] - b[..., 3]).max() <= 1e-3
    R = np.swapaxes(b[..., :3], -1, -2) @ a[..., :3]
    cos = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    assert np.arccos(cos).max() <= 1e-3


def _compare(port_out, jax_out):
    names = ("initial_rgbd_new.txt", "refined_rgbd_new.txt",
             "obj_mot_rgbd_new.txt", "cam_pose_gt.txt", "obj_mot_gt.txt")
    for name in names:
        assert os.path.exists(port_out + name) == os.path.exists(
            jax_out + name), name
    for name in ("initial_rgbd_new.txt", "refined_rgbd_new.txt"):
        ip, tp = _poses(port_out + name)
        ij, tj = _poses(jax_out + name)
        np.testing.assert_array_equal(ip, np.arange(N_FRAMES))
        np.testing.assert_array_equal(ip, ij)
        _within_bar(tp, tj)
    mp = np.loadtxt(port_out + "obj_mot_rgbd_new.txt", ndmin=2)
    mj = np.loadtxt(jax_out + "obj_mot_rgbd_new.txt", ndmin=2)
    assert mp.shape == mj.shape and mp.shape[0] >= N_FRAMES - 2
    np.testing.assert_array_equal(mp[:, :2], mj[:, :2])
    _within_bar(mp[:, 2:14].reshape(-1, 3, 4), mj[:, 2:14].reshape(-1, 3, 4))


@pytest.mark.parametrize("vio", [False, True], ids=["vo", "vio"])
def test_kaist_tree(tmp_path, scene_frames, vio):
    cfg = _tree(tmp_path, scene_frames, "kaist", vio=vio)
    port_out, jax_out = _run_both(cfg, str(tmp_path / "out"))
    _compare(port_out, jax_out)
    # without the full batch the refined trajectory is the initial one
    np.testing.assert_array_equal(
        np.loadtxt(port_out + "refined_rgbd_new.txt"),
        np.loadtxt(port_out + "initial_rgbd_new.txt"))


def test_missing_image_is_skipped_and_start_index_applies(tmp_path,
                                                          scene_frames):
    """start_index drops the first frames; a listed image that is missing is
    skipped, as in the JAX demo; --max-frames cuts the list."""
    cfg = _tree(tmp_path, scene_frames, "kaist")
    with open(cfg) as f:
        text = f.read().replace("start_index: 0", "start_index: 1")
    with open(cfg, "w") as f:
        f.write(text)
    img_dir = os.path.join(os.path.dirname(cfg), "image")
    names = sorted(os.listdir(img_dir))
    os.remove(os.path.join(img_dir, names[3]))
    out = str(tmp_path / "out") + "/"
    run = port_main([cfg, "--output", out, "--device", "cpu",
                     "--max-frames", "4"])
    # frames 1..4 listed, frame 3 missing
    assert len(run.track_s) == 3
    assert [r.timestamp for r in run.system.map.frames] == [0.1, 0.2, 0.4]
    assert np.loadtxt(out + "initial_rgbd_new.txt").shape == (3, 17)


def test_device_defaults_to_the_card(tmp_path, scene_frames):
    """Without --device the CLI runs on cuda, and raises without a card."""
    from vido_slam_tpu_torch.run_vido import parse_args

    assert parse_args(["c.yaml"]).device == "cuda"
    if not torch.cuda.is_available():
        cfg = _tree(tmp_path, scene_frames, "kaist")
        with pytest.raises(RuntimeError, match="cuda"):
            port_main([cfg, "--output", str(tmp_path / "out")])


def test_online_mode_is_track_frames(tmp_path, scene_frames, monkeypatch):
    """--online feeds the demosaiced frames, the previous one first, to
    System.AttachPerception + TrackFrames with PerceptionModel(544 x 800,
    seed 0) at the frame's timestamp: the CLI's trajectory is that of the
    port's System driven so directly with the CLI's model (the JAX demo's
    perception weights differ from the port's seeded ones, so this path is
    held to the port's own API; tests/test_torch_perception.py holds
    TrackFrames to JAX)."""
    from vido_slam_tpu_torch.io import datasets
    from vido_slam_tpu_torch.models import perception
    from vido_slam_tpu_torch.system import Sensor, System

    built = []

    def keep(*args, **kw):
        built.append((args, kw, perception_model(*args, **kw)))
        return built[-1][2]

    perception_model = perception.PerceptionModel
    monkeypatch.setattr(perception, "PerceptionModel", keep)
    cfg = _tree(tmp_path, scene_frames, "kaist")
    out = str(tmp_path / "out") + "/"
    run = port_main([cfg, "--output", out, "--device", "cpu", "--online",
                     "--max-frames", "2"])
    assert len(run.track_s) == 2
    (args, kw, model), = built
    assert args[:2] == (H, W) and kw["seed"] == 0 and kw["device"] == "cpu"
    assert (args[2].input_h, args[2].input_w) == (544, 800)

    system = System()
    system.Init(cfg, Sensor.RGBD, device="cpu")
    system.AttachPerception(model)
    img_dir = os.path.join(os.path.dirname(cfg), "image")
    prev = None
    for fr in datasets.load_kaist_image_list(img_dir)[:2]:
        bgr = datasets.demosaic_bayer_bg2bgr(
            datasets.imread(fr.image_path, datasets.IMREAD_GRAYSCALE))
        system.TrackFrames((bgr if prev is None else prev).astype(np.float32),
                           bgr.astype(np.float32), timestamp=fr.timestamp)
        prev = bgr
    np.testing.assert_array_equal(run.system.map.poses, system.map.poses)
    assert np.loadtxt(out + "initial_rgbd_new.txt").shape == (2, 17)



def test_corrupt_image_is_skipped_as_in_the_jax_demo(tmp_path, scene_frames,
                                                     capsys):
    """A frame whose PNG is cut in half (cv2.imread gives None) is skipped
    by both CLIs with the same "skip missing" line, and both write the same
    result rows over the frames left (within the tracker's bar)."""
    import demo.run_vido as jax_demo

    cfg = _tree(tmp_path, scene_frames, "kaist")
    img_dir = os.path.join(os.path.dirname(cfg), "image")
    bad = os.path.join(img_dir, sorted(os.listdir(img_dir))[2])
    with open(bad, "rb") as f:
        data = f.read()
    with open(bad, "wb") as f:
        f.write(data[:len(data) // 2])
    assert cv2.imread(bad, cv2.IMREAD_GRAYSCALE) is None
    port_out = str(tmp_path / "port") + "/"
    jax_out = str(tmp_path / "jax") + "/"
    capsys.readouterr()
    run = port_main([cfg, "--output", port_out, "--device", "cpu",
                     "--max-frames", "5"])
    port_said = capsys.readouterr().out
    argv = sys.argv
    sys.argv = ["run_vido.py", cfg, "--output", jax_out, "--max-frames", "5"]
    try:
        jax_demo.main()
    finally:
        sys.argv = argv
    jax_said = capsys.readouterr().out
    assert f"skip missing {bad}" in port_said.splitlines()
    assert f"skip missing {bad}" in jax_said.splitlines()
    assert len(run.track_s) == 4
    for name in ("initial_rgbd_new.txt", "obj_mot_rgbd_new.txt"):
        p = np.loadtxt(port_out + name, ndmin=2)
        j = np.loadtxt(jax_out + name, ndmin=2)
        assert p.shape == j.shape, name
    ip, tp = _poses(port_out + "initial_rgbd_new.txt")
    ij, tj = _poses(jax_out + "initial_rgbd_new.txt")
    np.testing.assert_array_equal(ip, [0, 1, 2, 3])
    np.testing.assert_array_equal(ip, ij)
    _within_bar(tp, tj)
    mp = np.loadtxt(port_out + "obj_mot_rgbd_new.txt", ndmin=2)
    mj = np.loadtxt(jax_out + "obj_mot_rgbd_new.txt", ndmin=2)
    np.testing.assert_array_equal(mp[:, :2], mj[:, :2])
    _within_bar(mp[:, 2:14].reshape(-1, 3, 4), mj[:, 2:14].reshape(-1, 3, 4))
