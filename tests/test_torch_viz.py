"""The port's ``viz.py`` against the JAX package's on the same map: the
metric plots return the same summaries (to 1e-12), and the trajectory,
scene, speed and overlay plots and the scene animation write their files.
The map is built by hand from seeded poses in both packages' records; the
plots run headless (Agg), where ``LiveViewer`` disables itself."""

import os

import matplotlib
import numpy as np
import pytest
import torch

from vido_slam_tpu import slam_map as j_slam_map
from vido_slam_tpu import viz as j_viz
from vido_slam_tpu_torch import slam_map as t_slam_map
from vido_slam_tpu_torch import viz as t_viz

torch.set_num_threads(1)
matplotlib.use("Agg", force=True)

N_FRAMES, N_PTS = 6, 50


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _map(mod):
    """A SlamMap of ``mod`` (either package's slam_map): a camera driving
    forward and turning, its estimate off the ground truth by seeded noise,
    static points, and one object tracked on frames 1-5."""
    rng = np.random.RandomState(0)
    m = mod.SlamMap()
    for i in range(N_FRAMES):
        Tcw_gt = np.eye(4)
        Tcw_gt[:3, :3] = _rot_y(0.02 * i)
        Tcw_gt[:3, 3] = [0.0, 0.0, -0.5 * i]
        Tcw = Tcw_gt.copy()
        Tcw[:3, 3] += rng.randn(3) * 0.01
        Tcw[:3, :3] = Tcw[:3, :3] @ _rot_y(rng.randn() * 0.002)
        H = np.eye(4, dtype=np.float32)
        H[:3, 3] = [0.3, 0.0, 0.1 * i]
        objects = [] if i == 0 else [mod.ObjectObservation(
            track_id=1, sem_value=3, motion=H, speed_kmh=10.0 + i,
            centroid=np.array([2.0, 0.5, 10.0 + i], np.float32),
            num_inliers=100, status=True)]
        uv = rng.rand(N_PTS, 2).astype(np.float32) * [96, 64]
        m.add_frame(mod.FrameRecord(
            frame_id=i, timestamp=0.1 * i, Tcw=Tcw.astype(np.float32),
            Tcw_gt=Tcw_gt.astype(np.float32), stat_uv=uv,
            stat_depth=np.full(N_PTS, 8.0, np.float32),
            stat_valid=rng.rand(N_PTS) < 0.8,
            stat_is_new=np.zeros(N_PTS, bool),
            stat_3d=(rng.randn(N_PTS, 3) * 3 + [0, 0, 10]).astype(np.float32),
            obj_uv=uv[:10], obj_depth=np.full(10, 9.0, np.float32),
            obj_valid=np.ones(10, bool), obj_is_new=np.zeros(10, bool),
            obj_sem=np.full(10, 3, np.int32),
            obj_label=np.full(10, 1 if i else -1, np.int32),
            obj_3d=np.zeros((10, 3), np.float32), objects=objects))
    return m


@pytest.fixture(scope="module")
def maps():
    return _map(j_slam_map), _map(t_slam_map)


def test_metric_error_summary_equal_jax(tmp_path, maps):
    jm, tm = maps
    want = j_viz.plot_metric_error(jm, str(tmp_path / "j.png"))
    got = t_viz.plot_metric_error(tm, str(tmp_path / "t.png"))
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert got["rpe_trans_mean"] > 0
    assert os.path.getsize(tmp_path / "t.png") > 1000


def test_object_motion_error_summary_equal_jax(tmp_path, maps):
    jm, tm = maps
    gtm = {1: {f.frame_id: f.objects[0].motion @ np.diag([1, 1, 1, 1.0])
               for f in jm.frames[1:]}}
    gtm[1][3] = gtm[1][3].copy()
    gtm[1][3][0, 3] += 0.2
    want = j_viz.plot_object_motion_errors(jm, gtm, str(tmp_path / "j.png"))
    got = t_viz.plot_object_motion_errors(tm, gtm, str(tmp_path / "t.png"))
    assert got.keys() == want.keys() == {1}
    for k in want[1]:
        assert abs(got[1][k] - want[1][k]) <= 1e-12
    assert got[1]["t_mean"] > 0


def test_plots_and_animation_written(tmp_path, maps):
    _, tm = maps
    gt = tm.gt_poses
    paths = {name: str(tmp_path / name) for name in
             ("traj.png", "scene.png", "speed.png", "overlay.png")}
    t_viz.plot_trajectory(tm, paths["traj.png"], gt=gt)
    t_viz.plot_scene_3d(tm, paths["scene.png"])
    t_viz.save_speed_plot(tm, paths["speed.png"])
    img = t_viz.draw_frame_overlay(np.zeros((64, 96), np.uint8), tm,
                                   path=paths["overlay.png"])
    assert img.shape == (64, 96, 3) and img.max() > 0
    for p in paths.values():
        assert os.path.getsize(p) > 500, p
    gif = str(tmp_path / "scene_3d.gif")
    n = t_viz.render_scene_animation(tm, gif, stride=2, fps=5, figsize=3.0,
                                     dpi=60)
    assert n == 3 and os.path.getsize(gif) > 2000
    flow = np.random.RandomState(0).randn(8, 9, 2).astype(np.float32)
    np.testing.assert_array_equal(t_viz.flow_to_rgb(flow),
                                  j_viz.flow_to_rgb(flow))


def test_live_viewer_is_a_no_op_headless(maps):
    _, tm = maps
    v = t_viz.LiveViewer(every=1)
    assert not v._ok and v.disabled_reason
    v.update(tm, image=np.zeros((64, 96, 3), np.uint8))
    v.close()


def test_without_matplotlib_plots_raise_import_error(monkeypatch, tmp_path,
                                                     maps):
    """Where matplotlib is missing (the port does not require it), the
    module imports and a plot raises a clear ImportError; the viewer
    disables itself."""
    import builtins

    real = builtins.__import__

    def no_mpl(name, *args, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    _, tm = maps
    with pytest.raises(ImportError, match="needs matplotlib"):
        t_viz.render_scene_animation(tm, str(tmp_path / "x.gif"))
    v = t_viz.LiveViewer()
    assert not v._ok and "matplotlib" in v.disabled_reason
