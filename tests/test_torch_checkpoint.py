"""The port's checkpoints and session resume (``utils/checkpoint.py``)
against the JAX package's ``vido_slam_tpu/utils/checkpoint.py``.

Bars: parameter bundles equal key for key and bit for bit; a session saved
after frame 3 of 5 and resumed in each package gives per-frame poses
within 1e-3 m / 1e-3 rad of the other package's resumed run (the
whole-tracker bar of test_torch_tracking.py: both redraw from
``PRNGKey(seed)``, since neither saves the tracker's key), within JAX's own
0.05 of the unbroken run, and bit-equal over two resumes of one snapshot.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.config import config_from_dict as j_config_from_dict
from vido_slam_tpu.geometry.se3 import make_se3 as j_make_se3
from vido_slam_tpu.io.synthetic import SyntheticSequence, simple_scene
from vido_slam_tpu.tracking import Tracker as JTracker
from vido_slam_tpu.utils import checkpoint as jck
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.tracking import Tracker
from vido_slam_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)

N_FRAMES, SNAP_AT = 5, 3
TRACKER_KW = dict(n_bg=600, n_obj=1500, max_objects=4, seed=0)


def _state_dict(seed):
    """A small net's state_dict: a conv, a grouped transposed conv, a
    linear and a batch norm, from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    sd = {"conv.weight": torch.randn(8, 3, 3, 3, generator=g),
          "conv.bias": torch.randn(8, generator=g),
          "up.weight": torch.randn(8, 1, 4, 4, generator=g),
          "fc.weight": torch.randn(10, 32, generator=g),
          "fc.bias": torch.randn(10, generator=g),
          "bn.running_var": torch.rand(8, generator=g) + 0.5}
    return sd


def test_params_round_trip_between_packages(tmp_path):
    rng = np.random.RandomState(0)
    p = {"a.weight": rng.randn(2, 3).astype(np.float32),
         "b": np.arange(4, dtype=np.int32), "c": rng.rand(3) > 0.5}
    path = str(tmp_path / "params")
    tck.save_params(path, {k: torch.from_numpy(v) for k, v in p.items()})
    back = tck.load_params(path)
    jback = jck.load_params(path)
    assert set(back) == set(jback) == set(p)
    for k, v in p.items():
        assert back[k].device.type == "cpu"
        np.testing.assert_array_equal(back[k].numpy(), v)
        np.testing.assert_array_equal(np.asarray(jback[k]), v)
        assert back[k].numpy().dtype == v.dtype


def test_torch_state_dict_bundle_equals_jax(tmp_path):
    """Either package writes the same bundle from one torch state_dict:
    the port's .npz against what JAX's load_params reads back from JAX's
    own save (an orbax directory here), and from a torch.save file."""
    sd = _state_dict(1)
    port = str(tmp_path / "port")
    jax_path = str(tmp_path / "jax")
    tck.save_torch_state_dict(port, sd)
    jck.save_torch_state_dict(jax_path, sd)
    want = jck.load_params(jax_path)
    got = tck.load_params(port)
    assert set(got) == set(want) == set(sd)
    for k in sd:
        w = np.asarray(want[k])
        assert got[k].numpy().shape == w.shape, k
        np.testing.assert_array_equal(got[k].numpy(), w)
    assert got["conv.weight"].shape == (3, 3, 3, 8)
    assert got["up.weight"].shape == (4, 4, 1, 8)
    assert got["fc.weight"].shape == (32, 10)
    pt = str(tmp_path / "sd.pt")
    torch.save(sd, pt)
    tck.save_torch_state_dict(str(tmp_path / "from_file"), pt)
    again = tck.load_params(str(tmp_path / "from_file"))
    for k in sd:
        np.testing.assert_array_equal(again[k].numpy(), got[k].numpy())


def test_orbax_directory_refused(tmp_path):
    path = str(tmp_path / "orbax_params")
    jck.save_params(path, {"w": jnp.ones((2, 2))})
    assert os.path.isdir(path) and not os.path.exists(path + ".npz")
    with pytest.raises(ValueError, match="orbax.*npz"):
        tck.load_params(path)
    with pytest.raises(FileNotFoundError):
        tck.load_params(str(tmp_path / "nothing"))


@pytest.fixture(scope="module")
def sequence():
    scene = simple_scene(width=256, height=160, moving_box=True,
                         box_speed=0.6)
    dT = np.asarray(j_make_se3(jnp.eye(3), jnp.array([0.0, 0.0, -0.4])))
    return scene, SyntheticSequence(scene, [dT], n_frames=N_FRAMES)


def _cfg(scene):
    cam = scene.cam
    return {"Camera.width": cam.width, "Camera.height": cam.height,
            "Camera.fx": float(cam.fx), "Camera.fy": float(cam.fy),
            "Camera.cx": float(cam.cx), "Camera.cy": float(cam.cy),
            "Camera.bf": float(cam.bf), "MaxTrackPointBG": 600,
            "WINDOW_SIZE": 5}


def _track(tracker, frames):
    for fr in frames:
        tracker.track(fr.depth, fr.flow, fr.mask, Tcw_gt=fr.Tcw_gt)


def _poses(tracker):
    return np.stack([np.asarray(f.Tcw, np.float64)
                     for f in tracker.map.frames])


def _within_bar(a, b):
    assert a.shape == b.shape
    assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() <= 1e-3
    R = np.swapaxes(b[:, :3, :3], -1, -2) @ a[:, :3, :3]
    cos = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    assert np.arccos(cos).max() <= 1e-3


def _holds_no_tensor(x):
    if isinstance(x, torch.Tensor):
        return False
    if isinstance(x, dict):
        return all(_holds_no_tensor(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_holds_no_tensor(v) for v in x)
    if hasattr(x, "__dict__"):
        return _holds_no_tensor(vars(x))
    return True


@pytest.fixture(scope="module")
def resumed_runs(sequence, tmp_path_factory):
    """Both packages: the unbroken run, and a run saved after frame 3 and
    resumed in a fresh tracker (the port's twice, from one snapshot)."""
    scene, seq = sequence
    d = tmp_path_factory.mktemp("sessions")
    jcfg = j_config_from_dict(_cfg(scene))
    tcfg = config_from_dict(_cfg(scene))
    out = {}
    jt = JTracker(jcfg, lm_pallas=False, **TRACKER_KW)
    _track(jt, seq.frames)
    out["jax_full"] = _poses(jt)
    jt = JTracker(jcfg, lm_pallas=False, **TRACKER_KW)
    _track(jt, seq.frames[:SNAP_AT])
    jck.save_session(str(d / "jax.pkl"), jt)
    jr = JTracker(jcfg, lm_pallas=False, **TRACKER_KW)
    jck.load_session(str(d / "jax.pkl"), jr)
    _track(jr, seq.frames[SNAP_AT:])
    out["jax_resumed"] = _poses(jr)

    tt = Tracker(tcfg, device="cpu", **TRACKER_KW)
    _track(tt, seq.frames)
    out["port_full"] = _poses(tt)
    tt = Tracker(tcfg, device="cpu", **TRACKER_KW)
    _track(tt, seq.frames[:SNAP_AT])
    snap = str(d / "port.pkl")
    tck.save_session(snap, tt)
    with open(snap, "rb") as f:
        out["payload"] = pickle.load(f)
    resumed = []
    for _ in range(2):
        tr = Tracker(tcfg, device="cpu", **TRACKER_KW)
        tck.load_session(snap, tr)
        assert tr.frame_id == SNAP_AT and len(tr.map) == SNAP_AT
        assert tr.state.Tcw.device.type == "cpu"
        _track(tr, seq.frames[SNAP_AT:])
        assert len(tr.map) == N_FRAMES
        resumed.append(_poses(tr))
    out["port_resumed"] = resumed
    return out


def test_resumed_session_matches_jax_resumed(resumed_runs):
    _within_bar(resumed_runs["port_resumed"][0],
                resumed_runs["jax_resumed"])
    _within_bar(resumed_runs["port_full"], resumed_runs["jax_full"])


def test_resumed_session_near_the_unbroken_run(resumed_runs):
    """JAX's own bar (tests/test_checkpoint_viz.py): the resume redraws
    from PRNGKey(seed), so it is close to, not equal to, the unbroken run."""
    d = np.abs(resumed_runs["port_resumed"][0]
               - resumed_runs["port_full"]).max()
    assert d < 0.05
    # the frames before the snapshot are the unbroken run's own
    np.testing.assert_array_equal(resumed_runs["port_resumed"][0][:SNAP_AT],
                                  resumed_runs["port_full"][:SNAP_AT])


def test_two_resumes_are_bit_equal(resumed_runs):
    a, b = resumed_runs["port_resumed"]
    np.testing.assert_array_equal(a, b)


def test_session_pickle_holds_no_tensor(resumed_runs):
    """Numpy only: a session written on one device loads on another."""
    payload = resumed_runs["payload"]
    assert _holds_no_tensor(payload)
    assert isinstance(payload["state"]["Tcw"], np.ndarray)
    assert isinstance(payload["state"]["stat"]["uv"], np.ndarray)
    assert payload["frame_id"] == SNAP_AT


def test_fused_ba_session_resumes(sequence, tmp_path):
    """chip_smoke.py's configuration, the fused window BA, whose window
    lives in the state's rings: a resumed run stays within 0.05 of the
    unbroken one and two resumes are bit-equal."""
    scene, seq = sequence
    cfg = config_from_dict(_cfg(scene))
    kw = dict(TRACKER_KW, fused_ba=True)
    full = Tracker(cfg, device="cpu", **kw)
    _track(full, seq.frames)
    part = Tracker(cfg, device="cpu", **kw)
    _track(part, seq.frames[:SNAP_AT])
    snap = str(tmp_path / "fused.pkl")
    tck.save_session(snap, part)
    runs = []
    for _ in range(2):
        tr = Tracker(cfg, device="cpu", **kw)
        tck.load_session(snap, tr)
        _track(tr, seq.frames[SNAP_AT:])
        runs.append(_poses(tr))
    np.testing.assert_array_equal(runs[0], runs[1])
    assert np.abs(runs[0] - _poses(full)).max() < 0.05
    assert int(tr.state.ba_nframes) == int(full.state.ba_nframes)
