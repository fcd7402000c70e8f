"""The pipelined tracker: the port's ``Tracker(pipelined=True)`` under
``track``, ``track_frames`` and ``track_frames_pair``, and ``System``'s
``TrackFramesPair``, against the JAX package's pipelined runs on the CPU.
Scenes: tests/test_torch_tracking.py's 6 rendered frames at 256x160 (a
moving box, window 6). The online entry points read them through a stub
perception that serves each frame's depth, flow and mask by the frame index
written into the previous image's first pixel, the pattern of
tests/test_vio_fused.py; the rest of each image is seeded texture, so FAST
picks the features. VIO through the pairs is
tests/test_torch_pipelined_vio.py.

Bars (PERF.md section 2): poses within 1e-3 m and 1e-3 rad of the JAX
run, with the same object ids and statuses and the same timestamps, the
repeated 1 / fps of a pipelined ``track`` without timestamps included;
the refined points written back into the records within 1e-3 m. Within
the port, exact: the pipelined fused-BA run equals the synchronous one
bit for bit (the JAX package's own bar between them is 1e-5,
tests/test_tracking_e2e.py:233), record="light" equals record="full",
``track_frames_pair`` equals ``track_frames`` and ``System``'s pair equals
the tracker's."""

import pickle
import types

import numpy as np
import pytest
import torch

from test_torch_tracking import (  # noqa: F401 (port_run, sequence:
    BASE_KW, N_FRAMES, TRACKER_KW, _cfg_dict,  # fixtures shared with it)
    _rot_err, port_run, sequence)
from test_vio_fused import StubPerception as JStub
from vido_slam_tpu.config import config_from_dict as j_config_from_dict
from vido_slam_tpu.system import Sensor as JSensor
from vido_slam_tpu.system import System as JSystem
from vido_slam_tpu.tracking import Tracker as JTracker
from vido_slam_tpu.utils.checkpoint import save_session as j_save_session
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.geometry.camera import convert_depth
from vido_slam_tpu_torch.system import Sensor, System
from vido_slam_tpu_torch.tracking import Tracker
from vido_slam_tpu_torch.utils.checkpoint import save_session
from vido_slam_tpu_torch.utils.transfer import to_host, to_host_async

torch.set_num_threads(1)

PIPE_KW = dict(TRACKER_KW, pipelined=True)
DM_FACTOR = 500.0


def _offline(cls, scene, seq, **kw):
    """Every frame through ``track``, then ``finish()``; returns the
    tracker, the returned poses as numpy and the map's length before
    ``finish``."""
    cfg = _cfg_dict(scene)
    if cls is JTracker:
        t = JTracker(j_config_from_dict(cfg), lm_pallas=False, **kw)
    else:
        t = Tracker(config_from_dict(cfg), device="cpu", **kw)
    rets = [np.asarray(t.track(fr.depth, fr.flow, fr.mask, Tcw_gt=fr.Tcw_gt))
            for fr in seq.frames]
    n_before = len(t.map)
    t.finish()
    return t, rets, n_before


@pytest.fixture(scope="module")
def jax_pipe(sequence):
    return _offline(JTracker, *sequence, **PIPE_KW)


@pytest.fixture(scope="module")
def port_pipe(sequence):
    return _offline(Tracker, *sequence, **PIPE_KW)


def _assert_close_maps(ja, ta, n=N_FRAMES):
    assert len(ta.map) == len(ja.map) == n
    for a, b in zip(ja.map.frames, ta.map.frames):
        assert a.frame_id == b.frame_id
        assert a.timestamp == b.timestamp, a.frame_id
        assert np.abs(a.Tcw[:3, 3] - b.Tcw[:3, 3]).max() <= 1e-3, a.frame_id
        assert _rot_err(a.Tcw, b.Tcw) <= 1e-3, a.frame_id
        assert [(o.status, o.track_id) for o in a.objects] == \
            [(o.status, o.track_id) for o in b.objects], a.frame_id


def test_pipelined_fused_matches_jax(jax_pipe, port_pipe):
    """Records, poses, object ids and the lazily returned poses of the
    pipelined fused-BA run, against JAX's; the map lags a frame until
    ``finish()``."""
    jt, jrets, jn = jax_pipe
    tt, trets, tn = port_pipe
    assert tt.pipelined and tt.record_light
    assert tn == jn == N_FRAMES - 1
    _assert_close_maps(jt, tt)
    assert sum(o.status for f in tt.map.frames for o in f.objects) >= 4
    for k, (a, b) in enumerate(zip(jrets, trets)):
        assert np.abs(a - b).max() <= 1e-3, k


def test_pipelined_fused_matches_sync(port_run, port_pipe):
    """The pipeline changes only when the host reads: the same poses,
    motions and object records to the bit."""
    sync, _ = port_run
    pipe, _, _ = port_pipe
    assert len(pipe.map) == len(sync.map) == N_FRAMES
    np.testing.assert_array_equal(pipe.map.poses, sync.map.poses)
    for a, b in zip(sync.map.frames, pipe.map.frames):
        np.testing.assert_array_equal(a.cam_motion, b.cam_motion)
        assert [(o.status, o.track_id, o.num_inliers) for o in a.objects] \
            == [(o.status, o.track_id, o.num_inliers) for o in b.objects]
        for oa, ob in zip(a.objects, b.objects):
            np.testing.assert_array_equal(oa.motion, ob.motion)


def test_pipelined_light_record_matches_full(sequence, port_pipe):
    """record="light" changes what is copied to the host, never the
    computation (tests/test_tracking_e2e.py::test_light_record_matches_
    full, whose pipelined light configuration is the bench's)."""
    light, _, _ = port_pipe
    full, _, _ = _offline(Tracker, *sequence, record="full", **PIPE_KW)
    assert not full.record_light
    np.testing.assert_array_equal(light.map.poses, full.map.poses)
    assert light.map.track_ids() == full.map.track_ids()
    assert light.map.frames[-1].stat_uv.size == 0
    assert full.map.frames[-1].stat_uv.shape == (TRACKER_KW["n_bg"], 2)


def test_pipelined_timestamps_match_jax(jax_pipe, port_pipe):
    """Without timestamps a pipelined ``track`` stamps frame k >= 2 with
    (k - 1) / fps: frame_id does not count the frame in flight, so frames
    1 and 2 share 1 / fps (tracking.py:1084-1085 of the JAX package)."""
    jt, _, _ = jax_pipe
    tt, _, _ = port_pipe
    fps = tt.cam.fps
    want = [0.0] + [max(k - 1, 1) / fps for k in range(1, N_FRAMES)]
    assert [f.timestamp for f in tt.map.frames] == want
    assert [f.timestamp for f in jt.map.frames] == want


def test_pipelined_host_ba_matches_jax(sequence):
    """The host-assembled window BA pipelined: the BA over the map up to
    frame t-1 corrects frame t's device pose and writes back by frame id.
    Poses, the refined points in the records and the frame count after
    ``finish()`` against JAX's pipelined run."""
    jt, jrets, jn = _offline(JTracker, *sequence, pipelined=True, **BASE_KW)
    tt, trets, tn = _offline(Tracker, *sequence, pipelined=True, **BASE_KW)
    assert tt.pipelined and not tt.fused_ba and not tt.record_light
    assert tn == jn == N_FRAMES - 1
    _assert_close_maps(jt, tt)
    for k, (a, b) in enumerate(zip(jrets, trets)):
        assert np.abs(a - b).max() <= 1e-3, k
    for a, b in zip(jt.map.frames, tt.map.frames):
        v = a.stat_valid
        np.testing.assert_allclose(b.stat_3d[v], a.stat_3d[v], atol=1e-3,
                                   err_msg=str(a.frame_id))
    # finish() drained the BA in flight and solved the last window
    assert tt._pending is None and tt._pending_ba is None


# ---------------------------------------------------------------------------
# the online entry points on a stub perception
# ---------------------------------------------------------------------------

class Stub:
    """The port's side of tests/test_vio_fused.py's ``StubPerception``:
    frame k's raw depth, flow (k -> k+1) and mask, picked by the index in
    the previous image's first pixel."""

    device = torch.device("cpu")

    def __init__(self, depth_u16, flows, masks):
        self.d = torch.from_numpy(np.asarray(depth_u16, np.float32))
        self.f = torch.from_numpy(np.asarray(flows, np.float32))
        self.m = torch.from_numpy(np.asarray(masks, np.int32))

    def __call__(self, prev_bgr, cur_bgr):
        k = min(max(int(torch.round(prev_bgr[0, 0, 0])), 0),
                self.d.shape[0] - 1)
        return types.SimpleNamespace(depth_u16=self.d[k], flow=self.f[k],
                                     mask=self.m[k].to(torch.uint8))

    def make_slam_forward(self, depth_mode, depth_map_factor, bf, scale=1.0):
        def forward(prev_bgr, cur_bgr):
            out = self(prev_bgr, cur_bgr)
            return (convert_depth(out.depth_u16, depth_mode,
                                  depth_map_factor, bf, scale=scale),
                    out.flow, out.mask.to(torch.int32))
        return forward


def stub_stacks(depths, flows, masks, bf, scale=1.0):
    """KAIST raw depth (DepthMapFactor x bf x scale / metric; metric =
    raw-decoded / scale at scale 1), flows and masks as stacks."""
    raws = [np.where(d > 0, DM_FACTOR * bf * scale / np.maximum(d, 1e-6),
                     0.0).astype(np.float32) for d in depths]
    return np.stack(raws), np.stack(flows), np.stack(masks)


def indexed_frames(n, h, w, seed=0):
    """BGR frames in 0..255 of seeded texture, frame k's index in its
    first pixel."""
    rng = np.random.RandomState(seed)
    frames = []
    for k in range(n):
        f = (rng.rand(h, w, 3) * 255).astype(np.float32)
        f[0, 0, 0] = k
        frames.append(f)
    return frames


def _online_cfg(scene):
    return _cfg_dict(scene, DepthMapFactor=DM_FACTOR, UseSampleFeature=0)


@pytest.fixture(scope="module")
def online(sequence):
    scene, seq = sequence
    stacks = stub_stacks([fr.depth for fr in seq.frames],
                         [fr.flow for fr in seq.frames],
                         [fr.mask for fr in seq.frames], float(scene.cam.bf))
    frames = indexed_frames(N_FRAMES, scene.cam.height, scene.cam.width)
    return scene, stacks, frames


def _pairs(t, frames, gts=None):
    """track_frames_pair over (f0, f1, f2), (f1, f2, f3), (f3, f4, f5) ...,
    then finish(); returns each call's returned pose as numpy."""
    rets = [np.asarray(t.track_frames_pair(*frames[:3]))]
    for i in range(1, len(frames) - 2, 2):
        gt = None if gts is None else (gts[i], gts[i + 1])
        rets.append(np.asarray(t.track_frames_pair(*frames[i:i + 3],
                                                   Tcw_gt=gt)))
    t.finish()
    return rets


def _port_online(scene, stacks, **kw):
    cfg = config_from_dict(_online_cfg(scene))
    t = Tracker(cfg, device="cpu", **kw)
    t.attach_perception(Stub(*stacks), "kaist", DM_FACTOR, cfg.camera.bf)
    return t


def test_track_frames_pair_matches_jax(sequence, online):
    """Two frames a call against the JAX pair program: records, poses,
    object ids and timestamps; frames 1-4 from 6 images."""
    scene, stacks, frames = online
    _, seq = sequence
    gts = [fr.Tcw_gt for fr in seq.frames]
    jt = JTracker(j_config_from_dict(_online_cfg(scene)), lm_pallas=False,
                  **PIPE_KW)
    jt.attach_perception(JStub(*stacks), "kaist", DM_FACTOR,
                         float(scene.cam.bf))
    tt = _port_online(scene, stacks, **PIPE_KW)
    jrets = _pairs(jt, frames, gts)
    trets = _pairs(tt, frames, gts)
    assert tt.use_fast
    _assert_close_maps(jt, tt, n=N_FRAMES - 1)
    assert [f.timestamp for f in tt.map.frames] == \
        [k / tt.cam.fps for k in range(N_FRAMES - 1)]
    for k, (a, b) in enumerate(zip(jrets, trets)):
        assert np.abs(a - b).max() <= 1e-3, k
    np.testing.assert_array_equal(tt.map.frames[2].Tcw_gt, gts[2])


def test_track_frames_pair_matches_track_frames(online):
    """The pair equals two pipelined ``track_frames`` calls to the bit,
    timestamps included (tests/test_perception.py:88-118); the single
    calls' default timestamps count the frame in flight."""
    scene, stacks, frames = online
    single = _port_online(scene, stacks, **PIPE_KW)
    for i in range(N_FRAMES - 1):
        single.track_frames(frames[i], frames[i + 1])
        assert len(single.map) == max(1, i)
    single.finish()
    pair = _port_online(scene, stacks, **PIPE_KW)
    _pairs(pair, frames)
    assert len(pair.map) == len(single.map) == N_FRAMES - 1
    np.testing.assert_array_equal(pair.map.poses, single.map.poses)
    assert [f.timestamp for f in pair.map.frames] == \
        [f.timestamp for f in single.map.frames]
    assert pair.map.track_ids() == single.map.track_ids()


def test_system_track_frames_pair(online):
    """System.TrackFramesPair is the tracker's pair call."""
    scene, stacks, frames = online
    ts = System()
    ts.init_from_config(config_from_dict(_online_cfg(scene)), Sensor.RGBD,
                        device="cpu", **PIPE_KW)
    ts.AttachPerception(Stub(*stacks))
    ts.TrackFramesPair(*frames[:3])
    for i in range(1, N_FRAMES - 2, 2):
        P = ts.TrackFramesPair(*frames[i:i + 3], imu_measurements=[object()])
        assert P is ts.tracker.state.Tcw
    ts.tracker.finish()
    ref = _port_online(scene, stacks, **PIPE_KW)
    _pairs(ref, frames)
    np.testing.assert_array_equal(ts.map.poses, ref.map.poses)


def test_pair_refusals(sequence, online):
    """track_frames_pair needs pipelined=True and fused_ba=True, as the
    JAX package asserts; VIO with the host-assembled BA runs unpipelined
    in both packages."""
    scene, stacks, frames = online
    for kw in (TRACKER_KW, dict(BASE_KW, pipelined=True)):
        t = _port_online(scene, stacks, **kw)
        with pytest.raises(ValueError, match="pipelined=True, fused_ba=True"):
            t.track_frames_pair(*frames[:3])
        jt = JTracker(j_config_from_dict(_online_cfg(scene)), **kw)
        jt.attach_perception(JStub(*stacks), "kaist", DM_FACTOR,
                             float(scene.cam.bf))
        with pytest.raises(AssertionError, match="pipelined=True"):
            jt.track_frames_pair(*frames[:3])
    with pytest.raises(RuntimeError, match="attach_perception"):
        Tracker(config_from_dict(_online_cfg(scene)), device="cpu",
                **PIPE_KW).track_frames_pair(*frames[:3])
    for fused, want in ((False, False), (True, True)):
        kw = dict(BASE_KW, pipelined=True, use_imu=True, fused_ba=fused)
        t = Tracker(config_from_dict(_cfg_dict(scene)), device="cpu", **kw)
        jt = JTracker(j_config_from_dict(_cfg_dict(scene)), **kw)
        assert t.pipelined is jt.pipelined is want


# ---------------------------------------------------------------------------
# System: the KITTI StopFrame and sessions under the pipeline
# ---------------------------------------------------------------------------

SAVE_AFTER = 4  # TrackRGBD calls before the session is saved


@pytest.fixture(scope="module")
def kitti_runs(sequence, tmp_path_factory):
    """Both Systems as KITTI (ChooseData=2: full records, the StopFrame
    full batch at nImage), pipelined with the fused BA, over every frame
    with nImage = the frame count; each saves its session after
    SAVE_AFTER calls. The full batch is replaced by a recorder."""
    scene, seq = sequence
    d = _cfg_dict(scene, ChooseData=2, DepthMapFactor=DM_FACTOR)
    bf = float(scene.cam.bf)
    out = {}
    for name, sys_cls, cfg, save, kw in (
            ("jax", JSystem, j_config_from_dict(d), j_save_session,
             dict(lm_pallas=False)),
            ("port", System, config_from_dict(d), save_session,
             dict(device="cpu"))):
        s = sys_cls()
        s.init_from_config(cfg, (JSensor if name == "jax" else Sensor).RGBD,
                           **kw, **PIPE_KW)
        calls = []
        s.tracker.run_full_batch = lambda calls=calls, s=s: calls.append(
            ("full batch", len(s.tracker.map)))
        finish = s.tracker.finish

        def recording_finish(calls=calls, finish=finish):
            calls.append(("finish",))
            finish()
        s.tracker.finish = recording_finish
        path = str(tmp_path_factory.mktemp(name) / "session.pkl")
        for k, fr in enumerate(seq.frames):
            raw = np.where(fr.depth > 0, DM_FACTOR * bf
                           / np.maximum(fr.depth, 1e-6), 0.0)
            s.TrackRGBD(None, raw.astype(np.float32), fr.flow, fr.mask,
                        mTcw_gt=fr.Tcw_gt, nImage=N_FRAMES)
            if k + 1 == SAVE_AFTER:
                save(path, s.tracker)
        with open(path, "rb") as f:
            out[name] = (s, calls, pickle.load(f))
    return out


def test_kitti_stopframe_does_not_fire_pipelined(kitti_runs):
    """Pipelined, the map lags a frame, so len(map) >= nImage never holds
    on the last frame and the full batch does not run: JAX's behaviour,
    copied. ``finish()`` then records the last frame."""
    for name, (s, calls, _) in kitti_runs.items():
        assert calls == [], name
        assert len(s.map) == N_FRAMES - 1, name
        assert s.map.refined_poses is None, name
    js, ts = kitti_runs["jax"][0], kitti_runs["port"][0]
    js.tracker.finish()
    ts.tracker.finish()
    _assert_close_maps(js.tracker, ts.tracker)


def test_session_saved_mid_pipeline_lacks_pending_frame(kitti_runs):
    """save_session does not drain: the saved map lacks the frame in
    flight, its frame_id lags, and the saved state is the one that runs a
    frame ahead, as in the JAX package."""
    jp, tp = kitti_runs["jax"][2], kitti_runs["port"][2]
    assert len(tp["frames"]) == len(jp["frames"]) == SAVE_AFTER - 1
    assert tp["frame_id"] == jp["frame_id"] == SAVE_AFTER - 1
    for a, b in zip(jp["frames"], tp["frames"]):
        assert np.abs(a.Tcw - b.Tcw).max() <= 1e-3
    # the state is on frame SAVE_AFTER - 1, not on the last saved record
    np.testing.assert_allclose(tp["state"]["Tcw"], np.asarray(jp["state"].Tcw),
                               atol=1e-3)
    assert np.abs(tp["state"]["Tcw"] - tp["frames"][-1].Tcw).max() > 1e-3


def test_trackrgbd_finishes_before_the_full_batch(sequence):
    """Synchronous KITTI: the StopFrame full batch runs once, on the last
    frame, after ``finish()`` (system.py:164-169 of the JAX package)."""
    scene, seq = sequence
    d = _cfg_dict(scene, ChooseData=2, DepthMapFactor=DM_FACTOR)
    s = System()
    s.init_from_config(config_from_dict(d), Sensor.RGBD, device="cpu",
                       **TRACKER_KW)
    calls = []
    s.tracker.run_full_batch = lambda: calls.append(("full batch",
                                                     len(s.map)))
    finish = s.tracker.finish
    s.tracker.finish = lambda: (calls.append(("finish",)), finish())
    bf = float(scene.cam.bf)
    for fr in seq.frames[:3]:
        raw = np.where(fr.depth > 0, DM_FACTOR * bf
                       / np.maximum(fr.depth, 1e-6), 0.0).astype(np.float32)
        s.TrackRGBD(None, raw, fr.flow, fr.mask, nImage=3)
    assert calls == [("finish",), ("full batch", 3)]


def test_host_copy_on_the_cpu_is_to_host():
    """On the CPU the asynchronous copy takes the arrays at once, as
    ``to_host`` does; its GPU cases are in tests/test_torch_kernels_gpu.py."""
    tree = (torch.arange(6.0).reshape(3, 2),
            (torch.ones(4, dtype=torch.bool), torch.zeros(0, 3)))
    c = to_host_async(tree)
    got, want = c.get(), to_host(tree)
    assert c.get() is got
    for a, b in ((got[0], want[0]), (got[1][0], want[1][0]),
                 (got[1][1], want[1][1])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
