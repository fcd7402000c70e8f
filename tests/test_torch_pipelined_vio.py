"""VIO through ``track_frames_pair``, the JAX bench's ``vio_r50_544x800``
configuration (pipelined, fused window BA, two frames a call), in the
port against the JAX package on the CPU. The scene is
tests/test_torch_vio.py's (tests/test_vio_e2e.py's: 24 frames at 192x120
of a textured ground plane, depth at 1/2.5 of metric times the IMU scale,
the analytic 200 Hz IMU), served to both packages' pair paths by the stub
perceptions of tests/test_torch_pipelined.py and tests/test_vio_fused.py
with the whole IMU stream queued up front, as tests/test_vio_fused.py
does. The calls (f0, f1, f2), (f1, f2, f3), ..., (f21, f22, f23) record
frames 0-22.

Bars: ``_vio_event_due`` (the pre-dispatch check) gives JAX's answer at
every call; the init attempts and the initialized flag after every call
equal JAX's; ``imu_scale`` within 4e-3 relative (test_torch_vio.py's
fused-BA bar, FUSED_SCALE_REL there says why); the returned poses before
the init and the map poses with each tracker's own init transform undone
within 1e-3 m and 1e-3 rad; ``Rwg`` within 1e-3 rad of JAX's and its
gravity within tests/test_vio_fused.py's 0.5 m/s^2 of the truth; the
timestamps k / fps. Each pair's two depth conversions take the IMU scale
that its own pre-dispatch update left."""

import numpy as np
import pytest
import torch

from test_torch_pipelined import DM_FACTOR, Stub, indexed_frames, stub_stacks
from test_torch_vio import (CFG, FUSED_SCALE_REL, N_FRAMES, SCALE_GT,
                            TRACKER_KW, Snapshot, _rot_err, scene)  # noqa: F401
from test_vio_fused import StubPerception as JStub
from vido_slam_tpu.config import config_from_dict as j_config_from_dict
from vido_slam_tpu.imu.preintegration import GRAVITY_VALUE
from vido_slam_tpu.system import ImuPoint as JImuPoint
from vido_slam_tpu.tracking import Tracker as JTracker
from vido_slam_tpu_torch import tracking as t_tracking
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.system import ImuPoint
from vido_slam_tpu_torch.tracking import Tracker

torch.set_num_threads(1)

PAIR_KW = dict(TRACKER_KW, use_imu=True, pipelined=True, fused_ba=True)


def _pair_run(tracker, frames, imu, point):
    """The IMU queued, then the pair calls and ``finish()``; returns each
    call's (returned pose, imu_initialized, imu_init_attempts,
    imu_scale) and ``_vio_event_due``'s answer at each call."""
    due = []
    check = tracker._vio_event_due

    def recording(ts):
        due.append(check(ts))
        return due[-1]

    tracker._vio_event_due = recording
    tracker.grab_imu_data([point(a, w, t) for a, w, t in imu])
    out = []
    for i in [0] + list(range(1, len(frames) - 2, 2)):
        T = tracker.track_frames_pair(*frames[i:i + 3])
        out.append((np.asarray(T, np.float32), tracker.imu_initialized,
                    tracker.imu_init_attempts, tracker.imu_scale))
    tracker.finish()
    return out, due


@pytest.fixture(scope="module")
def pair_runs(scene):
    stacks = stub_stacks([s[0] for s in scene], [s[1] for s in scene],
                         [s[2] for s in scene], CFG["Camera.bf"])
    frames = indexed_frames(N_FRAMES, CFG["Camera.height"],
                            CFG["Camera.width"])
    imu = [m for s in scene for m in s[5]]
    jt = JTracker(j_config_from_dict(CFG), lm_pallas=False, **PAIR_KW)
    jt.attach_perception(JStub(*stacks), "kaist", DM_FACTOR, CFG["Camera.bf"])
    rj, due_j = _pair_run(jt, frames, imu,
                          lambda a, w, t: JImuPoint(a=a, w=w, t=t))
    tt = Tracker(config_from_dict(CFG), device="cpu", **PAIR_KW)
    tt.attach_perception(Stub(*stacks), "kaist", DM_FACTOR, CFG["Camera.bf"])
    scales = []
    convert = t_tracking.convert_depth

    def recording(*args, scale, **kw):
        scales.append(float(scale))
        return convert(*args, scale=scale, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_tracking, "convert_depth", recording)
        rt, due_t = _pair_run(tt, frames, imu,
                              lambda a, w, t: ImuPoint(a=a, w=w, t=t))
    return jt, tt, rj, rt, due_j, due_t, scales


def test_pre_dispatch_check_matches_jax(pair_runs):
    """The check runs on every pair call after the first, and answers as
    JAX's does; it holds from the 2-s mark until the init succeeds."""
    _, tt, rj, rt, due_j, due_t, _ = pair_runs
    assert len(due_t) == len(rt) - 1
    assert due_t == due_j and any(due_t)
    assert [r[1:3] for r in rt] == [r[1:3] for r in rj]
    init = [k for k, r in enumerate(rt) if r[1]]
    assert init and tt.imu_init_attempts == sum(due_t[:init[0]])


def test_vio_pairs_match_jax(pair_runs):
    jt, tt, rj, rt, _, _, _ = pair_runs
    k0 = [k for k, r in enumerate(rj) if r[1]][0]
    assert [k for k, r in enumerate(rt) if r[1]][0] == k0
    assert tt.imu_scale == pytest.approx(jt.imu_scale, rel=FUSED_SCALE_REL)
    assert tt.imu_scale == pytest.approx(SCALE_GT, rel=0.1)
    for k in range(k0):
        a, b = rj[k][0], rt[k][0]
        assert np.abs(a[:3, 3] - b[:3, 3]).max() <= 1e-3, k
        assert _rot_err(a, b) <= 1e-3, k
    sj, st = Snapshot(jt), Snapshot(tt)
    assert len(st.poses) == len(sj.poses) == N_FRAMES - 1
    for k in range(N_FRAMES - 1):
        A, B = sj.undo_init(k), st.undo_init(k)
        assert np.abs(A[:3, 3] - B[:3, 3]).max() <= 1e-3, k
        assert _rot_err(A, B) <= 1e-3, k
    assert _rot_err(st.Rwg, sj.Rwg) <= 1e-3
    g_true = np.array([0.0, GRAVITY_VALUE, 0.0])
    for R in (st.Rwg, sj.Rwg):
        assert np.linalg.norm(R @ np.array([0.0, 0.0, -GRAVITY_VALUE])
                              - g_true) < 0.5
    want = [k / tt.cam.fps for k in range(N_FRAMES - 1)]
    assert [f.timestamp for f in tt.map.frames] == want
    assert [f.timestamp for f in jt.map.frames] == want


def test_pair_depth_converts_at_the_updated_scale(pair_runs):
    """Each pair's two conversions take the scale its own pre-dispatch
    update left (the scale after that call); the first call initialises
    through the perception's own conversion at the base scale."""
    _, _, _, rt, _, _, scales = pair_runs
    want = [float(np.float32(r[3])) for r in rt[1:] for _ in "AB"]
    assert scales == want
    assert len(set(scales)) == 2
