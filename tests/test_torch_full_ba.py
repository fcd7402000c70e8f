"""The full-batch BA (``estimation/full_ba.py``, ``assemble_full_problem``,
``Tracker.run_full_batch``) against the JAX package on the CPU.

On the 8-frame scene of tests/test_full_ba.py tracked by the port and by
JAX, both assemblers give exactly the same problem from either map. On that
problem and on a seeded one, with and without the altitude prior: the
residual blocks and the cost within 1e-5 relative (to the largest entry of
a block, at least 1: the odometry and smoothness logs are ~1e-5 differences
of unit-sized rotations, so float32 rounding of those leaves ~1e-7 in them,
in either package), the gradient and one J^T W J v product within 1e-4 relative, and
``solve_full_ba`` at small iteration counts (2 x 5 and 3 x 10 CG) with the
same LM iteration count, poses and motions within 1e-3 m / 1e-3 rad, points
within 1e-3 m and the cost within 1e-3 relative: float32 CG drifts with the
order of its dot products, so the iteration counts stay small.
``run_full_batch`` writes the refined slots as JAX's does on the same map,
and both refuse light records."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vjp

from vido_slam_tpu.config import config_from_dict as j_config_from_dict
from vido_slam_tpu.estimation import full_ba as jfb
from vido_slam_tpu.estimation.assembly import (
    assemble_full_problem as j_assemble_full_problem)
from vido_slam_tpu.geometry.se3 import make_se3 as j_make_se3
from vido_slam_tpu.geometry.so3 import exp_so3 as j_exp_so3
from vido_slam_tpu.io.synthetic import SyntheticSequence, simple_scene
from vido_slam_tpu.tracking import Tracker as JTracker
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.estimation import full_ba as tfb
from vido_slam_tpu_torch.estimation.assembly import assemble_full_problem
from vido_slam_tpu_torch.tracking import Tracker

torch.set_num_threads(1)

N_FRAMES = 8
KW = dict(n_bg=1000, n_obj=2500, max_objects=4, seed=0, ba_max_points=800)


def _cfg(scene):
    cam = scene.cam
    return {"Camera.width": cam.width, "Camera.height": cam.height,
            "Camera.fx": float(cam.fx), "Camera.fy": float(cam.fy),
            "Camera.cx": float(cam.cx), "Camera.cy": float(cam.cy),
            "Camera.bf": float(cam.bf), "MaxTrackPointBG": 1000,
            "WINDOW_SIZE": 6}


@pytest.fixture(scope="module")
def tracked():
    """The port's and the JAX package's trackers over the 8 frames."""
    scene = simple_scene(width=256, height=160, moving_box=True,
                         box_speed=0.6)
    dT = np.asarray(j_make_se3(j_exp_so3(jnp.array([0.0, 0.01, 0.0])),
                               jnp.array([0.02, 0.0, -0.4])))
    seq = SyntheticSequence(scene, [dT], n_frames=N_FRAMES)
    jt = JTracker(j_config_from_dict(_cfg(scene)), lm_pallas=False, **KW)
    tt = Tracker(config_from_dict(_cfg(scene)), device="cpu", **KW)
    for fr in seq.frames:
        jt.track(fr.depth, fr.flow, fr.mask, Tcw_gt=fr.Tcw_gt)
        tt.track(fr.depth, fr.flow, fr.mask, Tcw_gt=fr.Tcw_gt)
    return jt, tt


def _seeded_problem():
    """F=5 frames, 40 static tracks, 30 dynamic slots, K=2: poses and
    motions near identity, points 6-10 m ahead, noisy observations, random
    validity (pads at the front, ternary links only after a valid slot)."""
    rng = np.random.RandomState(0)
    F, P, Nd, K = 5, 40, 30, 2

    def se3(rot, trans, n):
        return np.asarray(j_make_se3(
            j_exp_so3(jnp.asarray(rng.randn(*n, 3) * rot, jnp.float32)),
            jnp.asarray(rng.randn(*n, 3) * trans, jnp.float32)))

    Twc0 = se3(0.02, 0.3, (F,))
    frame_valid = np.arange(F) >= 1
    X0 = (rng.randn(P, 3) * [2, 1, 1] + [0, 0, 8]).astype(np.float32)
    D0 = (rng.randn(F, Nd, 3) * [1, 0.5, 0.5] + [2, 0, 7]).astype(np.float32)
    dobs_valid = (rng.rand(F, Nd) < 0.7) & frame_valid[:, None]
    tern_valid = np.zeros((F, Nd), bool)
    tern_valid[1:] = dobs_valid[1:] & dobs_valid[:-1] & (rng.rand(F - 1, Nd)
                                                         < 0.8)
    motion_valid = (rng.rand(F, K) < 0.8) & frame_valid[:, None]
    smooth_valid = np.zeros((F, K), bool)
    smooth_valid[1:] = motion_valid[1:] & motion_valid[:-1]
    arrays = dict(
        Twc0=Twc0, frame_valid=frame_valid, odom=se3(0.01, 0.05, (F - 1,)),
        odom_valid=frame_valid[1:] & frame_valid[:-1], X0=X0,
        sobs=(rng.randn(F, P, 3) * 0.05 + [0, 0, 8]).astype(np.float32)
        + X0[None] * 0.1,
        sobs_valid=(rng.rand(F, P) < 0.6) & frame_valid[:, None],
        spoint_valid=rng.rand(P) < 0.9, D0=D0,
        dobs=(D0 + rng.randn(F, Nd, 3) * 0.05).astype(np.float32),
        dobs_valid=dobs_valid, tern_valid=tern_valid,
        midx=rng.randint(0, K, (F, Nd)).astype(np.int32),
        H0=se3(0.01, 0.1, (F, K)), motion_valid=motion_valid,
        smooth_valid=smooth_valid)
    return {k: np.ascontiguousarray(v) for k, v in arrays.items()}


def _problems(tracked, which):
    """(JAX FullBAProblem, port FullBAProblem) from the same numpy arrays."""
    if which == "tracked":
        _, tt = tracked
        jp, _, _ = j_assemble_full_problem(tt.map, tracked[0].cam, N_FRAMES,
                                           800, 4)
        arrays = {k: np.asarray(v) for k, v in jp._asdict().items()}
    else:
        arrays = _seeded_problem()
    jp = jfb.FullBAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tp = tfb.FullBAProblem(**{k: torch.from_numpy(v.copy())
                              for k, v in arrays.items()})
    return jp, tp


def _params(jp, scale, seed):
    """Seeded parameter deltas (zero at scale 0) in both packages."""
    rng = np.random.RandomState(seed)
    F, K = jp.H0.shape[:2]
    shapes = [(F, 6), tuple(jp.X0.shape), tuple(jp.D0.shape), (F, K, 6)]
    arrays = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
    return (jfb.Params(*(jnp.asarray(a) for a in arrays)),
            tfb.Params(*(torch.from_numpy(a) for a in arrays)))


def _rel(a, b, floor=1e-30):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def _rot_err(A, B):
    R = np.asarray(A, np.float64)[..., :3, :3]
    R = np.swapaxes(np.asarray(B, np.float64)[..., :3, :3], -1, -2) @ R
    c = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return float(np.arccos(c).max())


@pytest.mark.parametrize("which", ["port", "jax"])
def test_assembly_exactly_equal(tracked, which):
    """Both assemblers on the same map (tracked by the port or by JAX) give
    the same arrays, dtypes and motion ids; the port's without padding
    (F = len(map)) equals the padded one's real frames."""
    jt, tt = tracked
    slam_map = tt.map if which == "port" else jt.map
    for F in (N_FRAMES, 11):
        jp, jstat, jids = j_assemble_full_problem(slam_map, jt.cam, F, 800, 4)
        tp, tstat, tids = assemble_full_problem(slam_map, tt.cam, F, 800, 4,
                                                device="cpu")
        for name, a, b in zip(jp._fields, jp, tp):
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype, name
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
        np.testing.assert_array_equal(jids, tids)
        for a, b in zip(jstat, tstat):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tp.motion_valid.any() and tp.tern_valid.any()


@pytest.mark.parametrize("altitude", [False, True])
@pytest.mark.parametrize("which", ["tracked", "seeded"])
def test_residual_blocks_and_cost(tracked, which, altitude):
    jp, tp = _problems(tracked, which)
    j_residuals = jax.jit(jfb._residuals, static_argnums=2)
    for scale, seed in ((0.0, 0), (0.01, 1)):
        jpar, tpar = _params(jp, scale, seed)
        jb = j_residuals(jpar, jp, altitude)
        tb = tfb._residuals(tpar, tp, altitude)
        assert len(jb) == len(tb) == 5 + altitude
        for (jr, jw, jrob), (tr, tw, trob) in zip(jb, tb):
            assert jrob == trob and jr.shape == tuple(tr.shape)
            assert _rel(tr.numpy(), jr, floor=1.0) <= 1e-5
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert _rel(float(tfb._cost(tb)), float(jfb._cost(jb))) <= 1e-5
        # the Huber weights carry the residuals' rounding at the gradient's
        # bar
        for a, b in zip(tfb._robust_weights(tb), jfb._robust_weights(jb)):
            assert _rel(a.numpy(), b) <= 1e-4


@pytest.mark.parametrize("altitude", [False, True])
@pytest.mark.parametrize("which", ["tracked", "seeded"])
def test_gradient_and_gauss_newton_product(tracked, which, altitude):
    """g = J^T W r from one VJP and J^T W J v from a JVP and that VJP, at
    seeded parameters and direction, each block to 1e-4 relative."""
    jp, tp = _problems(tracked, which)
    jpar, tpar = _params(jp, 0.01, 2)
    jv, tv = _params(jp, 1.0, 3)

    @jax.jit
    def j_products(prob, p, v):
        """The JAX solver's gradient and product (full_ba.py:246-263)."""
        def j_res(q):
            return tuple(r for r, _, _ in jfb._residuals(q, prob, altitude))

        w = jfb._robust_weights(jfb._residuals(p, prob, altitude))
        r, j_vjp = jax.vjp(j_res, p)
        (g,) = j_vjp(tuple(x * wi[..., None] for x, wi in zip(r, w)))
        _, Jv = jax.jvp(j_res, (p,), (v,))
        (H,) = j_vjp(tuple(x * wi[..., None] for x, wi in zip(Jv, w)))
        return g, H

    def t_res(*p):
        return tuple(r for r, _, _ in tfb._residuals(tfb.Params(*p), tp,
                                                     altitude))

    jg, jH = j_products(jp, jpar, jv)
    tw = tfb._robust_weights(tfb._residuals(tpar, tp, altitude))
    tr, tvjp = vjp(t_res, *tpar)
    tg = tvjp(tuple(r * w[..., None] for r, w in zip(tr, tw)))
    _, tJv = jvp(t_res, tuple(tpar), tuple(tv))
    tH = tvjp(tuple(x * w[..., None] for x, w in zip(tJv, tw)))
    for a, b in zip(tg, jg):
        assert _rel(a.numpy(), b) <= 1e-4
    for a, b in zip(tH, jH):
        assert _rel(a.numpy(), b) <= 1e-4


@pytest.mark.parametrize("which,altitude,iters,cg", [
    ("tracked", False, 2, 5), ("tracked", False, 3, 10),
    ("tracked", True, 3, 10), ("seeded", False, 2, 5),
    ("seeded", False, 3, 10), ("seeded", True, 3, 10)])
def test_solve_full_ba(tracked, which, altitude, iters, cg):
    jp, tp = _problems(tracked, which)
    jr = jfb.solve_full_ba(jp, max_iters=iters, cg_iters=cg,
                           altitude=altitude)
    tr = tfb.solve_full_ba(tp, max_iters=iters, cg_iters=cg,
                           altitude=altitude)
    assert tr.num_iters == int(jr.num_iters)
    Tj, Tt = np.asarray(jr.Twc), tr.Twc.numpy()
    assert np.abs(Tt[:, :3, 3] - Tj[:, :3, 3]).max() <= 1e-3
    assert _rot_err(Tt, Tj) <= 1e-3
    Hj, Ht = np.asarray(jr.H), tr.H.numpy()
    assert np.abs(Ht[..., :3, 3] - Hj[..., :3, 3]).max() <= 1e-3
    assert _rot_err(Ht, Hj) <= 1e-3
    assert np.abs(tr.X.numpy() - np.asarray(jr.X)).max() <= 1e-3
    assert np.abs(tr.D.numpy() - np.asarray(jr.D)).max() <= 1e-3
    assert _rel(float(tr.cost), float(jr.cost)) <= 1e-3
    # the pinned pose stays where it was
    first = int(np.argmax(np.asarray(jp.frame_valid)))
    np.testing.assert_array_equal(Tt[:first + 1], tp.Twc0.numpy()[:first + 1])


def test_run_full_batch_writes_the_refined_slots(tracked):
    """The port's run_full_batch and JAX's on the port's map: the refined
    poses within 1e-3 m / 1e-3 rad, the same tracks and frames of refined
    motions, each within the same bar; the records keep their poses."""
    jt, tt = tracked
    initial = tt.map.poses.copy()
    jt_on_port_map = JTracker.__new__(JTracker)
    jt_on_port_map.__dict__.update(jt.__dict__)
    jt_on_port_map.map = tt.map
    kw = dict(max_frames=N_FRAMES, max_static=800, cg_iters=10, max_iters=3)
    jres = jt_on_port_map.run_full_batch(**kw)
    j_poses = tt.map.refined_poses
    j_motions = tt.map.refined_motions
    tt.map.refined_poses, tt.map.refined_motions = None, {}
    tres = tt.run_full_batch(**kw)
    assert tres.num_iters == int(jres.num_iters)
    t_poses, t_motions = tt.map.refined_poses, tt.map.refined_motions
    assert t_poses.shape == j_poses.shape == (N_FRAMES, 4, 4)
    assert t_poses.dtype == j_poses.dtype == np.float32
    assert np.abs(t_poses[:, :3, 3] - j_poses[:, :3, 3]).max() <= 1e-3
    assert _rot_err(t_poses, j_poses) <= 1e-3
    assert t_motions.keys() == j_motions.keys() and t_motions
    for tid in j_motions:
        assert t_motions[tid].keys() == j_motions[tid].keys()
        for fid, H in j_motions[tid].items():
            assert np.abs(t_motions[tid][fid][:3, 3] - H[:3, 3]).max() <= 1e-3
            assert _rot_err(t_motions[tid][fid], H) <= 1e-3
    np.testing.assert_array_equal(tt.map.poses, initial)
    assert not np.array_equal(t_poses, initial)


def test_run_full_batch_refuses_light_records(tracked):
    jt, tt = tracked
    cfg = tt.cfg
    light = Tracker(cfg, device="cpu", fused_ba=True, record="light", **KW)
    with pytest.raises(ValueError, match="record='full'"):
        light.run_full_batch()
    j_light = JTracker(j_config_from_dict(_cfg(simple_scene(
        width=256, height=160))), lm_pallas=False, fused_ba=True,
        record="light", **KW)
    with pytest.raises(AssertionError, match="record='full'"):
        j_light.run_full_batch()
