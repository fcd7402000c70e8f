"""The port's renderer of the offline inputs (``io/synthetic.py``) against the
JAX package's on the same scenes: depth, flow, mask and ground-truth poses.

Tolerances: labels exactly; depth 1e-5 relative and flow 1e-4 px, room for
float32 rounding of the ray casts in another order (on the CPU both
renderers agree bit for bit at these sizes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.geometry.camera import Camera as JCamera
from vido_slam_tpu.geometry.se3 import make_se3 as j_make_se3
from vido_slam_tpu.geometry.so3 import exp_so3 as j_exp_so3
from vido_slam_tpu.io import synthetic as j_syn
from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.io import synthetic as t_syn

torch.set_num_threads(1)


def _driving_scenes(width, height):
    """The bench's two-vehicle driving scene with the KAIST intrinsics
    scaled to width x height."""
    s = width / 1280.0
    cam_kw = dict(fx=816.402 * s, fy=817.38 * s, cx=608.2658 * s,
                  cy=266.688 * s, width=width, height=height, bf=387.57 * s)
    half = [0.9, 0.7, 2.0]
    mot = [0.06, 0.0, -0.5]
    starts = ([-3.0, 0.7, 14.0], [3.0, 0.7, 22.0])
    j_boxes = tuple(
        j_syn.Box(half_extent=jnp.asarray(half), label=2,
                  pose0=j_make_se3(jnp.eye(3), jnp.asarray(p)),
                  motion=j_make_se3(jnp.eye(3), jnp.asarray(mot)))
        for p in starts)
    t_boxes = tuple(
        t_syn.Box(half_extent=torch.tensor(half), label=2,
                  pose0=t_syn.translation_se3(p),
                  motion=t_syn.translation_se3(mot))
        for p in starts)
    return (j_syn.SyntheticScene(cam=JCamera.create(**cam_kw), ground_y=1.6,
                                 boxes=j_boxes),
            t_syn.SyntheticScene(cam=Camera.create(**cam_kw), ground_y=1.6,
                                 boxes=t_boxes))


def _compare(jseq, tseq):
    assert len(jseq) == len(tseq)
    for a, b in zip(jseq.frames, tseq.frames):
        np.testing.assert_allclose(b.Tcw_gt, a.Tcw_gt, atol=1e-6)
        for pa, pb in zip(a.box_poses, b.box_poses):
            np.testing.assert_allclose(pb, pa, atol=1e-5)
        assert b.mask.dtype == np.int32
        np.testing.assert_array_equal(b.mask, a.mask)
        np.testing.assert_allclose(b.depth, a.depth, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(b.flow, a.flow, atol=1e-4)
        assert (a.mask > 0).any()


@pytest.mark.parametrize("moving_box", [True, False])
def test_simple_scene_sequence_matches_jax(moving_box):
    dT = np.asarray(j_make_se3(j_exp_so3(jnp.array([0.0, 0.01, 0.0])),
                               jnp.array([0.02, 0.0, -0.4])))
    jseq = j_syn.SyntheticSequence(
        j_syn.simple_scene(moving_box=moving_box, box_speed=0.6), [dT], 3)
    tseq = t_syn.SyntheticSequence(
        t_syn.simple_scene(moving_box=moving_box, box_speed=0.6), [dT], 3,
        device="cpu")
    _compare(jseq, tseq)


def test_driving_scene_matches_jax():
    """chip_smoke.py's scene and trajectory at a quarter of the width."""
    for t in (0.0, 0.35, 1.7):
        np.testing.assert_array_equal(t_syn.driving_pose(t),
                                      j_syn.driving_pose(t))
    Tcws = [t_syn.driving_pose(k / 10.0) for k in range(5)]
    steps = [Tcws[k + 1] @ np.linalg.inv(Tcws[k]) for k in range(4)]
    jscene, tscene = _driving_scenes(320, 140)
    _compare(j_syn.SyntheticSequence(jscene, steps, 4),
             t_syn.SyntheticSequence(tscene, steps, 4, device="cpu"))
