"""Geometry of the PyTorch port against the JAX package on the cases of
tests/test_geometry.py: same numpy inputs, float32 both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.geometry import se3 as jse3
from vido_slam_tpu.geometry import so3 as jso3
from vido_slam_tpu.geometry.camera import Camera as JCamera
from vido_slam_tpu.geometry.camera import convert_depth as j_convert_depth
from vido_slam_tpu_torch.geometry import se3, so3
from vido_slam_tpu_torch.geometry.camera import Camera, convert_depth

torch.set_num_threads(1)

ATOL = 2e-6  # float32 rounding of the same formulas in another op order


def _cmp(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def _rotvecs(seed, n, scale):
    return (np.random.RandomState(seed).randn(n, 3) * scale).astype(
        np.float32)


@pytest.mark.parametrize("scale", [1e-9, 1e-5, 0.05, 0.8, 2.5])
def test_so3_exp_log(scale):
    w = _rotvecs(0, 64, scale)
    R = so3.exp_so3(torch.tensor(w))
    _cmp(R, jso3.exp_so3(jnp.asarray(w)))
    _cmp(so3.log_so3(R), jso3.log_so3(jso3.exp_so3(jnp.asarray(w))), 1e-5)
    _cmp(so3.right_jacobian_inv_so3(torch.tensor(w)),
         jso3.right_jacobian_inv_so3(jnp.asarray(w)), 1e-5)


def test_hat_vee():
    w = _rotvecs(1, 8, 1.0)
    _cmp(so3.hat(torch.tensor(w)), jso3.hat(jnp.asarray(w)), 0)
    _cmp(so3.vee(so3.hat(torch.tensor(w))), w, 0)


@pytest.mark.parametrize("scale", [1e-6, 0.1, 0.7])
def test_se3_exp_log_inverse(scale):
    xi = (np.random.RandomState(5).randn(32, 6) * scale).astype(np.float32)
    T = se3.exp_se3(torch.tensor(xi))
    Tj = jse3.exp_se3(jnp.asarray(xi))
    _cmp(T, Tj)
    _cmp(se3.log_se3(T), jse3.log_se3(Tj), 1e-4)
    _cmp(se3.inverse_se3(T), jse3.inverse_se3(Tj))
    _cmp(se3.compose(T, se3.inverse_se3(T)),
         np.broadcast_to(np.eye(4), (32, 4, 4)), 1e-5)


def test_transform_points():
    xi = np.random.RandomState(7).randn(6).astype(np.float32)
    pts = np.random.RandomState(8).randn(10, 3).astype(np.float32)
    T = se3.exp_se3(torch.tensor(xi))
    _cmp(se3.transform_points(T, torch.tensor(pts)),
         jse3.transform_points(jse3.exp_se3(jnp.asarray(xi)),
                               jnp.asarray(pts)), 1e-5)


def _cams():
    kw = dict(fx=816.402, fy=817.38, cx=608.2658, cy=266.688, width=1280,
              height=560, bf=387.57)
    return Camera.create(**kw), JCamera.create(**kw)


def test_camera_project_backproject_guard():
    cam, jcam = _cams()
    uv = np.array([[100.0, 200.0], [640.0, 280.0], [1000.0, 50.0]],
                  np.float32)
    depth = np.array([5.0, 10.0, 33.0], np.float32)
    pts = cam.backproject(torch.tensor(uv), torch.tensor(depth))
    _cmp(pts, jcam.backproject(jnp.asarray(uv), jnp.asarray(depth)), 0)
    # includes points with |z| < 1e-6, where both replace z by 1e-6
    p = np.array([[1.0, 2.0, 3.0], [0.5, -0.2, 1e-8], [0.1, 0.1, -5e-7]],
                 np.float32)
    np.testing.assert_allclose(cam.project(torch.tensor(p)).numpy(),
                               np.asarray(jcam.project(jnp.asarray(p))),
                               rtol=1e-6)
    uvb = np.array([[0.0, 0.0], [-1.0, 5.0], [1279.5, 100.0],
                    [1280.0, 100.0]], np.float32)
    np.testing.assert_array_equal(cam.in_bounds(torch.tensor(uvb)).numpy(),
                                  np.asarray(jcam.in_bounds(
                                      jnp.asarray(uvb))))


@pytest.mark.parametrize("dataset", ["omd", "kitti", "kaist"])
def test_convert_depth(dataset):
    raw = np.random.RandomState(3).uniform(-50, 5000, (16, 24)).astype(
        np.float32)
    raw[0, :4] = 0.0
    t = convert_depth(torch.tensor(raw), dataset, 500.0, 387.57, scale=1.3)
    j = j_convert_depth(jnp.asarray(raw), dataset, 500.0, 387.57, scale=1.3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


def test_convert_depth_unknown_dataset():
    with pytest.raises(ValueError):
        convert_depth(torch.zeros(2, 2), "tum", 1.0, 1.0)
