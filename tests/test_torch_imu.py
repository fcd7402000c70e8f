"""The port's IMU preintegration (``imu/preintegration.py``) against the JAX
package's on the CPU, on tests/test_imu.py's problems with the same
numpy-seeded samples.

Tolerances: dR, dV, dP, the 15x15 covariance C and the five bias Jacobians
within 1e-5 of each field's largest magnitude, dT within 1e-6 s;
``prepare_segments`` and ``compose_preints`` exactly (both are numpy in
both packages); the calibration's noise matrices exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_imu import simulate_imu
from vido_slam_tpu.imu import preintegration as J
from vido_slam_tpu_torch.imu import preintegration as T

torch.set_num_threads(1)

CALIB = (np.eye(4), 1e-3, 1e-3, 1e-5, 1e-4, 200.0)
FIELDS = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C")


def _samples(name):
    """(accs, gyros, dts, bias) of a named problem."""
    if name == "constant":
        return (*simulate_imu(), np.zeros(6, np.float32))
    rng = np.random.default_rng(0)
    n = 60
    accs = (rng.normal(0, 2.0, (n, 3)).astype(np.float32)
            + np.asarray([0.0, 0.0, -9.79], np.float32))
    gyros = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    dts = np.full(n, 0.005, np.float32)
    bias = np.zeros(6, np.float32)
    if name == "padded":
        accs[40:] = rng.normal(size=(20, 3))
        gyros[40:] = rng.normal(size=(20, 3))
        dts[40:] = 0.0
    elif name == "biased":
        bias = np.array([1e-3, -2e-3, 1e-3, 5e-3, -1e-3, 2e-3], np.float32)
    return accs, gyros, dts, bias


def _integrate_both(name):
    accs, gyros, dts, bias = _samples(name)
    js = J.integrate_measurements(
        J.init_preintegration(jnp.asarray(bias)), jnp.asarray(accs),
        jnp.asarray(gyros), jnp.asarray(dts), J.ImuCalib.from_config(*CALIB))
    ts = T.integrate_measurements(
        T.init_preintegration(bias, device="cpu"), torch.from_numpy(accs),
        torch.from_numpy(gyros), torch.from_numpy(dts),
        T.ImuCalib.from_config(*CALIB, device="cpu"))
    return js, ts


def _close(got, want, what):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= 1e-5 * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.mark.parametrize("name", ["constant", "random", "padded", "biased"])
def test_integrate_measurements_matches_jax(name):
    js, ts = _integrate_both(name)
    for f in FIELDS:
        _close(getattr(ts, f).numpy(), getattr(js, f), (name, f))
    assert abs(float(ts.dT) - float(js.dT)) <= 1e-6
    np.testing.assert_array_equal(ts.bias.numpy(), np.asarray(js.bias))


def test_bias_corrected_deltas_match_jax():
    js, ts = _integrate_both("constant")
    db = np.array([1e-3, -2e-3, 1e-3, 5e-3, -1e-3, 2e-3], np.float32)
    for got, want, f in zip(T.bias_corrected_deltas(ts, torch.from_numpy(db)),
                            J.bias_corrected_deltas(js, jnp.asarray(db)),
                            ("dR", "dV", "dP")):
        _close(got.numpy(), want, f)


def test_calibration_matches_jax():
    jc = J.ImuCalib.from_config(*CALIB)
    tc = T.ImuCalib.from_config(*CALIB, device="cpu")
    np.testing.assert_array_equal(tc.Nga.numpy(), np.asarray(jc.Nga))
    np.testing.assert_array_equal(tc.NgaWalk.numpy(), np.asarray(jc.NgaWalk))
    np.testing.assert_array_equal(tc.Tbc.numpy(), np.asarray(jc.Tbc))


@pytest.mark.parametrize("t0,t1,m", [(0.012, 0.043, 16), (0.0, 0.1, 8),
                                     (0.2, 0.3, 16), (0.0495, 0.0505, 4)])
def test_prepare_segments_matches_jax(t0, t1, m):
    rng = np.random.RandomState(2)
    times = np.arange(0.0, 0.1, 0.005)
    accs = rng.normal(size=(len(times), 3)).astype(np.float32)
    gyros = rng.normal(size=(len(times), 3)).astype(np.float32)
    for got, want in zip(T.prepare_segments(times, accs, gyros, t0, t1, m),
                         J.prepare_segments(times, accs, gyros, t0, t1, m)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_compose_preints_matches_jax():
    """The same two states (the JAX package's, as numpy) composed by both:
    every field equal."""
    accs, gyros, dts, _ = _samples("random")
    c = J.ImuCalib.from_config(*CALIB)
    a, b = (J.integrate_measurements(
        J.init_preintegration(), jnp.asarray(accs[s]), jnp.asarray(gyros[s]),
        jnp.asarray(dts[s]), c) for s in (slice(0, 37), slice(37, None)))
    a = J.PreintegrationState(*(np.asarray(x) for x in a))
    b = J.PreintegrationState(*(np.asarray(x) for x in b))
    want = J.compose_preints(a, b)
    got = T.compose_preints(a, b)
    for f in J.PreintegrationState._fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
