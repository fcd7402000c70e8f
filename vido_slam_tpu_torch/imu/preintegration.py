"""IMU preintegration — ORB-SLAM3's IMU::Preintegrated (ImuTypes.cc:245-302
IntegrateNewMeasurement, ImuTypes.h:32-230); counterpart of
``vido_slam_tpu/imu/preintegration.py``.

The state of one frame interval holds the deltas dR, dV, dP, the bias
Jacobians JRg, JVg, JPg, JVa, JPa, the 15x15 covariance C (order [rot, vel,
pos, bg, ba]) and the time dT, as float32 tensors. Each midpoint update goes
position, velocity, then rotation, as the reference does. A segment with
dt = 0 (padding) leaves the state as it was.

GRAVITY_VALUE = 9.79 (ImuTypes.h:29). The noise scales as
Tracking::ParseIMUParamFile does (Tracking.cc:174-275): the discrete noise
is density * sqrt(freq), the discrete walk is walk / sqrt(freq).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from vido_slam_tpu_torch.geometry.so3 import (
    exp_so3,
    hat,
    normalize_rotation,
    right_jacobian_so3,
)

GRAVITY_VALUE = 9.79


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class ImuCalib(NamedTuple):
    Tbc: torch.Tensor       # (4, 4) camera -> body
    # discrete-time noise std
    sigma_g: torch.Tensor
    sigma_a: torch.Tensor
    sigma_gw: torch.Tensor
    sigma_aw: torch.Tensor

    @classmethod
    def from_config(cls, Tbc, noise_gyro, noise_acc, gyro_walk, acc_walk,
                    freq, *, device):
        sf = float(np.sqrt(freq))
        return cls(Tbc=_f32(Tbc, device),
                   sigma_g=_f32(noise_gyro * sf, device),
                   sigma_a=_f32(noise_acc * sf, device),
                   sigma_gw=_f32(gyro_walk / sf, device),
                   sigma_aw=_f32(acc_walk / sf, device))

    def _diag(self, g, a) -> torch.Tensor:
        return torch.diag(torch.cat([(g ** 2).expand(3), (a ** 2).expand(3)]))

    @property
    def Nga(self) -> torch.Tensor:
        return self._diag(self.sigma_g, self.sigma_a)

    @property
    def NgaWalk(self) -> torch.Tensor:
        return self._diag(self.sigma_gw, self.sigma_aw)


class PreintegrationState(NamedTuple):
    dR: torch.Tensor    # (3, 3)
    dV: torch.Tensor    # (3,)
    dP: torch.Tensor    # (3,)
    JRg: torch.Tensor   # (3, 3)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    C: torch.Tensor     # (15, 15)
    dT: torch.Tensor    # scalar
    bias: torch.Tensor  # (6,) [bg, ba] at integration time


def init_preintegration(bias=None, *, device) -> PreintegrationState:
    z33 = torch.zeros(3, 3, device=device)
    return PreintegrationState(
        dR=torch.eye(3, device=device), dV=torch.zeros(3, device=device),
        dP=torch.zeros(3, device=device), JRg=z33, JVg=z33, JVa=z33,
        JPg=z33, JPa=z33, C=torch.zeros(15, 15, device=device),
        dT=torch.zeros((), device=device),
        bias=(torch.zeros(6, device=device) if bias is None
              else torch.as_tensor(bias, dtype=torch.float32, device=device)))


def _integrate_one(state: PreintegrationState, acc, gyro, dt,
                   calib: ImuCalib) -> PreintegrationState:
    """One midpoint update (ImuTypes.cc:245-301) with dt > 0."""
    a = acc - state.bias[3:]
    w = gyro - state.bias[:3]
    dR, dV, dP = state.dR, state.dV, state.dP
    eye3 = torch.eye(3, device=dR.device)

    # position and velocity first, with the rotation before the update
    dP_new = dP + dV * dt + 0.5 * dt * dt * (dR @ a)
    dV_new = dV + dt * (dR @ a)

    dRW = dR @ hat(a)
    A = torch.eye(9, device=dR.device)
    B = torch.zeros(9, 6, device=dR.device)
    A[3:6, 0:3] = -dRW * dt
    A[6:9, 0:3] = -0.5 * dt * dt * dRW
    A[6:9, 3:6] = eye3 * dt
    B[3:6, 3:6] = dR * dt
    B[6:9, 3:6] = 0.5 * dt * dt * dR

    # bias Jacobians, with the rotation before the update
    JPa = state.JPa + state.JVa * dt - 0.5 * dt * dt * dR
    JPg = state.JPg + state.JVg * dt - 0.5 * dt * dt * (dRW @ state.JRg)
    JVa = state.JVa - dR * dt
    JVg = state.JVg - dt * (dRW @ state.JRg)

    # rotation
    dRi = exp_so3(w * dt)
    rightJ = right_jacobian_so3(w * dt)
    dR_new = normalize_rotation(dR @ dRi)
    A[0:3, 0:3] = dRi.T
    B[0:3, 0:3] = rightJ * dt

    C = state.C.clone()
    C[:9, :9] = (A @ state.C[:9, :9]) @ A.T + (B @ calib.Nga) @ B.T
    C[9:, 9:] = C[9:, 9:] + calib.NgaWalk
    return PreintegrationState(
        dR=dR_new, dV=dV_new, dP=dP_new, JRg=dRi.T @ state.JRg - rightJ * dt,
        JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa, C=C, dT=state.dT + dt,
        bias=state.bias)


def integrate_measurements(state: PreintegrationState, accs: torch.Tensor,
                           gyros: torch.Tensor, dts: torch.Tensor,
                           calib: ImuCalib) -> PreintegrationState:
    """The segments in turn (the JAX package's ``lax.scan``): accs, gyros
    (M, 3), dts (M,) with 0 for padding slots, which are skipped."""
    for i, dt in enumerate(dts.tolist()):
        if dt > 0:
            state = _integrate_one(state, accs[i], gyros[i], dts[i], calib)
    return state


def bias_corrected_deltas(state: PreintegrationState, new_bias: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(dR, dV, dP) under an updated bias (ImuTypes.cc:347-368):
    dR' = dR Exp(JRg dbg); dV' = dV + JVg dbg + JVa dba; likewise dP."""
    db = new_bias - state.bias
    dbg, dba = db[:3], db[3:]
    dR = normalize_rotation(state.dR @ exp_so3(state.JRg @ dbg))
    dV = state.dV + state.JVg @ dbg + state.JVa @ dba
    dP = state.dP + state.JPg @ dbg + state.JPa @ dba
    return dR, dV, dP


def to_numpy(state: PreintegrationState) -> PreintegrationState:
    """The state with numpy fields, as the host-side consumers read it."""
    return PreintegrationState(*(t.detach().cpu().numpy() for t in state))


def prepare_segments(times: np.ndarray, accs: np.ndarray, gyros: np.ndarray,
                     t0: float, t1: float, max_segments: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side bucketing of raw IMU samples into the integration segments
    of [t0, t1], the first and last interpolated to the frame boundary as
    Tracking::PreintegrateIMU does (Tracking.cc:784-887). Fixed-size
    (max_segments, ...) arrays padded with dt = 0."""
    sel = np.nonzero((times > t0) & (times < t1))[0]
    a_out = np.zeros((max_segments, 3), np.float32)
    w_out = np.zeros((max_segments, 3), np.float32)
    dt_out = np.zeros(max_segments, np.float32)
    if sel.size == 0:
        return a_out, w_out, dt_out
    ts = np.concatenate([[t0], times[sel], [t1]])
    aa = np.concatenate([[accs[sel[0]]], accs[sel], [accs[sel[-1]]]])
    ww = np.concatenate([[gyros[sel[0]]], gyros[sel], [gyros[sel[-1]]]])
    n = min(len(ts) - 1, max_segments)
    for i in range(n):
        a_out[i] = 0.5 * (aa[i] + aa[i + 1])
        w_out[i] = 0.5 * (ww[i] + ww[i + 1])
        dt_out[i] = ts[i + 1] - ts[i]
    return a_out, w_out, dt_out


def _hat_np(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def compose_preints(a: PreintegrationState, b: PreintegrationState
                    ) -> PreintegrationState:
    """Two consecutive preintegrated segments as one covering both (the
    algebra of ImuTypes' MergePrevious), for the longer-baseline pairs of
    the inertial init: consecutive 0.1 s pairs make the alignment an
    errors-in-variables problem whose scale shrinks toward 0 under cm-level
    VO noise, and composing K pairs grows the kinematic signal ~K^2 while
    the noise stays. Host-side numpy in float64; both states share the
    integration bias.

      dR = dR_a dR_b;  dV = dV_a + dR_a dV_b;  dP = dP_a + dV_a dT_b + dR_a dP_b

    The bias Jacobians follow by the chain rule through dR_a Exp(JRg_a db);
    the 9x9 covariance propagates as C' = A1 C_a A1^T + A2 C_b A2^T.
    Returns numpy float32 fields."""
    def f64(x):
        return np.asarray(x, np.float64)

    Ra, Rb = f64(a.dR), f64(b.dR)
    Va, Vb = f64(a.dV), f64(b.dV)
    Pa, Pb = f64(a.dP), f64(b.dP)
    dTb = float(b.dT)
    JRg_a = f64(a.JRg)
    JVg = f64(a.JVg) + Ra @ (f64(b.JVg) - _hat_np(Vb) @ JRg_a)
    JVa = f64(a.JVa) + Ra @ f64(b.JVa)
    JPg = f64(a.JPg) + f64(a.JVg) * dTb + Ra @ (f64(b.JPg)
                                                 - _hat_np(Pb) @ JRg_a)
    JPa = f64(a.JPa) + f64(a.JVa) * dTb + Ra @ f64(b.JPa)
    JRg = Rb.T @ JRg_a + f64(b.JRg)

    I3 = np.eye(3)
    A1 = np.zeros((9, 9))
    A1[0:3, 0:3] = Rb.T
    A1[3:6, 0:3] = -Ra @ _hat_np(Vb)
    A1[3:6, 3:6] = I3
    A1[6:9, 0:3] = -Ra @ _hat_np(Pb)
    A1[6:9, 3:6] = dTb * I3
    A1[6:9, 6:9] = I3
    A2 = np.zeros((9, 9))
    A2[0:3, 0:3] = I3
    A2[3:6, 3:6] = Ra
    A2[6:9, 6:9] = Ra
    C = np.zeros((15, 15))
    C[:9, :9] = (A1 @ f64(a.C)[:9, :9] @ A1.T
                 + A2 @ f64(b.C)[:9, :9] @ A2.T)
    f32 = np.float32
    return PreintegrationState(
        dR=(Ra @ Rb).astype(f32), dV=(Va + Ra @ Vb).astype(f32),
        dP=(Pa + Va * dTb + Ra @ Pb).astype(f32), JRg=JRg.astype(f32),
        JVg=JVg.astype(f32), JVa=JVa.astype(f32), JPg=JPg.astype(f32),
        JPa=JPa.astype(f32), C=C.astype(f32),
        dT=np.float32(float(a.dT) + dTb), bias=np.asarray(a.bias))
