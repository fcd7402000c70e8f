"""State carried across from the JAX package: its camera, tracker state
(``TrackState``, ``vido_slam_tpu/tracking.py:82-111``) and PRNG key, given as
numpy arrays (``jax.device_get`` of them), become the port's tensors.

The inputs are read by field name, so any object with the JAX field names
works; nothing of the JAX package is imported. The slice has no network
parameters: the tracker's state is what a run carries.
"""

from __future__ import annotations

import numpy as np
import torch

from vido_slam_tpu_torch.frontend.features import FeatureSet
from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.tracking import TrackState
from vido_slam_tpu_torch.utils.device import resolve_device

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def tensor_from_numpy(x, device=None) -> torch.Tensor:
    """float -> float32, int -> int32, bool -> bool; on ``device``, the
    card unless the caller asks for the CPU."""
    a = np.array(x)
    return torch.from_numpy(a).to(
        device=resolve_device(device), dtype=_DTYPES[a.dtype])


def key_from_numpy(key, device=None) -> torch.Tensor:
    """A raw (2,) uint32 threefry key -> the port's int64 key."""
    return torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64),
                           device=resolve_device(device))


def camera_from_numpy(cam) -> Camera:
    return Camera.create(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                         dist=np.asarray(cam.dist), width=cam.width,
                         height=cam.height, bf=cam.bf, fps=cam.fps)


def feature_set_from_numpy(fs, device=None) -> FeatureSet:
    return FeatureSet(*(tensor_from_numpy(getattr(fs, f), device)
                        for f in FeatureSet._fields))


def track_state_from_numpy(state, device=None) -> TrackState:
    device = resolve_device(device)
    fields = {}
    for f in TrackState._fields:
        v = getattr(state, f)
        if f in ("stat", "obj"):
            fields[f] = feature_set_from_numpy(v, device)
        elif f == "key":
            fields[f] = key_from_numpy(v, device)
        else:
            fields[f] = tensor_from_numpy(v, device)
    return TrackState(**fields)
