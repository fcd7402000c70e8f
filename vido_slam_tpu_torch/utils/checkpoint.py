"""Checkpoints and session resume — counterpart of
``vido_slam_tpu/utils/checkpoint.py``:

  - network parameters as flat dicts of arrays in ``.npz`` bundles (the
    JAX package's fallback form, read first by its ``load_params`` too);
  - SLAM session snapshots: the map's FrameRecords and the tracker's
    state, so that a run resumes mid-sequence.

Orbax is not used: a bundle that the JAX package wrote as an orbax
directory must be re-saved as ``.npz`` (``load_params`` says so).

A session pickle holds numpy arrays, Python built-ins and the port's own
``slam_map`` classes only, never a tensor, so a session saved on ``cuda``
loads on the CPU and back. The port cannot read a session the JAX
package wrote: unpickling that would import ``vido_slam_tpu``.

What a session holds is the JAX package's choice, copied with its gaps:
the tracker's own PRNG key (``Tracker.key``) is not saved, so a resumed
tracker draws from ``PRNGKey(seed)`` again; the IMU pair states
(``_preints``), the last frame's timestamp (``_last_ts``), the pending
IMU samples, ``Rwg`` and the init's attempt count are not saved either.
Nor is what a pipelined tracker holds in flight: its state runs a frame
(two with ``track_frames_pair``) ahead of the saved map, whose records
lack the pending frames and any window BA in flight; call ``finish()``
first for a session whose map and state agree.
"""

from __future__ import annotations

import os
import pickle
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from vido_slam_tpu_torch import convert


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def save_params(path: str, params: Dict) -> None:
    """Write ``path + ".npz"`` from a flat dict of tensors or arrays."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **{k: _numpy(v) for k, v in params.items()})


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Read ``path + ".npz"`` as CPU tensors. An orbax directory at
    ``path`` raises ``ValueError``: the port reads ``.npz`` only."""
    if os.path.exists(path + ".npz"):
        with np.load(path + ".npz") as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory; the port reads .npz "
            f"bundles only. Re-save it as {path}.npz (the JAX package's "
            f"load_params of it, then numpy.savez)")
    raise FileNotFoundError(f"{path}.npz")


def save_torch_state_dict(path: str, sd) -> None:
    """Save a torch state_dict (or a ``torch.save`` file of one) in the JAX
    package's layout (``convert.convert_state_dict``), so that either
    package writes the same bundle."""
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    save_params(path, convert.convert_state_dict(sd))


def _state_to_numpy(state) -> dict:
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        out[f] = ({g: _numpy(getattr(v, g)) for g in v._fields}
                  if f in ("stat", "obj") else _numpy(v))
    return out


def _state_namespace(state: dict) -> SimpleNamespace:
    return SimpleNamespace(**{
        f: SimpleNamespace(**v) if isinstance(v, dict) else v
        for f, v in state.items()})


def save_session(path: str, tracker) -> None:
    """Snapshot the SLAM session: the map, the tracker's counters, its IMU
    scale and bias, the object ids and its state (as numpy)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ot = tracker.object_tracker
    payload = {
        "frames": tracker.map.frames,
        "refined_poses": tracker.map.refined_poses,
        "refined_motions": tracker.map.refined_motions,
        "lba_time": tracker.map.lba_time,
        "frame_id": tracker.frame_id,
        "imu_scale": tracker.imu_scale,
        "imu_initialized": tracker.imu_initialized,
        "imu_bias": tracker.imu_bias,
        "state": (_state_to_numpy(tracker.state)
                  if tracker.state is not None else None),
        "object_tracker": {
            "max_id": ot.max_id,
            "prev_sem_to_id": ot.prev_sem_to_id,
            "first_tracked_frame": ot.first_tracked_frame,
        },
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_session(path: str, tracker) -> None:
    """Restore a snapshot into a freshly built ``Tracker`` of the same
    configuration; the state lands on the tracker's device."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    tracker.map.frames = payload["frames"]
    tracker.map.refined_poses = payload["refined_poses"]
    tracker.map.refined_motions = payload["refined_motions"]
    tracker.map.lba_time = payload["lba_time"]
    tracker.frame_id = payload["frame_id"]
    tracker.imu_scale = payload["imu_scale"]
    tracker.imu_initialized = payload["imu_initialized"]
    tracker.imu_bias = payload["imu_bias"]
    ot = payload["object_tracker"]
    tracker.object_tracker.max_id = ot["max_id"]
    tracker.object_tracker.prev_sem_to_id = ot["prev_sem_to_id"]
    tracker.object_tracker.first_tracked_frame = ot["first_tracked_frame"]
    if payload["state"] is not None:
        tracker.state = convert.track_state_from_numpy(
            _state_namespace(payload["state"]), tracker.device)
