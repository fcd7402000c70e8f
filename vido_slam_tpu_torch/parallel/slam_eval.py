"""Multi-sequence SLAM tracking — counterpart of
``vido_slam_tpu/parallel/slam_eval.py`` (SURVEY §2.4's multi-sequence
KAIST evaluation on the SLAM side).

The JAX package vmaps S independent sequences through the same per-frame
step (``tracking._track_step``) and shards the sequence axis over a mesh's
``dp`` axis. Here the S sequences run in turn on ``device`` (``cuda``
unless the caller passes ``"cpu"``), each through the port's
``_track_step`` in light-record fused-BA mode with the JAX runner's
options (``_make_seq_runner``: no FAST, no joint flow). The key schedule
is ``Tracker.initialize``/``_next_key``'s, so sequence s equals a
``Tracker(seed=seeds[s], local_ba=True, fused_ba=True)`` on its frames.
On the card the camera and object solves run kernel 1 (the batched pose
LM), twice a tracked frame a sequence.

Given a ``mesh`` (``parallel/mesh.py``), S is padded to a multiple of dp by
repeating the last sequence and its seed (slam_eval.py:171-182 of the JAX
package), each dp rank tracks its contiguous block of sequences, and the
results are all-gathered and the pads cut off. Sequence s draws from
``PRNGKey(seeds[s])`` on whichever rank it lands.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vido_slam_tpu_torch.config import Config
from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.parallel.mesh import Mesh, gather_batch, shard_batch
from vido_slam_tpu_torch.tracking import TrackState, _track_step, initial_state
from vido_slam_tpu_torch.utils import prng
from vido_slam_tpu_torch.utils.device import resolve_device


class MultiSeqResult(NamedTuple):
    Tcw: torch.Tensor        # (S, T, 4, 4) per-frame refined camera poses
    ba_Twc: torch.Tensor     # (S, W, 4, 4) final window poses per sequence
    n_inliers: torch.Tensor  # (S, T) static-track health diagnostic


def init_track_state(key: torch.Tensor, cam: Camera, depth: torch.Tensor,
                     flow: torch.Tensor, mask: torch.Tensor, *, n_bg: int,
                     n_obj: int, window: int, th_depth_bg: float,
                     th_depth_obj: float) -> TrackState:
    """Functional Tracking::Initialization (Tracking.cc:1512-1580) — the
    device-state half of ``Tracker.initialize``, same key schedule (split
    -> sample key, split -> state key), on the inputs' device."""
    keys = prng.split(key, 2)
    k_sample = keys[1]
    k_state = prng.split(keys[0], 2)[1]
    return initial_state(k_sample, k_state, cam, depth, flow, mask,
                         n_bg=n_bg, n_obj=n_obj, window=window,
                         th_depth_bg=th_depth_bg, th_depth_obj=th_depth_obj)


def multi_sequence_tracking(
    cfg: Config,
    depths,                # (S, T, H, W) float32 metric depth
    flows,                 # (S, T, H, W, 2)
    masks,                 # (S, T, H, W) int32 semantic instance mask
    *,
    seeds=None,            # (S,) int seeds (default arange)
    n_bg: int = 800,
    n_obj: int = 500,
    max_objects: int = 4,
    ba_points: int = 400,
    ba_iters: int = 5,
    device=None,
    mesh: Optional[Mesh] = None,
) -> MultiSeqResult:
    """Track S sequences on ``device``, one after another. Frame 0
    initialises; frames 1..T-1 step. Inputs may be numpy arrays or tensors
    on any device: each frame is moved to ``device`` as it is tracked. The
    JAX package pads S to a multiple of its mesh's dp size by replicating
    the last sequence; one device needs no padding. On a ``mesh`` the
    sequences are spread over its dp ranks (see the module's note) and
    every rank returns all S results."""
    if mesh is not None:
        S = depths.shape[0]
        seeds = np.arange(S) if seeds is None else np.asarray(seeds)
        Sp = -(-S // mesh.dp) * mesh.dp

        def padded(x):
            idx = np.minimum(np.arange(Sp), S - 1)
            return x[torch.as_tensor(idx)] if isinstance(x, torch.Tensor) \
                else np.asarray(x)[idx]
        local = shard_batch([padded(x) for x in (depths, flows, masks,
                                                 seeds)], mesh)
        res = multi_sequence_tracking(
            cfg, *local[:3], seeds=local[3], n_bg=n_bg, n_obj=n_obj,
            max_objects=max_objects, ba_points=ba_points, ba_iters=ba_iters,
            device=mesh.device)
        return MultiSeqResult(*(x[:S] for x in gather_batch(res, mesh)))
    dev = resolve_device(device)
    s = cfg.system
    c = cfg.camera
    cam = Camera.create(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width,
                        height=c.height, bf=c.bf, fps=c.fps)
    S, T = depths.shape[0], depths.shape[1]
    seeds = range(S) if seeds is None else [int(x) for x in seeds]
    step_kw = dict(
        cam=cam, n_bg=n_bg, n_obj=n_obj, max_objects=max_objects,
        th_depth_bg=s.th_depth_bg, th_depth_obj=s.th_depth_obj,
        sf_mg_thres=s.sf_mg_thres, sf_ds_thres=s.sf_ds_thres,
        height=cam.height, width=cam.width, joint_flow=False, fused_ba=True,
        ba_window=s.window_size, ba_points=ba_points, ba_iters=ba_iters,
        record_light=True, use_fast=False)
    Tcws, ba_Twcs, inliers = [], [], []
    for seq, seed in enumerate(seeds):
        def inputs(t):
            return (torch.as_tensor(depths[seq, t], device=dev,
                                    dtype=torch.float32),
                    torch.as_tensor(flows[seq, t], device=dev,
                                    dtype=torch.float32),
                    torch.as_tensor(masks[seq, t], device=dev,
                                    dtype=torch.int32))
        state = init_track_state(
            prng.PRNGKey(seed, dev), cam, *inputs(0), n_bg=n_bg,
            n_obj=n_obj, window=s.window_size, th_depth_bg=s.th_depth_bg,
            th_depth_obj=s.th_depth_obj)
        poses = [torch.eye(4, dtype=torch.float32, device=dev)]
        n_inl = [state.stat.valid.sum().to(torch.int32)]
        for t in range(1, T):
            state, _ = _track_step(state, *inputs(t), **step_kw)
            # the BA-refined newest pose: what Tracker.track returns
            poses.append(state.Tcw)
            n_inl.append(state.ba_obs_valid[-1].sum().to(torch.int32))
        Tcws.append(torch.stack(poses))
        ba_Twcs.append(state.ba_Twc)
        inliers.append(torch.stack(n_inl))
    return MultiSeqResult(Tcw=torch.stack(Tcws), ba_Twc=torch.stack(ba_Twcs),
                          n_inliers=torch.stack(inliers))
