"""BA problem assembly from the map — counterpart of
``vido_slam_tpu/estimation/assembly.py``: ``assemble_static_window`` (the
reference's tracklet assembly GetStaticTrack, Tracking.cc:2514-2957, plus the
input loops of PartialBatchOptimization, Optimizer.cc:43-300) and
``assemble_full_problem`` (the inputs of FullBatchOptimization,
Optimizer.cc:1235-2178).

Feature slots are persistent (a surviving track stays in its slot, see
frontend/renewal.py), so a static tracklet inside a window is a maximal run
of a slot with ``stat_is_new == False`` after its start. The window's
FrameRecords are walked once with vectorised numpy; tracks shorter than 3
(FeaLengthThresSta, Optimizer.cc:211) are dropped, the longest are kept up
to ``max_points``, and the fixed-shape arrays ``solve_window_ba`` takes come
out. Host numpy, as in the JAX package, so the two agree exactly.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from vido_slam_tpu_torch.estimation.full_ba import FullBAProblem
from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.slam_map import SlamMap

MIN_TRACK_LEN = 3  # FeaLengthThresSta


class WindowProblem(NamedTuple):
    frame_ids: List[int]     # map frame ids in window order
    Twc0: np.ndarray         # (W, 4, 4)
    odom: np.ndarray         # (W-1, 4, 4)
    odom_valid: np.ndarray   # (W-1,)
    X0: np.ndarray           # (P, 3)
    obs: np.ndarray          # (W, P, 3) camera-frame measurements
    obs_valid: np.ndarray    # (W, P)
    point_valid: np.ndarray  # (P,)
    # bookkeeping for the write-back: the (frame_idx_in_window, slot) of
    # each track's first observation, -1 padded
    track_start: np.ndarray  # (P, 2) int32
    slots: np.ndarray        # (W, P) int32 slot of each observation, -1 pad
    pad: int                 # number of front-pad frames


def _backproject_np(cam: Camera, uv: np.ndarray,
                    depth: np.ndarray) -> np.ndarray:
    x = (uv[..., 0] - cam.cx) * depth / cam.fx
    y = (uv[..., 1] - cam.cy) * depth / cam.fy
    return np.stack([x, y, depth], axis=-1)


def assemble_static_window(slam_map: SlamMap, cam: Camera, window_size: int,
                           max_points: int) -> WindowProblem:
    """The fixed-shape static window problem over the last
    min(len(map), window_size) frames, front-padded to window_size."""
    n_frames = len(slam_map)
    w = min(n_frames, window_size)
    recs = slam_map.frames[n_frames - w:]
    W = window_size
    pad = W - w
    N = recs[0].stat_uv.shape[0]

    valid = np.stack([r.stat_valid for r in recs])          # (w, N)
    is_new = np.stack([r.stat_is_new for r in recs])
    uv = np.stack([r.stat_uv for r in recs])
    depth = np.stack([r.stat_depth for r in recs])
    p3d = np.stack([r.stat_3d for r in recs])

    # segment start frame per (frame, slot): the first window frame starts
    # every segment; renewal or a gap of invalidity starts a new one
    seg_start = np.zeros((w, N), np.int32)
    for t in range(1, w):
        seg_start[t] = np.where(is_new[t], t, seg_start[t - 1])
        seg_start[t] = np.where(
            valid[t] & ~valid[t - 1] & ~is_new[t], t, seg_start[t])
    key = seg_start.astype(np.int64) * N + np.arange(N)[None, :]

    flat_valid = valid.reshape(-1)
    obs_keys = key.reshape(-1)[flat_valid]
    uniq, inverse, counts = np.unique(obs_keys, return_inverse=True,
                                      return_counts=True)
    # rank the kept tracks by length (stable), cap at max_points
    kept_ids = np.nonzero(counts >= MIN_TRACK_LEN)[0]
    order = kept_ids[np.argsort(-counts[kept_ids], kind="stable")][:max_points]
    P = max_points
    track_of_uniq = np.full(uniq.shape[0], -1, np.int64)
    track_of_uniq[order] = np.arange(order.shape[0])

    obs = np.zeros((W, P, 3), np.float32)
    obs_valid = np.zeros((W, P), bool)
    slots = np.full((W, P), -1, np.int32)
    X0 = np.zeros((P, 3), np.float32)
    track_start = np.full((P, 2), -1, np.int32)
    point_valid = np.zeros(P, bool)
    point_valid[: order.shape[0]] = True

    # scatter the observations
    frame_idx = np.repeat(np.arange(w), N)[flat_valid]
    slot_idx = np.tile(np.arange(N), w)[flat_valid]
    tr = track_of_uniq[inverse]
    sel = tr >= 0
    fi = frame_idx[sel] + pad
    tr_s = tr[sel]
    xc = _backproject_np(cam, uv[frame_idx[sel], slot_idx[sel]],
                         depth[frame_idx[sel], slot_idx[sel]])
    obs[fi, tr_s] = xc
    obs_valid[fi, tr_s] = True
    slots[fi, tr_s] = slot_idx[sel]

    # each track's first observation initialises the point
    sl_s = slot_idx[sel]
    first = np.full(P, W + 1, np.int32)
    np.minimum.at(first, tr_s, fi)
    is_first = fi == first[tr_s]
    t_f, f_f, s_f = tr_s[is_first], fi[is_first], sl_s[is_first]
    track_start[t_f] = np.stack([f_f, s_f], axis=-1)
    X0[t_f] = p3d[f_f - pad, s_f]

    Twc0 = np.stack([np.eye(4, dtype=np.float32)] * pad
                    + [np.linalg.inv(r.Tcw).astype(np.float32) for r in recs])
    odom = np.tile(np.eye(4, dtype=np.float32), (W - 1, 1, 1))
    odom_valid = np.zeros(W - 1, bool)
    for i in range(1, w):
        m = recs[i].cam_motion
        if m is not None:
            odom[pad + i - 1] = m
            odom_valid[pad + i - 1] = True

    return WindowProblem(
        frame_ids=[r.frame_id for r in recs], Twc0=Twc0, odom=odom,
        odom_valid=odom_valid, X0=X0, obs=obs, obs_valid=obs_valid,
        point_valid=point_valid, track_start=track_start, slots=slots,
        pad=pad)


def assemble_full_problem(slam_map: SlamMap, cam: Camera, max_frames: int,
                          max_static: int, max_objects_per_frame: int, *,
                          device):
    """The FullBatchOptimization inputs (Optimizer.cc:1235-2178) over the
    last min(len(map), max_frames) records, front-padded: the static
    window problem plus the dynamic side — slot-aligned dynamic point
    observations, per-frame object motion slots keyed by tracking id,
    ternary links for slots continuing from the previous frame, and
    smoothness links between consecutive motions of one object. Returns
    (FullBAProblem on ``device``, the static WindowProblem, motion_ids
    (F, K): each motion slot's tracking id, -1 pad)."""
    F = max_frames
    n = min(len(slam_map), F)
    recs = slam_map.frames[len(slam_map) - n:]
    pad = F - n
    K = max_objects_per_frame
    Nd = recs[0].obj_uv.shape[0]

    stat = assemble_static_window(slam_map, cam, F, max_static)

    frame_valid = np.zeros(F, bool)
    frame_valid[pad:] = True
    dobs = np.zeros((F, Nd, 3), np.float32)
    dobs_valid = np.zeros((F, Nd), bool)
    D0 = np.zeros((F, Nd, 3), np.float32)
    tern_valid = np.zeros((F, Nd), bool)
    midx = np.zeros((F, Nd), np.int32)
    H0 = np.tile(np.eye(4, dtype=np.float32), (F, K, 1, 1))
    motion_valid = np.zeros((F, K), bool)
    smooth_valid = np.zeros((F, K), bool)
    motion_ids = np.full((F, K), -1, np.int32)

    prev_labels = prev_valid = None
    for fi, rec in enumerate(recs):
        f = pad + fi
        # this frame's motion slots, in the record's object order
        tid_to_k = {}
        for k, ob in enumerate([ob for ob in rec.objects if ob.status][:K]):
            H0[f, k] = ob.motion
            motion_valid[f, k] = True
            motion_ids[f, k] = ob.track_id
            tid_to_k[ob.track_id] = k
        if fi > 0:
            for k in range(K):
                tid = motion_ids[f, k]
                if tid >= 0 and tid in motion_ids[f - 1]:
                    smooth_valid[f, k] = True

        labels = rec.obj_label
        valid = rec.obj_valid & (labels > 0)
        # a point's label (track id) -> this frame's motion slot
        k_of = np.full(labels.shape[0], -1, np.int32)
        for tid, k in tid_to_k.items():
            k_of[labels == tid] = k
        use = valid & (k_of >= 0)
        dobs[f][use] = _backproject_np(cam, rec.obj_uv[use],
                                       rec.obj_depth[use])
        dobs_valid[f] = use
        D0[f] = rec.obj_3d
        midx[f][use] = k_of[use]
        if prev_labels is not None:
            tern_valid[f] = (use & ~rec.obj_is_new & (prev_labels == labels)
                             & prev_valid)
        prev_labels, prev_valid = labels, use

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    prob = FullBAProblem(
        Twc0=put(stat.Twc0), frame_valid=put(frame_valid),
        odom=put(stat.odom), odom_valid=put(stat.odom_valid),
        X0=put(stat.X0), sobs=put(stat.obs), sobs_valid=put(stat.obs_valid),
        spoint_valid=put(stat.point_valid), D0=put(D0), dobs=put(dobs),
        dobs_valid=put(dobs_valid), tern_valid=put(tern_valid),
        midx=put(midx), H0=put(H0), motion_valid=put(motion_valid),
        smooth_valid=put(smooth_valid))
    return prob, stat, motion_ids
