"""Dynamic-object statistics and tracking ids — Tracking::DynObjTracking
(Tracking.cc:1670-1912); counterpart of ``vido_slam_tpu/frontend/objects.py``.

Per-semantic-bin statistics are scatter-adds over MAX_SEM bins on the
device; the tracking-id bookkeeping (global id counter, label inheritance)
stays on the host. Per-point labels: -1 outlier, 0 static, > 0 object.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

MAX_SEM = 256  # mono8 instance masks

# Tracking.cc:1710, 1790, 1746
BOUNDARY_ROWS = 10
BOUNDARY_COLS = 20
BOUNDARY_FRAC = 0.5
MIN_OBJ_POINTS = 150


class ObjectStats(NamedTuple):
    """Per-semantic-bin statistics and decisions, each of length MAX_SEM."""

    count: torch.Tensor
    mean_depth: torch.Tensor
    static_frac: torch.Tensor
    boundary_frac: torch.Tensor
    is_boundary: torch.Tensor
    is_static: torch.Tensor
    is_rejected: torch.Tensor
    is_tracked: torch.Tensor
    assoc_prev_sem: torch.Tensor  # most common last-frame label per bin


def compute_object_stats(uv, sem, sem_prev, sf_norm, depth, valid, *,
                         height: int, width: int, sf_mg_thres: float = 0.12,
                         sf_ds_thres: float = 0.3,
                         th_depth_obj: float = 60.0) -> ObjectStats:
    """The per-label decisions of DynObjTracking. The counts are exact; the
    depth sums are summed in another order than the JAX scatter-add."""
    dev = uv.device
    sem_c = torch.clamp(sem, 0, MAX_SEM - 1).to(torch.int64)
    ones = (valid & (sem_c > 0)).to(torch.float32)

    def bincount(values):
        return torch.zeros(MAX_SEM, dtype=torch.float32,
                           device=dev).index_add_(0, sem_c, values)

    count = bincount(ones)
    safe_count = torch.clamp(count, min=1.0)
    on_boundary = ((uv[:, 1] < BOUNDARY_ROWS)
                   | (uv[:, 1] > height - BOUNDARY_ROWS)
                   | (uv[:, 0] < BOUNDARY_COLS)
                   | (uv[:, 0] > width - BOUNDARY_COLS))
    boundary_frac = bincount(ones * on_boundary) / safe_count
    static_frac = bincount(ones * (sf_norm < sf_mg_thres)) / safe_count
    mean_depth = bincount(ones * depth) / safe_count

    present = count > 0
    is_boundary = present & (boundary_frac > BOUNDARY_FRAC)
    is_static = present & ~is_boundary & (static_frac > sf_ds_thres)
    is_rejected = (present & ~is_boundary & ~is_static
                   & ((mean_depth > th_depth_obj) | (count < MIN_OBJ_POINTS)))
    is_tracked = present & ~is_boundary & ~is_static & ~is_rejected

    prev_c = torch.clamp(sem_prev, 0, MAX_SEM - 1).to(torch.int64)
    hist = torch.zeros(MAX_SEM * MAX_SEM, dtype=torch.float32, device=dev)
    hist.index_add_(0, sem_c * MAX_SEM + prev_c, ones)
    # argmax returns the first maximal index, as jnp.argmax
    assoc_prev_sem = torch.argmax(hist.reshape(MAX_SEM, MAX_SEM),
                                  dim=1).to(torch.int32)
    return ObjectStats(count=count, mean_depth=mean_depth,
                       static_frac=static_frac, boundary_frac=boundary_frac,
                       is_boundary=is_boundary, is_static=is_static,
                       is_rejected=is_rejected, is_tracked=is_tracked,
                       assoc_prev_sem=assoc_prev_sem)


def assign_point_labels(sem, valid, stats: ObjectStats,
                        bin_track_id: torch.Tensor) -> torch.Tensor:
    """Per-point motion labels from the per-bin decisions (-1/0/id)."""
    sem_c = torch.clamp(sem, 0, MAX_SEM - 1).to(torch.int64)
    neg = torch.full_like(sem_c, -1)
    lab = torch.where(stats.is_tracked[sem_c],
                      bin_track_id[sem_c].to(torch.int64), neg)
    lab = torch.where(stats.is_static[sem_c], torch.zeros_like(lab), lab)
    lab = torch.where(valid & (sem_c > 0), lab, neg)
    return lab.to(torch.int32)


class TrackedObject(NamedTuple):
    sem_value: int
    track_id: int


class ObjectTracker:
    """Host-side tracking-id bookkeeping (Tracking.cc:1836-1900)."""

    def __init__(self):
        self.max_id = 1
        self.prev_sem_to_id: dict[int, int] = {}
        self.first_tracked_frame = True

    def assign_ids(self, stats) -> tuple[np.ndarray, List[TrackedObject]]:
        """``stats`` holds numpy arrays (the per-frame host copy)."""
        tracked_bins = np.nonzero(np.asarray(stats.is_tracked))[0]
        assoc = np.asarray(stats.assoc_prev_sem)
        bin_track_id = np.zeros(MAX_SEM, np.int32)
        objects: List[TrackedObject] = []
        new_table: dict[int, int] = {}
        for b in tracked_bins:
            prev_lab = int(assoc[b])
            if not self.first_tracked_frame and prev_lab in self.prev_sem_to_id:
                tid = self.prev_sem_to_id[prev_lab]
            else:
                tid = self.max_id
                self.max_id += 1
            bin_track_id[b] = tid
            new_table[int(b)] = tid
            objects.append(TrackedObject(sem_value=int(b), track_id=tid))
        if len(tracked_bins) > 0:
            self.first_tracked_frame = False
        self.prev_sem_to_id = new_table
        return bin_track_id, objects

    def mark_failed(self, sem_value: int) -> None:
        """Motion estimation failed (< 50 inliers, Tracking.cc:1218-1228):
        the next frame cannot inherit this object's id."""
        self.prev_sem_to_id.pop(int(sem_value), None)
