"""Result writers — System::SaveResultsIJRR2020 (reference
vido_slam/src/System.cc:80-240) formats, bit-compatible:

  obj_mot_rgbd_new.txt / obj_mot_gt.txt : "<frame+1> <label> <12 pose floats> 0 0 0 1"
  initial_rgbd_new.txt / refined_rgbd_new.txt / cam_pose_gt.txt :
      "<frame> <12 pose floats> 0 0 0 1"   (poses are Twc = inv(Tcw))
plus the per-stage mean timing printout (System.cc:200-233).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from vido_slam_tpu_torch.slam_map import SlamMap


def _fmt_pose(T: np.ndarray) -> str:
    v = np.asarray(T, np.float64)
    cells = [f"{v[r, c]:.9f}" for r in range(3) for c in range(4)]
    return " ".join(cells) + " 0.000000000 0.000000000 0.000000000 1.000000000"


def _write_trajectory(path: str, poses_cw: List[np.ndarray], invert: bool = True):
    with open(path, "w") as f:
        for i, T in enumerate(poses_cw):
            Twc = np.linalg.inv(T) if invert else T
            f.write(f"{i} {_fmt_pose(Twc)}\n")


def save_results_ijrr2020(slam_map: SlamMap, prefix: str,
                          timing_summary: bool = True) -> Dict[str, float]:
    """Write all result files with the given path prefix; returns the mean
    per-stage timings (also printed, like the reference)."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)

    # object motions (frame index offset +1, System.cc:102)
    with open(prefix + "obj_mot_rgbd_new.txt", "w") as f, \
            open(prefix + "obj_mot_gt.txt", "w") as fg:
        for i, rec in enumerate(slam_map.frames):
            for ob in rec.objects:
                if not ob.status:
                    continue
                f.write(f"{i + 1} {ob.track_id} {_fmt_pose(ob.motion)}\n")
                if getattr(ob, "motion_gt", None) is not None:
                    fg.write(f"{i + 1} {ob.track_id} {_fmt_pose(ob.motion_gt)}\n")

    _write_trajectory(prefix + "initial_rgbd_new.txt",
                      [r.Tcw for r in slam_map.frames])
    refined = (
        slam_map.refined_poses
        if slam_map.refined_poses is not None
        else [r.Tcw for r in slam_map.frames]
    )
    _write_trajectory(prefix + "refined_rgbd_new.txt", list(refined))
    gts = [r.Tcw_gt for r in slam_map.frames if r.Tcw_gt is not None]
    if gts:
        _write_trajectory(prefix + "cam_pose_gt.txt", gts)

    # timing summary
    keys = ["mask_update", "cam_pose", "obj_track", "obj_motion", "map_update",
            "track_step"]
    sums: Dict[str, float] = {k: 0.0 for k in keys}
    counts: Dict[str, int] = {k: 0 for k in keys}
    for rec in slam_map.frames:
        for k, v in rec.timing.items():
            if k in sums:
                sums[k] += v
                counts[k] += 1
    means = {k: (sums[k] / counts[k] if counts[k] else 0.0) for k in keys}
    if slam_map.lba_time:
        means["local_ba"] = float(np.mean(slam_map.lba_time))
    if timing_summary:
        parts = [f"{k}: {1000 * v:.2f}ms" for k, v in means.items() if v > 0]
        print("Time of all components: " + " ".join(parts))
    return means
