"""Global map store — the reference's `Map` (vido_slam/include/Map.h:44-91)
re-shaped for array-first access.

The reference keeps per-frame vectors of features/depths/3D points/motions in
all-public std::vectors. Here each frame contributes one `FrameRecord` of
fixed-shape numpy arrays (device arrays are pulled off-device once per frame,
off the critical path), and slot indices double as tracklet identities:
`stat_is_new[i]==False` links slot i of frame t to slot i of frame t-1 —
which is exactly the information `GetStaticTrack`/`GetDynamicTrackNew`
(Tracking.cc:2514-2957) reconstructs from correspondence indices.

`apply_scaled_rotation` mirrors Map::ApplyScaledRotation (Map.cc:57-120):
gravity-aligns and rescales every pose/point/velocity after IMU init.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ObjectObservation:
    """Per-frame record of one tracked dynamic object."""

    track_id: int
    sem_value: int
    motion: np.ndarray          # (4, 4) world-frame SE(3) motion H
    speed_kmh: float
    centroid: np.ndarray        # (3,) pre-frame centroid in world
    num_inliers: int
    status: bool                # bObjStat: False if estimation failed


@dataclasses.dataclass
class FrameRecord:
    frame_id: int
    timestamp: float
    Tcw: np.ndarray                    # (4, 4) estimated pose (world->cam)
    Tcw_gt: Optional[np.ndarray]       # ground truth if available
    # static background features (N_BG slots)
    stat_uv: np.ndarray                # (N, 2)
    stat_depth: np.ndarray             # (N,)
    stat_valid: np.ndarray             # (N,) bool
    stat_is_new: np.ndarray            # (N,) bool — True: track starts here
    stat_3d: np.ndarray                # (N, 3) world points
    # object features (N_OBJ slots)
    obj_uv: np.ndarray
    obj_depth: np.ndarray
    obj_valid: np.ndarray
    obj_is_new: np.ndarray
    obj_sem: np.ndarray                # (N,) semantic value
    obj_label: np.ndarray              # (N,) motion label (-1/0/track_id)
    obj_3d: np.ndarray                 # (N, 3) world points
    objects: List[ObjectObservation] = dataclasses.field(default_factory=list)
    timing: Dict[str, float] = dataclasses.field(default_factory=dict)
    # measured camera motion Twc_{t-1}^-1 Twc_t at tracking time (None for
    # frame 0); the window-BA odometry measurement (vmRigidMotion[i][0])
    cam_motion: Optional[np.ndarray] = None
    # raw GT object-pose rows for this frame (the TrackRGBD vObjPose_gt
    # argument, stored verbatim for metric evaluation)
    obj_gt: Optional[np.ndarray] = None


class SlamMap:
    def __init__(self):
        self.frames: List[FrameRecord] = []
        # refined (full-batch) outputs, written by FullBatchOptimization
        self.refined_poses: Optional[np.ndarray] = None
        self.refined_motions: Dict[int, Dict[int, np.ndarray]] = {}
        self.lba_time: List[float] = []

    def add_frame(self, rec: FrameRecord) -> None:
        self.frames.append(rec)

    def __len__(self) -> int:
        return len(self.frames)

    @property
    def poses(self) -> np.ndarray:
        return np.stack([f.Tcw for f in self.frames])

    @property
    def gt_poses(self) -> Optional[np.ndarray]:
        if any(f.Tcw_gt is None for f in self.frames):
            return None
        return np.stack([f.Tcw_gt for f in self.frames])

    def object_motions(self, track_id: int) -> Dict[int, np.ndarray]:
        """frame_id -> world-frame motion H for one object track."""
        out = {}
        for f in self.frames:
            for ob in f.objects:
                if ob.track_id == track_id and ob.status:
                    out[f.frame_id] = ob.motion
        return out

    def object_track_times(self) -> Dict[int, int]:
        """track_id -> number of frames the object was successfully tracked
        (Tracking::GetObjTrackTime -> Map::vnObjTraTime,
        Tracking.cc:2722-2780): the full-batch optimizer uses these counts
        to weight/gate motion vertices."""
        out: Dict[int, int] = {}
        for f in self.frames:
            for ob in f.objects:
                if ob.status:
                    out[ob.track_id] = out.get(ob.track_id, 0) + 1
        return out

    def track_ids(self) -> List[int]:
        ids = []
        for f in self.frames:
            for ob in f.objects:
                if ob.status and ob.track_id not in ids:
                    ids.append(ob.track_id)
        return ids

    def apply_scaled_rotation(self, Ryw: np.ndarray, scale: float) -> None:
        """Map::ApplyScaledRotation (Map.cc:57-120): for every frame, rotate
        the world frame by Ryw (gravity alignment) and scale translations and
        points: Tcw' has Rcw' = Rcw*Ryw^T, tcw' = s*tcw (rotation of the
        world basis with uniform rescale)."""
        Ryw = np.asarray(Ryw, np.float64)
        for f in self.frames:
            Tcw = np.asarray(f.Tcw, np.float64)
            Rcw, tcw = Tcw[:3, :3], Tcw[:3, 3]
            Tcw_new = np.eye(4)
            Tcw_new[:3, :3] = Rcw @ Ryw.T
            Tcw_new[:3, 3] = scale * tcw
            f.Tcw = Tcw_new.astype(np.float32)
            f.stat_3d = (scale * (f.stat_3d @ Ryw.T)).astype(np.float32)
            f.obj_3d = (scale * (f.obj_3d @ Ryw.T)).astype(np.float32)
            f.stat_depth = (scale * f.stat_depth).astype(np.float32)
            f.obj_depth = (scale * f.obj_depth).astype(np.float32)
            for ob in f.objects:
                H = np.asarray(ob.motion, np.float64)
                Hn = np.eye(4)
                Hn[:3, :3] = Ryw @ H[:3, :3] @ Ryw.T
                Hn[:3, 3] = scale * (Ryw @ H[:3, 3])
                ob.motion = Hn.astype(np.float32)
                ob.centroid = (scale * (Ryw @ ob.centroid)).astype(np.float32)
