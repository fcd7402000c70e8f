"""Public System facade — the ``libvido_slam.so`` API (System.h) for the
offline VO path; counterpart of ``vido_slam_tpu/system.py``:
Init / init_from_config, TrackRGBD with an RGBD sensor, GetFrameOutput and
SaveResultsIJRR2020. Depth preprocessing (raw value -> metric, per dataset)
happens here, as in Tracking::GrabImageRGBD (Tracking.cc:299-322).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence

import numpy as np
import torch

from vido_slam_tpu_torch.config import Config, load_config
from vido_slam_tpu_torch.geometry.camera import convert_depth
from vido_slam_tpu_torch.io.results import save_results_ijrr2020
from vido_slam_tpu_torch.tracking import Tracker, _not_ported
from vido_slam_tpu_torch.utils.verbose import Verbose


class Sensor(enum.IntEnum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_RGBD = 3


@dataclasses.dataclass
class SceneObject:
    """System.h:52-66 / OutPut.h:13-32."""

    pose: np.ndarray
    velocity: np.ndarray
    speed_kmh: float
    yaw: float
    label_index: int
    label: str
    tracking_id: int


@dataclasses.dataclass
class FrameOutput:
    """OutPut.h:35-72."""

    frame_id: int
    timestamp: float
    camera_pose: np.ndarray
    camera_position: np.ndarray
    objects: List[SceneObject] = dataclasses.field(default_factory=list)


COCO_LABELS = [
    "__background", "person", "bicycle", "car", "motorcycle", "airplane",
    "bus", "train", "truck", "boat", "traffic light", "fire hydrant",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv", "laptop",
    "mouse", "remote", "keyboard", "cell phone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "book", "clock", "vase", "scissors",
    "teddy bear", "hair drier", "toothbrush",
]


class System:
    """Facade owning the tracker."""

    def __init__(self):
        self._initialized = False
        self.tracker: Optional[Tracker] = None
        self.sensor = Sensor.RGBD
        self.config: Optional[Config] = None

    def Init(self, settings_file: str, sensor: Sensor, *, device=None,
             **tracker_kwargs) -> None:
        self.init_from_config(load_config(settings_file), sensor,
                              device=device, **tracker_kwargs)

    def init_from_config(self, config: Config, sensor: Sensor, *,
                         device=None, **tracker_kwargs) -> None:
        """``device``: ``None`` (the card) or e.g. ``"cpu"``."""
        if Sensor(sensor) == Sensor.IMU_RGBD:
            raise _not_ported("the IMU_RGBD sensor (VIO)", 17)
        self.config = config
        self.sensor = Sensor(sensor)
        self.tracker = Tracker(config, device=device, **tracker_kwargs)
        self._initialized = True
        Verbose.print_mess(f"System initialized ({self.tracker.device})")

    def TrackRGBD(self, im: Optional[np.ndarray], depth_raw, flow, masksem,
                  mTcw_gt: Optional[np.ndarray] = None,
                  vObjPose_gt: Optional[Sequence] = None,
                  timestamp: Optional[float] = None,
                  imu_measurements=None,
                  nImage: Optional[int] = None) -> np.ndarray:
        """Process one frame; returns Tcw (4, 4). ``depth_raw`` is the raw
        network/stereo value; ``im`` selects FAST features when the config
        asks for them (not ported)."""
        if not self._initialized:
            raise RuntimeError("call Init or init_from_config first")
        if imu_measurements:
            raise _not_ported("IMU measurements (VIO)", 17)
        cfg = self.config
        if not isinstance(depth_raw, torch.Tensor):
            depth_raw = torch.as_tensor(np.asarray(depth_raw, np.float32))
        depth = convert_depth(
            depth_raw.to(device=self.tracker.device, dtype=torch.float32),
            cfg.system.dataset, cfg.system.depth_map_factor, cfg.camera.bf)
        gray = None
        if im is not None:
            im = np.asarray(im)
            gray = im.mean(axis=-1) if im.ndim == 3 else im
        Tcw = self.tracker.track(depth, flow, masksem, Tcw_gt=mTcw_gt,
                                 timestamp=timestamp, image=gray)
        if vObjPose_gt is not None and len(self.tracker.map):
            self.tracker.map.frames[-1].obj_gt = np.asarray(vObjPose_gt)
        if (nImage is not None and len(self.tracker.map) >= nImage
                and cfg.system.choose_data == 2):
            self.tracker.run_full_batch()
        return Tcw

    def GetFrameOutput(self, frame_index: int = -1) -> FrameOutput:
        rec = self.tracker.map.frames[frame_index]
        Twc = np.linalg.inv(rec.Tcw)
        objs = []
        for ob in rec.objects:
            if not ob.status:
                continue
            H = ob.motion
            label_idx = int(ob.sem_value)
            objs.append(SceneObject(
                pose=ob.centroid.copy(),
                velocity=H[:3, 3] - (np.eye(3) - H[:3, :3]) @ ob.centroid,
                speed_kmh=ob.speed_kmh,
                yaw=float(np.arctan2(H[0, 2], H[2, 2])),
                label_index=label_idx,
                label=(COCO_LABELS[label_idx] if label_idx < len(COCO_LABELS)
                       else str(label_idx)),
                tracking_id=ob.track_id))
        return FrameOutput(frame_id=rec.frame_id, timestamp=rec.timestamp,
                           camera_pose=rec.Tcw.copy(),
                           camera_position=Twc[:3, 3].copy(), objects=objs)

    def AttachPerception(self, perception_model) -> None:
        raise _not_ported("AttachPerception (online perception)", 15)

    def SaveResultsIJRR2020(self, filename: str) -> None:
        self.tracker.finish()
        save_results_ijrr2020(self.tracker.map, filename)

    @property
    def map(self):
        return self.tracker.map
