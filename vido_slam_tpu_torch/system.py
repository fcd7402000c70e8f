"""Public System facade — the ``libvido_slam.so`` API (System.h);
counterpart of ``vido_slam_tpu/system.py``: Init / init_from_config,
TrackRGBD with an RGBD or IMU_RGBD sensor (offline: depth, flow and mask
given; IMU samples as ``ImuPoint``s or, in TrackRGBDWithIMUArray, as rows),
AttachPerception, TrackFrames and TrackFramesPair (online: raw BGR frames
through the three networks, one or two frames a call), GetFrameOutput and
SaveResultsIJRR2020. An IMU_RGBD system
queues the samples in the tracker before the visual update (System.cc:
51-78). Depth preprocessing (raw value -> metric, per dataset, at the
current IMU scale) happens here for TrackRGBD, as in
Tracking::GrabImageRGBD (Tracking.cc:299-322).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from vido_slam_tpu_torch.config import Config, load_config
from vido_slam_tpu_torch.geometry.camera import convert_depth
from vido_slam_tpu_torch.io.results import save_results_ijrr2020
from vido_slam_tpu_torch.tracking import Tracker
from vido_slam_tpu_torch.utils.verbose import Verbose


class Sensor(enum.IntEnum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_RGBD = 3


class ImuPoint(NamedTuple):
    """IMU::Point (ImuTypes.h:32-43): accelerometer, gyro, timestamp."""

    a: np.ndarray  # (3,)
    w: np.ndarray  # (3,)
    t: float


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
    """Facade owning the tracker (and, with IMU_RGBD, the IMU path)."""

    def __init__(self):
        self._initialized = False
        self.tracker: Optional[Tracker] = None
        self.sensor = Sensor.RGBD
        self.config: Optional[Config] = None
        self.scale = 1.0  # mScale: updated by the IMU init

    def Init(self, settings_file: str, sensor: Sensor, *, device=None,
             **tracker_kwargs) -> None:
        self.init_from_config(load_config(settings_file), sensor,
                              device=device, **tracker_kwargs)

    def init_from_config(self, config: Config, sensor: Sensor, *,
                         device=None, **tracker_kwargs) -> None:
        """``device``: ``None`` (the card) or e.g. ``"cpu"``. IMU_RGBD builds
        the tracker with VIO on, from the config's IMU section."""
        self.config = config
        self.sensor = Sensor(sensor)
        self.tracker = Tracker(config, device=device,
                               use_imu=self.sensor == Sensor.IMU_RGBD,
                               **tracker_kwargs)
        self._initialized = True
        Verbose.print_mess(f"System initialized ({self.tracker.device})")

    def TrackRGBD(self, im: Optional[np.ndarray], depth_raw, flow, masksem,
                  mTcw_gt: Optional[np.ndarray] = None,
                  vObjPose_gt: Optional[Sequence] = None,
                  timestamp: Optional[float] = None,
                  imu_measurements=None,
                  nImage: Optional[int] = None):
        """Process one frame; returns Tcw (4, 4), pipelined as the state's
        device tensor (``Tracker.track``). ``depth_raw`` is the raw
        network/stereo value, converted at the current IMU scale; ``im``
        (its channel mean) feeds FAST when the config asks for it
        (UseSampleFeature=0). Only an IMU_RGBD system reads
        ``imu_measurements`` (``ImuPoint``s); an RGBD one ignores them."""
        if not self._initialized:
            raise RuntimeError("call Init or init_from_config first")
        cfg = self.config
        if not isinstance(depth_raw, torch.Tensor):
            depth_raw = torch.as_tensor(np.asarray(depth_raw, np.float32))
        depth = convert_depth(
            depth_raw.to(device=self.tracker.device, dtype=torch.float32),
            cfg.system.dataset, cfg.system.depth_map_factor, cfg.camera.bf,
            scale=self.scale)
        self._grab_imu(imu_measurements)
        gray = None
        if im is not None:
            im = np.asarray(im)
            gray = im.mean(axis=-1) if im.ndim == 3 else im
        Tcw = self.tracker.track(depth, flow, masksem, Tcw_gt=mTcw_gt,
                                 timestamp=timestamp, image=gray)
        self.scale = self.tracker.imu_scale
        if vObjPose_gt is not None and len(self.tracker.map):
            self.tracker.map.frames[-1].obj_gt = np.asarray(vObjPose_gt)
        if (nImage is not None and len(self.tracker.map) >= nImage
                and cfg.system.choose_data == 2):
            # KITTI StopFrame: the full batch over the whole trajectory.
            # Pipelined, the map lags a frame, so this never fires on the
            # last frame, as in the JAX package
            self.tracker.finish()
            self.tracker.run_full_batch()
            Verbose.print_mess("FullBatchOptimization done (StopFrame)")
        return Tcw

    def _grab_imu(self, imu_measurements) -> None:
        if self.sensor == Sensor.IMU_RGBD and imu_measurements:
            self.tracker.grab_imu_data(imu_measurements)

    def TrackRGBDWithIMUArray(self, im, depth_raw, flow, masksem, mTcw_gt,
                              timestamp, imu_rows=None,
                              nImage: Optional[int] = None):
        """The TrackRGBD VIO overload (System.h:98-100) with the IMU samples
        as an (N, 7) float64 array of rows (ax, ay, az, wx, wy, wz, t), as
        the native C ABI passes them."""
        meas = None
        if imu_rows is not None and len(imu_rows):
            arr = np.asarray(imu_rows, np.float64).reshape(-1, 7)
            meas = [ImuPoint(a=row[0:3].astype(np.float32),
                             w=row[3:6].astype(np.float32), t=float(row[6]))
                    for row in arr]
        return self.TrackRGBD(im, depth_raw, flow, masksem, mTcw_gt, None,
                              timestamp, imu_measurements=meas, nImage=nImage)

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

    def GetFrameOutputArray(self, frame_index: int = -1) -> np.ndarray:
        """Per-frame scene objects as (N, 10) float64 rows:
        [tracking_id, label_index, pos_xyz, vel_xyz, yaw, speed_kmh]."""
        out = self.GetFrameOutput(frame_index)
        rows = [[float(o.tracking_id), float(o.label_index),
                 *np.asarray(o.pose, np.float64),
                 *np.asarray(o.velocity, np.float64),
                 float(o.yaw), float(o.speed_kmh)] for o in out.objects]
        return np.asarray(rows, np.float64).reshape(-1, 10)

    def AttachPerception(self, perception_model) -> None:
        """Bind a ``PerceptionModel`` for ``TrackFrames``: the dataset's
        depth conversion at base scale 1.0 (system.py:209-217)."""
        if not self._initialized:
            raise RuntimeError("call Init or init_from_config first")
        cfg = self.config
        self.tracker.attach_perception(
            perception_model, cfg.system.dataset,
            cfg.system.depth_map_factor, cfg.camera.bf, scale=1.0)

    def TrackFrames(self, prev_bgr, cur_bgr, mTcw_gt=None, timestamp=None,
                    imu_measurements=None):
        """One frame from raw (H, W, 3) BGR frames in 0..255 (prev, cur)
        through perception and tracking; returns Tcw (4, 4), pipelined as
        the state's device tensor. The depth
        converts at the IMU scale; an RGBD system ignores
        ``imu_measurements``, as ``TrackRGBD`` does."""
        if not self._initialized:
            raise RuntimeError("call Init or init_from_config first")
        self._grab_imu(imu_measurements)
        Tcw = self.tracker.track_frames(prev_bgr, cur_bgr, Tcw_gt=mTcw_gt,
                                        timestamp=timestamp)
        self.scale = self.tracker.imu_scale
        return Tcw

    def TrackFramesPair(self, f0, f1, f2, mTcw_gt=None,
                        imu_measurements=None, timestamps=None):
        """Two frames a call (``Tracker.track_frames_pair``; needs
        ``pipelined=True, fused_ba=True``); returns the state's device
        tensor Tcw. ``timestamps``: the two frames' (tA, tB), to pass
        wherever the IMU samples carry a real clock."""
        if not self._initialized:
            raise RuntimeError("call Init or init_from_config first")
        self._grab_imu(imu_measurements)
        Tcw = self.tracker.track_frames_pair(f0, f1, f2, Tcw_gt=mTcw_gt,
                                             timestamps=timestamps)
        self.scale = self.tracker.imu_scale
        return Tcw

    def SaveResultsIJRR2020(self, filename: str) -> None:
        self.tracker.finish()
        save_results_ijrr2020(self.tracker.map, filename)

    @property
    def map(self):
        return self.tracker.map
