"""Configuration: every key of the reference's OpenCV-YAML configs.

Parses the reference config format (src/config/kaist_config.yaml /
kitti_config.yaml — OpenCV FileStorage YAML with ``%YAML:1.0`` header and
``!!opencv-matrix`` tags) into plain dataclasses. Key semantics follow the
parse sites in vido_slam/src/Tracking.cc:43-275 and demo/utils.h:16-28.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import yaml

# ChooseData selector (Tracking.cc / SURVEY §5): 1 OMD, 2 KITTI, 3 KAIST
DATASET_NAMES = {1: "omd", 2: "kitti", 3: "kaist"}


@dataclasses.dataclass
class CameraConfig:
    width: int = 1280
    height: int = 560
    fx: float = 816.402
    fy: float = 817.38
    cx: float = 608.2658
    cy: float = 266.688
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 10.0
    bf: float = 387.57
    rgb: int = 0  # 0: BGR, 1: RGB

    @property
    def dist(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.p1, self.p2, self.k3], np.float32)


@dataclasses.dataclass
class OrbConfig:
    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7


@dataclasses.dataclass
class ImuConfig:
    # Tbc: camera->body transform (4x4); noise densities; rate
    Tbc: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))
    noise_gyro: float = 0.001561
    noise_acc: float = 0.0007
    gyro_walk: float = 0.000058
    acc_walk: float = 0.0003
    frequency: float = 200.0


@dataclasses.dataclass
class SystemConfig:
    choose_data: int = 3  # 1 OMD, 2 KITTI, 3 KAIST
    depth_map_factor: float = 500.0
    th_depth_bg: float = 80.0
    th_depth_obj: float = 60.0
    max_track_points_bg: int = 3000
    max_track_points_obj: int = 800
    sf_mg_thres: float = 0.12  # scene-flow magnitude threshold
    sf_ds_thres: float = 0.3  # scene-flow distribution threshold
    window_size: int = 20
    overlap_size: int = 4
    use_sample_feature: bool = False

    @property
    def dataset(self) -> str:
        return DATASET_NAMES.get(self.choose_data, "kaist")


@dataclasses.dataclass
class DemoConfig:
    # demo/utils.h:16-28
    slam_mode: int = 0  # 0: vo, 1: vio
    image_path: str = ""
    imu_path: str = ""
    start_index: int = 0


@dataclasses.dataclass
class Config:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: OrbConfig = dataclasses.field(default_factory=OrbConfig)
    imu: ImuConfig = dataclasses.field(default_factory=ImuConfig)
    system: SystemConfig = dataclasses.field(default_factory=SystemConfig)
    demo: DemoConfig = dataclasses.field(default_factory=DemoConfig)
    car_model: str = ""
    font_path: str = ""
    raw: dict = dataclasses.field(default_factory=dict)


_OPENCV_MAT_RE = re.compile(r"!!opencv-matrix")


def _parse_opencv_yaml(text: str) -> dict:
    """Parse OpenCV FileStorage YAML into a flat dict."""
    lines = text.splitlines()
    if lines and lines[0].startswith("%YAML"):
        lines = lines[1:]
    cleaned = _OPENCV_MAT_RE.sub("", "\n".join(lines))
    return yaml.safe_load(cleaned) or {}


def _mat_from_node(node) -> np.ndarray:
    rows, cols = int(node["rows"]), int(node["cols"])
    return np.asarray(node["data"], dtype=np.float32).reshape(rows, cols)


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        raw = _parse_opencv_yaml(f.read())
    return config_from_dict(raw)


def config_from_dict(raw: dict) -> Config:
    g = raw.get  # noqa: E731
    cam = CameraConfig(
        width=int(g("Camera.width", 1280)),
        height=int(g("Camera.height", 560)),
        fx=float(g("Camera.fx", 816.402)),
        fy=float(g("Camera.fy", 817.38)),
        cx=float(g("Camera.cx", 608.2658)),
        cy=float(g("Camera.cy", 266.688)),
        k1=float(g("Camera.k1", 0.0)),
        k2=float(g("Camera.k2", 0.0)),
        p1=float(g("Camera.p1", 0.0)),
        p2=float(g("Camera.p2", 0.0)),
        k3=float(g("Camera.k3", 0.0)),
        fps=float(g("Camera.fps", 10.0)),
        bf=float(g("Camera.bf", 387.57)),
        rgb=int(g("Camera.RGB", 0)),
    )
    orb = OrbConfig(
        n_features=int(g("ORBextractor.nFeatures", 2000)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    imu = ImuConfig(
        noise_gyro=float(g("IMU.NoiseGyro", 0.001561)),
        noise_acc=float(g("IMU.NoiseAcc", 0.0007)),
        gyro_walk=float(g("IMU.GyroWalk", 0.000058)),
        acc_walk=float(g("IMU.AccWalk", 0.0003)),
        frequency=float(g("IMU.Frequency", 200.0)),
    )
    if isinstance(g("Tbc"), dict):
        imu.Tbc = _mat_from_node(raw["Tbc"])
    system = SystemConfig(
        choose_data=int(g("ChooseData", 3)),
        depth_map_factor=float(g("DepthMapFactor", 500.0)),
        th_depth_bg=float(g("ThDepthBG", 80.0)),
        th_depth_obj=float(g("ThDepthOBJ", 60.0)),
        max_track_points_bg=int(g("MaxTrackPointBG", 3000)),
        max_track_points_obj=int(g("MaxTrackPointOBJ", 800)),
        sf_mg_thres=float(g("SFMgThres", 0.12)),
        sf_ds_thres=float(g("SFDsThres", 0.3)),
        window_size=int(g("WINDOW_SIZE", 20)),
        overlap_size=int(g("OVERLAP_SIZE", 4)),
        use_sample_feature=bool(int(g("UseSampleFeature", 0))),
    )
    demo = DemoConfig(
        slam_mode=int(g("slam_mode", 0)),
        image_path=str(g("image_path", "")),
        imu_path=str(g("imu_path", "")),
        start_index=int(g("start_index", 0)),
    )
    return Config(
        camera=cam,
        orb=orb,
        imu=imu,
        system=system,
        demo=demo,
        car_model=str(g("CarModel", "")),
        font_path=str(g("FontPath", "")),
        raw=raw,
    )
