from vido_slam_tpu_torch.estimation.lm import LMResult, lm_solve  # noqa: F401
from vido_slam_tpu_torch.estimation.ransac import pnp_ransac  # noqa: F401
from vido_slam_tpu_torch.estimation.pose import (  # noqa: F401
    estimate_camera_pose,
    estimate_object_motion,
    pose_optimization,
    object_motion_optimization,
)
from vido_slam_tpu_torch.estimation.flow_joint import (  # noqa: F401
    estimate_camera_pose_joint,
    estimate_object_motion_joint,
    flow_joint_optimization,
)
