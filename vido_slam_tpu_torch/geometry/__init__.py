from vido_slam_tpu_torch.geometry import so3, se3, camera  # noqa: F401
from vido_slam_tpu_torch.geometry.so3 import (  # noqa: F401
    hat, vee, exp_so3, log_so3, right_jacobian_so3, right_jacobian_inv_so3,
    normalize_rotation,
)
from vido_slam_tpu_torch.geometry.se3 import (  # noqa: F401
    exp_se3, log_se3, inverse_se3, compose, transform_points, adjoint_se3,
)
from vido_slam_tpu_torch.geometry.camera import Camera  # noqa: F401
