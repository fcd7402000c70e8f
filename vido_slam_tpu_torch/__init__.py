"""vido_slam_tpu_torch — the PyTorch + CUDA port of ``vido_slam_tpu`` for one
NVIDIA H100 (sm_90a).

The port stands alone: it imports torch, numpy, scipy, yaml and the
standard library, never JAX and never ``vido_slam_tpu``. Ported so far:
the offline path ``System.TrackRGBD`` -> ``Tracker.track`` ->
``_track_step`` (VO with either window BA, the bJoint mode, and VIO with
the IMU preintegration and the staged inertial init), FAST features, the
perception graph (MonoDepth2, LiteFlowNet, Mask R-CNN as
``PerceptionModel``) and the online path ``System.TrackFrames`` ->
``Tracker.track_frames``, the offline demo from files (``run_vido``, the
dataset readers without cv2, the KITTI StopFrame full batch), and weights
and sessions in and out (``.npz`` bundles, ``from_pretrained``, the
Detectron caffe2 loader, session resume). All five TPU kernels are
rewritten as CUDA kernels in ``csrc/``: the batched pose LM, the joint
flow + pose solve, LiteFlowNet's cost volume and its regularization tail,
and the FPN multilevel ROIAlign.

- ``geometry``   : SO(3)/SE(3) and the pinhole camera.
- ``frontend``   : feature sampling, mask repair, scene flow, object stats.
- ``estimation`` : RANSAC, the LM kernels and their plain versions, pose
                   estimation, the window BA, the full batch, the generic
                   LM / GaussNewton / Dogleg and the inertial init.
- ``imu``        : IMU preintegration.
- ``models``     : MonoDepth2, LiteFlowNet, Mask R-CNN
                   (``models/maskrcnn``, with the caffe2 loader), their
                   layers and the perception model.
- ``ops``        : warps and resizing, FAST corners, ORB, NMS and box
                   utilities, the cost-volume, regularization and ROIAlign
                   kernels and their plain versions.
- ``io``         : the dataset readers and PNG decoder, ground-truth poses,
                   result writers and the synthetic renderers.
- ``utils``      : threefry PRNG bit-equal to ``jax.random``, stable order
                   helpers, device choice, the kernel and host builds,
                   checkpoints and sessions.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
