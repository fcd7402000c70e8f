"""vido_slam_tpu_torch — the PyTorch + CUDA port of ``vido_slam_tpu`` for one
NVIDIA H100 (sm_90a).

The port stands alone: it imports torch, numpy, yaml and the standard
library, never JAX and never ``vido_slam_tpu``. Ported so far is the offline
VO main path, ``System.TrackRGBD`` -> ``Tracker.track`` -> ``_track_step``
with the fused window BA, and its one TPU kernel, the batched pose LM, as
the CUDA kernel ``csrc/pose_lm.cu``.

- ``geometry``   : SO(3)/SE(3) and the pinhole camera.
- ``frontend``   : feature sampling, mask repair, scene flow, object stats.
- ``estimation`` : RANSAC, the LM kernel and its plain version, pose
                   estimation, the window BA.
- ``io``         : result writers and the synthetic sequence renderer.
- ``utils``      : threefry PRNG bit-equal to ``jax.random``, stable order
                   helpers, device choice, the kernel build.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
