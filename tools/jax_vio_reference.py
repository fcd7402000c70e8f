"""Reference numbers of the JAX package's offline VIO row, one frame a call.

    JAX_PLATFORMS=cpu python tools/jax_vio_reference.py

Runs ``bench.run_offline_row(3, 20, False, True, scene, seq, use_imu=True)``
(the ``kaist_offline_1280x560_vio`` row with ``pipelined=False``,
``fused_ba=True``) on ``bench._offline_sequence(45)``, then repeats the
row's loop (the same tracker, the same IMU feed, all 45 frames) to find the
frame at which ``imu_initialized`` turns true, which the row does not
report. Prints one JSON line per run. ``chip_smoke.py`` phase (f) holds the
PyTorch port to the loop's numbers. About 1.5 minutes on 8 CPU cores.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from vido_slam_tpu.io.synthetic import driving_imu  # noqa: E402
from vido_slam_tpu.metrics import (ate_rmse, camera_centers,  # noqa: E402
                                   umeyama_alignment)
from vido_slam_tpu.system import ImuPoint  # noqa: E402
from vido_slam_tpu.tracking import Tracker  # noqa: E402


def init_frame_loop(seq):
    """The row's tracker and IMU feed over every frame of ``seq``."""
    tracker = Tracker(bench.make_offline_config(), n_bg=3000, n_obj=4000,
                      max_objects=8, seed=0, local_ba=True,
                      ba_max_points=1000, ba_iters=10, pipelined=False,
                      fused_ba=True, use_imu=True,
                      lm_pallas=bench._lm_pallas_flag())
    clock, init_frame = 0.0, None
    for i, f in enumerate(seq.frames):
        t = i / 10.0
        ts = np.arange(clock + 1.0 / 200.0, t + 1e-9, 1.0 / 200.0)
        if len(ts):
            acc, gyro = driving_imu(ts)
            tracker.grab_imu_data([ImuPoint(a=acc[k], w=gyro[k], t=float(x))
                                   for k, x in enumerate(ts)])
            clock = float(ts[-1])
        tracker.track(jnp.asarray(f.depth), jnp.asarray(f.flow),
                      jnp.asarray(f.mask, jnp.int32), timestamp=t)
        if tracker.imu_initialized and init_frame is None:
            init_frame = i
    gt = np.stack([f.Tcw_gt for f in seq.frames])
    est = tracker.map.poses
    c = camera_centers(gt.astype(np.float64))
    _, _, s_fit = umeyama_alignment(camera_centers(est), camera_centers(gt),
                                    with_scale=True)
    return {"frames": len(seq.frames), "init_frame": init_frame,
            "imu_init_attempts": tracker.imu_init_attempts,
            "imu_scale": float(tracker.imu_scale),
            "scale_vs_gt": 1.0 / s_fit,
            "ate_rmse_m": ate_rmse(est, gt, align=False),
            "ate_se3_aligned_m": ate_rmse(est, gt, align=True),
            "ate_sim3_aligned_m": ate_rmse(est, gt, align=True,
                                           with_scale=True),
            "traj_len_m": float(np.linalg.norm(np.diff(c, axis=0),
                                               axis=1).sum())}


def main():
    scene, seq = bench._offline_sequence(45)
    print(json.dumps({"loop": init_frame_loop(seq)}), flush=True)
    row = bench.run_offline_row(3, 20, False, True, scene, seq, use_imu=True)
    print(json.dumps({"row": row}), flush=True)


if __name__ == "__main__":
    main()
