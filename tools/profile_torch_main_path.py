"""Where the time goes on the port's main path, on one GPU.

    python tools/profile_torch_main_path.py [--frames 24]

Drives the same System run as chip_smoke.py (KAIST 1280x560 synthetic
sequence, RGBD, fused window BA), after the kernel build and a short
warm-up run, and reports:
  * per-stage wall time of ``_track_step``, mean over the tracked frames:
    each stage function is wrapped with ``torch.cuda.synchronize()`` on
    both sides, so a stage's number is its launch overhead plus its device
    time (this serialises the frame; the total is an upper bound of the
    unwrapped frame);
  * from ``torch.profiler`` over an unwrapped run: device time by kernel
    name, the number of device events per frame, and the device's busy
    share of the frames' wall time (the union of the device intervals).
Prints a JSON summary as its last line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from vido_slam_tpu_torch import tracking  # noqa: E402
from vido_slam_tpu_torch.estimation import lm_kernel  # noqa: E402
from vido_slam_tpu_torch.utils import cuda_build  # noqa: E402

STAGES = ("update_mask", "propagate_features", "estimate_camera_pose",
          "scene_flow_world", "compute_object_stats",
          "estimate_object_motions_batched", "sample_background_features",
          "sample_object_points", "renew_features", "solve_window_ba")


def _wrap(name, fn, acc):
    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        acc[name] += time.perf_counter() - t0
        return out
    return timed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--warmup", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line())
    seq = chip_smoke.offline_sequence(args.frames, "cuda")
    inputs = chip_smoke.main_path_inputs(seq, "cuda", args.frames)
    counters = [lm_kernel.pose_lm_batched]
    cuda_build.build("pose_lm")
    chip_smoke.run_main_path(inputs[:args.warmup + 1], "cuda", counters)

    # 1. per-stage times (serialised by the synchronising wrappers)
    acc = collections.defaultdict(float)
    originals = {n: getattr(tracking, n) for n in STAGES}
    for n in STAGES:
        setattr(tracking, n, _wrap(n, originals[n], acc))
    _, times, _ = chip_smoke.run_main_path(inputs, "cuda", counters)
    for n in STAGES:
        setattr(tracking, n, originals[n])
    # per tracked frame (frame 0 only initialises)
    n_tracked = len(times) - 1
    stage_ms = {n: 1e3 * acc[n] / n_tracked for n in STAGES}
    wrapped_ms = 1e3 * float(np.mean(times[1:]))

    # 2. device trace over an unwrapped run (the inputs are on the device
    # already, so every device event of the trace belongs to a frame)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, times2, _ = chip_smoke.run_main_path(inputs, "cuda", counters)
    steady = times2[1 + args.warmup:]
    wall_ms = 1e3 * float(np.sum(times2))  # every frame of the trace
    # device events only (kernels, copies, fills): op-level entries of
    # key_averages() repeat their kernels' time
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    kern = collections.defaultdict(float)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            kern[ev.name] += (ev.time_range.end - ev.time_range.start) / 1e3
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:  # union of the device intervals
        if cur_e is None or s > cur_e:
            busy_us += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_ms = (busy_us + (0.0 if cur_e is None else cur_e - cur_s)) / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:15]
    print(f"frames {args.frames}, tracked {len(times2) - 1}; ms/frame under the "
          f"profiler mean {1e3 * np.mean(steady):.2f} median "
          f"{1e3 * np.median(steady):.2f} (after {args.warmup} warm-up)")
    print(f"wrapped ms/frame {wrapped_ms:.2f}; per stage (synchronised):")
    for n in STAGES:
        print(f"  {n:34s} {stage_ms[n]:8.2f} ms")
    print(f"device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f} %), {len(spans)} device events "
          f"({len(spans) / (len(times2) - 1):.0f} per tracked frame); top "
          f"by device ms:")
    for k, v in top:
        print(f"  {v:9.3f} ms  {k[:90]}")
    print(json.dumps({
        "ms_per_frame_mean": 1e3 * float(np.mean(steady)),
        "ms_per_frame_median": 1e3 * float(np.median(steady)),
        "stage_ms": stage_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_events_per_frame": len(spans) / (len(times2) - 1),
        "top_kernels_ms": dict(top),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
