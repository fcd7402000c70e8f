"""Where the time goes on the port's main path, on one GPU.

    python tools/profile_torch_main_path.py [--frames 24]
    python tools/profile_torch_main_path.py --flow [--frames 9]
    python tools/profile_torch_main_path.py --mask [--frames 8]
    python tools/profile_torch_main_path.py --online [--frames 24]

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
With ``--flow`` it drives chip_smoke.py's flow path instead (the
perception flow branch over consecutive 1280x560 driving-clip pairs, the
net at 1280x576) and reports the same for it, per pair: the wall time of
the encoder and of each level's Matching, Subpixel and Regularization
(synchronised the same way), and the device trace of an unwrapped run.
With ``--mask`` it drives chip_smoke.py's mask path (the perception mask
branch with Mask R-CNN R-50-FPN over 1280x560 driving-clip frames, the
detector at 1088x800) and reports per frame the wall time of the backbone,
the FPN, the RPN with its NMS, the box head, the post-processing, the
mask head and the paste (synchronised the same way), and the device trace
of an unwrapped run.
With ``--online`` it drives chip_smoke.py's online path (System.TrackFrames
over the 640x192 bench clip: MonoDepth2, LiteFlowNet, Mask R-CNN R-50-FPN
at 544x800, FAST, the fused window BA) and reports the wall time of the
depth, flow and mask branches per call, and of FAST, the tracking step,
its stages and the host's record per tracked call (synchronised the same
way; the first call's sampling counts in the samplers' rows), and the
device trace of an unwrapped run.
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


def device_trace(run):
    """Runs ``run()`` under torch.profiler. Returns its result, the sorted
    device intervals, device ms by kernel name and the device's busy ms
    (the union of the intervals). Device events only (kernels, copies,
    fills): op-level entries of key_averages() repeat their kernels'
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
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
    return out, spans, kern, busy_ms


def profile_flow(n_frames):
    """The flow path: per-module synchronised wall time per pair, then the
    device trace of an unwrapped run, after one warm-up run."""
    from vido_slam_tpu_torch.models import liteflownet
    from vido_slam_tpu_torch.ops import correlation, regularize

    counters = [correlation.correlation, regularize.dist_weighted_flow]
    chip_smoke.FLOW_PAIRS = n_frames - 1
    clip, net = chip_smoke.flow_inputs("cuda")
    chip_smoke.run_flow_path(clip, net, counters)       # build, warm-up
    acc = collections.defaultdict(float)
    modules = {"encoder": liteflownet.Features}
    for name in ("Matching", "Subpixel", "Regularization"):
        modules[name] = getattr(liteflownet, name)
    originals = {n: m.forward for n, m in modules.items()}

    def per_level(name, fn):
        def timed(self, *a):
            key = name if name == "encoder" else f"{name} L{self.level}"
            return _wrap(key, lambda *b: fn(self, *b), acc)(*a)
        return timed

    for n, m in modules.items():
        m.forward = per_level(n, originals[n])
    try:
        _, wrapped, _ = chip_smoke.run_flow_path(clip, net, counters)
    finally:
        for n, m in modules.items():
            m.forward = originals[n]
    n_pairs = len(wrapped)
    module_ms = {k: 1e3 * v / n_pairs for k, v in sorted(acc.items())}
    (_, times, launches), spans, kern, busy_ms = device_trace(
        lambda: chip_smoke.run_flow_path(clip, net, counters))
    wall_ms = 1e3 * float(np.sum(times))
    ours = {k: v for k, v in kern.items()
            if "correlation_kernel" in k or "dist_weighted_flow_kernel" in k}
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:15]
    print(f"flow path, {n_pairs} pairs: ms/pair under the profiler mean "
          f"{1e3 * np.mean(times):.2f} median {1e3 * np.median(times):.2f}; "
          f"wrapped ms/pair {1e3 * np.mean(wrapped):.2f}; launches "
          f"{launches}; per module and level (synchronised):")
    for k, v in module_ms.items():
        print(f"  {k:24s} {v:8.2f} ms")
    print(f"device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f} %), {len(spans) / n_pairs:.0f} "
          f"device events per pair; kernels 3 and 4 "
          f"{sum(ours.values()) / n_pairs:.3f} ms a pair; top by device ms:")
    for k, v in top:
        print(f"  {v:9.3f} ms  {k[:90]}")
    print(json.dumps({
        "ms_per_pair_mean": 1e3 * float(np.mean(times)),
        "ms_per_pair_median": 1e3 * float(np.median(times)),
        "module_ms": module_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_ms_per_pair": busy_ms / n_pairs,
        "kernels_3_4_device_ms_per_pair": sum(ours.values()) / n_pairs,
        "device_events_per_pair": len(spans) / n_pairs,
        "top_kernels_ms": dict(top),
    }))
    return 0


def profile_mask(n_frames):
    """The mask path: per-stage synchronised wall time per frame, then the
    device trace of an unwrapped run, after one warm-up run."""
    from vido_slam_tpu_torch.models import perception
    from vido_slam_tpu_torch.models.maskrcnn import backbone
    from vido_slam_tpu_torch.models.maskrcnn import model as mm
    from vido_slam_tpu_torch.ops import roi_align

    counters = [roi_align.roi_align_multilevel]
    chip_smoke.MASK_FRAMES = n_frames
    clip, model = chip_smoke.mask_inputs("cuda")
    chip_smoke.run_mask_path(clip, model, counters)     # build, warm-up
    acc = collections.defaultdict(float)
    methods = {"backbone": backbone.ResNet, "FPN": backbone.FPN}
    functions = {"RPN + NMS": (mm, "rpn_proposals"),
                 "box head": (mm, "box_head_forward"),
                 "postprocess": (mm, "postprocess_detections"),
                 "mask head": (mm, "mask_head_forward"),
                 "paste": (perception, "paste_semantic_mask")}
    originals = {n: c.forward for n, c in methods.items()}
    for n, c in methods.items():
        c.forward = (lambda name, fn: lambda self, *a: _wrap(
            name, lambda *b: fn(self, *b), acc)(*a))(n, originals[n])
    for n, (mod, attr) in functions.items():
        originals[n] = getattr(mod, attr)
        setattr(mod, attr, _wrap(n, originals[n], acc))
    try:
        _, _, wrapped, _ = chip_smoke.run_mask_path(clip, model, counters)
    finally:
        for n, c in methods.items():
            c.forward = originals[n]
        for n, (mod, attr) in functions.items():
            setattr(mod, attr, originals[n])
    stage_ms = {k: 1e3 * acc[k] / n_frames
                for k in list(methods) + list(functions)}
    (_, _, times, launches), spans, kern, busy_ms = device_trace(
        lambda: chip_smoke.run_mask_path(clip, model, counters))
    wall_ms = 1e3 * float(np.sum(times))
    ours = sum(v for k, v in kern.items() if "roi_align_kernel" in k)
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:15]
    print(f"mask path, {n_frames} frames: ms/frame under the profiler mean "
          f"{1e3 * np.mean(times):.2f} median {1e3 * np.median(times):.2f}; "
          f"wrapped ms/frame {1e3 * np.mean(wrapped):.2f}; launches "
          f"{launches}; per stage (synchronised):")
    for k, v in stage_ms.items():
        print(f"  {k:24s} {v:8.2f} ms")
    print(f"device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f} %), {len(spans) / n_frames:.0f} "
          f"device events per frame; kernel 5 {ours / n_frames:.3f} ms a "
          f"frame; top by device ms:")
    for k, v in top:
        print(f"  {v:9.3f} ms  {k[:90]}")
    print(json.dumps({
        "ms_per_frame_mean": 1e3 * float(np.mean(times)),
        "ms_per_frame_median": 1e3 * float(np.median(times)),
        "stage_ms": stage_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_ms_per_frame": busy_ms / n_frames,
        "kernel_5_device_ms_per_frame": ours / n_frames,
        "device_events_per_frame": len(spans) / n_frames,
        "top_kernels_ms": dict(top),
    }))
    return 0


def profile_online(n_frames):
    """The online path: per-stage synchronised wall time, then the device
    trace of an unwrapped run, after one warm-up run."""
    from vido_slam_tpu_torch.models import perception
    from vido_slam_tpu_torch.ops import correlation, regularize, roi_align

    counters = [lm_kernel.pose_lm_batched, correlation.correlation,
                regularize.dist_weighted_flow, roi_align.roi_align_multilevel]
    frames, tcw, model = chip_smoke.online_inputs("cuda")
    frames = frames[:n_frames]
    n_calls = frames.shape[0] - 1
    chip_smoke.run_online_path(frames, tcw, model, counters, [])  # warm-up
    acc = collections.defaultdict(float)
    branches = ("perception_depth", "perception_flow", "perception_mask")
    steps = ("fast_score_map", "_track_step") + STAGES
    sites = [(perception, n) for n in branches] + [(tracking, n)
                                                   for n in steps]
    originals = {(m, n): getattr(m, n) for m, n in sites}
    for (m, n), fn in originals.items():
        setattr(m, n, _wrap(n, fn, acc))
    post = tracking.Tracker._post_step
    tracking.Tracker._post_step = lambda self, *a: _wrap(
        "_post_step", lambda *b: post(self, *b), acc)(*a)
    try:
        _, _, wrapped, _ = chip_smoke.run_online_path(frames, tcw, model,
                                                      counters, [])
    finally:
        for (m, n), fn in originals.items():
            setattr(m, n, fn)
        tracking.Tracker._post_step = post
    stage_ms = {n: 1e3 * acc[n] / n_calls for n in branches}
    stage_ms.update({n: 1e3 * acc[n] / (n_calls - 1)
                     for n in steps + ("_post_step",)})
    (_, _, times, launches), spans, kern, busy_ms = device_trace(
        lambda: chip_smoke.run_online_path(frames, tcw, model, counters, []))
    steady = times[4:]
    wall_ms = 1e3 * float(np.sum(times))
    ours = {k: v for k, v in kern.items()
            if any(n in k for n in ("pose_lm_kernel", "correlation_kernel",
                                    "dist_weighted_flow_kernel",
                                    "roi_align_kernel"))}
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:15]
    print(f"online path, {n_calls} calls: ms/frame under the profiler mean "
          f"{1e3 * np.mean(steady):.2f} median {1e3 * np.median(steady):.2f} "
          f"(calls 4-{n_calls - 1}); wrapped ms/frame "
          f"{1e3 * np.mean(wrapped[1:]):.2f}; launches {launches}; per "
          f"stage (synchronised; branches a call, the rest a tracked call):")
    for k, v in stage_ms.items():
        print(f"  {k:34s} {v:8.2f} ms")
    print(f"device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f} %), {len(spans) / n_calls:.0f} "
          f"device events per call; kernels 1, 3, 4, 5 "
          f"{sum(ours.values()) / n_calls:.3f} ms a call; top by device ms:")
    for k, v in top:
        print(f"  {v:9.3f} ms  {k[:90]}")
    print(json.dumps({
        "ms_per_frame_mean": 1e3 * float(np.mean(steady)),
        "ms_per_frame_median": 1e3 * float(np.median(steady)),
        "stage_ms": stage_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_ms_per_call": busy_ms / n_calls,
        "kernels_device_ms_per_call": sum(ours.values()) / n_calls,
        "device_events_per_call": len(spans) / n_calls,
        "top_kernels_ms": dict(top),
    }))
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--flow", action="store_true",
                    help="profile the flow path instead of the VO path")
    ap.add_argument("--mask", action="store_true",
                    help="profile the mask path instead of the VO path")
    ap.add_argument("--online", action="store_true",
                    help="profile the online path instead of the VO path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line())
    if args.flow:
        return profile_flow(min(args.frames, 9))
    if args.mask:
        return profile_mask(min(args.frames, 8))
    if args.online:
        return profile_online(min(args.frames, 24))
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
    (_, times2, _), spans, kern, busy_ms = device_trace(
        lambda: chip_smoke.run_main_path(inputs, "cuda", counters))
    steady = times2[1 + args.warmup:]
    wall_ms = 1e3 * float(np.sum(times2))  # every frame of the trace
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
