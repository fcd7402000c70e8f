"""The launch plans of kernels 1-5 swept on one GPU, each against the plan
its wrapper picks.

    python tools/sweep_kernel_plans.py [pose_lm | correlation | flow_joint
                                        | roi_align | regularize ...]

(no argument: all five). Kernel 3, the cost volume
(``ops/correlation.py``): at each of the five LiteFlowNet levels of a
1280x576 pair (``chip_smoke.CORR_LEVELS``, seeded unit-normal inputs), every
tile height (4, 8) and channel split (1, 2, 4, 8). Kernels 1 and 2, the
pose LM (``estimation/lm_kernel.py``) and the joint flow + pose solve
(``estimation/flow_joint_kernel.py``): chip_smoke.py's seeded camera (B=1,
N=3000) and object (B=8, N=4000) problems at every cluster size (1, 2, 4,
8) and block size (64, 128, 256). Kernel 5, the multilevel ROIAlign
(``ops/roi_align.py``): the box (R=1000, 7x7) and mask (R=100, 14x14) heads
of chip_smoke.py's seeded 1088x800 pyramid and of the mask path's second
frame (chip_smoke.py's driving clip and seeded R-50-FPN), every channel
group (2 to 256) and block size (64, 128, 256); then its bf16 build on the
same four calls with the features in bf16, every group, block size and
buffer (the plan's, twice and four times that), each held to the plain
version by ``chip_smoke.check_bf16_kernel``. Kernel 4, the
regularization tail (``ops/regularize.py``): at each of the five levels
(``chip_smoke.regularize_cases`` from seed 0), 16-byte against 4-byte flow
copies, seven alternating timings each. A plan's ms is device time, 20
launches captured in a CUDA graph and the replay timed by CUDA events
(``chip_smoke.time_cuda_graph``); every result is held to chip_smoke.py's
bars against the plain version, and the wrapper's plan is marked with *.
Prints a JSON summary as its last line. Needs a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from vido_slam_tpu_torch.estimation import (  # noqa: E402
    flow_joint_kernel as fj, lm_kernel)
from vido_slam_tpu_torch.estimation.pose import (  # noqa: E402
    HUBER_DELTA_POSE, OBJ_ITERS, POSE_ITERS, RP_THRES)
from vido_slam_tpu_torch.geometry.camera import Camera  # noqa: E402
from vido_slam_tpu_torch.geometry.se3 import inverse_se3, log_se3  # noqa: E402
from vido_slam_tpu_torch.models.maskrcnn import roi_heads  # noqa: E402
from vido_slam_tpu_torch.ops import correlation as corr  # noqa: E402
from vido_slam_tpu_torch.ops import regularize as reg  # noqa: E402
from vido_slam_tpu_torch.ops import roi_align  # noqa: E402
from vido_slam_tpu_torch.utils import cuda_build  # noqa: E402


def correlation_inputs(rng):
    """Seeded unit-normal (f1, f2) at each level, as numpy."""
    return [tuple(rng.randn(1, C, H, W).astype(np.float32) for _ in range(2))
            for C, H, W, _ in chip_smoke.CORR_LEVELS]


def sweep_correlation(inputs, dev):
    summary = {}
    for level, (C, H, W, s), pair in zip(range(2, 7), chip_smoke.CORR_LEVELS,
                                         inputs):
        f1, f2 = (torch.tensor(a, device=dev) for a in pair)
        ref = corr.correlation_ref(f1, f2, s)
        bar = 1e-5 * max(1.0, float(ref.abs().max()))
        chosen = corr.launch_plan(1, C, H, W, s)
        Ho, Wo = -(-H // s), -(-W // s)
        rows = {}
        for tile_h in (4, 8):
            tiles = -(-Wo // corr.TILE_W) * -(-Ho // tile_h)
            for split in (1, 2, 4, 8):
                plan = corr.CorrelationPlan(tile_h, split,
                                            (split * tiles, 1),
                                            corr.smem_bytes(tile_h))
                out = torch.empty_like(ref)
                chip_smoke.check(corr._launch(f1, f2, s, plan, out) == 0,
                                 ("launch", level, plan))
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                chip_smoke.check(err <= bar, ("correlation", level, plan, err))
                ms = chip_smoke.time_cuda_graph(
                    lambda: corr._launch(f1, f2, s, plan, out), 20)
                mark = "*" if plan == chosen else ""
                rows[f"{tile_h}x{split}{mark}"] = ms
                print(f"correlation level {level} C={C} {H}x{W} stride {s}: "
                      f"tile height {tile_h}, split {split}{mark}: "
                      f"{split * tiles} CTAs, {ms:.4f} ms, max error "
                      f"{err:.1e}", flush=True)
        summary[f"level {level}"] = rows
    return summary


def held(got, ref, valid):
    """chip_smoke.check_flow_joint's bars: (largest pose error, most inlier
    flips, largest flow error of common inliers, all within the bars)."""
    N = valid.shape[1]
    rot = flips = dflow = 0.0
    ok = True
    for b in range(valid.shape[0]):
        r = float(torch.linalg.norm(log_se3(inverse_se3(ref.T[b]) @ got.T[b])))
        f = int((got.inliers[b] != ref.inliers[b]).sum())
        both = got.inliers[b] & ref.inliers[b]
        d = float((got.flow[b] - ref.flow[b]).abs()[both].max()) \
            if both.any() else 0.0
        ok &= math.isfinite(r) and r < 1e-4 and f <= max(3, N // 100) \
            and d < 1e-2
        rot, flips, dflow = max(rot, r), max(flips, f), max(dflow, d)
    return rot, flips, dflow, ok


def offline_camera():
    c = chip_smoke.OFFLINE_CONFIG
    return Camera.create(fx=c["Camera.fx"], fy=c["Camera.fy"],
                         cx=c["Camera.cx"], cy=c["Camera.cy"],
                         width=c["Camera.width"], height=c["Camera.height"],
                         bf=c["Camera.bf"])


def held_pose_lm(got, ref, valid):
    """chip_smoke.check_pose_lm's bars: (largest pose error, largest chi2
    error relative to max(1, chi2_ref), most inlier flips, all within the
    bars)."""
    rot = dchi = flips = 0.0
    ok = True
    for b in range(valid.shape[0]):
        r = float(torch.linalg.norm(log_se3(inverse_se3(ref.T[b]) @ got.T[b])))
        d = float((((got.chi2[b] - ref.chi2[b]).abs()
                    / torch.clamp(ref.chi2[b].abs(), min=1.0))).max())
        f = int(((got.chi2[b] <= RP_THRES) != (ref.chi2[b] <= RP_THRES))
                [valid[b]].sum())
        ok &= math.isfinite(r) and r < 1e-4 and d < 1e-3 and f <= 3
        rot, dchi, flips = max(rot, r), max(dchi, d), max(flips, f)
    return rot, dchi, flips, ok


def sweep_pose_lm(rng, dev):
    cam = offline_camera()
    Tcw = chip_smoke._pose([0.0, 0.02, 0.0], [0.1, 0.0, -3.0])
    cases = [("camera B=1 N=3000", chip_smoke.camera_problem(rng, cam, 3000),
              dict(huber_delta=HUBER_DELTA_POSE, max_iters=POSE_ITERS)),
             ("objects B=8 N=4000", chip_smoke.object_problems(
                 rng, cam, 8, 4000, Tcw),
              dict(huber_delta=None, max_iters=OBJ_ITERS))]
    summary = {}
    for name, args, kw in cases:
        args = tuple(a.to(dev).contiguous() for a in args)
        B, N = args[4].shape
        ref = lm_kernel.pose_lm_batched_ref(*args, cam, **kw)
        chosen = lm_kernel.launch_plan(B, N)
        rows = {}
        for G in (1, 2, 4, 8):
            cap = -(-N // G)
            for threads in (64, 128, 256):
                plan = lm_kernel.ClusterPlan(
                    G, threads, cap, 4 * lm_kernel.PLANES * cap, 0)
                out = lm_kernel.empty_batch(B, N, dev)
                chip_smoke.check(lm_kernel._launch(args, cam, plan, out, **kw)
                                 == 0, ("launch", name, plan))
                torch.cuda.synchronize()
                rot, dchi, flips, ok = held_pose_lm(out, ref, args[4])
                chip_smoke.check(ok, ("pose_lm", name, plan, rot, dchi,
                                      flips))
                ms = chip_smoke.time_cuda_graph(
                    lambda: lm_kernel._launch(args, cam, plan, out, **kw), 20)
                mark = "*" if plan == chosen else ""
                rows[f"{G}x{threads}{mark}"] = ms
                print(f"pose_lm {name}: cluster {G}, {threads} threads{mark}:"
                      f" {ms:.4f} ms, iterations {out.num_iters.tolist()} "
                      f"(plain {ref.num_iters.tolist()}), pose error "
                      f"{rot:.1e}, chi2 error {dchi:.1e}, inlier flips "
                      f"{flips}", flush=True)
        summary[name] = rows
    return summary


def mask_frame_calls(dev):
    """The box and mask heads' ROIAlign arguments of the mask path's second
    frame, as chip_smoke.py records them."""
    clip, model = chip_smoke.mask_inputs(dev)
    recorder = chip_smoke.KernelArgs(roi_heads.roi_align_multilevel, 6)
    roi_heads.roi_align_multilevel = recorder
    try:
        chip_smoke.run_mask_path(clip[:2], model, [])
    finally:
        roi_heads.roi_align_multilevel = recorder.wrapper
    return [(f"mask path frame 2 {what}", args) for what, (args, _) in
            zip(("box head", "mask head"), recorder.calls[2:4])]


def sweep_roi_align(rng, dev):
    cases = chip_smoke.roi_cases(rng, dev) + mask_frame_calls(dev)
    summary = {}
    for name, args in cases:
        feats, rois, levels, scales, r, s = args
        R, C = rois.shape[0], feats[0].shape[1]
        sizes = roi_align.level_sizes(feats)
        levels = levels.to(torch.int32).contiguous()
        ref = roi_align.roi_align_multilevel_ref(*args)
        bar = 1e-5 * max(1.0, max(float(f.abs().max()) for f in feats))
        chosen = roi_align.launch_plan(R, C, r, s, sizes)
        smem = roi_align.smem_bytes(r, s, sizes)
        rows = {}
        for group in (2, 4, 8, 16, 32, 64, 128, 256):
            for threads in (64, 128, 256):
                plan = roi_align.RoiAlignPlan(group, threads, smem)
                out = torch.empty_like(ref)

                def launch():
                    return roi_align._launch(feats, rois, levels, scales, r,
                                             s, plan, out)
                chip_smoke.check(launch() == 0, ("launch", name, plan))
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                chip_smoke.check(err <= bar, ("roi_align", name, plan, err))
                ms = chip_smoke.time_cuda_graph(launch, 20)
                mark = "*" if plan == chosen else ""
                rows[f"{group}x{threads}{mark}"] = ms
                print(f"roi_align {name}: group {group}, {threads} threads"
                      f"{mark}: {ms:.4f} ms, max error {err:.1e}", flush=True)
        summary[name] = rows
        summary[f"{name} in bf16"] = sweep_roi_align_bf16(
            f"{name} in bf16", ([f.to(torch.bfloat16) for f in feats], rois,
                                levels, scales, r, s))
    return summary


def sweep_roi_align_bf16(name, args):
    """Kernel 5's bf16 build on ``args`` at every channel group (2 to 256),
    block size (64, 128, 256) and buffer (the plan's, twice and four times
    that, where it fits), each held to the plain version by
    ``chip_smoke.check_bf16_kernel``."""
    feats, rois, levels, scales, r, s = args
    R, C = rois.shape[0], feats[0].shape[1]
    chosen = roi_align.launch_plan_bf16(R, C, r, s,
                                        roi_align.level_sizes(feats))
    rows = {}
    for group in (2, 4, 8, 16, 32, 64, 128, 256):
        for threads in (64, 128, 256):
            for scale in (1, 2, 4):
                smem = scale * chosen.smem_bytes
                if smem + roi_align.SMEM_RESERVE > roi_align.SMEM_LIMIT:
                    continue
                plan = roi_align.RoiAlignPlan(group, threads, smem)
                out = torch.empty((R, C, r, r), dtype=torch.bfloat16,
                                  device=rois.device)

                def launch(*_, plan=plan, out=out):
                    chip_smoke.check(roi_align._launch(
                        feats, rois, levels, scales, r, s, plan, out) == 0,
                        ("launch", name, plan))
                    return out

                def fresh(*a, plan=plan):
                    return launch(plan=plan, out=torch.empty_like(out))
                fresh.__name__ = "roi_align_multilevel"
                err = chip_smoke.check_bf16_kernel(
                    f"{name} {plan}", fresh,
                    roi_align.roi_align_multilevel_ref, args)
                ms = chip_smoke.time_cuda_graph(launch, 20)
                mark = "*" if plan == chosen else ""
                rows[f"{group}x{threads}x{smem}{mark}"] = ms
                print(f"roi_align bf16 {name}: group {group}, {threads} "
                      f"threads, {smem} B{mark}: {ms:.4f} ms, max error "
                      f"{err:.1e}", flush=True)
    return rows


def sweep_flow_joint(rng, dev):
    cam = offline_camera()
    Tcw = chip_smoke._pose([0.0, 0.02, 0.0], [0.1, 0.0, -3.0])
    cases = [("camera B=1 N=3000", chip_smoke.joint_camera_problem(
                  rng, cam, 3000)),
             ("objects B=8 N=4000", chip_smoke.joint_object_problems(
                  rng, cam, 8, 4000, Tcw))]
    summary = {}
    for name, args in cases:
        args = tuple(a.to(dev).contiguous() for a in args)
        B, N = args[4].shape
        ref = fj.flow_joint_batched_ref(*args, cam)
        chosen = fj.launch_plan(B, N)
        rows = {}
        for G in (1, 2, 4, 8):
            cap = -(-N // G)
            for threads in (64, 128, 256):
                plan = lm_kernel.ClusterPlan(G, threads, cap,
                                             4 * fj.PLANES * cap, 0)
                out = fj.empty_batch(B, N, dev)
                chip_smoke.check(fj._launch(args, cam, fj.ROUND_ITERS, plan,
                                            out) == 0, ("launch", name, plan))
                torch.cuda.synchronize()
                rot, flips, dflow, ok = held(out, ref, args[4])
                chip_smoke.check(ok, ("flow_joint", name, plan, rot, flips,
                                      dflow))
                ms = chip_smoke.time_cuda_graph(
                    lambda: fj._launch(args, cam, fj.ROUND_ITERS, plan, out),
                    20)
                mark = "*" if plan == chosen else ""
                rows[f"{G}x{threads}{mark}"] = ms
                print(f"flow_joint {name}: cluster {G}, {threads} threads"
                      f"{mark}: {ms:.4f} ms, iterations "
                      f"{out.num_iters[0].tolist()} (plain "
                      f"{ref.num_iters[0].tolist()}), pose error {rot:.1e}, "
                      f"inlier flips {flips}, flow error {dflow:.1e}",
                      flush=True)
        summary[name] = rows
    return summary


def sweep_regularize(rng, dev, rounds=7):
    """Kernel 4's flow copies, 16 bytes against 4, at each level: `rounds`
    alternating timings of each, the median kept."""
    summary = {}
    for name, args in chip_smoke.regularize_cases(rng, dev):
        dc, flow, wx, bx, wy, by, k = args
        ref = reg.dist_weighted_flow_ref(*args)
        chosen = reg.copy_width(flow)
        launches = {}
        for vec in (16, 4):
            out = torch.empty_like(ref)

            def launch(vec=vec, out=out):
                return reg._launch(dc, flow, wx, bx, wy, by, k, vec, out)
            chip_smoke.check(launch() == 0, ("launch", name, vec))
            torch.cuda.synchronize()
            diff = (out - ref).abs()
            chip_smoke.check(bool((diff <= 1e-5 + 1e-5 * ref.abs()).all()),
                             ("dist_weighted_flow", name, vec,
                              float(diff.max())))
            launches[vec] = launch
        times = {vec: [] for vec in launches}
        for _ in range(rounds):
            for vec, launch in launches.items():
                times[vec].append(chip_smoke.time_cuda_graph(launch, 20))
        widths = {}
        for vec, ms in times.items():
            mark = "*" if vec == chosen else ""
            widths[f"{vec}B{mark}"] = float(np.median(ms))
            print(f"dist_weighted_flow {name}: {vec}-byte flow copies{mark}: "
                  f"median {np.median(ms):.5f} ms of "
                  f"{' '.join(f'{t:.5f}' for t in ms)}", flush=True)
        summary[name] = widths
    return summary


SWEEPS = ("pose_lm", "correlation", "flow_joint", "roi_align", "regularize")


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_kernel_plans: no CUDA device available", file=sys.stderr)
        return 1
    wanted = sys.argv[1:] or list(SWEEPS)
    unknown = sorted(set(wanted) - set(SWEEPS))
    if unknown:
        print(f"sweep_kernel_plans: unknown sweeps {unknown}; choose from "
              f"{SWEEPS}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(card)
    cuda_build.build_all()
    # kernels 3 and 2 draw from one stream in that order, as before kernels
    # 1, 4 and 5 were swept; those get chip_smoke.py's seeded cases
    rng = np.random.RandomState(0)
    corr_inputs = correlation_inputs(rng) \
        if {"correlation", "flow_joint"} & set(wanted) else None
    sweeps = {"pose_lm": lambda: sweep_pose_lm(np.random.RandomState(0), dev),
              "correlation": lambda: sweep_correlation(corr_inputs, dev),
              "flow_joint": lambda: sweep_flow_joint(rng, dev),
              "roi_align": lambda: sweep_roi_align(np.random.RandomState(0),
                                                   dev),
              "regularize": lambda: sweep_regularize(
                  np.random.RandomState(0), dev)}
    summary = {"card": card}
    for part in SWEEPS:
        if part in wanted:
            summary[part] = sweeps[part]()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
