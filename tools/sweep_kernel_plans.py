"""The launch plans of kernels 1-5 swept on one GPU, each against the plan
its wrapper picks.

    python tools/sweep_kernel_plans.py [pose_lm | correlation | flow_joint
                                        | roi_align | regularize
                                        | bf16_parent ...]

(no argument: the first five). Kernel 3, the cost volume
(``ops/correlation.py``): at each of the five LiteFlowNet levels of a
1280x576 pair (``chip_smoke.CORR_LEVELS``, seeded unit-normal inputs), every
tile height (4, 8) and channel split (1, 2, 4, 8); then its bf16 build on
the same values in bf16 and at the online path's five levels
(``chip_smoke.ONLINE_CORR_LEVELS``): tile heights 4 and 8, 1, 2 and 4 tap
groups, rings of 4 and 8 channels a stage, the wrapper's split and, at
8-row tiles, splits of 2, 4 and 8. Kernels 1 and 2, the
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
copies, seven alternating timings each; then its bf16 build (16-byte
copies at any alignment) there and at the online levels beside the
float32 build on the same values. ``bf16_parent`` (named only): kernels 3 and 4's bf16
builds beside those of commit 7e57782 (before their redesign, built from
its sources unpacked into the git-ignored ``vido_slam_tpu_torch/build/
parent``) and the float32 builds on the same values, on chip_smoke.py
(j2)'s arguments and at the flow path's five levels: whether the bits
are the parent's, and each one's ms. A plan's ms is device time, 20
launches captured in a CUDA graph and the replay timed by CUDA events
(``chip_smoke.time_cuda_graph``); every result is held to chip_smoke.py's
bars against the plain version, and the wrapper's plan is marked with *.
Prints a JSON summary as its last line. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
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
    for level, (C, H, W, s), pair in zip(range(2, 7), chip_smoke.CORR_LEVELS,
                                         inputs):
        f1, f2 = (torch.tensor(a, device=dev).to(torch.bfloat16)
                  for a in pair)
        summary[f"level {level} in bf16"] = sweep_correlation_bf16(
            f"level {level} C={C} {H}x{W} stride {s} in bf16", f1, f2, s)
    rng = np.random.RandomState(1)
    for level, (C, H, W, s) in zip(range(2, 7),
                                   chip_smoke.ONLINE_CORR_LEVELS):
        f1, f2 = (torch.tensor(rng.randn(1, C, H, W).astype(np.float32),
                               device=dev).to(torch.bfloat16)
                  for _ in range(2))
        summary[f"online level {level} in bf16"] = sweep_correlation_bf16(
            f"online level {level} C={C} {H}x{W} stride {s} in bf16", f1,
            f2, s)
    return summary


def sweep_correlation_bf16(name, f1, f2, s):
    """Kernel 3's bf16 build on (f1, f2) at tile heights 4 and 8, 1, 2 and
    4 groups of threads over the tap rows, rings of 4 or 8 channels a
    stage, and the wrapper's split (the parent build's bits) or, at
    8-row tiles, the other splits of 2, 4 and 8 (sums regrouped), each held
    to the plain version by ``chip_smoke.check_bf16_kernel``."""
    N, C, H, W = f1.shape
    chosen = corr.launch_plan_bf16(N, C, H, W, s)
    Ho, Wo = -(-H // s), -(-W // s)
    rows = {}
    for tile_h, split, taps, chunk in (
            (h, g, t, c) for h in (4, 8)
            for g in ((chosen.split,) if h == 4 else
                      sorted({chosen.split, 2, 4, 8}))
            for t in corr.TAP_GROUPS for c in (4, 8)):
        smem = corr.smem_bytes_bf16(tile_h, s, chunk)
        if smem > corr.SMEM_LIMIT or split > C:
            continue
        tiles = -(-Wo // corr.TILE_W) * -(-Ho // tile_h)
        plan = chosen._replace(tile_h=tile_h, split=split, chunk=chunk,
                               taps=taps, smem_bytes=smem,
                               grid=(split * tiles, N))
        out = torch.empty((N, corr.TAPS, -(-H // s), -(-W // s)),
                          dtype=torch.bfloat16, device=f1.device)

        def launch(*_, plan=plan, out=out):
            chip_smoke.check(corr._launch(f1, f2, s, plan, out) == 0,
                             ("launch", name, plan))
            return out

        def fresh(*_, plan=plan):
            return launch(plan=plan, out=torch.empty_like(out))
        fresh.__name__ = "correlation"
        err = chip_smoke.check_bf16_kernel(
            f"{name} {plan}", fresh, corr.correlation_ref, (f1, f2, s))
        ms = chip_smoke.time_cuda_graph(launch, 20)
        mark = "*" if plan == chosen else ""
        rows[f"{tile_h}x{split}x{taps}x{chunk}{mark}"] = ms
        print(f"correlation bf16 {name}: tile {tile_h}, split {split}, taps "
              f"{taps}, chunk {chunk}, {smem} B{mark}: "
              f"{ms:.4f} ms, max error {err:.1e}", flush=True)
    return rows


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
    bf16 = [(f"{n} in bf16", a) for n, a in
             chip_smoke.regularize_cases(np.random.RandomState(0), dev)]
    online = regularize_online_cases(np.random.RandomState(1), dev)
    for name, args in bf16 + online:
        args = tuple(a.to(torch.bfloat16) if torch.is_tensor(a) else a
                     for a in args)
        summary[name] = sweep_regularize_bf16(name, args, rounds)
    return summary


def regularize_online_cases(rng, dev):
    """Seeded (dc, flow, wx, bx, wy, by, k) at the online levels
    (chip_smoke.ONLINE_REG_LEVELS), as chip_smoke.regularize_cases."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return [(f"online level {lv} K={k * k} {H}x{W} in bf16", (
        t(rng.randn(1, k * k, H, W)), t(rng.randn(1, 2, H, W) * 3),
        t(rng.randn(k * k)), t([0.3]), t(rng.randn(k * k)), t([-0.2]), k))
        for lv, (k, H, W) in zip(range(2, 7), chip_smoke.ONLINE_REG_LEVELS)]


def sweep_regularize_bf16(name, args, rounds):
    """Kernel 4's bf16 build on ``args`` (16-byte copies at any alignment)
    held to the plain version by ``chip_smoke.check_bf16_kernel``, then
    `rounds` alternating timings of it and of the float32 build on the
    same values."""
    chip_smoke.check_bf16_kernel(name, reg.dist_weighted_flow,
                                 reg.dist_weighted_flow_ref, args)
    f_args = chip_smoke.to_f32(args)
    timed = {"bf16": lambda: reg.dist_weighted_flow(*args),
             "float32": lambda: reg.dist_weighted_flow(*f_args)}
    times = {b: [] for b in timed}
    for _ in range(rounds):
        for b, fn in timed.items():
            times[b].append(chip_smoke.time_cuda_graph(fn, 20))
    rows = {}
    for b, ms in times.items():
        rows[b] = float(np.median(ms))
        print(f"dist_weighted_flow {name}: {b} build: median "
              f"{np.median(ms):.5f} ms of {' '.join(f'{t:.5f}' for t in ms)}",
              flush=True)
    return rows


# The bf16 builds of kernels 3 and 4 against those of the commit before
# their redesign (7e57782), unpacked by `git archive` into the git-ignored
# vido_slam_tpu_torch/build/parent and built here with that commit's C
# interface: correlation_launch(f1, f2, out, N, C, H, W, s, tile_h, split,
# grid_x, smem_bytes, bf16, stream) on the float32 plan,
# dist_weighted_flow_launch(dc, flow, wx, bx, wy, by, out, N, H, W, k, vec,
# stream) with vec 2 for bf16.
PARENT_DIR = os.path.join(cuda_build.BUILD_DIR, "parent")


def parent_launchers():
    """The parent's kernel 3 and 4 launchers, built from PARENT_DIR."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, sym, argtypes in (
            ("correlation", "correlation_launch", [P] * 3 + [I] * 10 + [P]),
            ("regularize", "dist_weighted_flow_launch",
             [P] * 7 + [I] * 5 + [P])):
        src = os.path.join(PARENT_DIR, "vido_slam_tpu_torch", "csrc",
                           f"{name}.cu")
        lib = os.path.join(cuda_build.BUILD_DIR, f"libparent_{name}.so")
        subprocess.run([cuda_build._nvcc(), "-gencode", cuda_build.ARCH,
                        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                        "-o", lib, src], check=True)
        fn = getattr(ctypes.CDLL(lib), sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    def corr_parent(f1, f2, s):
        N, C, H, W = f1.shape
        plan = corr.launch_plan(N, C, H, W, s)
        out = torch.empty((N, corr.TAPS, -(-H // s), -(-W // s)),
                          dtype=f1.dtype, device=f1.device)
        chip_smoke.check(fns["correlation"](
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), N, C, H, W, s,
            plan.tile_h, plan.split, plan.grid[0], plan.smem_bytes, 1,
            torch.cuda.current_stream().cuda_stream) == 0,
            ("parent correlation", tuple(f1.shape)))
        return out

    def reg_parent(dc, flow, wx, bx, wy, by, k):
        N, _, H, W = dc.shape
        out = torch.empty_like(flow)
        chip_smoke.check(fns["regularize"](
            dc.data_ptr(), flow.data_ptr(), wx.data_ptr(), bx.data_ptr(),
            wy.data_ptr(), by.data_ptr(), out.data_ptr(), N, H, W, k, 2,
            torch.cuda.current_stream().cuda_stream) == 0,
            ("parent dist_weighted_flow", tuple(dc.shape)))
        return out
    corr_parent.__name__ = "correlation"
    reg_parent.__name__ = "dist_weighted_flow"
    return {"correlation": corr_parent, "dist_weighted_flow": reg_parent}


def j2_calls(dev):
    """Kernels 3 and 4's arguments in chip_smoke.py's (j2): the online
    PerceptionModel from seed 0 with flow_dtype bf16 on the bench clip's
    first pair."""
    from vido_slam_tpu_torch.models import liteflownet
    frames, _, model = chip_smoke.online_inputs(dev,
                                                flow_dtype=torch.bfloat16)
    recs = {attr: chip_smoke.KernelArgs(getattr(liteflownet, attr), n)
            for attr, n in (("correlation", 3), ("dist_weighted_flow", 7))}
    for attr, r in recs.items():
        setattr(liteflownet, attr, r)
    try:
        model(frames[0], frames[1])
    finally:
        for attr, r in recs.items():
            setattr(liteflownet, attr, r.wrapper)
    return {attr: [(f"(j2) level {6 - k} {tuple(a[0].shape)}", a)
                   for k, (a, _) in enumerate(r.calls)]
            for attr, r in recs.items()}


def sweep_bf16_parent(dev, rounds=2):
    """Each bf16 build of kernels 3 and 4 beside the parent's bf16 build
    and the float32 build on the same values, on (j2)'s arguments and at
    the flow path's five levels (seeded as chip_smoke.py's cases): the
    parent's bits or not, each within ``chip_smoke.bf16_bar``, and device
    ms timed parent, new, float32, new, parent (`rounds` times)."""
    parent = parent_launchers()
    rng = np.random.RandomState(0)
    seeded = {"correlation": chip_smoke.correlation_cases(rng, dev),
              "dist_weighted_flow": chip_smoke.regularize_cases(rng, dev)}
    wrappers = {"correlation": (corr.correlation, corr.correlation_ref),
                "dist_weighted_flow": (reg.dist_weighted_flow,
                                       reg.dist_weighted_flow_ref)}
    summary = {}
    for attr, calls in j2_calls(dev).items():
        kernel, plain = wrappers[attr]
        cases = calls + [(f"flow path {n}", tuple(
            a.to(torch.bfloat16) if torch.is_tensor(a) else a for a in args))
            for n, args in seeded[attr]]
        rows = {}
        for name, args in cases:
            chip_smoke.check_bf16_kernel(name, kernel, plain, args)
            chip_smoke.check_bf16_kernel(f"{name} (parent)", parent[attr],
                                         plain, args)
            new, old = kernel(*args), parent[attr](*args)
            torch.cuda.synchronize()
            same = bool(torch.equal(new, old))
            differ = int((new != old).sum())
            f_args = chip_smoke.to_f32(args)
            order = [("parent", lambda: parent[attr](*args)),
                     ("new", lambda: kernel(*args)),
                     ("float32", lambda: kernel(*f_args)),
                     ("new", lambda: kernel(*args)),
                     ("parent", lambda: parent[attr](*args))]
            times = {"parent": [], "new": [], "float32": []}
            for _ in range(rounds):
                for who, fn in order:
                    times[who].append(chip_smoke.time_cuda_graph(fn, 20))
            rows[name] = dict(parent_bits=same, outputs_differ=differ,
                              **{who: ts for who, ts in times.items()})
            print(f"{attr} bf16 {name}: parent's bits {same} ({differ} of "
                  f"{new.numel()} outputs differ); device ms new "
                  f"{' '.join(f'{t:.4f}' for t in times['new'])}, parent "
                  f"{' '.join(f'{t:.4f}' for t in times['parent'])}, "
                  f"float32 build {' '.join(f'{t:.4f}' for t in times['float32'])}",
                  flush=True)
        summary[attr] = rows
    return summary


SWEEPS = ("pose_lm", "correlation", "flow_joint", "roi_align", "regularize")
EXTRA = ("bf16_parent",)   # run only when named


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_kernel_plans: no CUDA device available", file=sys.stderr)
        return 1
    wanted = sys.argv[1:] or list(SWEEPS)
    unknown = sorted(set(wanted) - set(SWEEPS) - set(EXTRA))
    if unknown:
        print(f"sweep_kernel_plans: unknown sweeps {unknown}; choose from "
              f"{SWEEPS + EXTRA}", file=sys.stderr)
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
                  np.random.RandomState(0), dev),
              "bf16_parent": lambda: sweep_bf16_parent(dev)}
    summary = {"card": card}
    for part in SWEEPS + EXTRA:
        if part in wanted:
            summary[part] = sweeps[part]()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
