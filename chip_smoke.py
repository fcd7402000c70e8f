"""Smoke run of the PyTorch + CUDA port (``vido_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run by raising:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the main path's kernel from ``csrc/`` and prints
     ptxas' register/shared-memory report;
  3. kernel vs plain: the kernel against its plain PyTorch version on the
     same numpy-seeded inputs, laid out at the main path's shapes as the
     main path lays them out, with the tolerance stated there;
  4. main path: the port's ``System`` (RGBD sensor, fused window BA) tracks a
     synthetic KAIST-calibration sequence (1280x560, two moving vehicles,
     the bench's offline widths) on the card; the kernel launch counters are
     zeroed just before and read just after, camera ATE must stay under 1 %
     of the path length, objects must be tracked, and the result txts must
     be written. The kernel's arguments of every call are kept, and phase 3
     runs again on those of one frame, where both versions are also timed;
  5. summary: a ``{"kernels": [...]}`` JSON line, then the device line.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM published peaks (dense): HBM bandwidth and float32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

N_FRAMES = 24  # the bench clip's length; both vehicles stay in view
OFFLINE_CONFIG = {
    # KAIST offline calibration (kaist_config.yaml:21-27) and widths of the
    # offline bench row
    "Camera.width": 1280, "Camera.height": 560, "Camera.fx": 816.402,
    "Camera.fy": 817.38, "Camera.cx": 608.2658, "Camera.cy": 266.688,
    "Camera.bf": 387.57, "ChooseData": 3, "DepthMapFactor": 500,
    "WINDOW_SIZE": 20, "MaxTrackPointBG": 3000, "MaxTrackPointOBJ": 800,
    "Camera.fps": 10, "UseSampleFeature": 1,
}
TRACKER_KW = dict(n_bg=3000, n_obj=4000, max_objects=8, seed=0,
                  local_ba=True, fused_ba=True, ba_max_points=1000,
                  ba_iters=10)


def check(ok, what) -> None:
    """A phase's check; raises (so the run fails) whatever the
    interpreter's -O flag."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------

def _pose(w, t):
    import torch
    from vido_slam_tpu_torch.geometry.se3 import make_se3
    from vido_slam_tpu_torch.geometry.so3 import exp_so3

    return make_se3(exp_so3(torch.tensor(w, dtype=torch.float32)),
                    torch.tensor(t, dtype=torch.float32))


def camera_problem(rng, cam, N):
    """The camera solve as the main path lays it out (B=1, T_pre = I):
    random points 5-40 m in front of the camera, seen through T_true with
    0.05 px noise and 5 % of 3 px outliers, about 90 % valid, T_init
    perturbed."""
    import torch

    uv = np.stack([rng.uniform(30.0, cam.width - 30.0, N),
                   rng.uniform(20.0, cam.height - 20.0, N)], -1)
    X = cam.backproject(torch.tensor(uv, dtype=torch.float32),
                        torch.tensor(rng.uniform(5.0, 40.0, N),
                                     dtype=torch.float32))
    Tt = _pose(rng.normal(0, 0.01, 3), rng.normal(0, 0.3, 3))
    obs = cam.project(X @ Tt[:3, :3].T + Tt[:3, 3]) + torch.tensor(
        rng.normal(0, 0.05, (N, 2)), dtype=torch.float32)
    obs[torch.tensor(rng.uniform(size=N) < 0.05)] += 3.0
    valid = torch.tensor(rng.uniform(size=(1, N)) < 0.9)
    T0 = _pose(rng.normal(0, 0.005, 3), rng.normal(0, 0.05, 3)) @ Tt
    return T0[None], torch.eye(4)[None], X, obs, valid


def object_problems(rng, cam, B, N, Tcw):
    """The object batch as the main path lays it out: one (N, 3) world
    point set and one (N, 2) observation array shared by the B problems,
    each object's points picked out by a disjoint mask, T_pre = Tcw.
    Object b is a 600 x 300 px patch of the image 2-10 m away (a near
    vehicle: smaller or farther patches leave the float32 solution itself,
    against float64, uncertain to a few 1e-5, too close to the pose bar)
    moved by its own motion H_b; a tenth of the points belongs to no
    object. T_init = H_b perturbed."""
    import torch
    from vido_slam_tpu_torch.geometry.se3 import inverse_se3

    owner = np.where(rng.uniform(size=N) < 0.1, -1, rng.randint(0, B, N))
    uv = np.zeros((N, 2))
    z = np.zeros(N)
    for b in range(-1, B):
        sel = owner == b
        uc = rng.uniform(330.0, cam.width - 330.0)
        vc = rng.uniform(170.0, cam.height - 170.0)
        uv[sel, 0] = uc + rng.uniform(-300.0, 300.0, sel.sum())
        uv[sel, 1] = vc + rng.uniform(-150.0, 150.0, sel.sum())
        z[sel] = rng.uniform(4.0, 8.0) + rng.uniform(-2.0, 2.0, sel.sum())
    Xc = cam.backproject(torch.tensor(uv, dtype=torch.float32),
                         torch.tensor(z, dtype=torch.float32))
    Twc = inverse_se3(Tcw)
    X = Xc @ Twc[:3, :3].T + Twc[:3, 3]
    obs = torch.zeros(N, 2)
    masks, T0 = [], []
    for b in range(B):
        sel = torch.tensor(owner == b)
        H = _pose(rng.normal(0, 0.01, 3), rng.normal(0, 0.3, 3))
        M = Tcw @ H
        obs[sel] = cam.project(X[sel] @ M[:3, :3].T + M[:3, 3])
        masks.append(sel)
        T0.append(_pose(rng.normal(0, 0.005, 3), rng.normal(0, 0.05, 3)) @ H)
    obs += torch.tensor(rng.normal(0, 0.05, (N, 2)), dtype=torch.float32)
    return (torch.stack(T0), Tcw.expand(B, 4, 4).contiguous(), X, obs,
            torch.stack(masks))


def lm_bound(args, res, huber_delta):
    """(bytes, flops) the call must move and compute: each input read once,
    each output written once, and the operations of lm_kernel.operations
    for the iterations and valid points of these inputs."""
    from vido_slam_tpu_torch.estimation.lm_kernel import operations

    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += sum(t.numel() * t.element_size() for t in res)
    return nbytes, operations(args[4], res.num_iters, huber_delta)


def time_cuda(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_pose_lm(cases, cam) -> float:
    """pose_lm_batched against pose_lm_batched_ref on each case
    (name, args, keyword arguments, chi2 held on the valid points only). Bars
    (per problem, those of the JAX parity test
    tests/test_estimation.py:269-309): |log(T_ref^-1 T)| < 1e-4,
    |chi2 - chi2_ref| <= 1e-3 max(1, chi2_ref) (absolute for inliers,
    relative for the few-px outliers), at most 3 valid points on different
    sides of the 0.01 inlier threshold. Returns max_abs_err over T and the
    chi2 of valid points with chi2_ref <= 1."""
    import torch
    from vido_slam_tpu_torch.estimation import lm_kernel
    from vido_slam_tpu_torch.estimation.pose import RP_THRES
    from vido_slam_tpu_torch.geometry.se3 import inverse_se3, log_se3

    err = 0.0
    for name, args, kw, valid_only in cases:
        got = lm_kernel.pose_lm_batched(*args, cam, **kw)
        ref = lm_kernel.pose_lm_batched_ref(*args, cam, **kw)
        torch.cuda.synchronize()
        valid = args[4]
        held = valid if valid_only else torch.ones_like(valid)
        for b in range(valid.shape[0]):
            rot = float(torch.linalg.norm(
                log_se3(inverse_se3(ref.T[b]) @ got.T[b])))
            dchi = float(((got.chi2[b] - ref.chi2[b]).abs()
                          / torch.clamp(ref.chi2[b].abs(), min=1.0))
                         [held[b]].max()) if held[b].any() else 0.0
            flips = int(((got.chi2[b] <= RP_THRES) != (ref.chi2[b] <= RP_THRES))
                        [valid[b]].sum())
            check(math.isfinite(rot) and rot < 1e-4, (name, b, "pose", rot))
            check(dchi < 1e-3, (name, b, "chi2", dchi))
            check(flips <= 3, (name, b, "inlier flips", flips))
        small = (ref.chi2 <= 1.0) & valid
        err = max(err, float((got.T - ref.T).abs().max()),
                  float((got.chi2 - ref.chi2).abs()[small].max())
                  if small.any() else 0.0)
        print(f"pose_lm_batched {name}: valid {valid.sum(-1).tolist()}, "
              f"iters {got.num_iters.tolist()}, plain "
              f"{ref.num_iters.tolist()}: within the bars")
    return err


def time_pose_lm(cases, cam):
    """Kernel and plain ms of the cases together (CUDA events, mean of 20
    and of 3 calls after a warm-up) and their bound: (ms, plain_ms,
    bound_ms, bound_by)."""
    from vido_slam_tpu_torch.estimation import lm_kernel

    ms = plain_ms = 0.0
    nbytes = flops = 0
    for name, args, kw, _ in cases:
        k_ms = time_cuda(lambda: lm_kernel.pose_lm_batched(*args, cam, **kw),
                         20)
        p_ms = time_cuda(
            lambda: lm_kernel.pose_lm_batched_ref(*args, cam, **kw), 3)
        b_, f_ = lm_bound(args, lm_kernel.pose_lm_batched(*args, cam, **kw),
                          kw["huber_delta"])
        print(f"pose_lm_batched {name}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.3f} ms, {b_} bytes, {f_} flops")
        ms += k_ms
        plain_ms += p_ms
        nbytes += b_
        flops += f_
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (ms, plain_ms, max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


class KernelArgs:
    """Stands in for ``pose_lm_batched`` in ``estimation/pose.py`` while the
    main path runs: passes every call on to the wrapper, which launches and
    counts, and keeps a copy of each call's arguments, so that the kernel
    can be held against its plain version on what the main path gave it."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kw):
        from vido_slam_tpu_torch.estimation import lm_kernel

        self.calls.append((tuple(a.clone() for a in args[:5]), kw))
        return lm_kernel.pose_lm_batched(*args, **kw)

    def frame_cases(self):
        """The camera and object calls of the tracked frame whose object
        call has the most valid points, as check_pose_lm cases."""
        pairs = [self.calls[i:i + 2] for i in range(0, len(self.calls), 2)]
        k = max(range(len(pairs)),
                key=lambda i: int(pairs[i][1][0][4].sum()))
        return [(f"main path frame {k + 1} {what}", args, kw, True)
                for what, (args, kw) in zip(("camera", "objects"), pairs[k])]


# ---------------------------------------------------------------------------
# phase 4: main path
# ---------------------------------------------------------------------------

def offline_sequence(n_frames, device):
    """The offline bench scene: KAIST calibration, the analytic driving
    trajectory, two vehicles (one semantic label) driving toward the
    camera."""
    import torch
    from vido_slam_tpu_torch.geometry.camera import Camera
    from vido_slam_tpu_torch.io.synthetic import (Box, SyntheticScene,
                                                  SyntheticSequence,
                                                  driving_pose,
                                                  translation_se3)

    cfg = OFFLINE_CONFIG
    cam = Camera.create(fx=cfg["Camera.fx"], fy=cfg["Camera.fy"],
                        cx=cfg["Camera.cx"], cy=cfg["Camera.cy"],
                        width=cfg["Camera.width"],
                        height=cfg["Camera.height"], bf=cfg["Camera.bf"])
    mot = translation_se3([0.06, 0.0, -0.5])
    boxes = (
        Box(half_extent=torch.tensor([0.9, 0.7, 2.0]), label=2,
            pose0=translation_se3([-3.0, 0.7, 14.0]), motion=mot),
        Box(half_extent=torch.tensor([0.9, 0.7, 2.0]), label=2,
            pose0=translation_se3([3.0, 0.7, 22.0]), motion=mot),
    )
    scene = SyntheticScene(cam=cam, ground_y=1.6, boxes=boxes)
    Tcws = [driving_pose(k / 10.0) for k in range(n_frames + 1)]
    steps = [Tcws[k + 1] @ np.linalg.inv(Tcws[k]) for k in range(n_frames)]
    return SyntheticSequence(scene, steps, n_frames, device=device)


def main_path_inputs(seq, device, n_frames):
    """The frames as TrackRGBD reads them, already on ``device``: KAIST raw
    depth (normalised inverse depth, metric = bf / (raw / f)), flow, mask
    and the ground-truth pose."""
    import torch
    from vido_slam_tpu_torch.config import config_from_dict

    cfg = config_from_dict(OFFLINE_CONFIG)
    f = cfg.system.depth_map_factor * cfg.camera.bf
    inputs = []
    for fr in seq.frames[:n_frames]:
        depth = torch.as_tensor(fr.depth, device=device)
        raw = torch.where(depth > 0, f / torch.clamp(depth, min=1e-6),
                          torch.zeros_like(depth))
        inputs.append((raw, torch.as_tensor(fr.flow, device=device),
                       torch.as_tensor(fr.mask, device=device), fr.Tcw_gt))
    return inputs


def run_main_path(inputs, device, counters):
    """Drive System.TrackRGBD over the frames; returns the system, the
    host seconds of every frame (the first one initialises) and each
    counter's launches during the run."""
    import torch
    from vido_slam_tpu_torch.config import config_from_dict
    from vido_slam_tpu_torch.system import Sensor, System

    system = System()
    system.init_from_config(config_from_dict(OFFLINE_CONFIG), Sensor.RGBD,
                            device=device, **TRACKER_KW)
    for c in counters:
        c.launches = 0
    times = []
    for raw, flow, mask, gt in inputs:
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.TrackRGBD(None, raw, flow, mask, mTcw_gt=gt)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    return system, times, launches


def check_main_path(system, seq, n_frames):
    """ATE < 1 % of the path, objects tracked on most frames, result txts
    written. Returns (ate_m, path_m, frames_with_object)."""
    from vido_slam_tpu_torch.metrics import ate_rmse, camera_centers

    est = system.map.poses
    gt = np.stack([fr.Tcw_gt for fr in seq.frames[:n_frames]])
    check(est.shape == gt.shape and np.isfinite(est).all(),
          f"poses of shape {est.shape}, finite: {np.isfinite(est).all()}")
    ate = ate_rmse(est, gt, align=False)
    c = camera_centers(gt.astype(np.float64))
    path = float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
    check(ate < 0.01 * path, f"camera ATE {ate} m over a {path} m path")
    with_obj = sum(any(ob.status for ob in rec.objects)
                   for rec in system.map.frames[1:])
    check(with_obj > (n_frames - 1) // 2,
          f"objects tracked on {with_obj} of {n_frames - 1} frames")
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "out_")
        system.SaveResultsIJRR2020(prefix)
        for name in ("obj_mot_rgbd_new.txt", "initial_rgbd_new.txt",
                     "refined_rgbd_new.txt", "cam_pose_gt.txt"):
            path_txt = prefix + name
            check(os.path.getsize(path_txt) > 0, f"{path_txt} is empty")
        with open(prefix + "refined_rgbd_new.txt") as fh:
            n_lines = len(fh.readlines())
        check(n_lines == n_frames, f"{n_lines} refined poses for {n_frames} "
              f"frames")
    return ate, path, with_obj


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from vido_slam_tpu_torch.estimation import lm_kernel, pose
    from vido_slam_tpu_torch.estimation.pose import (HUBER_DELTA_POSE,
                                                     OBJ_ITERS, POSE_ITERS)
    from vido_slam_tpu_torch.utils import cuda_build
    from vido_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    log = cuda_build.build("pose_lm")
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line:
            print(f"  pose_lm: {line.strip()}")

    # phase 3 on numpy-seeded problems laid out as the main path lays them
    seq = offline_sequence(N_FRAMES, "cuda")
    cam = seq.scene.cam
    rng = np.random.RandomState(0)
    Tcw = _pose([0.0, 0.02, 0.0], [0.1, 0.0, -3.0])
    cases = [
        ("camera B=1 N=3000 huber 0.1", camera_problem(rng, cam, 3000),
         dict(huber_delta=HUBER_DELTA_POSE, max_iters=POSE_ITERS), False),
        ("objects B=8 N=4000, shared points and observations",
         object_problems(rng, cam, 8, 4000, Tcw),
         dict(huber_delta=None, max_iters=OBJ_ITERS), False),
    ]
    err = check_pose_lm(
        [(n, tuple(a.to(dev).contiguous() for a in args), kw, v)
         for n, args, kw, v in cases], cam)

    # phase 4; the stand-in keeps the kernel's arguments for phase 3 below
    counters = [lm_kernel.pose_lm_batched]
    recorder = KernelArgs()
    pose.pose_lm_batched = recorder
    try:
        system, times, launches = run_main_path(
            main_path_inputs(seq, "cuda", N_FRAMES), "cuda", counters)
    finally:
        pose.pose_lm_batched = lm_kernel.pose_lm_batched
    n_tracked = N_FRAMES - 1
    check(launches[0] == 2 * n_tracked,
          f"pose_lm_batched launched {launches[0]} times over {n_tracked} "
          f"frames")
    ate, path, with_obj = check_main_path(system, seq, N_FRAMES)
    steady = times[4:]
    print(f"main path: {N_FRAMES} frames 1280x560, ATE {ate:.4f} m over "
          f"{path:.2f} m ({100 * ate / path:.3f} %), objects on {with_obj}/"
          f"{n_tracked} frames; ms/frame mean {1e3 * np.mean(steady):.2f} "
          f"median {1e3 * np.median(steady):.2f} (frames 4-{n_tracked}, "
          f"host clock over torch.cuda.synchronize)")

    # phase 3 on the arguments the main path gave the kernel in one frame
    frame = recorder.frame_cases()
    err = max(err, check_pose_lm(frame, cam))
    ms, plain_ms, bound_ms, bound_by = time_pose_lm(frame, cam)

    entry = dict(
        name="pose_lm_batched", route="cuda",
        source="vido_slam_tpu_torch/csrc/pose_lm.cu",
        replaces="vido_slam_tpu/estimation/lm_pallas.py:220",
        launches=launches[0], max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
