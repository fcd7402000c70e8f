"""Smoke run of the PyTorch + CUDA port (``vido_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run by raising:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles every kernel in ``csrc/`` (one nvcc each, started
     together) and prints ptxas' report of each kernel (its name,
     registers, shared memory, stack, spills), then the host C++ helpers
     (the PNG unfilter and the JPEG decoder);
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     same numpy-seeded inputs, laid out at the main paths' shapes as the
     main paths lay them out (kernels 3 and 4 at the five pyramid levels of
     a 1280x576 LiteFlowNet pair), with the tolerances stated there;
     every kernel must give the same bits in a second launch;
  4. the paths: the port's ``System`` (RGBD sensor) tracks a synthetic
     KAIST-calibration sequence (1280x560, two moving vehicles, the bench's
     offline widths) on the card twice: (a) the VO path with the fused
     window BA (kernel 1, the pose LM) and (b) the bJoint path at the JAX
     package's default host-assembled window BA (kernel 2, the joint flow +
     pose solve); then (c) the flow path: the perception flow branch with
     the port's LiteFlowNet (seeded random weights) over 8 consecutive
     pairs of the synthetic driving clip at 1280x560 with KAIST focal
     lengths (kernels 3 and 4, the cost volume and the regularization
     tail). The launch counters are zeroed just before each path and read
     just after; (a) and (b) must launch their kernel twice a tracked frame,
     (c) each of its kernels five times a pair, and no other kernel. (a) and
     (b) must keep camera ATE under 1 % of the path length, track objects
     on more than half of the frames and write the result txts; (c) must
     give finite (560, 1280, 2) flows. The kernels' arguments of every call
     are kept, and phase 3 runs again on those of one frame or pair, where
     both versions are also timed. Then the whole net on the card (kernels)
     is held against the port on the CPU (plain versions) on one 192x640
     pair. Last, (d) the mask path: the perception mask branch with the
     port's Mask R-CNN R-50-FPN (seeded random weights, class 3's score
     bias lifted) over 8 frames of the driving clip at 1280x560, the
     detector at 1088x800 (kernel 5, the multilevel ROIAlign, twice a
     frame: the box head's 1000 ROIs at 7x7 and the mask head's 100 at
     14x14); each mask must be a (560, 1280) uint8 map with some labelled
     pixels. Kernel 5 is held against its plain version on seeded pyramids
     and on one frame's arguments; the whole detector on the card against
     the CPU on one frame at 320x256; one frame of the reference ROS
     node's X-101-32x8d-FPN must launch kernel 5 twice and stay finite.
     Then (e) the online path, the JAX bench's ``r50_544x800`` row one
     frame a call: ``System.AttachPerception`` of the port's
     ``PerceptionModel`` (MonoDepth2 and LiteFlowNet at 640x192, Mask
     R-CNN R-50-FPN at 544x800, seeded random weights, class 3 lifted) and
     ``System.TrackFrames`` over the 23 consecutive pairs of the bench clip
     (assets/bench_clip_192x640_24.npz) with FAST features and the fused
     window BA. It must launch kernel 1 twice a tracked frame, kernels 3
     and 4 five times a call and kernel 5 twice a call ([44, 0, 115, 115,
     46]), give 23 finite poses, a finite GetFrameOutput, depths in [0,
     65536] and masks with labelled pixels, and write the result txts; it
     prints its median ms a frame over calls 4-22 beside the card line.
     Phase 3 runs again on the kernels' arguments of call 3, and MonoDepth2
     on the card is held against the CPU on one 192x640 frame. Then VIO,
     with the IMU math on the CPU and the state, step and kernels on the
     card: (f) the JAX bench's offline VIO row (``kaist_offline_1280x560_
     vio``) one frame a call: ``Tracker(use_imu=True)`` with the fused
     window BA over 45 frames of the offline scene (the first 24 are those
     of (a) and (b)), the analytic 200 Hz IMU of ``driving_imu`` fed before
     each frame. The init must fire at the JAX package's frame after its
     attempts (its one-frame-a-call run on the CPU, constants below),
     scale_vs_gt within 0.01 and the SE(3)-aligned ATE within 0.05 m of
     it, the state on the card after the rescale, and kernel 1 twice a
     tracked frame; it prints the init, the scale, the ATEs and its median
     ms a frame over frames 4-44. (g) phase (e)'s configuration, model and
     clip as IMU_RGBD through ``System.TrackFrames`` with the IMU up to
     each frame's timestamp: init attempts from the gate on (>= 10 frames,
     >= 2 s), each tracked call's depth at base x the IMU scale, finite
     poses, phase (e)'s launches; it prints its median ms a frame. (h) the
     offline demo from files: the port's CLI (``vido_slam_tpu_torch.
     run_vido.main``) on dataset trees this script writes into a temporary
     directory with its own PNG writer (the rows' filters cycle through all
     five types): (h1) a KAIST tree of (a)'s scene at 1280x560 (BayerBG
     frames, .flo, 16-bit depth by KAIST's rule, masks, timestamps) as VO
     with FAST features over 24 frames, (h2) the same tree as VIO over (f)'s
     45 frames with ``driving_imu``'s 200 Hz xsens_imu.csv, (h3) a KITTI tree
     at 1242x375 with the KITTI tracking camera 2 over 24 frames, ending in
     the StopFrame full batch at the JAX defaults, (h4) ``--online`` over 8
     frames of the bench clip as a 640x192 KAIST tree. Each writes a line a
     frame into its result txts; (h1)-(h3) keep camera ATE of the initial
     and the refined trajectory under 1 % of the path (SE(3)-aligned for
     VIO) and launch kernel 1 twice a tracked frame and nothing else; (h2)
     initializes at (f)'s frame after (f)'s attempts; (h3)'s refined
     trajectory differs from the initial one; (h4) launches at (e)'s per-call
     counts; the C++ PNG unfilter is bit-equal to its plain version on a
     full-size frame. It prints the CLI loop's ms a frame, reading included,
     with the reading's share, and the full batch's seconds and LM
     iterations, beside the card line. (i) weights and sessions in and
     out: (i1) (a)'s VO configuration tracks 3 frames, ``save_session``
     writes the session (a System on the CPU loads it too, the same
     state), ``load_session`` restores it into a fresh System on the card
     twice, and each tracks the other 21 frames: kernel 1
     twice a frame, the two resumes bit-equal, the poses within 0.05 of
     (a)'s unbroken run (the JAX package's bar); (i2) (e)'s seeded
     ``PerceptionModel`` written as ``depth``/``flow``/``mask`` bundles by
     ``save_torch_state_dict`` and rebuilt by
     ``PerceptionModel.from_pretrained`` on the card: weights and one
     pair's outputs bit-equal, then 5 ``System.TrackFrames`` calls at (e)'s
     per-call launches; (i3) one frame of the GroupNorm R-50-FPN
     (``ResNetConfig(norm="gn")``) at 1088x800, kernel 5 held against its
     plain version on that frame's arguments; and the single-problem
     ``estimate_object_motion`` and ``estimate_object_motion_joint`` on one
     object of 4000 points, kernels 1 and 2 at B=1, each held against its
     plain version. (j) bf16 perception: (j1) (e)'s online cell with
     ``mask_dtype=torch.bfloat16`` (the JAX bench's default) over the same
     23 calls: (e)'s launches, finite poses, the detections' validity and
     labels equal to the float32 detector's on the same frames except
     where a detection lies within a bf16 margin of a threshold
     (``match_detections``), kernel 5's bf16 build held against its bf16
     plain version on call 3's arguments; (j2) one call each with
     ``flow_dtype`` and ``compute_dtype`` bf16: kernels 3 and 4's bf16
     builds against their plain versions at every level, the flow within
     the JAX package's bf16 bar of the float32 flow, the depth within
     BF16_DEPTH_BAR; it prints the bf16 and the float32 ms a frame and
     each bf16 build's device ms, launches and bound beside the float32
     build's on the same values. (k) JPEG frames: the fixtures under
     tests/data/jpeg (every sampling layout, a restart interval, optimised
     tables, gray, 24 KITTI frames of (h3)'s scene written by cv2 at
     quality 95) decoded bit-equal to cv2's committed arrays by the C++
     decoder and its plain version, then the CLI on (h3)'s KITTI
     configuration over a tree of those .jpg frames: ATE under 1 %, the
     StopFrame full batch, kernel 1 twice a tracked frame; it prints the
     decode's ms a frame beside the PNG reading's. (m) the detector
     families, from seed 0 with random weights: (m1)
     ``PerceptionModel(mask_cfg=RESNEXT101_FPN_DCN)`` (class 3 lifted,
     seeded non-zero offset convs) through ``perception_mask`` over 3
     frames of the driving clip at 1280x560, the detector at 1088x800:
     kernel 5 twice a frame, labelled pixels in every mask, its ms a frame
     beside a plain X-101-32x8d frame's, and the DCN detector on the card
     against the CPU at 320x256; (m2) ``fbnet_inference`` ("default",
     class 3 lifted) at 1088x800 over 3 frames: kernel 5 once a frame (the
     one-level pooler), held against its plain version on the last frame's
     arguments and timed there, and the five archs' trunks on the card
     against the CPU at 320x256; (m3) ``retinanet_inference`` (R-50-FPN,
     classes 3 and 7 lifted) at 1088x800: no launch, and the card against
     the CPU at 320x256; (m4) the keypoint head on (d)'s R-50-FPN P2-P5 and
     its 100 detections, then ``keypoints_from_heatmaps``: kernel 5 once,
     held against its plain version and timed, heatmaps card against CPU;
     (m5) ``roi_pool`` 7x7 over those 100 boxes on P4: the card's bits
     equal the CPU's. Each part prints its ms beside the card line;
  5. summary: a ``{"kernels": [...]}`` JSON line (each kernel also with
     its launches on the online path and its device ms on the online
     call's arguments, its launches on (f) and (g), on (h1)-(h4), on
     (i1)-(i3) and the B=1 calls and on (k), and its bf16 build's
     launches, device ms, plain ms and bound in (j) beside the float32
     build's device ms on the same values; its launches in (m1)-(m4), and
     kernel 5's device ms, plain ms and bound at the FBNet and keypoint
     shapes), then the device line.

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
# the bJoint path: the window BA at the default (host-assembled), full records
JOINT_KW = dict(n_bg=3000, n_obj=4000, max_objects=8, seed=0,
                ba_max_points=1000, ba_iters=10, joint_flow=True,
                record="full")


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
    sides of the 0.01 inlier threshold; a second launch gives the same
    bits. Returns max_abs_err over T and the chi2 of valid points with
    chi2_ref <= 1."""
    import torch
    from vido_slam_tpu_torch.estimation import lm_kernel
    from vido_slam_tpu_torch.estimation.pose import RP_THRES
    from vido_slam_tpu_torch.geometry.se3 import inverse_se3, log_se3

    err = 0.0
    for name, args, kw, valid_only in cases:
        got = lm_kernel.pose_lm_batched(*args, cam, **kw)
        again = lm_kernel.pose_lm_batched(*args, cam, **kw)
        ref = lm_kernel.pose_lm_batched_ref(*args, cam, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              (name, "two launches differ"))
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
              f"{ref.num_iters.tolist()}: within the bars; plan "
              f"{lm_kernel.launch_plan(*valid.shape)}")
    return err


def time_pose_lm(cases, cam):
    """Kernel and plain ms of the cases together and their bound: (ms,
    plain_ms, bound_ms, bound_by). The kernel's ms is its device time
    (``time_cuda_graph``, 20 calls); beside it is printed the mean of 20
    calls by CUDA events after a warm-up, which includes the wrappers' host
    time. The plain version's ms: CUDA events over 3 calls."""
    from vido_slam_tpu_torch.estimation import lm_kernel

    ms = plain_ms = 0.0
    nbytes = flops = 0
    for name, args, kw, _ in cases:
        def kernel():
            return lm_kernel.pose_lm_batched(*args, cam, **kw)
        k_ms = time_cuda_graph(kernel, 20)
        ev_ms = time_cuda(kernel, 20)
        p_ms = time_cuda(
            lambda: lm_kernel.pose_lm_batched_ref(*args, cam, **kw), 3)
        b_, f_ = lm_bound(args, kernel(), kw["huber_delta"])
        print(f"pose_lm_batched {name}: kernel {k_ms:.4f} ms (graph replay; "
              f"{ev_ms:.4f} ms by events), plain {p_ms:.3f} ms, {b_} bytes, "
              f"{f_} flops; plan {lm_kernel.launch_plan(*args[4].shape)}")
        ms += k_ms
        plain_ms += p_ms
        nbytes += b_
        flops += f_
    return (ms, plain_ms) + bound(nbytes, flops)


def joint_camera_problem(rng, cam, N):
    """The camera's joint solve as the main path lays it out (B=1): points
    5-40 m in front of the last camera (the world frame here), their last
    pixels, the measured flow to their projection through T_true with
    0.3 px noise and 8 % of +30 px outliers, about 90 % in the initial
    inlier set, T_init perturbed."""
    import torch

    uv = np.stack([rng.uniform(30.0, cam.width - 30.0, N),
                   rng.uniform(20.0, cam.height - 20.0, N)], -1)
    obs_last = torch.tensor(uv, dtype=torch.float32)
    X = cam.backproject(obs_last, torch.tensor(rng.uniform(5.0, 40.0, N),
                                               dtype=torch.float32))
    Tt = _pose(rng.normal(0, 0.01, 3), rng.normal(0, 0.3, 3))
    fm = cam.project(X @ Tt[:3, :3].T + Tt[:3, 3]) - obs_last
    fm += torch.tensor(rng.normal(0, 0.3, (N, 2)), dtype=torch.float32)
    fm[torch.tensor(rng.uniform(size=N) < 0.08)] += 30.0
    valid = torch.tensor(rng.uniform(size=(1, N)) < 0.9)
    T0 = _pose(rng.normal(0, 0.005, 3), rng.normal(0, 0.05, 3)) @ Tt
    return T0[None], X, obs_last, fm, valid


def joint_object_problems(rng, cam, B, N, Tcw):
    """The object batch's joint solve as the main path lays it out: one
    (N, 3) world point set, one (N, 2) array of last pixels and one (N, 2)
    measured flow shared by the B problems, each object's points picked out
    by a disjoint mask; object b is a 600 x 300 px patch 2-10 m away moved
    by its own motion H_b (flow noise 0.2 px), a tenth of the points
    belongs to no object, M_init = Tcw H_b perturbed."""
    import torch

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
    obs_last = torch.tensor(uv, dtype=torch.float32)
    X = cam.backproject(obs_last, torch.tensor(z, dtype=torch.float32))
    fm = torch.zeros(N, 2)
    masks, M0 = [], []
    for b in range(B):
        sel = torch.tensor(owner == b)
        M = Tcw @ _pose(rng.normal(0, 0.01, 3), rng.normal(0, 0.3, 3))
        fm[sel] = cam.project(X[sel] @ M[:3, :3].T + M[:3, 3]) - obs_last[sel]
        masks.append(sel)
        M0.append(_pose(rng.normal(0, 0.005, 3), rng.normal(0, 0.05, 3)) @ M)
    fm += torch.tensor(rng.normal(0, 0.2, (N, 2)), dtype=torch.float32)
    return torch.stack(M0), X, obs_last, fm, torch.stack(masks)


def check_flow_joint(cases, cam) -> float:
    """flow_joint_batched against flow_joint_batched_ref on each case
    (name, args). Bars (per problem, those of the JAX parity test
    tests/test_flow_joint.py:190-200): |log(T_ref^-1 T)| < 1e-4, inlier
    sets differing on at most max(3, 1 %) of the points, the flows of
    common inliers within 1e-2 px; a second launch gives the same bits.
    Returns max_abs_err over T and those flows."""
    import torch
    from vido_slam_tpu_torch.estimation import flow_joint_kernel as fj
    from vido_slam_tpu_torch.geometry.se3 import inverse_se3, log_se3

    err = 0.0
    for name, args in cases:
        got = fj.flow_joint_batched(*args, cam)
        again = fj.flow_joint_batched(*args, cam)
        ref = fj.flow_joint_batched_ref(*args, cam)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              (name, "two launches differ"))
        N = args[4].shape[1]
        for b in range(args[4].shape[0]):
            rot = float(torch.linalg.norm(
                log_se3(inverse_se3(ref.T[b]) @ got.T[b])))
            flips = int((got.inliers[b] != ref.inliers[b]).sum())
            both = got.inliers[b] & ref.inliers[b]
            dflow = float((got.flow[b] - ref.flow[b]).abs()[both].max()) \
                if both.any() else 0.0
            check(math.isfinite(rot) and rot < 1e-4, (name, b, "pose", rot))
            check(flips <= max(3, N // 100), (name, b, "inlier flips", flips))
            check(dflow < 1e-2, (name, b, "flow", dflow))
            err = max(err, dflow)
        err = max(err, float((got.T - ref.T).abs().max()))
        print(f"flow_joint_batched {name}: valid {args[4].sum(-1).tolist()}, "
              f"inliers {got.num_inliers.tolist()}, iters "
              f"{got.num_iters.tolist()}, plain {ref.num_iters.tolist()}: "
              f"within the bars")
    return err


def time_flow_joint(cases, cam):
    """Kernel and plain ms of the cases together and their bound: (ms,
    plain_ms, bound_ms, bound_by), timed as ``time_pose_lm`` times kernel
    1."""
    from vido_slam_tpu_torch.estimation import flow_joint_kernel as fj

    ms = plain_ms = 0.0
    nbytes = flops = 0
    for name, args in cases:
        def kernel():
            return fj.flow_joint_batched(*args, cam)
        k_ms = time_cuda_graph(kernel, 20)
        ev_ms = time_cuda(kernel, 20)
        p_ms = time_cuda(lambda: fj.flow_joint_batched_ref(*args, cam), 3)
        res = kernel()
        b_ = sum(t.numel() * t.element_size() for t in args + tuple(res))
        f_ = fj.operations(args[4], res.num_iters)
        print(f"flow_joint_batched {name}: kernel {k_ms:.4f} ms (graph "
              f"replay; {ev_ms:.4f} ms by events), plain {p_ms:.3f} ms, "
              f"{b_} bytes, {f_} flops; plan "
              f"{fj.launch_plan(*args[4].shape)}")
        ms += k_ms
        plain_ms += p_ms
        nbytes += b_
        flops += f_
    return (ms, plain_ms) + bound(nbytes, flops)


# LiteFlowNet at the KAIST perception size: 1280x560 frames run the net at
# 1280x576 (the next multiples of 32); per pyramid level 2..6 the cost
# volume's (channels, height, width, stride) and the regularization's
# (window, height, width)
FLOW_H, FLOW_W = 560, 1280
FLOW_PAIRS = 8
CORR_LEVELS = [(64, 288, 640, 2), (64, 144, 320, 2), (96, 72, 160, 1),
               (128, 36, 80, 1), (192, 18, 40, 1)]
REG_LEVELS = [(7, 288, 640), (5, 144, 320), (5, 72, 160), (3, 36, 80),
              (3, 18, 40)]


def flow_level(args) -> str:
    """'level L' of a recorded cost-volume (f1, f2, stride) or
    regularization (dc, flow, ...) call, by its shape."""
    x = args[0]
    if len(args) == 3:
        shape = (x.shape[1], x.shape[2], x.shape[3], args[2])
        return f"level {2 + CORR_LEVELS.index(shape)}"
    shape = (args[6], x.shape[2], x.shape[3])
    return f"level {2 + REG_LEVELS.index(shape)}"


def correlation_cases(rng, dev):
    """Seeded unit-normal (f1, f2, stride) at each level's shape, N=1."""
    import torch

    def t(*shape):
        return torch.tensor(rng.randn(*shape).astype(np.float32), device=dev)

    return [(f"level {lv} C={C} {H}x{W} stride {s}", (t(1, C, H, W),
                                                      t(1, C, H, W), s))
            for lv, (C, H, W, s) in zip(range(2, 7), CORR_LEVELS)]


def regularize_cases(rng, dev):
    """Seeded (dc, flow, wx, bx, wy, by, k) at each level's shape, N=1:
    unit-normal logits and weights, flows of a few px."""
    import torch

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    cases = []
    for lv, (k, H, W) in zip(range(2, 7), REG_LEVELS):
        K = k * k
        cases.append((f"level {lv} K={K} {H}x{W}", (
            t(rng.randn(1, K, H, W)), t(rng.randn(1, 2, H, W) * 3),
            t(rng.randn(K)), t([0.3]), t(rng.randn(K)), t([-0.2]), k)))
    return cases


def check_correlation(cases) -> float:
    """correlation against correlation_ref on each case (name, args): max
    |kernel - plain| <= 1e-5 max(1, max |plain|), the bar of the CPU test
    (atol 1e-5 on unit-normal inputs) relative to the output's magnitude;
    a second launch gives the same bits. Returns max_abs_err."""
    import torch
    from vido_slam_tpu_torch.ops import correlation as corr

    err = 0.0
    for name, args in cases:
        got = corr.correlation(*args)
        again = corr.correlation(*args)
        ref = corr.correlation_ref(*args)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        check(got.shape == ref.shape and math.isfinite(e)
              and e <= 1e-5 * scale, ("correlation", name, e, scale))
        check(torch.equal(got, again), ("correlation", name,
                                        "two launches differ"))
        err = max(err, e)
        print(f"correlation {name}: max error {e:.3e} (bar "
              f"{1e-5 * scale:.1e}); plan "
              f"{corr.launch_plan(*args[0].shape, args[2])}")
    return err


def check_regularize(cases) -> float:
    """dist_weighted_flow against dist_weighted_flow_ref on each case:
    |kernel - plain| <= 1e-5 + 1e-5 |plain| element by element (the CPU
    test's rtol = atol = 1e-5); a second launch gives the same bits.
    Returns max_abs_err."""
    import torch
    from vido_slam_tpu_torch.ops import regularize as reg

    err = 0.0
    for name, args in cases:
        got = reg.dist_weighted_flow(*args)
        again = reg.dist_weighted_flow(*args)
        ref = reg.dist_weighted_flow_ref(*args)
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        ok = bool((diff <= 1e-5 + 1e-5 * ref.abs()).all())
        e = float(diff.max())
        check(got.shape == ref.shape and ok and math.isfinite(e),
              ("dist_weighted_flow", name, e))
        check(torch.equal(got, again), ("dist_weighted_flow", name,
                                        "two launches differ"))
        err = max(err, e)
        print(f"dist_weighted_flow {name}: max error {e:.3e}, within "
              f"rtol = atol = 1e-5; {reg.copy_width(args[1])}-byte flow "
              f"copies")
    return err


def time_cuda_graph(fn, reps):
    """Device ms of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    the replay timed by CUDA events. Unlike ``time_cuda`` it leaves out the
    host time of the calls, which is longer than a small kernel."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_flow_kernel(cases, kernel, plain, count):
    """Kernel and plain ms of the cases together (one pair's five levels)
    and their bound: (ms, plain_ms, bound_ms, bound_by). The kernel's ms is
    its device time (``time_cuda_graph``, 20 calls), the plain version's
    the mean of 3 calls after a warm-up (CUDA events). ``count(args)``
    gives the (bytes, flops) of a call."""
    ms = plain_ms = 0.0
    nbytes = flops = 0
    for name, args in cases:
        k_ms = time_cuda_graph(lambda: kernel(*args), 20)
        p_ms = time_cuda(lambda: plain(*args), 3)
        b_, f_ = count(args)
        print(f"{kernel.__name__} {name}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, {b_} bytes, {f_} flops")
        ms += k_ms
        plain_ms += p_ms
        nbytes += b_
        flops += f_
    return (ms, plain_ms) + bound(nbytes, flops)


def flow_inputs(dev):
    """The flow path's inputs on ``dev``: FLOW_PAIRS + 1 frames of the
    driving clip at 1280x560 (KAIST focal lengths) and the port's
    LiteFlowNet from seed 0."""
    from vido_slam_tpu_torch.io.synthetic import driving_clip
    from vido_slam_tpu_torch.models.liteflownet import LiteFlowNet

    cfg = OFFLINE_CONFIG
    clip = driving_clip(height=FLOW_H, width=FLOW_W, n_frames=FLOW_PAIRS + 1,
                        fx=cfg["Camera.fx"], fy=cfg["Camera.fy"], device=dev)
    return clip, LiteFlowNet(seed=0, device=dev)


def run_flow_path(clip, net, counters):
    """The perception flow branch over the clip's consecutive pairs.
    Returns the flows, the host seconds of every pair and each counter's
    launches during the run."""
    import torch
    from vido_slam_tpu_torch.models.perception import perception_flow

    for c in counters:
        c.launches = 0
    flows, times = [], []
    for k in range(clip.shape[0] - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flows.append(perception_flow(net, clip[k], clip[k + 1]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return flows, times, [c.launches for c in counters]


def check_whole_net(dev) -> float:
    """The whole net on the card (kernels) against the port on the CPU
    (plain versions), same seed-0 weights, on one 192x640 pair of the
    driving clip: max |flow_gpu - flow_cpu| <= 1e-3 max(1, max |flow|).
    Returns the error."""
    import torch
    from vido_slam_tpu_torch.io.synthetic import driving_clip
    from vido_slam_tpu_torch.models.liteflownet import LiteFlowNet

    clip = driving_clip(height=192, width=640, n_frames=2, device=dev)
    x = clip.permute(0, 3, 1, 2) / 255.0
    got = LiteFlowNet(seed=0, device=dev)(x[:1], x[1:]).cpu()
    xc = x.cpu()
    want = LiteFlowNet(seed=0, device="cpu")(xc[:1], xc[1:])
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    check(got.shape == (1, 2, 96, 320) and math.isfinite(err)
          and err <= 1e-3 * scale, ("whole net GPU vs CPU", err, scale))
    print(f"whole net 192x640, card (kernels) vs CPU (plain): max |flow| "
          f"{float(want.abs().max()):.4f}, max error {err:.3e}")
    return err


# Mask R-CNN at the perception size: a 1280x560 frame runs the detector at
# 1088x800, whose P2-P5 are 272x200 ... 34x25 at 256 channels
MASK_FRAMES = 8
MASK_LEVELS = [(272, 200), (136, 100), (68, 50), (34, 25)]
# class 3 (car): its score bias lifted so that random weights give
# detections, and on a 0..1 image a probability of exactly 1.0 (ties that
# float32 noise cannot reorder)
MASK_LIFT = 30.0


def roi_cases(rng, dev):
    """Seeded (feats, rois, levels, scales, resolution, 2) at the heads'
    shapes: unit-normal P2-P5 of a 1088x800 image, the box head's 1000
    ROIs at 7x7 and the mask head's 100 at 14x14. The ROIs span all four
    levels (sides log-uniform from 0.3 to 1500 px, so some under 1 px) and
    start up to 60 px outside the image; two 28-px boxes put samples
    exactly at -1 and at 271 = H - 1 of P2."""
    import torch
    from vido_slam_tpu_torch.models.maskrcnn.roi_heads import (
        POOLER_SCALES, assign_fpn_level)

    feats = [torch.tensor(rng.randn(1, 256, h, w).astype(np.float32),
                          device=dev) for h, w in MASK_LEVELS]
    cases = []
    for R, r in ((1000, 7), (100, 14)):
        x1 = rng.uniform(-60, 800, R)
        y1 = rng.uniform(-60, 1088, R)
        ww, hh = np.exp(rng.uniform(np.log(0.3), np.log(1500), (2, R)))
        rois = np.stack([x1, y1, x1 + ww, y1 + hh], 1).astype(np.float32)
        rois[:2] = [[-5, -5, 23, 23], [100, 1081, 128, 1109]]
        rois = torch.tensor(rois, device=dev)
        levels = assign_fpn_level(rois)
        cases.append((f"R={R} {r}x{r} levels "
                      f"{torch.bincount(levels.long(), minlength=4).tolist()}",
                      (feats, rois, levels, POOLER_SCALES, r, 2)))
    return cases


def roi_plan(args):
    """The launch plan the wrapper picks for roi_align_multilevel(*args)."""
    from vido_slam_tpu_torch.ops import roi_align

    feats, rois, _, _, r, s = args
    return roi_align.launch_plan(rois.shape[0], feats[0].shape[1], r, s,
                                 roi_align.level_sizes(feats))


def check_roi_align(cases) -> float:
    """roi_align_multilevel against roi_align_multilevel_ref on each case:
    max |kernel - plain| <= 1e-5 max(1, max |feature|) (the kernel and the
    plain version put every sample at the same float32 position and differ
    only in the order of 16 weighted sums); a second launch gives the same
    bits. Returns max_abs_err."""
    import torch
    from vido_slam_tpu_torch.ops import roi_align

    err = 0.0
    for name, args in cases:
        got = roi_align.roi_align_multilevel(*args)
        again = roi_align.roi_align_multilevel(*args)
        ref = roi_align.roi_align_multilevel_ref(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, again), ("roi_align_multilevel", name,
                                        "two launches differ"))
        e = float((got - ref).abs().max())
        scale = max(1.0, max(float(f.abs().max()) for f in args[0]))
        check(got.shape == ref.shape and math.isfinite(e)
              and e <= 1e-5 * scale, ("roi_align_multilevel", name, e, scale))
        err = max(err, e)
        print(f"roi_align_multilevel {name}: max error {e:.3e} (bar "
              f"{1e-5 * scale:.1e}); plan {roi_plan(args)}")
    return err


def mask_inputs(dev):
    """The mask path's inputs on ``dev``: MASK_FRAMES frames of the driving
    clip at 1280x560 (KAIST focal lengths) and the port's Mask R-CNN
    R-50-FPN (at 1088x800) from seed 0 with class 3 lifted."""
    from vido_slam_tpu_torch.io.synthetic import driving_clip
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           RESNET50_FPN)

    c = OFFLINE_CONFIG
    clip = driving_clip(height=FLOW_H, width=FLOW_W, n_frames=MASK_FRAMES,
                        fx=c["Camera.fx"], fy=c["Camera.fy"], device=dev)
    model = lifted(MaskRCNN(RESNET50_FPN, seed=0, device=dev))
    return clip, model


def lifted(model):
    """``model`` with class 3's score bias at MASK_LIFT."""
    import torch

    with torch.no_grad():
        model.roi_heads.box.predictor.cls_score.bias[3] = MASK_LIFT
    return model


class Detected:
    """Stands in for a function of ``models/perception.py``
    (``maskrcnn_inference``, ``perception_forward``): passes every call on
    and keeps each call's output (on the device, read after the run)."""

    def __init__(self, fn):
        self.fn = fn
        self.outputs = []

    def __call__(self, *args):
        out = self.fn(*args)
        self.outputs.append(out)
        return out


def run_mask_path(clip, model, counters):
    """The perception mask branch over the clip's frames. Returns the masks,
    each frame's detections, the host seconds of every frame and each
    counter's launches during the run."""
    import torch
    from vido_slam_tpu_torch.models import perception

    detected = Detected(perception.maskrcnn_inference)
    perception.maskrcnn_inference = detected
    try:
        for c in counters:
            c.launches = 0
        masks, times = [], []
        for k in range(clip.shape[0]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masks.append(perception.perception_mask(model, clip[k],
                                                    device=clip.device))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = [c.launches for c in counters]
    finally:
        perception.maskrcnn_inference = detected.fn
    return masks, detected.outputs, times, launches


def check_masks(masks, dets, what) -> list:
    """Each mask (560, 1280) uint8 with some labelled pixels, each frame's
    detections finite. Returns the valid detections per frame."""
    import torch

    n_valid = []
    for m, d in zip(masks, dets):
        check(m.shape == (FLOW_H, FLOW_W) and m.dtype == torch.uint8
              and bool((m > 0).any()),
              f"{what}: mask {tuple(m.shape)} {m.dtype}, labelled pixels "
              f"{int((m > 0).sum())}")
        check(bool(torch.isfinite(d.boxes).all())
              and bool(torch.isfinite(d.masks28).all()),
              f"{what}: non-finite detections")
        n_valid.append(int(d.valid.sum()))
    return n_valid


def box_iou(a, b) -> np.ndarray:
    """(len(a), len(b)) IoUs of x1y1x2y2 boxes, +1 pixel convention (the
    detector's)."""
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(hi - lo + 1, 0, None), -1)

    def area(z):
        return (z[:, 2] - z[:, 0] + 1) * (z[:, 3] - z[:, 1] + 1)
    return inter / (area(a)[:, None] + area(b)[None] - inter)


# Where two detectors' outputs differ slot by slot (the detections come
# sorted by score, so validity differs in the count of valid slots, and a
# label where the order differs), the detection at that slot must lie
# within a bf16 margin of a threshold: its score within SCORE_MARGIN of the
# confidence threshold or of the lowest kept score of its class (the
# per-class and per-image top-k cuts rank candidates by score; where the
# scores lie within a bf16 step of each other, as random weights with a
# lifted class give them, the cut among them is a tie), or its IoU with
# another kept box within IOU_MARGIN of the box head's NMS threshold.
NMS_IOU = 0.5
IOU_MARGIN = 0.1
SCORE_MARGIN = 2.0 ** -7   # a bf16 step just below 1


def match_detections(a: dict, b: dict, confidence: float) -> dict:
    """Two detectors' outputs on one frame (numpy "boxes", "scores",
    "labels", "valid"): the slots whose validity or label differ, each
    explained when its detection lies within a bf16 margin of a threshold
    (the margins above); and, as a measure of the boxes, the valid
    detections matched one to one in score order by label and IoU >= 0.9.
    Returns the counts and the unexplained slots (output, slot, score,
    largest IoU with another valid detection of its output)."""
    a, b = ({k: np.asarray(d[k], bool if k == "valid" else None)
             for k in ("boxes", "scores", "labels", "valid")} for d in (a, b))
    ia, ib = np.nonzero(a["valid"])[0], np.nonzero(b["valid"])[0]
    iou = box_iou(a["boxes"][ia], b["boxes"][ib])
    iou[a["labels"][ia][:, None] != b["labels"][ib][None]] = 0.0
    used = set()
    for k in np.argsort(-a["scores"][ia], kind="stable"):
        cand = [j for j in np.argsort(-iou[k], kind="stable")
                if j not in used and iou[k, j] >= 0.9]
        if cand:
            used.add(cand[0])
    differ = np.nonzero((a["valid"] != b["valid"])
                        | (a["valid"] & (a["labels"] != b["labels"])))[0]
    unexplained = []
    for name, det in (("a", a), ("b", b)):
        for i in differ:
            if not det["valid"][i]:
                continue
            others = [j for j in np.nonzero(det["valid"])[0] if j != i]
            near = float(box_iou(det["boxes"][i:i + 1],
                                 det["boxes"][others]).max()) if others \
                else 0.0
            score, label = float(det["scores"][i]), det["labels"][i]
            lowest = min(float(d["scores"][d["valid"]
                                           & (d["labels"] == label)].min(
                                               initial=np.inf))
                         for d in (a, b))
            if abs(near - NMS_IOU) > IOU_MARGIN \
                    and abs(score - confidence) > SCORE_MARGIN \
                    and abs(score - lowest) > SCORE_MARGIN:
                unexplained.append((name, int(i), score, near))
    return {"valid": (len(ia), len(ib)), "slots_differ": len(differ),
            "boxes_matched": len(used), "unexplained": unexplained}


def check_whole_detector(dev, frame, resnet=None, prepare=lifted,
                         what="whole detector") -> float:
    """The whole detector on the card (kernel 5) against the port on the
    CPU (plain version), same seed-0 weights (the R-50-FPN unless
    ``resnet`` is given; ``prepare`` applied on each device), on one
    driving-clip frame resized to 320x256 and scaled to 0..1: FPN features
    and the box head's logits (on the CPU's proposals) within 1e-4 of their
    largest magnitude; the (560, 1280) semantic masks equal on at least
    99 % of the pixels (the discrete selections may part on float noise).
    Returns the largest relative error."""
    import torch
    from vido_slam_tpu_torch.models.maskrcnn import model as mm
    from vido_slam_tpu_torch.models.maskrcnn.backbone import ResNetConfig
    from vido_slam_tpu_torch.models.maskrcnn.roi_heads import box_head_forward
    from vido_slam_tpu_torch.ops.warp import resize_bilinear

    cfg = mm.MaskRCNNConfig(resnet=resnet or ResNetConfig(), input_h=320,
                            input_w=256)
    x = (resize_bilinear(frame.permute(2, 0, 1)[None], 320, 256)
         / 255.0).contiguous()
    dev = str(dev)
    nets = {d: prepare(mm.MaskRCNN(cfg, seed=0, device=d))
            for d in (dev, "cpu")}
    xs = {dev: x, "cpu": x.cpu()}
    with torch.no_grad():
        feats = {d: nets[d].backbone(xs[d]) for d in nets}
        props, _, _ = mm.rpn_proposals(nets["cpu"], feats["cpu"])
        logits = {d: box_head_forward(nets[d].roi_heads.box, feats[d][:4],
                                      props.to(d))[0].cpu() for d in nets}
    rel = 0.0
    for name, got, want in [(f"P{i + 2}", feats[dev][i].cpu(),
                             feats["cpu"][i]) for i in range(5)]             + [("box logits", logits[dev], logits["cpu"])]:
        e = float((got - want).abs().max())             / max(1.0, float(want.abs().max()))
        check(math.isfinite(e) and e <= 1e-4, (what, name, e))
        rel = max(rel, e)
    sem = {}
    for d in nets:
        det = mm.maskrcnn_inference(nets[d], xs[d])
        sem[d] = mm.paste_semantic_mask(det, 320, 256, FLOW_H, FLOW_W).cpu()
        sem[d + " valid"] = int(det.valid.sum())
    agree = float((sem[dev] == sem["cpu"]).float().mean())
    check(agree >= 0.99 and bool((sem["cpu"] > 0).any()),
          (what, "semantic masks", agree))
    print(f"{what} 320x256, card (kernel) vs CPU (plain): largest "
          f"error {rel:.3e} of the magnitude (FPN P2-P6, box logits); valid "
          f"detections {sem[dev + ' valid']} and {sem['cpu valid']}; semantic "
          f"masks agree on {100 * agree:.4f} % of the pixels")
    return rel


def time_roi_align(cases):
    """Kernel and plain ms of one frame's two calls together and their
    bound: (ms, plain_ms, bound_ms, bound_by). Kernel ms is device time
    (``time_cuda_graph``, 20 calls), plain ms CUDA events over 3 calls."""
    from vido_slam_tpu_torch.ops import roi_align

    ms = plain_ms = 0.0
    nbytes = flops = 0
    for name, args in cases:
        k_ms = time_cuda_graph(lambda: roi_align.roi_align_multilevel(*args),
                               20)
        p_ms = time_cuda(lambda: roi_align.roi_align_multilevel_ref(*args), 3)
        b_ = roi_align.nbytes(*args)
        f_ = roi_align.operations(args[1], args[0][0].shape[1], args[4],
                                  args[5])
        print(f"roi_align_multilevel {name}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, {b_} bytes, {f_} flops; plan "
              f"{roi_plan(args)}")
        ms += k_ms
        plain_ms += p_ms
        nbytes += b_
        flops += f_
    return (ms, plain_ms) + bound(nbytes, flops)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the float32 operations over the float32 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


class KernelArgs:
    """Stands in for a kernel's wrapper (``pose_lm_batched`` in
    ``estimation/pose.py``, ``flow_joint_batched`` in
    ``estimation/flow_joint.py``, ``correlation`` and ``dist_weighted_flow``
    in ``models/liteflownet.py``, ``roi_align_multilevel`` in
    ``models/maskrcnn/roi_heads.py``) while a main path runs: passes every
    call on to the wrapper, which launches and counts, and keeps a copy of
    each call's first ``n_args`` positional arguments (tensors, also in
    lists, cloned) and its keywords, so that the kernel can be held against
    its plain version on what the main path gave it."""

    def __init__(self, wrapper, n_args=5):
        self.wrapper = wrapper
        self.n_args = n_args
        self.calls = []
        # keeps the arguments only while on (the online path keeps those of
        # one call)
        self.on = True

    def __call__(self, *args, **kw):
        import torch

        def keep(a):
            if torch.is_tensor(a):
                return a.clone()
            return [keep(x) for x in a] if isinstance(a, list) else a

        if self.on:
            self.calls.append((tuple(keep(a) for a in args[:self.n_args]),
                               kw))
        return self.wrapper(*args, **kw)

    def frame_calls(self):
        """The (camera, objects) calls of the tracked frame whose object
        call has the most valid points, and the frame's number."""
        pairs = [self.calls[i:i + 2] for i in range(0, len(self.calls), 2)]
        k = max(range(len(pairs)),
                key=lambda i: int(pairs[i][1][0][4].sum()))
        return pairs[k], k + 1


# ---------------------------------------------------------------------------
# phase 4: main path
# ---------------------------------------------------------------------------

def offline_sequence(n_frames, device, cfg=OFFLINE_CONFIG):
    """The offline bench scene: KAIST calibration (or ``cfg``'s camera),
    the analytic driving trajectory, two vehicles (one semantic label)
    driving toward the camera."""
    import torch
    from vido_slam_tpu_torch.geometry.camera import Camera
    from vido_slam_tpu_torch.io.synthetic import (Box, SyntheticScene,
                                                  SyntheticSequence,
                                                  driving_pose,
                                                  translation_se3)

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


def run_main_path(inputs, device, counters, tracker_kw=TRACKER_KW):
    """Drive System.TrackRGBD over the frames; returns the system, the
    host seconds of every frame (the first one initialises) and each
    counter's launches during the run."""
    import torch
    from vido_slam_tpu_torch.config import config_from_dict
    from vido_slam_tpu_torch.system import Sensor, System

    system = System()
    system.init_from_config(config_from_dict(OFFLINE_CONFIG), Sensor.RGBD,
                            device=device, **tracker_kw)
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
    check_results_written(system, n_frames)
    return ate, path, with_obj


def check_results_written(system, n_frames, with_objects=True):
    """SaveResultsIJRR2020 writes the four result txts, one refined pose a
    frame; the object motions' file is empty only where ``with_objects``
    is False (no object was tracked)."""
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "out_")
        system.SaveResultsIJRR2020(prefix)
        for name in ("obj_mot_rgbd_new.txt", "initial_rgbd_new.txt",
                     "refined_rgbd_new.txt", "cam_pose_gt.txt"):
            path_txt = prefix + name
            check(os.path.getsize(path_txt) > 0
                  or (name.startswith("obj_") and not with_objects),
                  f"{path_txt} is empty")
        with open(prefix + "refined_rgbd_new.txt") as fh:
            n_lines = len(fh.readlines())
        check(n_lines == n_frames, f"{n_lines} refined poses for {n_frames} "
              f"frames")


# ---------------------------------------------------------------------------
# phase 4 (e): the online path
# ---------------------------------------------------------------------------

# the JAX bench's r50_544x800 row (bench.py:49-73, 545-547) one frame a
# call: the KAIST half calibration at 640x192, UseSampleFeature unset (FAST
# corners), no IMU; the detector at 544x800 in float32
ONLINE_CONFIG = {
    "Camera.width": 640, "Camera.height": 192, "Camera.fx": 408.201,
    "Camera.fy": 408.69, "Camera.cx": 304.1329, "Camera.cy": 133.344,
    "Camera.bf": 193.785, "ChooseData": 3, "DepthMapFactor": 500,
    "WINDOW_SIZE": 20, "MaxTrackPointBG": 3000, "MaxTrackPointOBJ": 800,
    "Camera.fps": 10,
}
ONLINE_H, ONLINE_W = 192, 640
ONLINE_DETECTOR = (544, 800)
ONLINE_CLIP = os.path.join("assets", "bench_clip_192x640_24.npz")
# the call whose kernel arguments phase 3 reruns: a tracked frame outside
# the timed calls 4-22
ONLINE_RECORD = 3


def online_inputs(dev, **options):
    """The online path's inputs: the bench clip's 24 frames on ``dev`` (fed
    as the JAX bench feeds them, as BGR in 0..255), their poses, and the
    port's PerceptionModel from seed 0 (class 3 lifted) on ``dev``, with
    the dtype ``options`` (``mask_dtype`` ...) given."""
    import torch
    from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNNConfig
    from vido_slam_tpu_torch.models.perception import PerceptionModel

    clip = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ONLINE_CLIP))
    frames = torch.tensor(clip["clip"].astype(np.float32), device=dev)
    h, w = ONLINE_DETECTOR
    model = PerceptionModel(ONLINE_H, ONLINE_W,
                            MaskRCNNConfig(input_h=h, input_w=w), seed=0,
                            device=dev, **options)
    lifted(model.mask_model)
    return frames, clip["tcw"], model


def run_online_path(frames, tcw, model, counters, recorders):
    """System.AttachPerception, then System.TrackFrames over the clip's
    consecutive pairs. The stand-ins in ``recorders`` keep the kernels'
    arguments of call ONLINE_RECORD only. Returns the system, each call's
    PerceptionOutput, the host seconds of every call (the first one
    initialises) and each counter's launches during the run."""
    import torch
    from vido_slam_tpu_torch.config import config_from_dict
    from vido_slam_tpu_torch.models import perception
    from vido_slam_tpu_torch.system import Sensor, System

    dev = frames.device
    system = System()
    system.init_from_config(config_from_dict(ONLINE_CONFIG), Sensor.RGBD,
                            device=dev, **TRACKER_KW)
    system.AttachPerception(model)
    perceived = Detected(perception.perception_forward)
    perception.perception_forward = perceived
    try:
        for c in counters:
            c.launches = 0
        times = []
        for k in range(frames.shape[0] - 1):
            for r in recorders:
                r.on = k == ONLINE_RECORD
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            system.TrackFrames(frames[k], frames[k + 1], mTcw_gt=tcw[k])
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = [c.launches for c in counters]
    finally:
        perception.perception_forward = perceived.fn
    return system, perceived.outputs, times, launches


def check_online_path(system, outputs, n_calls):
    """n_calls finite poses, a finite GetFrameOutput, each call's depth in
    [0, 65536], finite (192, 640, 2) flows and (192, 640) uint8 masks with
    labelled pixels, the result txts written. Returns (frames with a
    tracked object, labelled pixels per call)."""
    import torch

    est = system.map.poses
    check(est.shape == (n_calls, 4, 4) and np.isfinite(est).all(),
          f"online poses of shape {est.shape}, finite: "
          f"{np.isfinite(est).all()}")
    out = system.GetFrameOutput(-1)
    check(np.isfinite(out.camera_pose).all()
          and np.isfinite(out.camera_position).all()
          and all(np.isfinite(o.pose).all() and np.isfinite(o.velocity).all()
                  and math.isfinite(o.speed_kmh) and math.isfinite(o.yaw)
                  for o in out.objects), "online GetFrameOutput not finite")
    check(len(outputs) == n_calls, f"{len(outputs)} perception calls")
    labelled = []
    for o in outputs:
        d = o.depth_u16
        check(d.shape == (ONLINE_H, ONLINE_W) and bool(torch.isfinite(d).all())
              and float(d.min()) >= 0.0 and float(d.max()) <= 65536.0,
              f"online depth_u16 {tuple(d.shape)} in "
              f"[{float(d.min())}, {float(d.max())}]")
        check(o.flow.shape == (ONLINE_H, ONLINE_W, 2)
              and bool(torch.isfinite(o.flow).all()), "online flow")
        check(o.mask.shape == (ONLINE_H, ONLINE_W)
              and o.mask.dtype == torch.uint8 and bool((o.mask > 0).any()),
              f"online mask {tuple(o.mask.shape)} {o.mask.dtype}, labelled "
              f"pixels {int((o.mask > 0).sum())}")
        labelled.append(int((o.mask > 0).sum()))
    with_obj = sum(any(ob.status for ob in rec.objects)
                   for rec in system.map.frames[1:])
    check_results_written(system, n_calls, with_objects=with_obj > 0)
    return with_obj, labelled


# ---------------------------------------------------------------------------
# phase 4 (f): offline VIO; (g): online VIO
# ---------------------------------------------------------------------------

# the JAX bench's kaist_offline_1280x560_vio row (bench.py:185-320, set up
# at :566-580) one frame a call: 3 + 2 x 20 + 2 frames of the offline scene
VIO_FRAMES = 45
VIO_KW = dict(TRACKER_KW, use_imu=True)
IMU_HZ = 200.0
# the JAX package's run of that row one frame a call (pipelined=False,
# fused_ba=True) on the CPU over the same 45 frames, from
# tools/jax_vio_reference.py (PERF.md section 2): init at frame 20 after 1
# attempt, imu_scale 1.0008518, scale_vs_gt 1.0011846, SE(3)-aligned ATE
# 0.0101352 m over the 26.686 m path
JAX_VIO_INIT_FRAME = 20
JAX_VIO_ATTEMPTS = 1
JAX_VIO_SCALE_VS_GT = 1.0011846048430717
JAX_VIO_ATE_SE3_M = 0.010135213322929059


class ImuFeed:
    """The analytic 200 Hz IMU of ``driving_imu``, fed up to each frame's
    timestamp as the JAX bench's ``feed_imu`` does (bench.py:217-231)."""

    def __init__(self):
        self.clock = 0.0

    def samples(self, t_frame):
        from vido_slam_tpu_torch.io.synthetic import driving_imu
        from vido_slam_tpu_torch.system import ImuPoint

        ts = np.arange(self.clock + 1.0 / IMU_HZ, t_frame + 1e-9,
                       1.0 / IMU_HZ)
        if not len(ts):
            return []
        acc, gyro = driving_imu(ts)
        self.clock = float(ts[-1])
        return [ImuPoint(a=acc[i], w=gyro[i], t=float(t))
                for i, t in enumerate(ts)]


def state_devices(state):
    """The device types of every tensor in a TrackState."""
    import torch

    out, todo = set(), [state]
    while todo:
        x = todo.pop()
        if torch.is_tensor(x):
            out.add(x.device.type)
        elif isinstance(x, tuple):
            todo.extend(x)
    return out


def run_offline_vio(seq, device, counters):
    """``Tracker(use_imu=True)`` over the frames with metric depth, flow and
    mask, the IMU fed before each frame, as the JAX bench row drives it.
    Returns the tracker, the host seconds of every frame, the frame at which
    the init fired (None if it did not), the state's device types right
    after it, and each counter's launches during the run."""
    import torch
    from vido_slam_tpu_torch.config import config_from_dict
    from vido_slam_tpu_torch.tracking import Tracker

    tracker = Tracker(config_from_dict(OFFLINE_CONFIG), device=device,
                      **VIO_KW)
    feed = ImuFeed()
    frames = [(torch.as_tensor(fr.depth, device=device),
               torch.as_tensor(fr.flow, device=device),
               torch.as_tensor(fr.mask, device=device), fr.Tcw_gt)
              for fr in seq.frames]
    for c in counters:
        c.launches = 0
    times, init_frame, devices = [], None, None
    for i, (depth, flow, mask, gt) in enumerate(frames):
        t = i / 10.0
        tracker.grab_imu_data(feed.samples(t))
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker.track(depth, flow, mask, Tcw_gt=gt, timestamp=t)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if tracker.imu_initialized and init_frame is None:
            init_frame, devices = i, state_devices(tracker.state)
    return (tracker, times, init_frame, devices,
            [c.launches for c in counters])


def vio_accuracy(tracker, seq):
    """(scale_vs_gt, unaligned ATE, SE(3)- and Sim(3)-aligned ATE, path
    length), as the JAX bench row computes them (bench.py:266-298)."""
    from vido_slam_tpu_torch.metrics import (ate_rmse, camera_centers,
                                             umeyama_alignment)

    est = tracker.map.poses
    gt = np.stack([fr.Tcw_gt for fr in seq.frames[:len(est)]])
    c = camera_centers(gt.astype(np.float64))
    path = float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
    _, _, s_fit = umeyama_alignment(camera_centers(est), camera_centers(gt),
                                    with_scale=True)
    return (1.0 / max(s_fit, 1e-9), ate_rmse(est, gt, align=False),
            ate_rmse(est, gt, align=True, with_scale=False),
            ate_rmse(est, gt, align=True, with_scale=True), path)


def check_offline_vio(tracker, seq, init_frame, devices, launches):
    """The init fired at the JAX run's frame after its attempts, scale_vs_gt
    within 0.01 and the SE(3)-aligned ATE within 0.05 m of it, the state on
    the card after the rescale, kernel 1 twice a tracked frame. Returns
    vio_accuracy's numbers."""
    n_tracked = len(seq.frames) - 1
    check(tracker.imu_initialized, "offline VIO: the IMU init never fired "
          f"({tracker.imu_init_attempts} attempts)")
    check(init_frame == JAX_VIO_INIT_FRAME
          and tracker.imu_init_attempts == JAX_VIO_ATTEMPTS,
          f"offline VIO: init at frame {init_frame} after "
          f"{tracker.imu_init_attempts} attempts, the JAX run's at "
          f"{JAX_VIO_INIT_FRAME} after {JAX_VIO_ATTEMPTS}")
    acc = vio_accuracy(tracker, seq)
    check(np.isfinite(tracker.map.poses).all(), "offline VIO: poses")
    check(abs(acc[0] - JAX_VIO_SCALE_VS_GT) <= 0.01,
          f"offline VIO: scale_vs_gt {acc[0]}, the JAX run's "
          f"{JAX_VIO_SCALE_VS_GT}")
    check(abs(acc[2] - JAX_VIO_ATE_SE3_M) <= 0.05,
          f"offline VIO: SE(3)-aligned ATE {acc[2]} m, the JAX run's "
          f"{JAX_VIO_ATE_SE3_M}")
    check(devices == {"cuda"}, f"offline VIO: state on {devices} after the "
          f"rescale")
    check(launches == [2 * n_tracked, 0, 0, 0, 0],
          f"offline VIO: launches {launches} over {n_tracked} frames")
    return acc


def run_online_vio(frames, tcw, model, counters):
    """``System`` IMU_RGBD, ``AttachPerception`` and ``TrackFrames`` over the
    clip's pairs at 10 fps, with the analytic IMU up to each frame's
    timestamp. Returns the system, the host seconds of every call, the init
    attempts, whether the init had fired and the IMU scale after each call,
    the depth scale each tracked call converted at, and the counters'
    launches."""
    import torch
    from vido_slam_tpu_torch import tracking
    from vido_slam_tpu_torch.config import config_from_dict
    from vido_slam_tpu_torch.system import Sensor, System

    dev = frames.device
    system = System()
    system.init_from_config(config_from_dict(ONLINE_CONFIG), Sensor.IMU_RGBD,
                            device=dev, **TRACKER_KW)
    system.AttachPerception(model)
    convert, scales = tracking.convert_depth, []

    def recording(*args, scale, **kw):
        scales.append(float(scale))
        return convert(*args, scale=scale, **kw)

    tracking.convert_depth = recording
    feed = ImuFeed()
    try:
        for c in counters:
            c.launches = 0
        times, after = [], []
        for k in range(frames.shape[0] - 1):
            t = k / 10.0
            imu = feed.samples(t)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            system.TrackFrames(frames[k], frames[k + 1], mTcw_gt=tcw[k],
                               timestamp=t, imu_measurements=imu)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            tr = system.tracker
            after.append((tr.imu_init_attempts, tr.imu_initialized,
                          tr.imu_scale))
        launches = [c.launches for c in counters]
    finally:
        tracking.convert_depth = convert
    return system, times, after, scales, launches


def check_online_vio(system, after, scales, launches, expect):
    """Attempts from the gate on (a call at >= 10 frames and >= 2 s since
    the first), one a call until the init fires; every tracked call's depth
    at base (1.0) x the IMU scale the previous call left; finite poses; the
    online path's launches."""
    n_calls = len(after)
    want, n, done = [], 0, False
    for k in range(n_calls):
        if not done and k + 1 >= 10 and k / 10.0 >= 2.0:
            n += 1
        done = after[k][1]
        want.append(n)
    attempts = [a[0] for a in after]
    check(attempts == want, f"online VIO: attempts {attempts}, not {want}")
    want_scales = [float(np.float32(1.0 * a[2])) for a in after[:-1]]
    check(scales == want_scales, f"online VIO: depth scales {scales}, not "
          f"{want_scales}")
    est = system.map.poses
    check(est.shape == (n_calls, 4, 4) and np.isfinite(est).all(),
          "online VIO: poses")
    check(launches == expect, f"online VIO: launches {launches}, not "
          f"{expect}")
    return attempts


def check_whole_depth(dev, frame) -> float:
    """MonoDepth2 on the card against the port on the CPU, same seed-0
    weights, on one 192x640 frame of the bench clip fed as
    ``perception_depth`` feeds it (RGB in [0, 1]): max |disp_gpu -
    disp_cpu| <= 1e-4 (disparities are sigmoids in (0, 1)). Returns the
    error."""
    from vido_slam_tpu_torch.models.monodepth2 import (MonoDepth2,
                                                       monodepth2_disp)

    x = (frame.flip(-1).permute(2, 0, 1)[None] / 255.0).contiguous()
    got = monodepth2_disp(MonoDepth2(seed=0, device=dev), x).cpu()
    want = monodepth2_disp(MonoDepth2(seed=0, device="cpu"), x.cpu())
    err = float((got - want).abs().max())
    check(got.shape == (1, 1, ONLINE_H, ONLINE_W) and math.isfinite(err)
          and err <= 1e-4, ("MonoDepth2 GPU vs CPU", err))
    print(f"MonoDepth2 192x640, card vs CPU: disparity "
          f"{float(want.min()):.4f}..{float(want.max()):.4f}, max error "
          f"{err:.3e}")
    return err


# ---------------------------------------------------------------------------
# phase 4 (h): the offline demo from files
# ---------------------------------------------------------------------------

def write_png(path, img, level=6) -> None:
    """A PNG of ``img`` as ``cv2.imwrite`` takes it (gray, gray + alpha, BGR
    or BGRA; uint8 or uint16), row y filtered by type y % 5 (None, Sub, Up,
    Avg, Paeth), so a reader of the file meets every unfilter path."""
    import struct
    import zlib

    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    if C >= 3:  # BGR(A) -> the file's RGB(A)
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img.astype(">u2" if depth == 16
                                           else np.uint8))
    x = rows.view(np.uint8).reshape(H, -1).astype(np.int32)
    bpp = C * depth // 8
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kind = np.arange(H) % 5
    pred = np.select([kind[:, None] == k for k in range(1, 5)],
                     [a, b, (a + b) >> 1, paeth])
    body = np.concatenate([kind[:, None].astype(np.uint8),
                           ((x - pred) & 0xFF).astype(np.uint8)], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(body.tobytes(), level))
                + chunk(b"IEND", b""))


def mosaic_bayer_bg(bgr):
    """(H, W, 3) uint8 BGR -> the (H, W) BayerBG frame a KAIST camera
    records: R at (even, even), B at (odd, odd), G elsewhere."""
    raw = bgr[..., 1].copy()
    raw[0::2, 0::2] = bgr[0::2, 0::2, 2]
    raw[1::2, 1::2] = bgr[1::2, 1::2, 0]
    return raw


def write_config(path, cfg) -> None:
    """An OpenCV-FileStorage YAML of the flat ``cfg`` dict."""
    with open(path, "w") as f:
        f.write("%YAML:1.0\n")
        for k, v in cfg.items():
            f.write(f'{k}: "{v}"\n' if isinstance(v, str) else f"{k}: {v}\n")


def write_tree(root, kind, frames, png=write_png, imu=None, jpg=None):
    """A dataset tree in the reference demo's layout under ``root``: each of
    ``frames`` is (bgr uint8, raw depth uint16, flow (H, W, 2) float32, mask
    uint8, t seconds). ``kind`` "kaist": image/<19-digit ns stamp>.png
    BayerBG frames listed by vTimestampsImage.txt, and with ``imu`` (times
    s, acc, gyro) xsens_imu.csv (stamp ns, gyro cols 8-10, acc 11-13);
    "kitti": image_02/<10-digit index>.png BGR frames listed by times.txt,
    or <10-digit index>.jpg written by ``jpg(path, bgr)`` where it is
    given. flow/<stem>.flo, depth/<stem>.png (16-bit) and mask/<stem>.png
    beside the image directory. ``png(path, img)`` writes the PNGs.
    Returns the config entries naming the tree (image_path, and
    imu_path)."""
    from vido_slam_tpu_torch.io.datasets import write_flo

    img_dir = os.path.join(root, "image" if kind == "kaist" else "image_02")
    for d in (img_dir, *(os.path.join(root, s)
                         for s in ("flow", "depth", "mask"))):
        os.makedirs(d, exist_ok=True)
    stamps = []
    for i, (bgr, depth, flow, mask, t) in enumerate(frames):
        if kind == "kaist":
            stamps.append(f"{int(round(t * 1e9)):019d}")
            stem = stamps[-1]
            png(os.path.join(img_dir, stem + ".png"), mosaic_bayer_bg(bgr))
        else:
            stamps.append(f"{t:.6f}")
            stem = f"{i:010d}"
            if jpg is None:
                png(os.path.join(img_dir, stem + ".png"), bgr)
            else:
                jpg(os.path.join(img_dir, stem + ".jpg"), bgr)
        write_flo(os.path.join(root, "flow", stem + ".flo"), flow)
        png(os.path.join(root, "depth", stem + ".png"), depth)
        png(os.path.join(root, "mask", stem + ".png"), mask)
    with open(os.path.join(root, "vTimestampsImage.txt" if kind == "kaist"
                           else "times.txt"), "w") as f:
        f.write("# timestamp\n" + "".join(s + "\n" for s in stamps))
    out = {"image_path": img_dir}
    if imu is not None:
        times, acc, gyro = imu
        out["imu_path"] = os.path.join(root, "xsens_imu.csv")
        with open(out["imu_path"], "w") as f:
            f.write("# stamp_ns,q,...,gyro x y z,acc x y z\n")
            for t, a, w in zip(times, acc, gyro):
                cols = [f"{int(round(t * 1e9))}"] + ["0"] * 7 \
                    + [repr(float(v)) for v in (*w, *a)]
                f.write(",".join(cols) + "\n")
    return out


# the KITTI tracking benchmark's camera 2 (its calib files): 1242x375,
# bf = fx x 0.54 m (the stereo baseline); raw depth = 256 bf / z
KITTI_CONFIG = {
    "Camera.width": 1242, "Camera.height": 375, "Camera.fx": 721.5377,
    "Camera.fy": 721.5377, "Camera.cx": 609.5593, "Camera.cy": 172.854,
    "Camera.bf": 721.5377 * 0.54, "ChooseData": 2, "DepthMapFactor": 256,
    "WINDOW_SIZE": 20, "MaxTrackPointBG": 3000, "MaxTrackPointOBJ": 800,
    "Camera.fps": 10, "UseSampleFeature": 0,
}
DEMO_ONLINE_FRAMES = 8


def demo_rows(seq, cfg):
    """The frames of ``seq`` as a dataset stores them: BGR uint8 rendered
    by ``render_rgb``, raw 16-bit depth by the dataset's rule (metric = bf /
    (raw / DepthMapFactor), KAIST and KITTI alike; 0 where no surface),
    flow, uint8 mask, t = k / 10 s."""
    import torch
    from vido_slam_tpu_torch.io.synthetic import render_rgb

    dev = torch.device("cuda")
    f = cfg["DepthMapFactor"] * cfg["Camera.bf"]
    rows = []
    for k, fr in enumerate(seq.frames):
        rgb = render_rgb(seq.scene, torch.as_tensor(fr.Tcw_gt, device=dev),
                         [torch.as_tensor(p, device=dev)
                          for p in fr.box_poses])
        bgr = torch.round(rgb.flip(-1)).to(torch.uint8).cpu().numpy()
        raw = np.where(fr.depth > 0, np.clip(np.round(
            f / np.maximum(fr.depth, 1e-6)), 1, 65535), 0)
        rows.append((bgr, raw.astype(np.uint16), fr.flow,
                     fr.mask.astype(np.uint8), k / 10.0))
    return rows


class Spy:
    """Wraps ``owner.attr`` while on: each call passes on, and ``after(self,
    result, seconds)`` sees it (the card synchronised around it)."""

    def __init__(self, owner, attr, after):
        self.owner, self.attr, self.after = owner, attr, after
        self.fn = getattr(owner, attr)

    def __enter__(self):
        import torch

        fn, after = self.fn, self.after

        def wrapper(obj, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(obj, *args, **kw)
            torch.cuda.synchronize()
            after(obj, out, time.perf_counter() - t0)
            return out

        setattr(self.owner, self.attr, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.fn)


def run_demo(argv, counters):
    """The CLI's ``main(argv)`` in this process, the counters zeroed just
    before; returns its DemoRun, each counter's launches during it, the
    IMU-initialized flag after each TrackRGBD and each full batch's
    (seconds, result)."""
    from vido_slam_tpu_torch import run_vido, system, tracking

    inited, batches = [], []
    with Spy(system.System, "TrackRGBD", lambda s, out, t: inited.append(
            s.tracker.imu_initialized)), \
            Spy(tracking.Tracker, "run_full_batch",
                lambda s, out, t: batches.append((t, out))):
        for c in counters:
            c.launches = 0
        run = run_vido.main(argv)
        launches = [c.launches for c in counters]
    return run, launches, inited, batches


def check_demo(run, out_dir, gts, n_frames, launches, expect, aligned=False):
    """A line a frame in the result txts, the launches as expected, camera
    ATE of the initial and the refined trajectory under 1 % of the path
    (SE(3)-aligned for VIO, whose map is gravity-aligned after the init).
    Returns (ATE initial, ATE refined, path length)."""
    from vido_slam_tpu_torch.metrics import ate_rmse, camera_centers

    check(launches == expect, f"{out_dir}: launches {launches}, not {expect}")
    check(len(run.track_s) == n_frames, f"{out_dir}: {len(run.track_s)} "
          f"frames tracked, not {n_frames}")
    poses = {}
    for name in ("initial_rgbd_new.txt", "refined_rgbd_new.txt"):
        rows = np.loadtxt(os.path.join(out_dir, name), ndmin=2)
        check(rows.shape == (n_frames, 17) and np.isfinite(rows).all()
              and (rows[:, 0] == np.arange(n_frames)).all(),
              f"{out_dir}{name}: {rows.shape} rows")
        Twc = np.tile(np.eye(4), (n_frames, 1, 1))
        Twc[:, :3, :] = rows[:, 1:13].reshape(-1, 3, 4)
        poses[name] = np.linalg.inv(Twc)
    check(os.path.exists(os.path.join(out_dir, "obj_mot_rgbd_new.txt")),
          f"{out_dir}: no object motions' file")
    gt = np.stack(gts[:n_frames]).astype(np.float64)
    c = camera_centers(gt)
    path = float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
    ates = [ate_rmse(p, gt, align=aligned, with_scale=False)
            for p in poses.values()]
    check(max(ates) < 0.01 * path, f"{out_dir}: camera ATE initial, refined "
          f"{ates} m over a {path} m path")
    return ates[0], ates[1], path, poses


def demo_ms(run):
    """(median ms a frame of the CLI loop, reading included, over frames
    4 on; the reading's median ms; the ratio of the two medians). The
    last frame of a KITTI run carries the full batch, which the medians
    leave out."""
    read, track = np.asarray(run.read_s[4:]), np.asarray(run.track_s[4:])
    ms, read_ms = 1e3 * float(np.median(read + track)), \
        1e3 * float(np.median(read))
    return ms, read_ms, read_ms / ms


def check_unfilter(path):
    """The C++ unfilter bit-equal to its plain version on one written
    frame's inflated stream. Returns the stream's bytes."""
    import zlib

    from vido_slam_tpu_torch.io import png

    with open(path, "rb") as f:
        chunks = list(png._chunks(f.read()))
    w, h, depth, ctype = (int.from_bytes(chunks[0][1][i:i + n], "big")
                          for i, n in ((0, 4), (4, 4), (8, 1), (9, 1)))
    raw = np.frombuffer(zlib.decompress(b"".join(
        b for t, b in chunks if t == b"IDAT")), np.uint8)
    bpp = png.CHANNELS[ctype] * depth // 8
    check(sorted(set(raw[::w * bpp + 1].tolist())) == [0, 1, 2, 3, 4],
          f"{path}: not every filter type")
    native = png.unfilter(raw, h, w * bpp, bpp)
    plain = png.unfilter_plain(raw, h, w * bpp, bpp)
    check(np.array_equal(native, plain), f"{path}: the C++ unfilter differs "
          f"from its plain version")
    return raw.size


def run_phase_h(counters, names, seq, vio_init, vio_attempts):
    """Phase (h), the offline demo from files: the CLI's main() on trees
    this function writes. Returns each kernel's launches on (h1)-(h4)."""
    cards = card_line()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        # the KAIST tree of (a)'s scene over (f)'s 45 frames, with the IMU
        t_imu = np.arange(1, int(round(IMU_HZ * (len(seq.frames) - 1) / 10))
                          + 1) / IMU_HZ
        from vido_slam_tpu_torch.io.synthetic import driving_imu

        t0 = time.perf_counter()
        kaist = write_tree(os.path.join(root, "kaist"), "kaist",
                           demo_rows(seq, OFFLINE_CONFIG),
                           imu=(t_imu, *driving_imu(t_imu)))
        kitti_seq = offline_sequence(N_FRAMES, "cuda", KITTI_CONFIG)
        kitti = write_tree(os.path.join(root, "kitti"), "kitti",
                           demo_rows(kitti_seq, KITTI_CONFIG))
        clip = np.load(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), ONLINE_CLIP))["clip"]
        zeros = (np.zeros((ONLINE_H, ONLINE_W), np.uint16),
                 np.zeros((ONLINE_H, ONLINE_W, 2), np.float32),
                 np.zeros((ONLINE_H, ONLINE_W), np.uint8))
        online = write_tree(os.path.join(root, "online"), "kaist", [
            (np.clip(np.round(fr), 0, 255).astype(np.uint8), *zeros, k / 10.0)
            for k, fr in enumerate(clip[:DEMO_ONLINE_FRAMES])])
        print(f"(h) trees written in {time.perf_counter() - t0:.1f} s: KAIST "
              f"1280x560 x {len(seq.frames)} (BayerBG PNG, .flo, 16-bit "
              f"depth, mask, {t_imu.size} IMU rows), KITTI 1242x375 x "
              f"{N_FRAMES}, online 640x192 x {DEMO_ONLINE_FRAMES}")
        first = sorted(os.listdir(kaist["image_path"]))[0]
        n_bytes = [check_unfilter(os.path.join(kaist["image_path"], first)),
                   check_unfilter(os.path.join(kitti["image_path"],
                                               "0000000000.png"))]
        print(f"(h) C++ PNG unfilter bit-equal to its plain version on a "
              f"Bayer frame ({n_bytes[0]} bytes) and a KITTI BGR frame "
              f"({n_bytes[1]} bytes)")

        def cfg_file(name, cfg):
            path = os.path.join(root, name + ".yaml")
            write_config(path, cfg)
            return path

        vo = dict(OFFLINE_CONFIG, UseSampleFeature=0, slam_mode=0, **kaist)
        gts = [fr.Tcw_gt for fr in seq.frames]
        for tag, cfg, n, kw in (
                ("h1", vo, N_FRAMES, {}),
                ("h2", dict(vo, slam_mode=1), len(seq.frames),
                 {"aligned": True}),
                ("h3", dict(KITTI_CONFIG, slam_mode=0, **kitti), N_FRAMES,
                 {})):
            d = os.path.join(root, "out_" + tag, "")
            run, launches, inited, batches = run_demo(
                [cfg_file(tag, cfg), "--output", d, "--max-frames", str(n),
                 "--device", "cuda"], counters)
            want = [2 * (n - 1), 0, 0, 0, 0]
            truth = [fr.Tcw_gt for fr in kitti_seq.frames] if tag == "h3" \
                else gts
            ate0, ate1, path, poses = check_demo(run, d, truth, n, launches,
                                                 want, **kw)
            ms, read_ms, share = demo_ms(run)
            line = (f"({tag}) CLI {'KITTI' if tag == 'h3' else 'KAIST'} "
                    f"{'VIO' if tag == 'h2' else 'VO'}: {n} frames, launches "
                    f"{launches}, camera ATE initial {ate0:.5f} m, refined "
                    f"{ate1:.5f} m over {path:.3f} m"
                    f"{' (SE(3)-aligned)' if kw else ''}; ms a frame of the "
                    f"CLI loop median {ms:.2f}, reading {read_ms:.2f} "
                    f"({100 * share:.1f} % of it)")
            if tag == "h2":
                init = inited.index(True) if True in inited else None
                attempts = run.system.tracker.imu_init_attempts
                check(init == vio_init and attempts == vio_attempts,
                      f"(h2): init at frame {init} after {attempts} "
                      f"attempts, (f)'s at {vio_init} after {vio_attempts}")
                line += (f"; init at frame {init} after {attempts} "
                         f"attempt(s), as (f)")
            if tag == "h3":
                check(len(batches) == 1, f"(h3): {len(batches)} full batches")
                secs, res = batches[0]
                check(not np.allclose(poses["initial_rgbd_new.txt"],
                                      poses["refined_rgbd_new.txt"],
                                      rtol=0, atol=1e-7),
                      "(h3): the refined trajectory is the initial one")
                line += (f"; StopFrame full batch {secs:.2f} s, "
                         f"{res.num_iters} LM iterations (15 x 60 CG at "
                         f"most), cost {float(res.cost):.6f}")
            print(line + f"; card {cards}")
            out[tag] = launches
            del run
        d = os.path.join(root, "out_h4", "")
        run, launches, _, _ = run_demo(
            [cfg_file("h4", dict(ONLINE_CONFIG, **online)), "--output", d,
             "--online", "--device", "cuda"], counters)
        n = DEMO_ONLINE_FRAMES
        want = [2 * (n - 1), 0, 5 * n, 5 * n, 2 * n]
        check(launches == want, f"(h4): launches {launches}, not {want}")
        check(len(run.track_s) == n, f"(h4): {len(run.track_s)} frames")
        for name in ("initial_rgbd_new.txt", "refined_rgbd_new.txt"):
            rows = np.loadtxt(os.path.join(d, name), ndmin=2)
            check(rows.shape == (n, 17) and np.isfinite(rows).all(),
                  f"(h4) {name}: {rows.shape}")
        ms, read_ms, share = demo_ms(run)
        print(f"(h4) CLI --online: {n} frames of the bench clip as a 640x192 "
              f"KAIST tree, launches {launches}; ms a frame median {ms:.2f}, "
              f"reading {read_ms:.2f} ({100 * share:.1f} % of it); card "
              f"{cards}")
        out["h4"] = launches
        del run
    return {name: {t: out[t][i] for t in ("h1", "h2", "h3", "h4")}
            for i, name in enumerate(names)}


# ---------------------------------------------------------------------------
# phase 4 (i): weights and sessions in and out
# ---------------------------------------------------------------------------

RESUME_AT = 3        # (i1): frames tracked before the session is saved
PRETRAINED_CALLS = 5  # (i2): System.TrackFrames calls on the reloaded model


def run_session_resume(seq, unbroken, counters, names):
    """(i1): (a)'s VO configuration through System.TrackRGBD for RESUME_AT
    frames, ``save_session`` (it loads on the CPU as well), then twice
    ``load_session`` into a fresh System on the card and the rest of the
    frames. The resumed poses stay
    within 0.05 of (a)'s unbroken run (the JAX package's bar: the tracker's
    own key is not saved) and the two resumes are bit-equal. Returns the
    first resume's launches."""
    import torch
    from vido_slam_tpu_torch.config import config_from_dict
    from vido_slam_tpu_torch.system import Sensor, System
    from vido_slam_tpu_torch.utils.checkpoint import load_session, save_session

    def system():
        s = System()
        s.init_from_config(config_from_dict(OFFLINE_CONFIG), Sensor.RGBD,
                           device="cuda", **TRACKER_KW)
        return s

    inputs = main_path_inputs(seq, "cuda", N_FRAMES)
    first = system()
    for raw, flow, mask, gt in inputs[:RESUME_AT]:
        first.TrackRGBD(None, raw, flow, mask, mTcw_gt=gt)
    poses, launches, times = [], [], []
    with tempfile.TemporaryDirectory() as d:
        snap = os.path.join(d, "session.pkl")
        save_session(snap, first.tracker)
        size = os.path.getsize(snap)
        # the payload is numpy: a session saved on the card loads on the CPU
        on_cpu = System()
        on_cpu.init_from_config(config_from_dict(OFFLINE_CONFIG),
                                Sensor.RGBD, device="cpu", **TRACKER_KW)
        load_session(snap, on_cpu.tracker)
        check(state_devices(on_cpu.tracker.state) == {"cpu"}
              and torch.equal(on_cpu.tracker.state.Tcw,
                              first.tracker.state.Tcw.cpu())
              and np.array_equal(on_cpu.map.poses, first.map.poses),
              "(i1): the session saved on the card differs on the CPU")
        for _ in range(2):
            resumed = system()
            load_session(snap, resumed.tracker)
            check(state_devices(resumed.tracker.state) == {"cuda"},
                  f"(i1): the resumed state lies on "
                  f"{state_devices(resumed.tracker.state)}")
            for c in counters:
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for raw, flow, mask, gt in inputs[RESUME_AT:]:
                resumed.TrackRGBD(None, raw, flow, mask, mTcw_gt=gt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append([c.launches for c in counters])
            poses.append(resumed.map.poses)
    n = N_FRAMES - RESUME_AT
    want = [2 * n, 0, 0, 0, 0]
    check(launches[0] == want and launches[1] == want,
          f"(i1): {names} launched {launches}, not {want} each")
    check(poses[0].shape == unbroken.shape and np.isfinite(poses[0]).all(),
          f"(i1): resumed poses {poses[0].shape}")
    check(np.array_equal(poses[0], poses[1]),
          "(i1): two resumes of one snapshot differ")
    gap = float(np.abs(poses[0] - unbroken).max())
    check(gap < 0.05, f"(i1): resumed poses {gap} from the unbroken run")
    print(f"(i1) session resume, VO 1280x560: {RESUME_AT} frames, "
          f"save_session ({size} bytes; it loads on the CPU too), "
          f"load_session into a fresh System on the card twice, {n} frames "
          f"each: launches {launches[0]}, poses "
          f"within {gap:.3e} of (a)'s unbroken run (bar 0.05), the two "
          f"resumes bit-equal; {1e3 * np.mean(times) / n:.2f} ms a frame")
    return launches[0]


def run_pretrained(dev, counters, names):
    """(i2): the online configuration's seeded PerceptionModel written as
    ``depth``/``flow``/``mask`` bundles (``save_torch_state_dict``, the JAX
    layout), rebuilt by ``PerceptionModel.from_pretrained`` on the card:
    bit-equal weights and outputs on one pair, then System.TrackFrames over
    PRETRAINED_CALLS calls. Returns their launches."""
    import torch
    from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNNConfig
    from vido_slam_tpu_torch.models.perception import PerceptionModel
    from vido_slam_tpu_torch.utils.checkpoint import save_torch_state_dict

    frames, tcw, model = online_inputs(dev)
    h, w = ONLINE_DETECTOR
    nets = {"depth": "depth_net", "flow": "flow_net", "mask": "mask_model"}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        for bundle, attr in nets.items():
            save_torch_state_dict(os.path.join(d, bundle),
                                  getattr(model, attr).state_dict())
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        loaded = PerceptionModel.from_pretrained(
            d, ONLINE_H, ONLINE_W, MaskRCNNConfig(input_h=h, input_w=w),
            device=dev)
        secs = time.perf_counter() - t0
    for attr in nets.values():
        a, b = getattr(model, attr).state_dict(), \
            getattr(loaded, attr).state_dict()
        check(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a),
              f"(i2): {attr} reloaded differs")
    want, got = model(frames[0], frames[1]), loaded(frames[0], frames[1])
    for field in ("depth_u16", "flow", "mask"):
        check(torch.equal(getattr(want, field), getattr(got, field)),
              f"(i2): {field} of the reloaded model differs")
    del model
    system, outputs, times, launches = run_online_path(
        frames[:PRETRAINED_CALLS + 1], tcw, loaded, counters, [])
    n = PRETRAINED_CALLS
    expect = [2 * (n - 1), 0, 5 * n, 5 * n, 2 * n]
    check(launches == expect,
          f"(i2): {names} launched {launches} times over {n} calls, not "
          f"{expect}")
    check(np.isfinite(system.map.poses).all() and len(system.map) == n,
          f"(i2): {len(system.map)} poses")
    print(f"(i2) PerceptionModel.from_pretrained, online {ONLINE_W}x"
          f"{ONLINE_H} with Mask R-CNN at {w}x{h}: bundles of {size} bytes "
          f"written and read in {secs:.2f} s, weights and one pair's depth, "
          f"flow and mask bit-equal to the seeded model's; {n} calls of "
          f"System.TrackFrames, launches {launches}")
    return launches


def run_gn_detector(dev, counters, names):
    """(i3): the GroupNorm R-50-FPN (``ResNetConfig(norm="gn")``, seed 0,
    class 3 lifted) on one driving-clip frame at 1280x560, the detector at
    1088x800 after a warm-up frame: kernel 5 twice, held against its plain
    version on that frame's arguments. Returns (launches, max_abs_err)."""
    import torch
    from vido_slam_tpu_torch.io.synthetic import driving_clip
    from vido_slam_tpu_torch.models.maskrcnn import roi_heads
    from vido_slam_tpu_torch.models.maskrcnn.backbone import ResNetConfig
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           MaskRCNNConfig)

    c = OFFLINE_CONFIG
    clip = driving_clip(height=FLOW_H, width=FLOW_W, n_frames=2,
                        fx=c["Camera.fx"], fy=c["Camera.fy"], device=dev)
    model = lifted(MaskRCNN(MaskRCNNConfig(resnet=ResNetConfig(norm="gn")),
                            seed=0, device=dev))
    run_mask_path(clip[:1], model, counters)
    recorder = KernelArgs(roi_heads.roi_align_multilevel, 6)
    roi_heads.roi_align_multilevel = recorder
    try:
        masks, dets, times, launches = run_mask_path(clip[1:], model,
                                                     counters)
    finally:
        roi_heads.roi_align_multilevel = recorder.wrapper
    check(launches == [0, 0, 0, 0, 2],
          f"(i3): {names} launched {launches} times, not [0, 0, 0, 0, 2]")
    # random GN weights give boxes but (unlike (d)'s) rarely an area that
    # the paste fills: the mask is checked for its shape, not its pixels
    (mask,), (det,) = masks, dets
    n_valid = int(det.valid.sum())
    check(mask.shape == (FLOW_H, FLOW_W) and mask.dtype == torch.uint8
          and n_valid > 0 and bool(torch.isfinite(det.boxes).all())
          and bool(torch.isfinite(det.masks28).all()),
          f"(i3): mask {tuple(mask.shape)} {mask.dtype}, {n_valid} valid "
          f"detections")
    err = check_roi_align([(f"GN detector frame {what}", args)
                           for what, (args, _) in
                           zip(("box head", "mask head"), recorder.calls)])
    print(f"(i3) GroupNorm R-50-FPN frame {FLOW_W}x{FLOW_H} (detector at "
          f"800x1088): launches {launches}, valid detections {n_valid}, "
          f"labelled pixels {int((mask > 0).sum())}; "
          f"{1e3 * times[0]:.2f} ms")
    return launches, err


def run_single_object(seq, counters, names):
    """The single-problem object estimators on one object of the offline
    camera (4000 points, one mask): ``estimate_object_motion`` (kernel 1,
    B=1, T_pre = Tcw) and ``estimate_object_motion_joint`` (kernel 2, B=1),
    each launch held against its plain version. Returns (their launches,
    kernel 1's and kernel 2's max_abs_err)."""
    import torch
    from vido_slam_tpu_torch.estimation import flow_joint, pose
    from vido_slam_tpu_torch.estimation.pose import OBJ_ITERS
    from vido_slam_tpu_torch.geometry.se3 import inverse_se3
    from vido_slam_tpu_torch.utils import prng

    cam = seq.scene.cam
    rng = np.random.RandomState(1)
    Tcw = _pose([0.0, 0.02, 0.0], [0.1, 0.0, -3.0]).cuda()
    M0, X, obs_last, fm, masks = (t.cuda() for t in joint_object_problems(
        rng, cam, 1, 4000, Tcw.cpu()))
    cur_uv = obs_last + fm
    H_mm = inverse_se3(Tcw) @ M0[0]
    key = prng.PRNGKey(5, "cuda")
    recorders = {attr: KernelArgs(getattr(module, attr))
                 for attr, module in (("pose_lm_batched", pose),
                                      ("flow_joint_batched", flow_joint))}
    for attr, module in (("pose_lm_batched", pose),
                         ("flow_joint_batched", flow_joint)):
        setattr(module, attr, recorders[attr])
    try:
        for c in counters:
            c.launches = 0
        est = pose.estimate_object_motion(key, Tcw, X, cur_uv, masks[0], cam,
                                          H_mm, True)
        est_j, flow = flow_joint.estimate_object_motion_joint(
            key, Tcw, X, obs_last, cur_uv, masks[0], cam, H_mm, True)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
    finally:
        pose.pose_lm_batched = recorders["pose_lm_batched"].wrapper
        flow_joint.flow_joint_batched = recorders["flow_joint_batched"].wrapper
    check(launches == [1, 1, 0, 0, 0],
          f"B=1 object estimators: {names} launched {launches}, not "
          f"[1, 1, 0, 0, 0]")
    for what, e in (("estimate_object_motion", est),
                    ("estimate_object_motion_joint", est_j)):
        check(bool(torch.isfinite(e.T).all()) and int(e.num_inliers) > 100,
              f"{what}: {int(e.num_inliers)} inliers")
    (args, kw), = recorders["pose_lm_batched"].calls
    err_lm = check_pose_lm([("estimate_object_motion B=1", args, kw, True)],
                           cam)
    check(kw["max_iters"] == OBJ_ITERS and args[0].shape[0] == 1,
          f"estimate_object_motion: {tuple(args[0].shape)}, {kw}")
    (args, _), = recorders["flow_joint_batched"].calls
    err_fj = check_flow_joint([("estimate_object_motion_joint B=1", args)],
                              cam)
    print(f"(i) single-problem object estimators on {int(masks.sum())} "
          f"points: launches {launches}; estimate_object_motion "
          f"{int(est.num_inliers)} inliers, estimate_object_motion_joint "
          f"{int(est_j.num_inliers)} inliers")
    return launches, err_lm, err_fj


def run_phase_i(dev, counters, names, seq, unbroken):
    """Phase (i), weights and sessions in and out. Returns each kernel's
    launches on (i1)-(i3) and the B=1 calls, and the errors of kernels 1, 2
    and 5 against their plain versions there."""
    t0 = time.perf_counter()
    out = {"i1": run_session_resume(seq, unbroken, counters, names),
           "i2": run_pretrained(dev, counters, names)}
    out["i3"], err_roi = run_gn_detector(dev, counters, names)
    out["b1"], err_lm, err_fj = run_single_object(seq, counters, names)
    print(f"(i) {time.perf_counter() - t0:.1f} s; card {card_line()}")
    launches = {name: {t: out[t][i] for t in ("i1", "i2", "i3", "b1")}
                for i, name in enumerate(names)}
    return launches, {"pose_lm_batched": err_lm, "flow_joint_batched": err_fj,
                      "roi_align_multilevel": err_roi}


# ---------------------------------------------------------------------------
# phase 4 (j): bf16 perception; (k): JPEG frames (ROADMAP.md items 15b, 10b)
# ---------------------------------------------------------------------------

# (j2): the bf16 depth's largest deviation from the float32 depth, as a
# share of the uint16 depth's 65536 range: the bf16 disparity moves by a
# few bf16 steps (2^-9 at 0.5), which the min-max normalisation magnifies
# by the inverse of the disparity's range (0.0135 on the CPU, frame 1 of
# the bench clip, seed 0)
BF16_DEPTH_BAR = 0.05
# (j2): the JAX package's bar for bf16 flow against f32
# (tests/test_liteflownet.py:54-64): max |diff| / max(|f32|, 1)
BF16_FLOW_BAR = 0.02


def bf16_bar(ref):
    """The bar of a bf16 build against its plain version, elementwise: one
    bf16 step at |ref| plus 1e-5 of max(1, max |ref|), the float32 builds'
    bar. Both compute in float32 and round to bf16 where the JAX package
    rounds; only the order of the float32 sums differs, by at most the
    float32 bar (it matters where a sum cancels), and two float32 values
    that close round to bf16 values at most one step further apart."""
    import torch
    r = ref.float().abs()
    step = torch.exp2(torch.floor(torch.log2(r.clamp(min=2.0 ** -126))) - 7)
    return step + 1e-5 * max(1.0, float(r.max()))


def check_bf16_kernel(name, kernel, plain, args) -> float:
    """A bf16 build against its bf16 plain version on ``args``: two
    launches give the same bits, and each output lies within ``bf16_bar``
    of the plain version's. Returns max |kernel - plain|."""
    import torch

    got, again, ref = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    check(got.dtype == ref.dtype == torch.bfloat16
          and got.shape == ref.shape, (name, got.dtype, tuple(got.shape)))
    check(torch.equal(got, again), (name, "two launches differ"))
    d = (got.float() - ref.float()).abs()
    check(bool((d <= bf16_bar(ref)).all()),
          (name, "further from the plain version than the bar",
           float(d.max())))
    print(f"{kernel.__name__} bf16 {name}: max error {float(d.max()):.3e}, "
          f"{int((d > 0).sum())} of {d.numel()} outputs differ from the "
          f"plain version, all within one bf16 step plus 1e-5 of "
          f"max(1, max |out|)")
    return float(d.max())


def to_f32(args):
    """``args`` with every bf16 tensor (in lists too) as float32."""
    import torch

    def conv(a):
        if torch.is_tensor(a):
            return a.float() if a.dtype == torch.bfloat16 else a
        return [conv(x) for x in a] if isinstance(a, list) else a
    return tuple(conv(a) for a in args)


def time_bf16(cases, kernel, plain, count):
    """The bf16 build's device ms over ``cases`` (a graph replay of 20
    calls each), its plain version's, their bound (``count(args)``: bytes,
    flops) and the float32 build's device ms on the same values:
    (ms, plain_ms, bound_ms, bound_by, f32_ms)."""
    ms, plain_ms, f32_ms = 0.0, 0.0, 0.0
    nbytes = flops = 0
    for name, args in cases:
        k_ms = time_cuda_graph(lambda: kernel(*args), 20)
        f_args = to_f32(args)
        f_ms = time_cuda_graph(lambda: kernel(*f_args), 20)
        p_ms = time_cuda(lambda: plain(*args), 3)
        b_, f_ = count(args)
        print(f"{kernel.__name__} bf16 {name}: kernel {k_ms:.4f} ms (float32 "
              f"build on the same values {f_ms:.4f}), plain {p_ms:.4f} ms, "
              f"{b_} bytes, {f_} flops")
        ms += k_ms
        plain_ms += p_ms
        f32_ms += f_ms
        nbytes += b_
        flops += f_
    return (ms, plain_ms) + bound(nbytes, flops) + (f32_ms,)


def detections(d) -> dict:
    """A detector output as numpy, its floating fields float32."""
    import torch
    return {k: getattr(d, k).float().cpu().numpy()
            if torch.is_floating_point(getattr(d, k))
            else getattr(d, k).cpu().numpy()
            for k in ("boxes", "scores", "labels", "valid")}


def run_phase_j(dev, counters, names, f32_ms):
    """Phase (j), bf16 perception: (j1) the online cell with the JAX
    bench's default ``mask_dtype=torch.bfloat16`` over the bench clip,
    its detections held to the float32 detector's, kernel 5's bf16 build
    to its plain version on call ONLINE_RECORD's arguments; (j2) one call
    with ``flow_dtype`` and one with ``compute_dtype`` bf16 against the
    float32 model, kernels 3 and 4's bf16 builds against their plain
    versions at every level. ``f32_ms``: (e)'s median ms a frame. Returns
    {kernel: (bf16 launches, max error, (ms, plain_ms, bound_ms, bound_by,
    f32_ms))} for kernels 3-5."""
    import torch
    from vido_slam_tpu_torch.models import liteflownet, perception
    from vido_slam_tpu_torch.models.maskrcnn import roi_heads
    from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNNConfig
    from vido_slam_tpu_torch.models.perception import PerceptionModel
    from vido_slam_tpu_torch.ops import correlation, regularize, roi_align

    bf = torch.bfloat16
    cards = card_line()
    out = {}
    t0 = time.perf_counter()
    # (j1) the online cell, the detector in bf16
    frames, tcw, model = online_inputs(dev, mask_dtype=bf)
    check(next(model.mask_model.parameters()).dtype == bf
          and next(model.flow_net.parameters()).dtype == torch.float32,
          "(j1): mask_dtype did not cast the detector alone")
    rec = KernelArgs(roi_heads.roi_align_multilevel, 6)
    detected = Detected(perception.maskrcnn_inference)
    roi_heads.roi_align_multilevel = rec
    perception.maskrcnn_inference = detected
    try:
        system, outputs, times, launches = run_online_path(
            frames, tcw, model, counters, [rec])
    finally:
        roi_heads.roi_align_multilevel = rec.wrapper
        perception.maskrcnn_inference = detected.fn
    n_calls = frames.shape[0] - 1
    expect = [2 * (n_calls - 1), 0, 5 * n_calls, 5 * n_calls, 2 * n_calls]
    check(launches == expect, f"(j1): {names} launched {launches}, not "
          f"{expect}")
    with_obj, labelled = check_online_path(system, outputs, n_calls)
    bf16_dets = [detections(d) for d in detected.outputs]
    del system, outputs, detected
    # the float32 detector on the same frames
    h, w = ONLINE_DETECTOR
    cfg = MaskRCNNConfig(input_h=h, input_w=w)
    f32_model = lifted(PerceptionModel(ONLINE_H, ONLINE_W, cfg, seed=0,
                                       device=dev).mask_model)
    detected = Detected(perception.maskrcnn_inference)
    perception.maskrcnn_inference = detected
    try:
        for k in range(n_calls):
            perception.perception_mask(f32_model, frames[k + 1], device=dev)
    finally:
        perception.maskrcnn_inference = detected.fn
    f32_dets = [detections(d) for d in detected.outputs]
    del f32_model, detected
    conf = model.mask_cfg.confidence_threshold
    matched = differ = valid = 0
    for k, (a, b) in enumerate(zip(bf16_dets, f32_dets)):
        r = match_detections(a, b, conf)
        check(not r["unexplained"], (f"(j1) call {k}: validity or labels "
                                     f"differ from the float32 detector's "
                                     f"outside the bf16 margins", r))
        matched += r["boxes_matched"]
        differ += r["slots_differ"]
        valid += sum(r["valid"])
    steady = times[4:]
    ms = 1e3 * float(np.median(steady))
    print(f"(j1) online cell, mask_dtype=torch.bfloat16 (the JAX bench's "
          f"default): {n_calls} calls, launches {launches} (as (e)), objects "
          f"on {with_obj}/{n_calls - 1} tracked frames, labelled pixels per "
          f"call {labelled}; detections against the float32 detector on the "
          f"same frames ({valid} valid in both together): validity or label "
          f"differ in {differ} slots, each within a bf16 margin of a "
          f"threshold (a score within {SCORE_MARGIN} of the confidence "
          f"threshold or of its class's lowest kept score, or an IoU within "
          f"{IOU_MARGIN} of NMS {NMS_IOU}); {matched} boxes matched (label, "
          f"IoU >= 0.9); ms/frame median bf16 {ms:.2f}, float32 (e) "
          f"{f32_ms:.2f} in this call (calls 4-{n_calls - 1}); card {cards}")
    cases = [(f"(j1) call {ONLINE_RECORD} {what}", args) for what, (args, _)
             in zip(("box head", "mask head"), rec.calls)]
    err = max(check_bf16_kernel(n, roi_align.roi_align_multilevel,
                                roi_align.roi_align_multilevel_ref, a)
              for n, a in cases)
    timing = time_bf16(cases, roi_align.roi_align_multilevel,
                       roi_align.roi_align_multilevel_ref,
                       lambda a: (roi_align.nbytes(*a),
                                  roi_align.operations_bf16(*a)))
    roi = [launches[4], err, timing]
    del rec, cases, model

    # (j2) one call each with flow_dtype and with compute_dtype bf16
    prev, cur = frames[0], frames[1]
    ref = PerceptionModel(ONLINE_H, ONLINE_W, cfg, seed=0, device=dev)
    want = ref(prev, cur)
    del ref
    recs = {attr: KernelArgs(getattr(liteflownet, attr), n)
            for attr, n in (("correlation", 3), ("dist_weighted_flow", 7))}
    flow_model = PerceptionModel(ONLINE_H, ONLINE_W, cfg, seed=0, device=dev,
                                 flow_dtype=bf)
    for attr, r in recs.items():
        setattr(liteflownet, attr, r)
    try:
        for c in counters:
            c.launches = 0
        got = flow_model(prev, cur)
        launches_flow = [c.launches for c in counters]
    finally:
        for attr, r in recs.items():
            setattr(liteflownet, attr, r.wrapper)
    del flow_model
    check(launches_flow == [0, 0, 5, 5, 2], f"(j2) flow_dtype: launches "
          f"{launches_flow}, not [0, 0, 5, 5, 2]")
    check(got.flow.dtype == torch.float32, "(j2): bf16 flow not float32")
    scale = max(1.0, float(want.flow.abs().max()))
    flow_err = float((got.flow - want.flow).abs().max()) / scale
    check(math.isfinite(flow_err) and flow_err < BF16_FLOW_BAR,
          f"(j2): bf16 flow {flow_err} of max(|flow|, 1) from float32")
    for attr, r in recs.items():
        check(all(a[0].dtype == bf for a, _ in r.calls),
              f"(j2): {attr} was not given bf16 tensors")
    kernels = {"correlation": (correlation.correlation,
                               correlation.correlation_ref,
                               lambda a: (correlation.nbytes(a[0], a[2]),
                                          correlation.operations(a[0],
                                                                 a[2]))),
               "dist_weighted_flow": (regularize.dist_weighted_flow,
                                      regularize.dist_weighted_flow_ref,
                                      lambda a: (regularize.nbytes(a[0]),
                                                 regularize.operations(
                                                     a[0])))}
    for i, (attr, (kernel, plain, count)) in enumerate(kernels.items()):
        cases = [(f"(j2) level {6 - k} {tuple(args[0].shape)}", args)
                 for k, (args, _) in enumerate(recs[attr].calls)]
        err = max(check_bf16_kernel(n, kernel, plain, a) for n, a in cases)
        out[attr] = [launches_flow[2 + i], err,
                     time_bf16(cases, kernel, plain, count)]
    del recs
    comp_model = PerceptionModel(ONLINE_H, ONLINE_W, cfg, seed=0, device=dev,
                                 compute_dtype=bf)
    for c in counters:
        c.launches = 0
    comp = comp_model(prev, cur)
    launches_comp = [c.launches for c in counters]
    del comp_model
    check(launches_comp == [0, 0, 5, 5, 2], f"(j2) compute_dtype: launches "
          f"{launches_comp}, not [0, 0, 5, 5, 2]")
    depth_diff = (comp.depth_u16 - want.depth_u16).abs() / 65536
    depth_err = float(depth_diff.max())
    check(math.isfinite(depth_err) and depth_err <= BF16_DEPTH_BAR,
          f"(j2): bf16 depth {depth_err} of the range from float32")
    roi[0] += launches_comp[4]
    out["roi_align_multilevel"] = roi
    print(f"(j2) one call of the bench clip's pair 1: flow_dtype bf16 "
          f"launches {launches_flow} (kernels 3 and 4 in bf16), flow within "
          f"{flow_err:.3e} of max(|f32 flow|, 1) = {scale:.4f} (bar "
          f"{BF16_FLOW_BAR}, the JAX package's); compute_dtype bf16 launches "
          f"{launches_comp} (kernel 5 in bf16), depth within "
          f"{depth_err:.5f} of the 65536 range (bar {BF16_DEPTH_BAR}, "
          f"mean {float(depth_diff.mean()):.5f}); "
          f"(j) {time.perf_counter() - t0:.1f} s; card {cards}")
    for name, (n, err, t) in out.items():
        print(f"(j) {name} bf16 build: {n} launches, device ms {t[0]:.4f} "
              f"(float32 build {t[4]:.4f} on the same values), plain "
              f"{t[1]:.3f} ms, bound {t[2]:.6f} ms by {t[3]}, max error "
              f"{err:.3e}")
    return out


JPEG_FIXTURES = os.path.join("tests", "data", "jpeg")


def run_phase_k(counters, names):
    """Phase (k), JPEG frames: the committed fixtures (written by cv2,
    tools/make_jpeg_fixtures.py) decoded bit-equal to cv2's committed
    arrays by the C++ path and its plain version, then the CLI on (h3)'s
    KITTI configuration over a tree of the committed 1242x375 .jpg frames
    (ATE under 1 %, the StopFrame full batch, kernel 1 twice a tracked
    frame). Returns each kernel's launches on the CLI run."""
    import hashlib
    import shutil

    from vido_slam_tpu_torch.io import datasets, jpeg

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        JPEG_FIXTURES)
    cards = card_line()
    t0 = time.perf_counter()
    ref = np.load(os.path.join(root, "layouts.npz"))
    names_l = sorted(n for n in ref.files if not n.endswith("_gray"))
    check(len(names_l) == 7, f"(k): layout fixtures {names_l}")
    for name in names_l:
        with open(os.path.join(root, "layouts", name + ".jpg"), "rb") as f:
            data = f.read()
        for gray, key in ((False, name), (True, name + "_gray")):
            for plain in (False, True):
                got = jpeg.decode_jpeg(data, gray=gray, plain=plain)
                check(got.shape == ref[key].shape
                      and np.array_equal(got, ref[key]),
                      f"(k) {name} gray={gray} plain={plain}: not cv2's")
    kitti = np.load(os.path.join(root, "kitti.npz"))
    files = sorted(os.listdir(os.path.join(root, "kitti")))
    check(len(files) == len(kitti["sha256"]) == N_FRAMES,
          f"(k): {len(files)} KITTI frames")
    jpg_s, png_s = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for k, fname in enumerate(files):
            path = os.path.join(root, "kitti", fname)
            t1 = time.perf_counter()
            img = datasets.imread(path)
            jpg_s.append(time.perf_counter() - t1)
            check(hashlib.sha256(img.tobytes()).hexdigest()
                  == kitti["sha256"][k], f"(k) {fname}: not cv2's decode")
            if k == 0:
                check(np.array_equal(img, kitti["frame0"]),
                      f"(k) {fname}: not cv2's array")
                with open(path, "rb") as f:
                    check(np.array_equal(jpeg.decode_jpeg(f.read(),
                                                          plain=True), img),
                          f"(k) {fname}: C++ path and plain version differ")
            png_path = os.path.join(tmp, f"{k:010d}.png")
            write_png(png_path, img)
            t1 = time.perf_counter()
            datasets.imread(png_path)
            png_s.append(time.perf_counter() - t1)
        print(f"(k) fixtures: 7 layouts (4:4:4, 4:2:2, 4:2:0, 4:4:0, a "
              f"restart interval, optimised tables, gray) bit-equal to cv2's "
              f"arrays in colour and gray, C++ and plain; {N_FRAMES} KITTI "
              f"1242x375 frames bit-equal to cv2 (SHA-256), frame 0 C++ = "
              f"plain; decode ms a frame median "
              f"{1e3 * np.median(jpg_s):.2f}, the same frames as PNG "
              f"(write_png) {1e3 * np.median(png_s):.2f}; card {cards}")

        kitti_seq = offline_sequence(N_FRAMES, "cuda", KITTI_CONFIG)

        def copy_jpg(path, bgr):
            shutil.copy(os.path.join(root, "kitti", os.path.basename(path)),
                        path)
        tree = write_tree(os.path.join(tmp, "kitti"), "kitti",
                          demo_rows(kitti_seq, KITTI_CONFIG), jpg=copy_jpg)
        check(sorted(os.listdir(tree["image_path"])) == files,
              "(k): the tree's frames are not the fixtures")
        cfg = os.path.join(tmp, "k.yaml")
        write_config(cfg, dict(KITTI_CONFIG, slam_mode=0, **tree))
        d = os.path.join(tmp, "out_k", "")
        run, launches, _, batches = run_demo(
            [cfg, "--output", d, "--max-frames", str(N_FRAMES), "--device",
             "cuda"], counters)
        want = [2 * (N_FRAMES - 1), 0, 0, 0, 0]
        ate0, ate1, path, poses = check_demo(
            run, d, [fr.Tcw_gt for fr in kitti_seq.frames], N_FRAMES,
            launches, want)
        check(len(batches) == 1, f"(k): {len(batches)} full batches")
        check(not np.allclose(poses["initial_rgbd_new.txt"],
                              poses["refined_rgbd_new.txt"], rtol=0,
                              atol=1e-7),
              "(k): the refined trajectory is the initial one")
        secs, res = batches[0]
        ms, read_ms, share = demo_ms(run)
        print(f"(k) CLI KITTI VO on the committed .jpg frames: {N_FRAMES} "
              f"frames, launches {launches}, camera ATE initial {ate0:.5f} m, "
              f"refined {ate1:.5f} m over {path:.3f} m; StopFrame full batch "
              f"{secs:.2f} s, {res.num_iters} LM iterations; ms a frame of "
              f"the CLI loop median {ms:.2f}, reading {read_ms:.2f} "
              f"({100 * share:.1f} % of it); (k) "
              f"{time.perf_counter() - t0:.1f} s; card {cards}")
        del run
    return dict(zip(names, launches))


# ---------------------------------------------------------------------------
# phase 4 (m): the detector families (ROADMAP.md item 19)
# ---------------------------------------------------------------------------

DCN_FRAMES = 3
# the DCN offset convs' weights N(0, (gain^2) / fan_in): offsets of about
# 1-2 px on the driving clip's raw 0..255 frames (the init's are zero)
DCN_OFFSET_GAIN = 0.02
FAMILY_FRAMES = 3
FAMILY_INPUT = (1088, 800)  # (height, width) of the detectors' input
FAMILY_CHECK = (320, 256)   # (height, width) of the card-against-CPU checks
# FBNet's image scale: at init the net has no bias, so its outputs scale
# with the image; on 0..1 images the random RPN's boxes collapse onto the
# border (tests/test_torch_fbnet.py)
FBNET_IMAGE_SCALE = 0.01
# RetinaNet: classes 3 (anchors 0-4) and 7 (anchors 5-8) lifted over the
# prior bias, which leaves every random-weight score under the threshold
RETINA_LIFTED = [(a, 2) for a in range(5)] + [(a, 6) for a in range(5, 9)]


def deformed(model, seed=0):
    """``model`` with its DCN offset convs drawn from ``seed`` (weights
    N(0, DCN_OFFSET_GAIN^2 / fan_in), zero bias) instead of the init's
    zeros, so that the sampling really deforms."""
    import torch
    from vido_slam_tpu_torch.models.maskrcnn.backbone import DFConv2d

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, DFConv2d):
                w = mod.offset.weight
                w.copy_(torch.randn(w.shape, generator=g)
                        * (DCN_OFFSET_GAIN / w[0].numel() ** 0.5))
    return model


def launches_of(counters, fn):
    """(fn's result, each counter's launches during fn())."""
    for c in counters:
        c.launches = 0
    out = fn()
    return out, [c.launches for c in counters]


def frame_at(frame, h, w, scale):
    """(1, 3, h, w) contiguous RGB of an (H, W, 3) BGR 0..255 frame,
    resized bilinearly and multiplied by ``scale``."""
    from vido_slam_tpu_torch.ops.warp import resize_bilinear

    return (resize_bilinear(frame.flip(-1).permute(2, 0, 1)[None], h, w)
            * scale).contiguous()


def timed_frames(frames, fn):
    """ms of fn(x) for each x, host clock over torch.cuda.synchronize;
    returns (outputs, ms list)."""
    import torch

    outs, ms = [], []
    for x in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fn(x))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return outs, ms


def close_rel(got, want):
    """max |got - want| over max(1, max |want|), both moved to the CPU."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def run_dcn_detector(dev, counters, names, clip, card):
    """(m1): ``PerceptionModel(mask_cfg=RESNEXT101_FPN_DCN)`` (seed 0,
    class 3 lifted, offset convs by ``deformed``) through
    ``perception_mask`` over DCN_FRAMES frames of the driving clip at
    1280x560 after a warm-up frame (kernel 5 twice a frame, labelled
    pixels in every mask), a plain X-101-32x8d frame timed in the same
    call, and the DCN detector on the card held against the CPU at
    320x256. Returns (launches, largest relative error)."""
    from vido_slam_tpu_torch.models.maskrcnn.model import (
        RESNEXT101_FPN, RESNEXT101_FPN_DCN, MaskRCNN)
    from vido_slam_tpu_torch.models.perception import PerceptionModel

    model = PerceptionModel(FLOW_H, FLOW_W, mask_cfg=RESNEXT101_FPN_DCN,
                            device=dev)
    mask_model = lifted(deformed(model.mask_model))
    run_mask_path(clip[:1], mask_model, counters)
    masks, dets, times, launches = run_mask_path(clip[1:1 + DCN_FRAMES],
                                                 mask_model, counters)
    check(launches == [0, 0, 0, 0, 2 * DCN_FRAMES],
          f"(m1): {names} launched {launches} times over {DCN_FRAMES} "
          f"frames, not [0, 0, 0, 0, {2 * DCN_FRAMES}]")
    n_valid = check_masks(masks, dets, "(m1) DCN frame")
    del model, mask_model, masks, dets
    x101 = lifted(MaskRCNN(RESNEXT101_FPN, seed=0, device=dev))
    run_mask_path(clip[:1], x101, counters)
    _, _, x_times, _ = run_mask_path(clip[1:1 + DCN_FRAMES], x101, counters)
    del x101
    rel = check_whole_detector(
        dev, clip[0], RESNEXT101_FPN_DCN.resnet,
        lambda m: lifted(deformed(m)), "(m1) X-101-32x8d-DCN detector")
    dcn_ms = 1e3 * float(np.median(times))
    x_ms = 1e3 * float(np.median(x_times))
    print(f"(m1) X-101-32x8d-FPN-DCN ({FLOW_W}x{FLOW_H}, detector at "
          f"{RESNEXT101_FPN_DCN.input_w}x{RESNEXT101_FPN_DCN.input_h}, "
          f"offset convs at gain {DCN_OFFSET_GAIN}): launches "
          f"{launches}, valid detections {n_valid}; ms/frame median "
          f"{dcn_ms:.2f} ({[round(1e3 * t, 2) for t in times]}) against the "
          f"plain X-101-32x8d-FPN's {x_ms:.2f} "
          f"({[round(1e3 * t, 2) for t in x_times]}) in this call, "
          f"{dcn_ms / x_ms:.2f}x; card {card}")
    return launches, rel


def run_fbnet(dev, counters, names, clip, card):
    """(m2): ``fbnet_inference`` of the "default" arch (seed 0, class 3
    lifted) at 1088x800 on FAMILY_FRAMES clip frames after a warm-up:
    kernel 5 once a frame (the one-level pooler), held against its plain
    version on the last frame's arguments and timed there; then every
    arch's trunk on the card against the CPU at 320x256 (within 1e-4 of
    its magnitude). Returns (launches, max_abs_err, timing)."""
    import torch
    from vido_slam_tpu_torch.models.maskrcnn import fbnet

    model = fbnet.FBNet("default", device=dev)
    with torch.no_grad():
        model.bbox.cls_score.bias[3] = MASK_LIFT
    fh, fw = FAMILY_INPUT
    frames = [frame_at(clip[k], fh, fw, FBNET_IMAGE_SCALE / 255.0)
              for k in range(1, 1 + FAMILY_FRAMES)]
    fbnet.fbnet_inference(model, frames[0], fh, fw)
    recorder = KernelArgs(fbnet.roi_align_multilevel, 6)
    fbnet.roi_align_multilevel = recorder
    try:
        (dets, ms), launches = launches_of(counters, lambda: timed_frames(
            frames, lambda x: fbnet.fbnet_inference(model, x, fh, fw)))
    finally:
        fbnet.roi_align_multilevel = recorder.wrapper
    check(launches == [0, 0, 0, 0, FAMILY_FRAMES],
          f"(m2): {names} launched {launches} times over {FAMILY_FRAMES} "
          f"frames, not once a frame")
    for d in dets:
        check(bool(torch.isfinite(d.boxes).all()) and int(d.valid.sum()) > 0,
              f"(m2): {int(d.valid.sum())} valid detections, finite boxes "
              f"{bool(torch.isfinite(d.boxes).all())}")
    case = [(f"(m2) FBNet pooler frame {FAMILY_FRAMES} (one level "
             f"{tuple(recorder.calls[-1][0][0][0].shape)}, R=200 6x6)",
             recorder.calls[-1][0])]
    err = check_roi_align(case)
    timing = time_roi_align(case)
    rel = 0.0
    h, w = FAMILY_CHECK
    x = frame_at(clip[0], h, w, FBNET_IMAGE_SCALE / 255.0)
    for arch in fbnet.MODEL_ARCH:
        nets = {d: fbnet.FBNet(arch, device=d) for d in (dev, "cpu")}
        with torch.no_grad():
            t = {d: fbnet.fbnet_trunk(nets[d], x.to(d)) for d in nets}
        e = close_rel(t[dev], t["cpu"])
        check(math.isfinite(e) and e <= 1e-4, ("(m2) FBNet trunk", arch, e))
        rel = max(rel, e)
    print(f"(m2) FBNet default at {fw}x{fh}: launches {launches} over "
          f"{FAMILY_FRAMES} frames after a warm-up, valid detections "
          f"{[int(d.valid.sum()) for d in dets]}, labels "
          f"{sorted(set(dets[-1].labels[dets[-1].valid].tolist()))}; "
          f"ms/frame median {np.median(ms):.2f} ({[round(t, 2) for t in ms]});"
          f" the five trunks card vs CPU at {w}x{h}: largest error {rel:.3e} "
          f"of the magnitude; card {card}")
    return launches, err, timing


def run_retinanet(dev, counters, names, clip, card):
    """(m3): ``retinanet_inference`` (R-50-FPN, seed 0, RETINA_LIFTED) at
    1088x800 on FAMILY_FRAMES clip frames (0..1) after a warm-up: no
    kernel launch, finite detections of the lifted classes; at 320x256
    the FPN and the head's outputs on the card within 1e-4 of the CPU's,
    the detections' validity and labels equal and boxes within 5e-3 px.
    Returns the launches."""
    import torch
    from vido_slam_tpu_torch.models.maskrcnn import retinanet

    def make(d):
        m = retinanet.RetinaNet(device=d)
        with torch.no_grad():
            for a, c in RETINA_LIFTED:
                m.rpn.head.cls_logits.bias[a * 80 + c] = MASK_LIFT
        return m

    model = make(dev)
    fh, fw = FAMILY_INPUT
    frames = [frame_at(clip[k], fh, fw, 1 / 255.0)
              for k in range(1, 1 + FAMILY_FRAMES)]
    retinanet.retinanet_inference(model, frames[0], fh, fw)
    (dets, ms), launches = launches_of(counters, lambda: timed_frames(
        frames, lambda x: retinanet.retinanet_inference(model, x, fh, fw)))
    check(launches == [0] * 5, f"(m3): {names} launched {launches} times")
    for d in dets:
        check(bool(torch.isfinite(d.boxes).all()) and int(d.valid.sum()) > 0
              and set(d.labels[d.valid].tolist()) <= {3, 7},
              f"(m3): {int(d.valid.sum())} valid detections, labels "
              f"{set(d.labels[d.valid].tolist())}")
    del model
    h, w = FAMILY_CHECK
    x = frame_at(clip[0], h, w, 1 / 255.0)
    nets = {d: make(d) for d in (dev, "cpu")}
    with torch.no_grad():
        feats = {d: nets[d].backbone(x.to(d)) for d in nets}
        heads = {d: nets[d].rpn.head(feats["cpu"][1].to(d)) for d in nets}
    rel = max([close_rel(a, b) for a, b in zip(feats[dev], feats["cpu"])]
              + [close_rel(a, b) for a, b in zip(heads[dev], heads["cpu"])])
    check(math.isfinite(rel) and rel <= 1e-4, ("(m3) RetinaNet", rel))
    out = {d: retinanet.retinanet_inference(nets[d], x.to(d), h, w)
           for d in nets}
    a, b = out[dev], out["cpu"]
    v = b.valid
    box_err = float((a.boxes.cpu() - b.boxes).abs()[v].max())
    check(torch.equal(a.valid.cpu(), v) and torch.equal(a.labels.cpu(),
                                                        b.labels)
          and box_err <= 5e-3,
          ("(m3) RetinaNet detections card vs CPU", int(a.valid.sum()),
           int(v.sum()), box_err))
    print(f"(m3) RetinaNet R-50-FPN at {fw}x{fh}: launches {launches}, valid "
          f"detections {[int(d.valid.sum()) for d in dets]}; ms/frame median "
          f"{np.median(ms):.2f} ({[round(t, 2) for t in ms]}); card vs CPU at "
          f"{w}x{h}: FPN and head within {rel:.3e} of the magnitude, "
          f"{int(v.sum())} detections equal, boxes within {box_err:.3e} px; "
          f"card {card}")
    return launches


def run_keypoints_and_roi_pool(dev, counters, names, clip, card):
    """(m4): the keypoint head (seed 0) on (d)'s R-50-FPN P2-P5 and its
    100 detections of one clip frame, then ``keypoints_from_heatmaps``:
    kernel 5 once, held against its plain version and timed; the heatmaps
    on the card within 1e-4 of the CPU's on the same features and boxes.
    (m5): ``roi_pool`` 7x7 over those 100 boxes on P4 (stride 16): the
    card's bits equal the CPU's. Returns (launches, max_abs_err,
    timing)."""
    import torch
    from vido_slam_tpu_torch.models.maskrcnn import keypoint_head, roi_heads
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           RESNET50_FPN,
                                                           maskrcnn_inference)
    from vido_slam_tpu_torch.ops.roi_pool import roi_pool

    detector = lifted(MaskRCNN(RESNET50_FPN, seed=0, device=dev))
    x = frame_at(clip[1], *FAMILY_INPUT, 1.0)
    with torch.no_grad():
        feats = detector.backbone(x)[:4]
    boxes = maskrcnn_inference(detector, x).boxes.contiguous()
    del detector
    head = keypoint_head.KeypointHead(device=dev)

    def keypoints():
        hm = keypoint_head.keypoint_head_forward(head, feats, boxes)
        return hm, keypoint_head.keypoints_from_heatmaps(hm, boxes)

    keypoints()
    recorder = KernelArgs(roi_heads.roi_align_multilevel, 6)
    roi_heads.roi_align_multilevel = recorder
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (hm, kps), launches = launches_of(counters, keypoints)
        torch.cuda.synchronize()
        kp_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        roi_heads.roi_align_multilevel = recorder.wrapper
    check(launches == [0, 0, 0, 0, 1],
          f"(m4): {names} launched {launches} times, not [0, 0, 0, 0, 1]")
    check(tuple(hm.shape) == (100, 17, 56, 56)
          and bool(torch.isfinite(kps.xy).all()),
          f"(m4): heatmaps {tuple(hm.shape)}, finite keypoints "
          f"{bool(torch.isfinite(kps.xy).all())}")
    case = [("(m4) keypoint head (P2-P5, R=100 14x14)", recorder.calls[0][0])]
    err = check_roi_align(case)
    timing = time_roi_align(case)
    cpu_head = keypoint_head.KeypointHead(device="cpu")
    hm_cpu = keypoint_head.keypoint_head_forward(
        cpu_head, [f.cpu() for f in feats], boxes.cpu())
    rel = close_rel(hm, hm_cpu)
    check(math.isfinite(rel) and rel <= 1e-4, ("(m4) heatmaps", rel))
    # (m5) ROIPool on P4
    pooled, launches_pool = launches_of(
        counters, lambda: roi_pool(feats[2], boxes, 1.0 / 16, 7))
    pool_ms = time_cuda(lambda: roi_pool(feats[2], boxes, 1.0 / 16, 7), 5)
    pooled_cpu = roi_pool(feats[2].cpu(), boxes.cpu(), 1.0 / 16, 7)
    check(launches_pool == [0] * 5 and torch.equal(pooled.cpu(), pooled_cpu),
          ("(m5) roi_pool card vs CPU", launches_pool,
           float((pooled.cpu() - pooled_cpu).abs().max())))
    print(f"(m4) keypoint head on (d)'s R-50-FPN frame (P2-P5 of "
          f"{FAMILY_INPUT[1]}x{FAMILY_INPUT[0]}, 100 detections): launches "
          f"{launches}, heatmaps card vs CPU within "
          f"{rel:.3e} of the magnitude, {kp_ms:.2f} ms (host clock over "
          f"torch.cuda.synchronize); (m5) roi_pool 7x7 over the 100 boxes on "
          f"P4 {tuple(feats[2].shape)}: card bit-equal to CPU, "
          f"{pool_ms:.3f} ms (events over 5 calls); card {card}")
    return launches, err, timing


def run_phase_m(dev, counters, names):
    """Phase (m), the detector families: (m1)-(m5) above. Returns kernel
    5's launches by part, its largest error against the plain version,
    and the FBNet-shape and keypoint-shape timings."""
    from vido_slam_tpu_torch.io.synthetic import driving_clip

    t0 = time.perf_counter()
    card = card_line()
    c = OFFLINE_CONFIG
    clip = driving_clip(height=FLOW_H, width=FLOW_W, n_frames=1 + DCN_FRAMES,
                        fx=c["Camera.fx"], fy=c["Camera.fy"], device=dev)
    m1, rel_dcn = run_dcn_detector(dev, counters, names, clip, card)
    m2, err_fb, timing_fb = run_fbnet(dev, counters, names, clip, card)
    m3 = run_retinanet(dev, counters, names, clip, card)
    m4, err_kp, timing_kp = run_keypoints_and_roi_pool(dev, counters, names,
                                                       clip, card)
    print(f"phase (m): {time.perf_counter() - t0:.1f} s")
    launches = {part: dict(zip(names, n)) for part, n in
                (("m1", m1), ("m2", m2), ("m3", m3), ("m4", m4))}
    return launches, max(err_fb, err_kp), {"fbnet": timing_fb,
                                           "keypoint": timing_kp}


# ---------------------------------------------------------------------------
# phase 4 (l): the pipelined paths (ROADMAP.md item 16)
# ---------------------------------------------------------------------------

# timing as bench.py:435-450 does it: each call on the host clock with no
# synchronisation between calls, one synchronize after the last; the
# offline and online single-frame runs time calls 4-23 / 4-22, the pair
# runs calls 3-11 (frames 5-22), a call's time over 2 a frame
TIMED_FROM = 4
PAIR_TIMED_FROM = 3
# the call whose host syncs are counted (outside the timed calls)
SYNC_CALL = 2


def count_syncs(fn):
    """``fn()`` under CUDA's sync debug mode "warn": returns its result and
    the host syncs it made, counted by call site (file:line)."""
    import collections
    import warnings

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return out, sites


def sites_text(sites) -> str:
    return ", ".join(f"{s} x{n}" for s, n in sorted(
        sites.items(), key=lambda x: -x[1]))


def run_calls(calls, timed_from, per_call=1):
    """Each call in turn, the one at SYNC_CALL under ``count_syncs``. Returns
    the median host ms a frame of the calls from ``timed_from`` on (no
    synchronisation between calls), their end-to-end ms a frame (to a
    synchronize after the last call and the closing call ``calls[-1]``,
    which is not timed alone) and the sync sites of SYNC_CALL."""
    import torch

    *calls, close = calls
    times, sites = [], None
    t_from = None
    for k, call in enumerate(calls):
        if k == timed_from:
            t_from = time.perf_counter()
        t0 = time.perf_counter()
        if k == SYNC_CALL:
            _, sites = count_syncs(call)
        else:
            call()
        times.append(time.perf_counter() - t0)
    close()
    torch.cuda.synchronize()
    n_frames = (len(calls) - timed_from) * per_call
    return (1e3 * float(np.median(times[timed_from:])) / per_call,
            1e3 * (time.perf_counter() - t_from) / n_frames, sites)


def run_offline_pipelined(inputs, counters, kw):
    """System.TrackRGBD over the offline frames with ``kw`` as
    ``run_calls`` times it, ``finish()`` closing. Returns the system, the
    two ms a frame, the sync sites and the launches."""
    from vido_slam_tpu_torch.config import config_from_dict
    from vido_slam_tpu_torch.system import Sensor, System

    system = System()
    system.init_from_config(config_from_dict(OFFLINE_CONFIG), Sensor.RGBD,
                            device=inputs[0][0].device, **kw)
    for c in counters:
        c.launches = 0
    calls = [lambda a=a: system.TrackRGBD(None, a[0], a[1], a[2],
                                          mTcw_gt=a[3]) for a in inputs]
    ms, e2e, sites = run_calls(calls + [system.tracker.finish], TIMED_FROM)
    return system, ms, e2e, sites, [c.launches for c in counters]


def run_online_single(frames, tcw, model, counters):
    """Phase (e)'s run again, timed as ``run_calls`` does."""
    from vido_slam_tpu_torch.config import config_from_dict
    from vido_slam_tpu_torch.system import Sensor, System

    system = System()
    system.init_from_config(config_from_dict(ONLINE_CONFIG), Sensor.RGBD,
                            device=frames.device, **TRACKER_KW)
    system.AttachPerception(model)
    for c in counters:
        c.launches = 0
    calls = [lambda k=k: system.TrackFrames(frames[k], frames[k + 1],
                                            mTcw_gt=tcw[k])
             for k in range(frames.shape[0] - 1)]
    ms, e2e, sites = run_calls(calls + [system.tracker.finish], TIMED_FROM)
    return system, ms, e2e, sites, [c.launches for c in counters]


def run_online_pairs(frames, tcw, model, counters, sensor):
    """System.TrackFramesPair at odd offsets, as the JAX bench runs its
    online rows: (f0, f1, f2) initialises, (f1, f2, f3), (f3, f4, f5), ...
    process frames 1-22; IMU_RGBD feeds the analytic IMU up to each pair's
    second frame before the call. Returns the system, the two ms a frame,
    the sync sites of the call that processes frames 3 and 4, the
    launches, after each call (init attempts, initialized, IMU scale), the
    pre-dispatch check's answer at each call and each depth conversion's
    scale."""
    from vido_slam_tpu_torch import tracking
    from vido_slam_tpu_torch.config import config_from_dict
    from vido_slam_tpu_torch.system import Sensor, System

    system = System()
    system.init_from_config(config_from_dict(ONLINE_CONFIG), sensor,
                            device=frames.device, pipelined=True,
                            **TRACKER_KW)
    system.AttachPerception(model)
    tr = system.tracker
    due, scales, after = [], [], []
    check_due = tr._vio_event_due

    def recording_due(ts):
        due.append(check_due(ts))
        return due[-1]

    tr._vio_event_due = recording_due
    convert = tracking.convert_depth

    def recording(*args, scale, **kw):
        scales.append(float(scale))
        return convert(*args, scale=scale, **kw)

    feed = ImuFeed() if sensor == Sensor.IMU_RGBD else None

    def pair(i):
        imu = None if feed is None else feed.samples(
            0.0 if i == 0 else (i + 1) / 10.0)
        gt = None if i == 0 else (tcw[i], tcw[i + 1])
        system.TrackFramesPair(frames[i], frames[i + 1], frames[i + 2],
                               mTcw_gt=gt, imu_measurements=imu)
        after.append((tr.imu_init_attempts, tr.imu_initialized,
                      tr.imu_scale))

    tracking.convert_depth = recording
    try:
        for c in counters:
            c.launches = 0
        starts = [0] + list(range(1, frames.shape[0] - 2, 2))
        calls = [lambda i=i: pair(i) for i in starts]
        ms, e2e, sites = run_calls(calls + [tr.finish], PAIR_TIMED_FROM,
                                   per_call=2)
        launches = [c.launches for c in counters]
    finally:
        tracking.convert_depth = convert
    return system, ms, e2e, sites, launches, after, due, scales


def check_vio_pairs(after, due, scales):
    """The pre-dispatch check holds at a pair call exactly where the init's
    gates are open on the frames before it (>= 10 frames, >= 2 s since
    the first) and the init has not fired; each such call makes one
    attempt; each pair converts its depth at the scale its own update
    left. Returns the number of calls that paid the sync."""
    want_due, done = [], False
    for j in range(1, len(after)):
        last_ts, n = (2 * j - 2) / 10.0, 2 * j - 1
        want_due.append(not done and n >= 10 and last_ts >= 2.0)
        done = after[j][1]
    check(due == want_due, f"(l4): pre-dispatch checks {due}, not "
          f"{want_due}")
    attempts = [a[0] for a in after]
    want = [0] + list(np.cumsum(want_due))
    check(attempts == [int(x) for x in want],
          f"(l4): attempts {attempts}, not {want}")
    want_scales = [float(np.float32(a[2])) for a in after[1:] for _ in "AB"]
    check(scales == want_scales, f"(l4): depth scales {scales}, not "
          f"{want_scales}")
    return sum(due)


def same_records(a, b) -> bool:
    """Each record's object statuses and track ids equal."""
    return [[(o.status, o.track_id) for o in f.objects] for f in a] == \
        [[(o.status, o.track_id) for o in f.objects] for f in b]


def ms_text(ms) -> str:
    """Median and end-to-end ms a frame of each run, in run order."""
    return ", ".join(f"{m:.2f}/{e:.2f}" for m, e in ms)


def run_phase_l(seq, counters, names, ref, dev="cuda"):
    """Phase (l): the pipelined paths against the same configuration's
    synchronous run in this call, timed in turns (synchronous, pipelined,
    pipelined, synchronous) where both are timed. ``ref`` holds the earlier
    phases' runs: (a)'s records and launches, (b)'s ATE and launches, (e)'s
    poses and launches, (g)'s launches, and (e)'s frames, poses and model.
    Returns each kernel's launches in (l1)-(l4)."""
    from vido_slam_tpu_torch.system import Sensor

    cards = card_line()
    out = {}
    inputs = main_path_inputs(seq, dev, N_FRAMES)
    n_tracked = N_FRAMES - 1
    # (l1) offline VO, the fused BA, pipelined beside synchronous
    ms = {False: [], True: []}
    for pipelined in (False, True, True, False):
        system, ms_, e2e, sites, launches = run_offline_pipelined(
            inputs, counters, dict(TRACKER_KW, pipelined=pipelined))
        ms[pipelined].append((ms_, e2e))
        check(launches == ref["a_launches"], f"(l1) pipelined={pipelined}: "
              f"{names} launched {launches} times, (a) {ref['a_launches']}")
        if not pipelined:
            sites_s = sites
            continue
        ate, length, with_obj = check_main_path(system, seq, N_FRAMES)
        d = float(np.abs(system.map.poses - ref["a_poses"]).max())
        check(d <= 1e-5 and same_records(system.map.frames, ref["a_frames"]),
              f"(l1): poses {d} from (a)'s, or other object records")
        out["l1"], sites_p = launches, sites
    del system
    print(f"(l1) offline VO pipelined, fused window BA: {N_FRAMES} frames "
          f"1280x560, ATE {ate:.4f} m ({100 * ate / length:.3f} %), objects "
          f"on {with_obj}/{n_tracked}, launches {out['l1']}; poses "
          f"{'bit-equal to' if d == 0.0 else f'within {d:.3g} of'} (a)'s; "
          f"ms/frame median/end to end, pipelined {ms_text(ms[True])}, "
          f"synchronous {ms_text(ms[False])} (run in turns synchronous, "
          f"pipelined, pipelined, synchronous; frames {TIMED_FROM}-"
          f"{n_tracked}, host clock, no synchronize between calls); card "
          f"{cards}")
    print(f"(l1) host syncs in frame {SYNC_CALL}: pipelined "
          f"{sum(sites_p.values())} ({sites_text(sites_p)}); synchronous "
          f"{sum(sites_s.values())} ({sites_text(sites_s)})")
    # (l2) bJoint at the host-assembled BA, pipelined
    system, ms_, e2e, _, launches = run_offline_pipelined(
        inputs, counters, dict(JOINT_KW, pipelined=True))
    check(launches == ref["b_launches"], f"(l2): {names} launched "
          f"{launches} times, (b) {ref['b_launches']}")
    out["l2"] = launches
    check(len(system.map) == N_FRAMES, f"(l2): {len(system.map)} records "
          f"after finish()")
    ate, length, with_obj = check_main_path(system, seq, N_FRAMES)
    check(ate <= max(2.5 * ref["b_ate"], 0.05),
          f"(l2): ATE {ate} against (b)'s {ref['b_ate']}")
    print(f"(l2) bJoint pipelined, host-assembled window BA: ATE {ate:.4f} m "
          f"({100 * ate / length:.3f} %; (b) {ref['b_ate']:.4f}), objects on "
          f"{with_obj}/{n_tracked}, launches {launches}; ms/frame median "
          f"{ms_:.2f}, end to end {e2e:.2f}")
    del system, inputs
    # (l3) the online row as the bench runs it: pairs, beside (e) again
    frames, tcw, model = ref["frames"], ref["tcw"], ref["model"]
    n_frames = frames.shape[0] - 1
    ms = {False: [], True: []}
    for pairs in (False, True, True, False):
        if not pairs:
            system, ms_, e2e, sites_s, launches = run_online_single(
                frames, tcw, model, counters)
            ms[False].append((ms_, e2e))
            check(launches == ref["e_launches"], f"(l3) (e) again: "
                  f"launches {launches}")
            continue
        system, ms_, e2e, sites_p, launches, _, _, _ = run_online_pairs(
            frames, tcw, model, counters, Sensor.RGBD)
        ms[True].append((ms_, e2e))
        check(launches == ref["e_launches"], f"(l3): {names} launched "
              f"{launches} times, (e) {ref['e_launches']}")
        out["l3"] = launches
        est = system.map.poses
        check(est.shape == (n_frames, 4, 4) and np.isfinite(est).all(),
              f"(l3): poses of shape {est.shape} after finish()")
        d = float(np.abs(est - ref["e_poses"]).max())
        check(d <= 5e-3, f"(l3): poses {d} from (e)'s")
        check([f.timestamp for f in system.map.frames]
              == [k / 10.0 for k in range(n_frames)], "(l3): timestamps")
    del system
    print(f"(l3) online pairs (System.TrackFramesPair, pipelined, fused "
          f"window BA): {n_frames} records after finish(), launches "
          f"{out['l3']}, poses "
          f"{'bit-equal to' if d == 0.0 else f'within {d:.3g} of'} (e)'s; "
          f"ms/frame median/end to end, pairs {ms_text(ms[True])} (a call "
          f"over 2; frames {2 * PAIR_TIMED_FROM - 1}-{n_frames - 1}), (e) one "
          f"frame a call {ms_text(ms[False])} (calls {TIMED_FROM}-"
          f"{n_frames - 1}); run in turns (e), pairs, pairs, (e); host clock, "
          f"no synchronize between calls; card {cards}")
    print(f"(l3) host syncs: the pair call of frames 3-4 "
          f"{sum(sites_p.values())} ({sites_text(sites_p)}); (e) call "
          f"{SYNC_CALL} {sum(sites_s.values())} ({sites_text(sites_s)})")
    # (l4) online VIO in pairs
    system, ms_, e2e, _, launches, after, due, scales = run_online_pairs(
        frames, tcw, model, counters, Sensor.IMU_RGBD)
    check(launches == ref["g_launches"], f"(l4): {names} launched "
          f"{launches} times, (g) {ref['g_launches']}")
    out["l4"] = launches
    paid = check_vio_pairs(after, due, scales)
    check(system.map.poses.shape == (n_frames, 4, 4)
          and np.isfinite(system.map.poses).all(), "(l4): poses")
    print(f"(l4) online VIO pairs: attempts after each call "
          f"{[a[0] for a in after]}, imu_initialized "
          f"{system.tracker.imu_initialized}, imu_scale "
          f"{system.tracker.imu_scale:.7f}, {paid} of {len(after) - 1} pair "
          f"calls paid the pre-dispatch sync, launches {launches}; ms/frame "
          f"median {ms_:.2f}, end to end {e2e:.2f}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from vido_slam_tpu_torch.estimation import (flow_joint, flow_joint_kernel,
                                                lm_kernel, pose)
    from vido_slam_tpu_torch.estimation.pose import (HUBER_DELTA_POSE,
                                                     OBJ_ITERS, POSE_ITERS)
    from vido_slam_tpu_torch.models import liteflownet
    from vido_slam_tpu_torch.models.maskrcnn import roi_heads
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           RESNEXT101_FPN)
    from vido_slam_tpu_torch.ops import correlation, regularize, roi_align
    from vido_slam_tpu_torch.utils import cuda_build, host_build
    from vido_slam_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"build of {sorted(logs)}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    host = [os.path.basename(host_build.build(name))
            for name in ("png_unfilter", "jpeg_decode")]
    print(f"host build of the PNG unfilter and the JPEG decoder {host}: "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            # each kernel's name, registers, shared memory, stack, spills
            if "entry function" in line or "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # phase 3 on numpy-seeded problems laid out as the main paths lay them;
    # paths (a) and (b) take the first N_FRAMES frames, (f) all of them
    seq = offline_sequence(VIO_FRAMES, "cuda")
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
    err_lm = check_pose_lm(
        [(n, tuple(a.to(dev).contiguous() for a in args), kw, v)
         for n, args, kw, v in cases], cam)
    joint_cases = [
        ("camera B=1 N=3000", joint_camera_problem(rng, cam, 3000)),
        ("objects B=8 N=4000, shared points, pixels and flows",
         joint_object_problems(rng, cam, 8, 4000, Tcw)),
    ]
    err_fj = check_flow_joint(
        [(n, tuple(a.to(dev).contiguous() for a in args))
         for n, args in joint_cases], cam)

    corr_cases = correlation_cases(rng, dev)
    reg_cases = regularize_cases(rng, dev)
    err_corr = check_correlation(corr_cases)
    err_reg = check_regularize(reg_cases)
    err_roi = check_roi_align(roi_cases(rng, dev))
    del corr_cases, reg_cases

    # phase 4; the stand-ins keep the kernels' arguments for phase 3 below
    counters = [lm_kernel.pose_lm_batched, flow_joint_kernel.flow_joint_batched,
                correlation.correlation, regularize.dist_weighted_flow,
                roi_align.roi_align_multilevel]
    names = [c.__name__ for c in counters]
    inputs = main_path_inputs(seq, "cuda", N_FRAMES)
    n_tracked = N_FRAMES - 1
    runs = {}
    for own, (path, kw, module, attr) in enumerate((
            ("VO, fused window BA", TRACKER_KW, pose, "pose_lm_batched"),
            ("bJoint, host-assembled window BA", JOINT_KW, flow_joint,
             "flow_joint_batched"))):
        wrapper = getattr(module, attr)
        recorder = KernelArgs(wrapper)
        setattr(module, attr, recorder)
        try:
            system, times, launches = run_main_path(inputs, "cuda", counters,
                                                    kw)
        finally:
            setattr(module, attr, wrapper)
        expect = [0] * len(counters)
        expect[own] = 2 * n_tracked
        check(launches == expect,
              f"{path}: {names} launched {launches} times over {n_tracked} "
              f"frames, not {expect}")
        ate, length, with_obj = check_main_path(system, seq, N_FRAMES)
        steady = times[4:]
        print(f"{path}: {N_FRAMES} frames 1280x560, ATE {ate:.4f} m over "
              f"{length:.2f} m ({100 * ate / length:.3f} %), objects on "
              f"{with_obj}/{n_tracked} frames, launches {launches}; ms/frame "
              f"mean {1e3 * np.mean(steady):.2f} median "
              f"{1e3 * np.median(steady):.2f} (frames 4-{n_tracked}, host "
              f"clock over torch.cuda.synchronize)")
        runs[attr] = (recorder, launches[own])
        if attr == "pose_lm_batched":
            vo_poses = system.map.poses
            ref_l = dict(a_poses=vo_poses, a_frames=system.map.frames,
                         a_launches=launches)
        else:
            ref_l.update(b_ate=ate, b_launches=launches)
    del inputs, system

    # (f) offline VIO: the JAX bench's offline VIO row one frame a call
    tracker, times, init_frame, devices, launches = run_offline_vio(
        seq, "cuda", counters)
    scale_vs_gt, ate, ate_se3, ate_sim3, length = check_offline_vio(
        tracker, seq, init_frame, devices, launches)
    launches_vio = launches
    steady = times[4:]
    print(f"offline VIO: {VIO_FRAMES} frames 1280x560, Tracker(use_imu=True,"
          f" fused_ba=True), analytic {IMU_HZ:.0f} Hz IMU; imu_initialized "
          f"{tracker.imu_initialized} at frame {init_frame} after "
          f"{tracker.imu_init_attempts} attempt(s) (JAX: frame "
          f"{JAX_VIO_INIT_FRAME}, {JAX_VIO_ATTEMPTS}), imu_scale "
          f"{tracker.imu_scale:.7f}, scale_vs_gt {scale_vs_gt:.7f} (JAX "
          f"{JAX_VIO_SCALE_VS_GT:.7f}), ATE unaligned {ate:.4f} m, SE(3)-"
          f"aligned {ate_se3:.5f} m ({100 * ate_se3 / length:.4f} % of "
          f"{length:.3f} m; JAX {JAX_VIO_ATE_SE3_M:.5f}), Sim(3)-aligned "
          f"{ate_sim3:.5f} m ({100 * ate_sim3 / length:.4f} %), launches "
          f"{launches}; ms/frame median {1e3 * np.median(steady):.2f} mean "
          f"{1e3 * np.mean(steady):.2f} (frames 4-{VIO_FRAMES - 1}, host "
          f"clock over torch.cuda.synchronize; init frame "
          f"{1e3 * times[init_frame]:.2f} ms); card {card_line()}")
    vio_attempts = tracker.imu_init_attempts
    del tracker

    # (c) the flow path
    recorders = {attr: KernelArgs(getattr(liteflownet, attr), n)
                 for attr, n in (("correlation", 3),
                                 ("dist_weighted_flow", 7))}
    for attr, rec in recorders.items():
        setattr(liteflownet, attr, rec)
    clip, net = flow_inputs(dev)
    try:
        flows, times, launches = run_flow_path(clip, net, counters)
    finally:
        for attr, rec in recorders.items():
            setattr(liteflownet, attr, rec.wrapper)
    expect = [0, 0, 5 * FLOW_PAIRS, 5 * FLOW_PAIRS, 0]
    check(launches == expect,
          f"flow path: {names} launched {launches} times over {FLOW_PAIRS} "
          f"pairs, not {expect}")
    for f in flows:
        check(f.shape == (FLOW_H, FLOW_W, 2) and bool(torch.isfinite(f).all()),
              f"flow of shape {tuple(f.shape)}, finite: "
              f"{bool(torch.isfinite(f).all())}")
    launches_flow = launches
    steady = times[1:]
    print(f"flow path: {FLOW_PAIRS} pairs {FLOW_W}x{FLOW_H} (net at "
          f"{FLOW_W}x576), launches {launches}, flow |max| "
          f"{max(float(f.abs().max()) for f in flows):.4f} px; ms/pair mean "
          f"{1e3 * np.mean(steady):.2f} median {1e3 * np.median(steady):.2f} "
          f"(pairs 2-{FLOW_PAIRS}, host clock over torch.cuda.synchronize); "
          f"first pair {1e3 * times[0]:.2f} ms")
    del flows, clip, net

    # (d) the mask path
    roi_recorder = KernelArgs(roi_heads.roi_align_multilevel, 6)
    roi_heads.roi_align_multilevel = roi_recorder
    clip, model = mask_inputs(dev)
    try:
        masks, dets, times, launches = run_mask_path(clip, model, counters)
    finally:
        roi_heads.roi_align_multilevel = roi_recorder.wrapper
    expect = [0, 0, 0, 0, 2 * MASK_FRAMES]
    check(launches == expect,
          f"mask path: {names} launched {launches} times over {MASK_FRAMES} "
          f"frames, not {expect}")
    n_valid = check_masks(masks, dets, "mask path")
    launches_roi = launches[4]
    steady = times[1:]
    print(f"mask path: {MASK_FRAMES} frames {FLOW_W}x{FLOW_H} (detector at "
          f"800x1088), launches {launches}, valid detections per frame "
          f"{n_valid}, labelled pixels per frame "
          f"{[int((m > 0).sum()) for m in masks]}; ms/frame mean "
          f"{1e3 * np.mean(steady):.2f} median {1e3 * np.median(steady):.2f} "
          f"(frames 2-{MASK_FRAMES}, host clock over torch.cuda.synchronize);"
          f" first frame {1e3 * times[0]:.2f} ms")
    del masks, dets, model

    # the reference ROS node's X-101-32x8d-FPN: one frame after a warm-up
    model = lifted(MaskRCNN(RESNEXT101_FPN, seed=0, device=dev))
    masks, dets, times, launches = run_mask_path(clip[:1], model, counters)
    masks, dets, times2, launches = run_mask_path(clip[1:2], model, counters)
    check(launches == [0, 0, 0, 0, 2],
          f"X-101 frame: {names} launched {launches} times, not [0, 0, 0, 0, 2]")
    n_x101 = check_masks(masks, dets, "X-101 frame")
    print(f"X-101-32x8d-FPN frame {FLOW_W}x{FLOW_H}: launches {launches}, "
          f"valid detections {n_x101}; {1e3 * times2[0]:.2f} ms (first frame "
          f"{1e3 * times[0]:.2f} ms)")
    frame0 = clip[0].clone()
    del masks, dets, clip, model

    # (e) the online path: the three nets and the tracker from raw frames;
    # the stand-ins keep the kernels' arguments of one call
    sites = {"pose_lm_batched": (pose, 5),
             "correlation": (liteflownet, 3),
             "dist_weighted_flow": (liteflownet, 7),
             "roi_align_multilevel": (roi_heads, 6)}
    online_recs = {attr: KernelArgs(getattr(module, attr), n)
                   for attr, (module, n) in sites.items()}
    for attr, (module, _) in sites.items():
        setattr(module, attr, online_recs[attr])
    frames, tcw, model = online_inputs(dev)
    try:
        system, outputs, times, launches = run_online_path(
            frames, tcw, model, counters, list(online_recs.values()))
    finally:
        for attr, (module, _) in sites.items():
            setattr(module, attr, online_recs[attr].wrapper)
    n_calls = frames.shape[0] - 1
    expect = [2 * (n_calls - 1), 0, 5 * n_calls, 5 * n_calls, 2 * n_calls]
    check(launches == expect,
          f"online path: {names} launched {launches} times over {n_calls} "
          f"calls, not {expect}")
    check([len(r.calls) for r in online_recs.values()] == [2, 5, 5, 2],
          f"online call {ONLINE_RECORD}: kept "
          f"{[len(r.calls) for r in online_recs.values()]} calls")
    with_obj, labelled = check_online_path(system, outputs, n_calls)
    launches_online = launches
    steady = times[4:]
    online_ms = 1e3 * float(np.median(steady))
    h, w = ONLINE_DETECTOR
    print(f"online path: {n_calls} calls of System.TrackFrames on the "
          f"{ONLINE_W}x{ONLINE_H} bench clip (MonoDepth2 and LiteFlowNet at "
          f"{ONLINE_W}x{ONLINE_H}, Mask R-CNN R-50-FPN at {w}x{h}, FAST "
          f"features), launches {launches}, objects on {with_obj}/"
          f"{n_calls - 1} tracked frames, labelled pixels per call "
          f"{labelled}; ms/frame median {1e3 * np.median(steady):.2f} mean "
          f"{1e3 * np.mean(steady):.2f} (calls 4-{n_calls - 1}, host clock "
          f"over torch.cuda.synchronize; first call {1e3 * times[0]:.2f} ms, "
          f"call {ONLINE_RECORD} keeps the kernels' arguments); card "
          f"{card_line()}")
    online_cam = system.tracker.cam
    frame_online = frames[1].clone()
    ref_l.update(e_poses=system.map.poses, e_launches=launches)
    del system, outputs

    # (g) online VIO: phase (e)'s configuration and clip as IMU_RGBD
    system, times, after, scales, launches = run_online_vio(
        frames, tcw, model, counters)
    attempts = check_online_vio(system, after, scales, launches,
                                launches_online)
    launches_online_vio = launches
    steady = times[4:]
    print(f"online VIO: {n_calls} calls of System.TrackFrames as IMU_RGBD "
          f"(phase (e)'s configuration, analytic {IMU_HZ:.0f} Hz IMU), "
          f"attempts after each call {attempts}, imu_initialized "
          f"{system.tracker.imu_initialized}, imu_scale "
          f"{system.tracker.imu_scale:.7f}, depth scales of calls 1-"
          f"{n_calls - 1} {sorted(set(scales))}, launches {launches}; "
          f"ms/frame median {1e3 * np.median(steady):.2f} mean "
          f"{1e3 * np.mean(steady):.2f} (calls 4-{n_calls - 1}, host clock "
          f"over torch.cuda.synchronize); card {card_line()}")
    del system

    # (l) the pipelined paths, each beside its synchronous run in this call
    ref_l.update(g_launches=launches, frames=frames, tcw=tcw, model=model)
    pipelined_launches = run_phase_l(seq, counters, names, ref_l)
    del ref_l, frames, model

    # (j) bf16 perception: the online cell with the JAX bench's default
    # mask_dtype, and one call each with flow_dtype and compute_dtype
    bf16 = run_phase_j(dev, counters, names, online_ms)

    # (h) the offline demo from files: the CLI on trees written here
    demo_launches = run_phase_h(counters, names, seq, init_frame,
                                vio_attempts)

    # (i) weights and sessions in and out
    phase_i_launches, phase_i_err = run_phase_i(dev, counters, names, seq,
                                                vo_poses)

    # (k) JPEG frames: the committed fixtures, and the CLI on a KITTI tree
    # of the committed .jpg frames
    jpeg_launches = run_phase_k(counters, names)

    # (m) the detector families: the DCN X-101, FBNet, RetinaNet, the
    # keypoint head and ROIPool
    family_launches, family_err, family_timing = run_phase_m(dev, counters,
                                                             names)

    # phase 3 on the arguments the main paths gave the kernels in one frame
    recorder, launches_lm = runs["pose_lm_batched"]
    calls, k = recorder.frame_calls()
    frame = [(f"main path frame {k} {what}", args, kw, True)
             for what, (args, kw) in zip(("camera", "objects"), calls)]
    err_lm = max(err_lm, check_pose_lm(frame, cam))
    timing_lm = time_pose_lm(frame, cam)
    recorder, launches_fj = runs["flow_joint_batched"]
    calls, k = recorder.frame_calls()
    frame = [(f"bJoint path frame {k} {what}", args)
             for what, (args, _) in zip(("camera", "objects"), calls)]
    err_fj = max(err_fj, check_flow_joint(frame, cam))
    timing_fj = time_flow_joint(frame, cam)
    # ... and those of the flow path's second pair, one call a level
    pair = 1
    level_calls = {}
    for attr, rec in recorders.items():
        level_calls[attr] = [
            (f"flow path pair {pair + 1} call {i + 1} "
             f"({flow_level(args)})", args)
            for i, (args, _) in enumerate(rec.calls[5 * pair:5 * pair + 5])]
    err_corr = max(err_corr, check_correlation(level_calls["correlation"]))
    err_reg = max(err_reg, check_regularize(level_calls["dist_weighted_flow"]))
    timing_corr = time_flow_kernel(
        level_calls["correlation"], correlation.correlation,
        correlation.correlation_ref,
        lambda a: (correlation.nbytes(a[0], a[2]),
                   correlation.operations(a[0], a[2])))
    timing_reg = time_flow_kernel(
        level_calls["dist_weighted_flow"], regularize.dist_weighted_flow,
        regularize.dist_weighted_flow_ref,
        lambda a: (regularize.nbytes(a[0]), regularize.operations(a[0])))
    del recorders, level_calls
    check_whole_net(dev)
    # ... and those of the mask path's second frame: the box and mask heads
    frame = [(f"mask path frame 2 {what}", args) for what, (args, _) in
             zip(("box head", "mask head"), roi_recorder.calls[2:4])]
    err_roi = max(err_roi, check_roi_align(frame))
    timing_roi = time_roi_align(frame)
    del roi_recorder, frame
    check_whole_detector(dev, frame0)
    # ... and those of the online path's call ONLINE_RECORD
    tag = f"online call {ONLINE_RECORD}"
    frame = [(f"{tag} {what}", args, kw, True) for what, (args, kw) in
             zip(("camera", "objects"), online_recs["pose_lm_batched"].calls)]
    err_lm = max(err_lm, check_pose_lm(frame, online_cam))
    online_timing = {"pose_lm_batched": time_pose_lm(frame, online_cam)}
    level_calls = {
        attr: [(f"{tag} call {i + 1} {tuple(args[0].shape)}", args)
               for i, (args, _) in enumerate(online_recs[attr].calls)]
        for attr in ("correlation", "dist_weighted_flow")}
    err_corr = max(err_corr, check_correlation(level_calls["correlation"]))
    err_reg = max(err_reg, check_regularize(level_calls["dist_weighted_flow"]))
    online_timing["correlation"] = time_flow_kernel(
        level_calls["correlation"], correlation.correlation,
        correlation.correlation_ref,
        lambda a: (correlation.nbytes(a[0], a[2]),
                   correlation.operations(a[0], a[2])))
    online_timing["dist_weighted_flow"] = time_flow_kernel(
        level_calls["dist_weighted_flow"], regularize.dist_weighted_flow,
        regularize.dist_weighted_flow_ref,
        lambda a: (regularize.nbytes(a[0]), regularize.operations(a[0])))
    frame = [(f"{tag} {what}", args) for what, (args, _) in
             zip(("box head", "mask head"),
                 online_recs["roi_align_multilevel"].calls)]
    err_roi = max(err_roi, check_roi_align(frame))
    online_timing["roi_align_multilevel"] = time_roi_align(frame)
    del online_recs, level_calls, frame
    for name, (ms, plain_ms, bound_ms, bound_by) in online_timing.items():
        print(f"{name} on {tag}'s arguments: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms by {bound_by}")
    check_whole_depth(dev, frame_online)

    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    entries = [
        dict(name="pose_lm_batched", route="cuda",
             source="vido_slam_tpu_torch/csrc/pose_lm.cu",
             replaces="vido_slam_tpu/estimation/lm_pallas.py:220",
             launches=launches_lm, max_abs_err=err_lm,
             **dict(zip(keys, timing_lm)), library_ms=None),
        dict(name="flow_joint_batched", route="cuda",
             source="vido_slam_tpu_torch/csrc/flow_joint.cu",
             replaces="vido_slam_tpu/estimation/flow_joint_pallas.py:308",
             launches=launches_fj, max_abs_err=err_fj,
             **dict(zip(keys, timing_fj)), library_ms=None),
        dict(name="correlation", route="cuda",
             source="vido_slam_tpu_torch/csrc/correlation.cu",
             replaces="vido_slam_tpu/ops/correlation.py:154",
             launches=launches_flow[2], max_abs_err=err_corr,
             **dict(zip(keys, timing_corr)), library_ms=None),
        dict(name="dist_weighted_flow", route="cuda",
             source="vido_slam_tpu_torch/csrc/regularize.cu",
             replaces="vido_slam_tpu/ops/regularize.py:146",
             launches=launches_flow[3], max_abs_err=err_reg,
             **dict(zip(keys, timing_reg)), library_ms=None),
        dict(name="roi_align_multilevel", route="cuda",
             source="vido_slam_tpu_torch/csrc/roi_align.cu",
             replaces="vido_slam_tpu/ops/roi_align.py:249",
             launches=launches_roi, max_abs_err=err_roi,
             **dict(zip(keys, timing_roi)), library_ms=None),
    ]
    # beside each kernel's own path: its launches on the online path, its
    # device ms on the online call's arguments and their bound
    for i, e in enumerate(entries):
        timing = online_timing.get(e["name"], (None, None, None, None))
        e["online_launches"] = launches_online[i]
        e["offline_vio_launches"] = launches_vio[i]
        e["online_vio_launches"] = launches_online_vio[i]
        e["demo_launches"] = demo_launches[e["name"]]
        e["weights_sessions_launches"] = phase_i_launches[e["name"]]
        if e["name"] in phase_i_err:
            e["max_abs_err"] = max(e["max_abs_err"],
                                   phase_i_err[e["name"]])
        e["online_ms"], e["online_bound_ms"] = timing[0], timing[2]
        e["jpeg_cli_launches"] = jpeg_launches[e["name"]]
        # (l1) offline VO, (l2) bJoint, (l3) online pairs, (l4) online VIO
        # pairs, all pipelined
        for cell, key in (("l1", "pipelined_vo"), ("l2", "pipelined_joint"),
                          ("l3", "pipelined_pairs"),
                          ("l4", "pipelined_vio_pairs")):
            e[f"{key}_launches"] = pipelined_launches[cell][i]
        # the bf16 build (phase (j)): its launches there, its device ms on
        # the arguments (j) gave it, the float32 build's on the same values
        n, err, t = bf16.get(e["name"], (None, None, (None,) * 5))
        e.update(bf16_launches=n, bf16_max_abs_err=err, bf16_ms=t[0],
                 bf16_plain_ms=t[1], bf16_bound_ms=t[2], bf16_bound_by=t[3],
                 f32_ms_same_values=t[4])
        # phase (m): the launches of (m1) DCN (3 frames), (m2) FBNet (3
        # frames), (m3) RetinaNet, (m4) the keypoint head
        e["detector_families_launches"] = {
            part: n[e["name"]] for part, n in family_launches.items()}
        if e["name"] == "roi_align_multilevel":
            e["max_abs_err"] = max(e["max_abs_err"], family_err)
            for shape, t in family_timing.items():
                e.update({f"{shape}_ms": t[0], f"{shape}_plain_ms": t[1],
                          f"{shape}_bound_ms": t[2],
                          f"{shape}_bound_by": t[3]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
