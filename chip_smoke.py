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
     builds against their plain versions at every level and at the flow
     path's five levels of a 1280x576 pair (seeded), the flow within
     the JAX package's bf16 bar of the float32 flow, the depth within
     BF16_DEPTH_BAR; it prints the bf16 and the float32 ms a frame and
     each bf16 build's device ms, launches and bound beside the float32
     build's on the same values, at both sizes. (k) JPEG frames: the fixtures under
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
     equal the CPU's. Each part prints its ms beside the card line. (n)
     training: (n1) the detector CLI ``python -m
     vido_slam_tpu_torch.train_maskrcnn --synthetic --batch 2 --input-h
     544 --input-w 800 --lr 1e-3 --iters 6`` in-process (R-50-FPN, random
     init): kernel 5 forward and its backward kernel 5b twice an image a
     step (24 each), finite losses, ``model_final.npz`` reloads into the
     detector bit-equal, s/it; (n2) kernel 5 against its plain version
     on the last step's four calls, and kernel 5b against the autograd of
     kernel 5's plain version (max error <= 1e-5 max |plain gradient|:
     atomics add in a run-to-run order) on those calls with the step's
     grad_out and with N(0, 1) grad_out, and at (d)'s inference shapes,
     timed as a CUDA-graph replay, with its bound; (n3) one detector step
     at 128x160 (one block a stage) on the card against the CPU, three
     times: with the card's own discrete decisions, the CPU's proposals,
     and all the CPU's decisions (proposals, relu sides, max-pool
     winners; ``StepTape``): loss parts within 1e-4 relative each, every
     key's gradient within 1e-3 of its max |g| with the CPU's decisions
     and within 1e-2 with the card's own (near-ties the card's rounding
     decides otherwise, printed); (n4)
     ``make_selfsup_train_step`` at 640x192, batch 4 of three consecutive
     bench-clip frames, 5 Adam steps (finite losses, the first within 1e-4
     relative of the CPU's), then one supervised ``make_train_step``;
     (o) the depth data pipeline and the single-device evaluation paths:
     (o1) ``MonoSequenceDataset`` at 640x192 (seed 0) over the committed
     KITTI frames (tests/data/jpeg/kitti, 1242x375 JPEG) and over the
     bench clip written as 1280x384 PNGs (each pixel repeated), each
     drawn as one epoch of batches of 4 onto the card: the batch count and
     the jitter draws printed, the epoch's first batch built on the CPU
     bit-equal to the card's, then three steps of (n4)'s self-supervised
     trainer on the KITTI batches (finite losses, no kernel launched);
     (o2) ``multi_sequence_tracking`` at the JAX defaults (n_bg 800, n_obj
     500, ba_points 400, ba_iters 5) over two 24-frame sequences of the
     offline scene (frames 0-23 and 21-44 of (f)'s) at 1280x560: kernel 1
     twice a tracked frame a sequence (92) and nothing else, one frame's
     calls held against the plain version, each sequence within 1e-5 of a
     ``Tracker(seed=s, fused_ba=True)`` on the card and its ATE under 1 %
     of its path; (o3) ``evaluate_sequences`` on 8 numpy-seeded window
     problems at the tracker's size (W 20, P 1000): each within 1e-5 of
     ``solve_window_ba`` alone, ATE under 0.01 m; (o4)
     ``sharded_coco_evaluation`` of (d)'s R-50-FPN at 1088x800 (class 3's
     bias at EVAL_LIFT, where no two scores tie) over 4 frames of the
     driving clip (scaled to 0..1), the ground truth the same frames'
     detections from the port on the CPU, pasted at 1280x560: kernel 5
     twice an image (8) and nothing else, held against its plain version
     on the first image's calls, bbox and segm mAP/AP50 printed, both
     AP50s and ``detection_ap50`` at least 0.9. Each part prints its host-clock
     seconds (ending in ``torch.cuda.synchronize``). (p) the multi-device
     paths (``parallel/mesh.py``) on an NCCL group of one rank in this
     process: (p1) (n1)'s detector steps (3, the CLI's SGD at lr 1e-3) on
     ``make_mesh(1)`` and twice without a mesh: kernels 5 and 5b 12
     launches each in all three, the first loss equal to the bit, its
     gradients within 5b's 1e-5 of a key's max, the final state within
     max(1e-6, twice the two runs without the mesh apart: 5b's atomics and
     cuDNN part two runs on the saturated random detector); (p2) (n4)'s
     self-supervised steps on the mesh, the first loss equal to the bit;
     (p3) (o2)'s sequences on the mesh: [92, 0, 0, 0, 0], within 1e-6 of
     (o2); (p4) (o4)'s frames on the mesh: 8 launches, (o4)'s AP50s; (p5)
     ``dryrun_multichip(1)``; and, in processes of their own while the
     card works, ``python -m vido_slam_tpu_torch.parallel.dryrun 8
     --device cpu`` (8 gloo ranks, mesh (dp 4, tp 2)) and the training
     CLI under ``python -m torch.distributed.run --standalone`` on 4 gloo
     ranks (``--dp 2 --tp 2 --device cpu``, 64x96) and on 1 NCCL rank
     (``--dp 1 --tp 1``, 544x800), 2 iterations each: exit 0, the dry
     run's line, two log lines and a model_final that reloads. (q)
     ``python -m vido_slam_tpu_torch.infer_nets`` in-process on the card
     against the same CLI with ``--device cpu``: ``depth`` over the 24
     committed KITTI JPEGs (the disparity within 1e-4 of its max), ``flow``
     on their first pair (kernels 3 and 4, 5 launches each; within 1e-3
     of max(|flow|, 1)), ``detector`` for FBNet (kernel 5 once),
     RetinaNet (none) and Mask R-CNN (kernel 5 twice; its random init
     gives an inverted box, which both devices refuse to draw after the
     JSON, as the JAX CLI does) on a bench-clip frame, the detections held
     by ``match_detections``. (r) the C facade, the standalone host, the
     file prefetcher and the deformable detector in bf16: (r1) (a)'s 24
     frames at 1280x560 through the C facade (``csrc/vido_system.cpp``,
     built by g++ and loaded by ctypes, ``vido_system_init_ex`` with (a)'s
     tracker arguments, on the card), then through the Python ``System``
     on the card: kernel 1 twice a tracked frame (46) in each, every
     pose, every frame's ``GetFrameOutputArray`` rows and the four result
     txts equal, both ms a frame printed; (r2) ``run_vido_native`` (a C++
     process that embeds CPython, ``vido_system_init`` on the card) as a
     subprocess over 3 synthetic 160x256 frames: its printed translations
     equal the Python ``System``'s on the same frames rebuilt in numpy,
     and it ends with ``ok``; (r3) inside (h), ``FilePrefetcher`` over
     (h)'s KAIST tree (24 frames x 4 files): its bytes equal the files,
     the ms to read a frame's files with it and with ``open().read()``
     printed; (r4) ``PerceptionModel(mask_cfg=RESNEXT101_FPN_DCN,
     mask_dtype=torch.bfloat16)`` with (m1)'s offset convs and lift over
     (m1)'s 3 frames: kernel 5's bf16 build twice a frame, held against its
     plain version on the last frame's calls and timed there, ms a frame
     beside the float32 DCN detector's on the same frames, and the bf16
     detector on the card held against the port on the CPU in bf16 at
     320x256 by ``match_detections``;
  5. summary: one ``summary (<phase>)`` line a phase with its headline
     figures (printed with the failure instead where a check fails), then
     a ``{"kernels": [...]}`` JSON line (each kernel also with
     its launches on the online path and its device ms on the online
     call's arguments, its launches on (f) and (g), on (h1)-(h4), on
     (i1)-(i3) and the B=1 calls and on (k), and its bf16 build's
     launches, device ms, plain ms and bound in (j) beside the float32
     build's device ms on the same values; its launches in (m1)-(m4), and
     kernel 5's device ms, plain ms and bound at the FBNet and keypoint
     shapes; its launches in (n1) and in (o1), (o2) and (o4), in (p1),
     (p3) and (p4) and in (q); kernel 5b's entry: its launches in (n1) and
     (p1), its device ms, plain ms and bound on a training step's calls
     and at the inference shapes; each kernel's launches in (r1) and (r4),
     and kernel 5's bf16 device ms, plain ms and bound on (r4)'s last
     frame; its launches in the image-format phases (s)-(v)), then the
     device line.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
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


# one short line a phase (its result and headline figures), printed just
# before the kernels line, and with the failure where a check fails, so
# that every phase's result is in the last lines of the output
SUMMARY = []


def summarize(phase, text) -> None:
    SUMMARY.append(f"summary ({phase}) pass: {str(text)[:320]}")


def print_summary(failure=None) -> None:
    for line in SUMMARY:
        print(line)
    if failure is not None:
        print(f"summary FAIL after {len(SUMMARY)} phases: "
              f"{str(failure)[:400]}")


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
# ... and of the online path's 640x192 frames (LiteFlowNet at 640x192)
ONLINE_CORR_LEVELS = [(64, 96, 320, 2), (64, 48, 160, 2), (96, 24, 80, 1),
                      (128, 12, 40, 1), (192, 6, 20, 1)]
ONLINE_REG_LEVELS = [(7, 96, 320), (5, 48, 160), (5, 24, 80), (3, 12, 40),
                     (3, 6, 20)]


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


def roi_plan_bf16(args):
    """The launch plan the wrapper picks for the bf16 build on ``args``."""
    from vido_slam_tpu_torch.ops import roi_align

    feats, rois, _, _, r, s = args
    return roi_align.launch_plan_bf16(rois.shape[0], feats[0].shape[1], r, s,
                                      roi_align.level_sizes(feats))


def check_roi_align_bf16(cases) -> float:
    """Kernel 5's bf16 build on ``cases`` with the features cast to bf16
    (``check_bf16_kernel``: two launches give the same bits, each output
    within ``bf16_bar`` of the plain version), each case's plan printed.
    Returns max_abs_err."""
    import torch
    from vido_slam_tpu_torch.ops import roi_align

    err = 0.0
    for name, (feats, *rest) in cases:
        args = ([f.to(torch.bfloat16) for f in feats], *rest)
        err = max(err, check_bf16_kernel(
            f"{name} in bf16", roi_align.roi_align_multilevel,
            roi_align.roi_align_multilevel_ref, args))
        print(f"roi_align_multilevel bf16 {name}: plan {roi_plan_bf16(args)}")
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


def lifted(model, lift=MASK_LIFT):
    """``model`` with class 3's score bias at ``lift``."""
    import torch

    with torch.no_grad():
        model.roi_heads.box.predictor.cls_score.bias[3] = lift
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
                return a.detach().clone()
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


def demo_rows(seq, cfg, dev="cuda"):
    """The frames of ``seq`` as a dataset stores them: BGR uint8 rendered
    by ``render_rgb`` on ``dev``, raw 16-bit depth by the dataset's rule
    (metric = bf / (raw / DepthMapFactor), KAIST and KITTI alike; 0 where
    no surface), flow, uint8 mask, t = k / 10 s."""
    import torch
    from vido_slam_tpu_torch.io.synthetic import render_rgb

    dev = torch.device(dev)
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


def run_phase_h(counters, names, seq, vio_init, vio_attempts,
                tree_hook=None):
    """Phase (h), the offline demo from files: the CLI's main() on trees
    this function writes; ``tree_hook(root, n_frames)``, if given, runs on
    the KAIST tree once it is written. Returns each kernel's launches on
    (h1)-(h4)."""
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
        if tree_hook is not None:
            tree_hook(os.path.join(root, "kaist"), N_FRAMES)
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


def time_bf16(cases, kernel, plain, count, plan=None):
    """The bf16 build's device ms over ``cases`` (a graph replay of 20
    calls each), its plain version's, their bound (``count(args)``: bytes,
    flops) and the float32 build's device ms on the same values:
    (ms, plain_ms, bound_ms, bound_by, f32_ms). ``plan(args)``, if given,
    is the bf16 build's launch plan, printed beside its time."""
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
              f"{b_} bytes, {f_} flops"
              + (f", plan {plan(args)}" if plan else ""))
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
    versions at every level of that call and at the flow path's five
    levels (seeded, as phase 3's cases). ``f32_ms``: (e)'s median ms a
    frame. Returns {kernel: (bf16 launches, max error, (ms, plain_ms,
    bound_ms, bound_by, f32_ms)[, the same at the flow path's levels])}
    for kernels 3-5."""
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
                                  roi_align.operations_bf16(*a)),
                       roi_plan_bf16)
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
    plans = {"correlation": lambda a: correlation.plan_for(a[0], a[2]),
             "dist_weighted_flow": lambda a: (
                 f"{regularize.copy_width(a[1])}-byte flow copies")}
    # ... and at the flow path's five levels (the 1280x576 pair's shapes,
    # seeded as phase 3's cases) in bf16
    rng = np.random.RandomState(0)
    seeded = {"correlation": correlation_cases(rng, dev),
              "dist_weighted_flow": regularize_cases(rng, dev)}
    for i, (attr, (kernel, plain, count)) in enumerate(kernels.items()):
        cases = [(f"(j2) level {6 - k} {tuple(args[0].shape)}", args)
                 for k, (args, _) in enumerate(recs[attr].calls)]
        err = max(check_bf16_kernel(n, kernel, plain, a) for n, a in cases)
        path = [(f"(j2) flow path {n}", tuple(
            a.to(bf) if torch.is_tensor(a) else a for a in args))
            for n, args in seeded[attr]]
        err = max([err] + [check_bf16_kernel(n, kernel, plain, a)
                           for n, a in path])
        out[attr] = [launches_flow[2 + i], err,
                     time_bf16(cases, kernel, plain, count, plans[attr]),
                     time_bf16(path, kernel, plain, count, plans[attr])]
    del recs, seeded
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
    for name, (n, err, t, *path) in out.items():
        print(f"(j) {name} bf16 build: {n} launches, device ms {t[0]:.4f} "
              f"(float32 build {t[4]:.4f} on the same values), plain "
              f"{t[1]:.3f} ms, bound {t[2]:.6f} ms by {t[3]}, max error "
              f"{err:.3e}" + "".join(
                  f"; at the flow path's five levels device ms {p[0]:.4f} "
                  f"(float32 build {p[4]:.4f}), plain {p[1]:.3f} ms, bound "
                  f"{p[2]:.6f} ms by {p[3]}" for p in path))
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
# phase 4 (s): the images the JAX package reads through cv2 and PIL beyond
# PNG and baseline JPEG: progressive and multi-scan JPEG, JPEG without
# Huffman tables, BMP
# ---------------------------------------------------------------------------

PROGRESSIVE_FIXTURES = os.path.join("tests", "data", "progressive")
BMP_FIXTURES = os.path.join("tests", "data")


def image_digest(img) -> str:
    """An image's shape and the SHA-256 of its bytes, as
    tools/make_image_fixtures.py records cv2's and PIL's reads."""
    import hashlib

    return ",".join(map(str, img.shape)) + ":" + hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


def write_bmp24(path, bgr) -> None:
    """A 24-bit bottom-up BMP (40-byte header) of an (H, W, 3) BGR frame."""
    import struct

    H, W = bgr.shape[:2]
    stride = (3 * W + 3) & ~3
    rows = np.zeros((H, stride), np.uint8)
    rows[:, :3 * W] = bgr[::-1].reshape(H, -1)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, W, H, 1, 24, 0, rows.size,
                            2835, 2835, 0, 0))
        f.write(rows.tobytes())


def check_image_fixtures(root) -> int:
    """(s1): each committed progressive, multi-scan, DHT-less and cut JPEG
    fixture and each BMP fixture read as cv2 reads it in colour and in gray
    (IMREAD_GRAYSCALE and IMREAD_ANYDEPTH: the JPEG's C++ and plain steps,
    ``datasets.imread``) and as PIL reads it (``read_rgb_pil``), against
    the digests of cv2's and PIL's reads (tools/make_image_fixtures.py);
    the cut file raises as PIL does. Returns the number of reads held."""
    from vido_slam_tpu_torch.io import datasets, jpeg

    held = 0
    for kind, ref_path, directory, ext in (
            ("jpeg", os.path.join(root, PROGRESSIVE_FIXTURES, "layouts.npz"),
             os.path.join(root, PROGRESSIVE_FIXTURES, "layouts"), ".jpg"),
            ("bmp", os.path.join(root, BMP_FIXTURES, "bmp.npz"),
             os.path.join(root, BMP_FIXTURES, "bmp"), ".bmp")):
        ref = np.load(ref_path)
        names = sorted(n for n in ref.files
                       if not n.endswith(("_gray", "_pil")))
        check(names == sorted(os.path.splitext(f)[0]
                              for f in os.listdir(directory)),
              f"(s1) {kind} fixtures {names}")
        for name in names:
            path = os.path.join(directory, name + ext)
            with open(path, "rb") as f:
                data = f.read()
            reads = [(name, datasets.imread(path, datasets.IMREAD_COLOR)),
                     (name + "_gray",
                      datasets.imread(path, datasets.IMREAD_GRAYSCALE)),
                     (name + "_gray",
                      datasets.imread(path, datasets.IMREAD_ANYDEPTH))]
            if kind == "jpeg":
                reads += [(key, jpeg.decode_jpeg(data, gray=gray, plain=True))
                          for key, gray in ((name, False),
                                            (name + "_gray", True))]
            for key, got in reads:
                check(got is not None and image_digest(got) == str(ref[key]),
                      f"(s1) {name}{ext} {key}: not cv2's read")
                held += 1
            if name + "_pil" in ref.files:
                got = datasets.read_rgb_pil(path)
                check(image_digest(got) == str(ref[name + "_pil"]),
                      f"(s1) {name}{ext}: not PIL's read")
            else:
                try:
                    datasets.read_rgb_pil(path)
                    raised = None
                except OSError as e:
                    raised = e
                check(isinstance(raised, jpeg.TruncatedJpeg),
                      f"(s1) {name}{ext}: PIL's reader does not raise")
            held += 1
    return held


def run_phase_s(counters, tmp, dev="cuda"):
    """Phase (s): (s1) the committed fixtures against cv2's and PIL's reads;
    (s2) the CLI on (h3)'s KITTI configuration over a tree of the 24
    committed progressive 1242x375 frames (their cv2 SHA-256, kernel 1
    twice a tracked frame, the StopFrame full batch), with a frame's decode
    ms, progressive, baseline and PNG; (s3) ``infer_nets`` on a 24-bit BMP
    of bench-clip frame INFER_FRAME written here and on the progressive
    frames, card against ``--device cpu``: ``depth``, ``flow`` (kernels 3
    and 4, 5 launches each) and the Mask R-CNN ``detector`` (kernel 5
    twice). Returns each part's launches."""
    import hashlib
    import shutil

    from vido_slam_tpu_torch.io import datasets

    root = os.path.dirname(os.path.abspath(__file__))
    cards = card_line()
    t0 = time.perf_counter()
    held = check_image_fixtures(root)
    print(f"(s1) fixtures: progressive 4:4:4, 4:2:2, 4:2:0, 4:4:0, gray and "
          f"restart, one sequential scan a component, a smoothed script, no "
          f"DHT, a cut file; BMP palettes 1/4/8, RLE4/RLE8, 5-5-5, 5-6-5, "
          f"24-, 32-bit, top-down: {held} reads bit-equal to cv2's and "
          f"PIL's (C++ and plain)")
    # (s2)
    prog = os.path.join(root, PROGRESSIVE_FIXTURES, "kitti")
    base = os.path.join(root, JPEG_FIXTURES, "kitti")
    digests = np.load(os.path.join(root, PROGRESSIVE_FIXTURES,
                                   "kitti.npz"))["sha256"]
    files = sorted(os.listdir(prog))
    check(len(files) == len(digests) == N_FRAMES,
          f"(s2): {len(files)} progressive KITTI frames")
    decode = {"progressive": [], "baseline": [], "png": []}
    for k, fname in enumerate(files):
        t1 = time.perf_counter()
        img = datasets.imread(os.path.join(prog, fname))
        decode["progressive"].append(time.perf_counter() - t1)
        check(hashlib.sha256(img.tobytes()).hexdigest() == digests[k],
              f"(s2) {fname}: not cv2's decode")
        t1 = time.perf_counter()
        datasets.imread(os.path.join(base, fname))
        decode["baseline"].append(time.perf_counter() - t1)
        png_path = os.path.join(tmp, f"s{k:010d}.png")
        write_png(png_path, img)
        t1 = time.perf_counter()
        datasets.imread(png_path)
        decode["png"].append(time.perf_counter() - t1)
    ms = {k: 1e3 * float(np.median(v)) for k, v in decode.items()}
    print(f"(s2) decode ms a 1242x375 frame (median of {N_FRAMES}, host): "
          f"progressive {ms['progressive']:.2f}, baseline "
          f"{ms['baseline']:.2f}, PNG (write_png) {ms['png']:.2f}; card "
          f"{cards}")
    kitti_seq = offline_sequence(N_FRAMES, dev, KITTI_CONFIG)

    def copy_jpg(path, bgr):
        shutil.copy(os.path.join(prog, os.path.basename(path)), path)
    tree = write_tree(os.path.join(tmp, "kitti_s"), "kitti",
                      demo_rows(kitti_seq, KITTI_CONFIG), jpg=copy_jpg)
    cfg = os.path.join(tmp, "s.yaml")
    write_config(cfg, dict(KITTI_CONFIG, slam_mode=0, **tree))
    d = os.path.join(tmp, "out_s", "")
    run, launches, _, batches = run_demo(
        [cfg, "--output", d, "--max-frames", str(N_FRAMES), "--device",
         dev], counters)
    want = [2 * (N_FRAMES - 1), 0, 0, 0, 0]
    ate0, ate1, path, _ = check_demo(
        run, d, [fr.Tcw_gt for fr in kitti_seq.frames], N_FRAMES, launches,
        want)
    check(len(batches) == 1, f"(s2): {len(batches)} full batches")
    secs, res = batches[0]
    loop_ms, read_ms, share = demo_ms(run)
    print(f"(s2) CLI KITTI VO on the progressive .jpg frames: {N_FRAMES} "
          f"frames, launches {launches}, camera ATE initial {ate0:.5f} m, "
          f"refined {ate1:.5f} m over {path:.3f} m; StopFrame full batch "
          f"{secs:.2f} s, {res.num_iters} LM iterations; ms a frame of the "
          f"CLI loop median {loop_ms:.2f}, reading {read_ms:.2f} "
          f"({100 * share:.1f} %)")
    del run, kitti_seq
    parts = {"s2_cli": launches}
    parts.update(run_infer_formats(counters, tmp, files[:2], prog))
    print(f"phase (s): {time.perf_counter() - t0:.1f} s; card {cards}")
    return {**parts, "decode_ms": ms}


def run_infer_formats(counters, tmp, pair, prog):
    """(s3): ``infer_nets`` card against CPU on a 24-bit BMP of bench-clip
    frame INFER_FRAME and the progressive KITTI frames ``pair`` (in
    ``prog``): depth over the three, flow on the pair, the Mask R-CNN
    detector on the BMP. Returns each part's launches on the card."""
    import shutil

    from vido_slam_tpu_torch import infer_nets
    from vido_slam_tpu_torch.io import datasets
    from vido_slam_tpu_torch.io.datasets import read_flo

    root = os.path.dirname(os.path.abspath(__file__))
    parts = {}
    clip = np.load(os.path.join(root, ONLINE_CLIP))["clip"]
    frame_bmp = os.path.join(tmp, "clip_frame.bmp")
    write_bmp24(frame_bmp, np.ascontiguousarray(clip[INFER_FRAME][..., ::-1]))
    check(np.array_equal(datasets.read_rgb_pil(frame_bmp),
                         clip[INFER_FRAME]), "(s3): the BMP frame")
    images = os.path.join(tmp, "s3_images")
    os.makedirs(images)
    shutil.copy(frame_bmp, images)
    for fname in pair:
        shutil.copy(os.path.join(prog, fname), images)

    def both(argv, part, refuse=False):
        """The CLI on the card (its launches), then on the CPU; the output
        directories and each run's refusal (None where it finished)."""
        outs, refusals = [], []
        for dev in ("cuda", "cpu"):
            out = os.path.join(tmp, f"s3_{part}_{dev}")
            extra = [] if dev == "cuda" else ["--device", "cpu"]

            def call():
                try:
                    quiet(lambda: infer_nets.main(argv + ["--out", out]
                                                  + extra))
                except ValueError as e:
                    if not refuse:
                        raise
                    return str(e)
                return None
            msg, n = launches_of(counters, lambda: host_timed(call, dev))
            if dev == "cuda":
                parts[part] = n
            outs.append(out)
            refusals.append(msg[0])
        return outs, refusals
    card, cpu = both(["depth", "--images", images], "depth")[0]
    gap = 0.0
    for fname in sorted(os.listdir(images)):
        stem = os.path.splitext(fname)[0]
        a = np.load(os.path.join(card, f"{stem}_disp.npy"))
        b = np.load(os.path.join(cpu, f"{stem}_disp.npy"))
        check(a.shape == b.shape and np.isfinite(a).all(),
              f"(s3) depth {fname}: {a.shape}")
        gap = max(gap, float(np.abs(a - b).max()) / float(np.abs(b).max()))
    check(gap <= DEPTH_BAR and parts["depth"] == [0] * len(counters),
          f"(s3) depth: card against CPU {gap:.2e}, launches "
          f"{parts['depth']}")
    card, cpu = both(["flow", "--first", os.path.join(images, pair[0]),
                      "--second", os.path.join(images, pair[1])],
                     "flow")[0]
    a = read_flo(os.path.join(card, "flow.flo"))
    b = read_flo(os.path.join(cpu, "flow.flo"))
    fgap = float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
    check(a.shape == (375, 1242, 2) and fgap <= FLOW_BAR
          and parts["flow"] == [0, 0, 5, 5, 0],
          f"(s3) flow: {a.shape}, card against CPU {fgap:.2e}, launches "
          f"{parts['flow']}")
    (card, cpu), refusals = both(["detector", "--family", "maskrcnn",
                                  "--image", frame_bmp], "maskrcnn",
                                 refuse=True)
    check(refusals[0] == refusals[1], f"(s3) maskrcnn: refusals {refusals}")
    a = json_detections(os.path.join(card, "maskrcnn_detections.json"))
    b = json_detections(os.path.join(cpu, "maskrcnn_detections.json"))
    n = max(len(a["valid"]), len(b["valid"]))
    m = match_detections(padded(a, n), padded(b, n),
                         DETECTOR_THRESHOLDS["maskrcnn"])
    check(not m["unexplained"] and parts["maskrcnn"] == [0, 0, 0, 0, 2],
          f"(s3) maskrcnn: {m}, launches {parts['maskrcnn']}")
    print(f"(s3) infer_nets on a BMP of clip frame {INFER_FRAME} and "
          f"progressive KITTI frames {pair[0]}, {pair[1]}: depth card "
          f"against CPU {gap:.2e} of the max (bar {DEPTH_BAR:.0e}); flow "
          f"{fgap:.2e} of max(|flow|, 1) (bar {FLOW_BAR:.0e}), launches "
          f"{parts['flow']}; maskrcnn on the BMP: card {m['valid'][0]} "
          f"detections, CPU {m['valid'][1]}, launches {parts['maskrcnn']}")
    return parts


# ---------------------------------------------------------------------------
# phase 4 (t): the other images the JAX package reads through cv2 and PIL:
# PBM/PGM/PPM, PAM, PFM, TIFF, Radiance HDR, Sun raster, CMYK/YCCK JPEG
# ---------------------------------------------------------------------------

FORMAT_FIXTURES = ("pxm", "tiff", "hdr", "sunras", "cmyk")
FORMAT_FRAMES = 12   # (t2)'s tracked frames a tree, and no StopFrame


def check_format_fixtures(root, formats=FORMAT_FIXTURES) -> int:
    """(t1), (u1): each committed fixture of tests/data/<format>/ read as
    cv2 reads it under IMREAD_COLOR, IMREAD_GRAYSCALE and IMREAD_ANYDEPTH
    (``datasets.imread``; TIFF (tiff, tiff26c), GIF and WebP (webp,
    webp26d) also by their host codecs' plain versions, JPEG by its plain
    steps and plain arithmetic and lossless decoders) and as PIL reads it
    (``read_rgb_pil``; the files of pil29 also by their host loops' plain
    versions), against the
    digests of cv2's and PIL's reads (tools/make_image_fixtures.py;
    "None" where cv2 gives None; no PIL digest where PIL raises, and then
    ``read_rgb_pil`` raises). Returns the number of reads held."""
    from vido_slam_tpu_torch.io import datasets, gif, jpeg, tiff, webp

    held = 0
    flags = ((datasets.IMREAD_COLOR, ""), (datasets.IMREAD_GRAYSCALE,
                                           "_gray"),
             (datasets.IMREAD_ANYDEPTH, "_any"))
    for fmt in formats:
        directory = os.path.join(root, "tests", "data", fmt)
        ref = np.load(os.path.join(root, "tests", "data", fmt + ".npz"))
        files = sorted(os.listdir(directory))
        check(len(files) >= 3 and all(os.path.splitext(f)[0] in ref.files
                                      for f in files),
              f"(t1) {fmt} fixtures {files}")
        for fname in files:
            name = os.path.splitext(fname)[0]
            path = os.path.join(directory, fname)
            with open(path, "rb") as f:
                data = f.read()
            for flag, suffix in flags:
                reads = [datasets.imread(path, flag)]
                if fmt in ("tiff", "tiff26c"):
                    reads.append(tiff.read_cv2(data, flag, plain=True))
                if fmt in ("cmyk", "jpeg24"):
                    try:
                        reads.append(jpeg.decode_jpeg(
                            data, gray=flag != datasets.IMREAD_COLOR,
                            plain=True))
                    except jpeg.CorruptJpeg:
                        reads.append(None)
                if fmt == "gif":
                    reads.append(gif.read_cv2(data, flag, plain=True))
                if fmt in ("webp", "webp26d"):
                    reads.append(webp.read_cv2(data, flag, plain=True))
                for got in reads:
                    digest = "None" if got is None else image_digest(got)
                    check(digest == str(ref[name + suffix]),
                          f"(t1) {fname} {suffix or 'colour'}: not cv2's read")
                    held += 1
            readers = [lambda: datasets.read_rgb_pil(path)]
            if fmt == "pil29" and pil29_plain_module(data) is not None:
                readers.append(lambda: pil29_plain_module(data).read_pil(
                    data, plain=True))
            for read in readers:
                try:
                    got, raised = read(), None
                except (OSError, ValueError) as e:
                    got, raised = None, e
                if name + "_pil" in ref.files:
                    check(got is not None
                          and image_digest(got) == str(ref[name + "_pil"]),
                          f"(t1) {fname}: not PIL's read ({raised})")
                else:
                    check(raised is not None,
                          f"(t1) {fname}: PIL raises, read_rgb_pil does not")
                held += 1
    return held


def pil29_plain_module(data):
    """The reader module of a file of the formats PIL opens and cv2 does
    not, where it has host loops with plain versions (``read_pil(data,
    plain=True)``); None for the others (IM, ICO)."""
    from vido_slam_tpu_torch.io import msp, pcx, pil_open, qoi, sgi, tga, xbm

    modules = {"TGA": tga, "PCX": pcx, "SGI": sgi, "QOI": qoi, "XBM": xbm,
               "MSP": msp}
    try:
        return modules.get(pil_open.pil_format(data))
    except OSError:
        return None


def write_pnm(path, img) -> None:
    """Binary PPM (an (H, W, 3) BGR frame) or PGM (8- or 16-bit gray)."""
    img = np.asarray(img)
    if img.ndim == 3:
        head, body = b"P6", img[..., ::-1].tobytes()
    else:
        head = b"P5"
        body = img.astype(">u2").tobytes() if img.dtype == np.uint16 \
            else img.tobytes()
    top = 65535 if img.dtype == np.uint16 else 255
    with open(path, "wb") as f:
        f.write(head + b"\n%d %d\n%d\n" % (img.shape[1], img.shape[0], top)
                + body)


@functools.lru_cache(maxsize=None)
def image_encoders():
    """tests/image_encoders.py, the test-side writers of the layouts cv2
    and PIL read but do not write, loaded once by its path (a ``tests``
    package installed elsewhere may shadow the repo's directory)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "image_encoders.py")
    spec = importlib.util.spec_from_file_location("image_encoders", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_tiff_tree_file(path, img) -> None:
    """A frame as an LZW TIFF (RGB, horizontal predictor, strips of 16
    rows), a depth map as a 16-bit Deflate TIFF, a mask as an 8-bit PGM."""
    write_tiff = image_encoders().write_tiff
    img = np.asarray(img)
    if img.ndim == 3:
        write_tiff(path, np.ascontiguousarray(img[..., ::-1]), photometric=2,
                   compression=5, predictor=2, rows_per_strip=16)
    elif img.dtype == np.uint16:
        write_tiff(path, img, photometric=1, compression=8, predictor=2,
                   rows_per_strip=32)
    else:
        write_pnm(path, img)


def run_format_trees(counters, tmp, dev="cuda", n_frames=FORMAT_FRAMES,
                     cfg=None):
    """(t2): the CLI on three KITTI trees of the same rendered frames, each
    file under the name the reader expects (<10 digits>.png): PNG
    (``write_png``), PPM frames with 16-bit PGM depth and 8-bit PGM masks
    (``write_pnm``), LZW TIFF frames with 16-bit Deflate TIFF depth
    (``write_tiff_tree_file``); times.txt lists one more frame, whose image
    is missing, so no StopFrame full batch runs. Each tree decodes to the
    PNG tree's arrays, so its launches and trajectories equal the PNG
    run's. Returns (each tree's launches, each format's median decode ms
    of a frame's image file and of its three files)."""
    from vido_slam_tpu_torch.io import datasets

    cfg = cfg or KITTI_CONFIG
    seq = offline_sequence(n_frames, dev, cfg)
    rows = demo_rows(seq, cfg, dev)
    trees = {"png": write_png, "pnm": write_pnm,
             "tiff": write_tiff_tree_file}
    runs, launches, decode = {}, {}, {}
    for tag, writer in trees.items():
        root = os.path.join(tmp, f"t2_{tag}")
        tree = write_tree(root, "kitti", rows, png=writer)
        with open(os.path.join(root, "times.txt"), "a") as f:
            f.write(f"{n_frames / 10.0:.6f}\n")     # its image is missing
        stems = sorted(os.listdir(tree["image_path"]))
        check(len(stems) == n_frames, f"(t2) {tag}: {stems}")
        ms = []
        for k, stem in enumerate(stems):
            paths = (os.path.join(tree["image_path"], stem),
                     os.path.join(root, "depth", stem),
                     os.path.join(root, "mask", stem))
            t0 = time.perf_counter()
            bgr = datasets.imread(paths[0])
            t1 = time.perf_counter()
            depth = datasets.imread(paths[1], datasets.IMREAD_ANYDEPTH)
            mask = datasets.imread(paths[2], datasets.IMREAD_GRAYSCALE)
            ms.append((1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0)))
            check(np.array_equal(bgr, rows[k][0])
                  and np.array_equal(depth, rows[k][1])
                  and np.array_equal(mask, rows[k][3]),
                  f"(t2) {tag} {stem}: not the rendered arrays")
        decode[tag] = dict(zip(("frame", "files"),
                               np.median(ms, axis=0).tolist()))
        cfg_path = os.path.join(tmp, f"t2_{tag}.yaml")
        write_config(cfg_path, dict(cfg, slam_mode=0, **tree))
        out = os.path.join(tmp, f"t2_{tag}_out", "")
        run, n, _, batches = run_demo(
            [cfg_path, "--output", out, "--device", dev], counters)
        check(not batches, f"(t2) {tag}: {len(batches)} full batches")
        ate0, _, path, poses = check_demo(
            run, out, [fr.Tcw_gt for fr in seq.frames], n_frames, n,
            [2 * (n_frames - 1), 0, 0, 0, 0][:len(counters)])
        runs[tag], launches[tag] = (poses, ate0, path), n
        del run
    base = runs["png"][0]
    for tag in ("pnm", "tiff"):
        for name, p in runs[tag][0].items():
            check(np.array_equal(p, base[name]),
                  f"(t2) {tag} {name}: not the PNG tree's trajectory")
    print(f"(t2) CLI KITTI VO on PNG, PPM/PGM and TIFF/PGM trees of "
          f"{n_frames} rendered 1242x375 frames (one listed frame missing: "
          f"no StopFrame): launches {launches}, trajectories equal to the "
          f"PNG tree's, camera ATE {runs['png'][1]:.5f} m over "
          f"{runs['png'][2]:.3f} m; host decode ms (median) of a frame "
          f"and of its frame, depth and mask files: PNG "
          f"{decode['png']['frame']:.2f} and {decode['png']['files']:.2f}, "
          f"PPM and PPM+PGM {decode['pnm']['frame']:.2f} and "
          f"{decode['pnm']['files']:.2f}, LZW TIFF and LZW TIFF+Deflate "
          f"TIFF+PGM {decode['tiff']['frame']:.2f} and "
          f"{decode['tiff']['files']:.2f}")
    return launches, decode


def run_infer_new_formats(counters, tmp, dev="cuda"):
    """(t3): ``infer_nets`` on the card on the new formats against the
    same run on a PNG of the same pixels: flow on a binary PPM pair of the
    progressive KITTI frames 0 and 1 (kernels 3 and 4, 5 launches each),
    depth on an RGB LZW TIFF of bench-clip frame INFER_FRAME, the Mask
    R-CNN detector on a CMYK JPEG of that frame read as PIL reads it
    (kernel 5 twice). Returns each part's launches."""
    from vido_slam_tpu_torch import infer_nets
    from vido_slam_tpu_torch.io import datasets
    from vido_slam_tpu_torch.io.datasets import read_flo

    root = os.path.dirname(os.path.abspath(__file__))
    prog = os.path.join(root, PROGRESSIVE_FIXTURES, "kitti")
    pair = sorted(os.listdir(prog))[:2]
    d = os.path.join(tmp, "t3")
    os.makedirs(d)
    inputs = {}
    for k, fname in enumerate(pair):
        bgr = datasets.imread(os.path.join(prog, fname))
        inputs[f"ppm{k}"] = os.path.join(d, f"pair{k}.ppm")
        write_pnm(inputs[f"ppm{k}"], bgr)
        inputs[f"png{k}"] = os.path.join(d, f"pair{k}.png")
        write_png(inputs[f"png{k}"], bgr)
    clip = np.load(os.path.join(root, ONLINE_CLIP))["clip"]
    rgb = np.ascontiguousarray(clip[INFER_FRAME])
    inputs["tiff"] = os.path.join(d, "frame.tif")
    write_tiff_tree_file(inputs["tiff"], rgb[..., ::-1])
    inputs["tiff_png"] = os.path.join(d, "frame_tif.png")
    write_png(inputs["tiff_png"], datasets.read_rgb_pil(inputs["tiff"])[
        ..., ::-1])
    check(np.array_equal(datasets.read_rgb_pil(inputs["tiff"]), rgb),
          "(t3): the TIFF frame")
    inputs["cmyk"] = os.path.join(d, "frame_cmyk.jpg")
    image_encoders().write_cmyk_jpeg(inputs["cmyk"], rgb)
    cmyk_rgb = datasets.read_rgb_pil(inputs["cmyk"])
    inputs["cmyk_png"] = os.path.join(d, "frame_cmyk.png")
    write_png(inputs["cmyk_png"], cmyk_rgb[..., ::-1])
    parts, refusals = {}, []

    def call(argv):
        try:
            quiet(lambda: infer_nets.main(argv))
        except ValueError as e:
            # random Mask R-CNN weights give inverted boxes: the CLI
            # refuses the drawing after writing the JSON, as JAX's does
            refusals.append(str(e))

    def run(argv, part, out):
        argv = argv + ["--out", out] + ([] if dev == "cuda"
                                        else ["--device", dev])
        n = launches_of(counters, lambda: call(argv))[1]
        parts.setdefault(part, n)
        check(n == parts[part], f"(t3) {part}: launches {n}, "
              f"{parts[part]} on the other input")
        return out
    a = run(["flow", "--first", inputs["ppm0"], "--second", inputs["ppm1"]],
            "flow", os.path.join(d, "flow_ppm"))
    b = run(["flow", "--first", inputs["png0"], "--second", inputs["png1"]],
            "flow", os.path.join(d, "flow_png"))
    fa, fb = (read_flo(os.path.join(x, "flow.flo")) for x in (a, b))
    fgap = float(np.abs(fa - fb).max()) / max(1.0, float(np.abs(fb).max()))
    a = run(["depth", "--images", inputs["tiff"]], "depth",
            os.path.join(d, "depth_tiff"))
    b = run(["depth", "--images", inputs["tiff_png"]], "depth",
            os.path.join(d, "depth_png"))
    da = np.load(os.path.join(a, "frame_disp.npy"))
    db = np.load(os.path.join(b, "frame_tif_disp.npy"))
    gap = float(np.abs(da - db).max()) / float(np.abs(db).max())
    dets = []
    for key in ("cmyk", "cmyk_png"):
        out = run(["detector", "--family", "maskrcnn", "--image",
                   inputs[key]], "maskrcnn", os.path.join(d, "det_" + key))
        dets.append(json_detections(os.path.join(
            out, "maskrcnn_detections.json")))
    check(len(refusals) in (0, 2) and len(set(refusals)) <= 1,
          f"(t3): the CLI's refusals {refusals}")
    n = max(len(x["valid"]) for x in dets)
    m = match_detections(padded(dets[0], n), padded(dets[1], n),
                         DETECTOR_THRESHOLDS["maskrcnn"])
    want = {"flow": [0, 0, 5, 5, 0], "depth": [0, 0, 0, 0, 0],
            "maskrcnn": [0, 0, 0, 0, 2]}
    check(fa.shape == (375, 1242, 2) and fgap <= FLOW_BAR
          and da.shape == db.shape and gap <= DEPTH_BAR
          and not m["unexplained"]
          and all(parts[k] == want[k][:len(counters)] for k in want),
          f"(t3): flow {fgap:.2e}, depth {gap:.2e}, maskrcnn {m}, launches "
          f"{parts}")
    print(f"(t3) infer_nets: flow on a PPM pair against the PNG pair "
          f"{fgap:.2e} of max(|flow|, 1) (bar {FLOW_BAR:.0e}; "
          f"{'bit-equal' if fgap == 0 else 'not bit-equal'}), launches "
          f"{parts['flow']}; depth on an LZW TIFF against its PNG {gap:.2e} "
          f"of the max ({'bit-equal' if gap == 0 else 'not bit-equal'}); "
          f"Mask R-CNN on a CMYK JPEG against a PNG of PIL's read of it: "
          f"{m['valid'][0]} and {m['valid'][1]} detections matched, "
          f"launches {parts['maskrcnn']}")
    return parts


def run_phase_t(counters, tmp, dev="cuda"):
    """Phase (t): (t1) the committed fixtures of tests/data/{pxm, tiff,
    hdr, sunras, cmyk} against cv2's and PIL's digests; (t2) the CLI on
    PNG, PPM/PGM and TIFF/PGM KITTI trees; (t3) ``infer_nets`` on PPM,
    TIFF and CMYK JPEG inputs. Returns each part's launches and the decode
    ms."""
    root = os.path.dirname(os.path.abspath(__file__))
    cards = card_line() if dev == "cuda" else "cpu"
    t0 = time.perf_counter()
    held = check_format_fixtures(root)
    print(f"(t1) fixtures: PBM/PGM/PPM (ASCII, binary, 8/16-bit, odd "
          f"maxval), PAM, PFM, TIFF (strips, tiles, planes, BigTIFF, LZW "
          f"both ways, Deflate, PackBits, predictors 2/3; 1/8/16-bit, "
          f"float, RGB(A), palette), HDR (RLE, flat), Sun raster (1/8/24/"
          f"32-bit, map, RLE, type 3), CMYK/YCCK/Adobe-RGB JPEG: {held} "
          f"reads bit-equal to cv2's and PIL's (C++ and plain)")
    launches, decode = run_format_trees(counters, tmp, dev)
    parts = {f"t2_{k}": v for k, v in launches.items()}
    parts.update(run_infer_new_formats(counters, tmp, dev))
    print(f"phase (t): {time.perf_counter() - t0:.1f} s; card {cards}")
    return {**parts, "decode_ms": decode}


# ---------------------------------------------------------------------------
# phase 4 (u): arithmetic-coded, lossless and 12-bit JPEG, GIF and lossless
# WebP (ROADMAP.md queue 1 items 24, 28b GIF and 26b VP8L)
# ---------------------------------------------------------------------------

U_FIXTURES = ("jpeg24", "gif", "webp")
U_FRAMES = 12        # (u2)'s tracked frames a tree, and no StopFrame


def write_gray_gif(path, img) -> None:
    """An 8-bit gray image as a GIF of the gray ramp (cv2's gray of the
    ramp's colours is the index itself)."""
    enc = image_encoders()
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    with open(path, "wb") as f:
        f.write(enc.write_gif((img.shape[1], img.shape[0]), [enc.gif_frame(
            np.asarray(img, np.uint8), min_code_size=8)], palette=ramp))


def write_lossless_webp(path, bgr) -> None:
    """An (H, W, 3) BGR frame as a lossless WebP (VP8L: subtract-green,
    literals)."""
    b, g, r = (bgr[..., c].astype(np.uint32) for c in range(3))
    with open(path, "wb") as f:
        f.write(image_encoders().write_vp8l(
            np.uint32(0xFF000000) | r << 16 | g << 8 | b,
            subtract_green=True))


def run_u_trees(counters, tmp, dev="cuda", n_frames=U_FRAMES, cfg=None):
    """(u2): the CLI on two KITTI trees of the committed baseline .jpg
    frames (tests/data/jpeg/kitti), the same rendered depth (16-bit PNG)
    and masks: the frames as they are with PNG masks, and the frames
    arithmetic-coded (re-coded from their coefficients) with GIF masks;
    times.txt lists one more frame, whose image is missing, so no
    StopFrame full batch runs. The two trees decode to the same arrays, so
    their launches and trajectories are equal. Returns each tree's launches
    and the median host decode ms of a frame: baseline JPEG, arithmetic
    JPEG, a GIF mask, that mask as a lossless JPEG, a frame as a lossless
    WebP."""
    import shutil

    from vido_slam_tpu_torch.io import datasets

    enc = image_encoders()
    cfg = cfg or KITTI_CONFIG
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        JPEG_FIXTURES, "kitti")
    seq = offline_sequence(n_frames, dev, cfg)
    rows = demo_rows(seq, cfg, dev)

    def copy_jpg(path, bgr):
        shutil.copy(os.path.join(root, os.path.basename(path)), path)

    def arith_jpg(path, bgr):
        with open(os.path.join(root, os.path.basename(path)), "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(enc.reencode_jpeg(data, [enc.Scan([0, 1, 2])],
                                      progressive=False, arithmetic=True))

    def gif_masks(path, img):
        if img.dtype == np.uint8 and img.ndim == 2:
            write_gray_gif(path, img)
        else:
            write_png(path, img)
    trees = {"jpeg": (copy_jpg, write_png), "arith": (arith_jpg, gif_masks)}
    runs, launches, decode = {}, {}, {}
    for tag, (jpg, png) in trees.items():
        t_root = os.path.join(tmp, f"u2_{tag}")
        tree = write_tree(t_root, "kitti", rows, png=png, jpg=jpg)
        with open(os.path.join(t_root, "times.txt"), "a") as f:
            f.write(f"{n_frames / 10.0:.6f}\n")     # its image is missing
        stems = sorted(os.listdir(tree["image_path"]))
        check(len(stems) == n_frames, f"(u2) {tag}: {stems}")
        ms = {"frame": [], "mask": []}
        for k, stem in enumerate(stems):
            t0 = time.perf_counter()
            bgr = datasets.imread(os.path.join(tree["image_path"], stem))
            t1 = time.perf_counter()
            mask = datasets.imread(os.path.join(t_root, "mask", stem[:-4]
                                                + ".png"),
                                   datasets.IMREAD_GRAYSCALE)
            ms["frame"].append(1e3 * (t1 - t0))
            ms["mask"].append(1e3 * (time.perf_counter() - t1))
            check(np.array_equal(mask, rows[k][3]),
                  f"(u2) {tag} {stem}: not the rendered mask")
            runs.setdefault(("frames", k), bgr)
            check(np.array_equal(bgr, runs[("frames", k)]),
                  f"(u2) {tag} {stem}: not the baseline frame")
        decode[tag] = {k: float(np.median(v)) for k, v in ms.items()}
        cfg_path = os.path.join(tmp, f"u2_{tag}.yaml")
        write_config(cfg_path, dict(cfg, slam_mode=0, **tree))
        out = os.path.join(tmp, f"u2_{tag}_out", "")
        run, n, _, batches = run_demo(
            [cfg_path, "--output", out, "--device", dev], counters)
        check(not batches, f"(u2) {tag}: {len(batches)} full batches")
        ate0, _, path, poses = check_demo(
            run, out, [fr.Tcw_gt for fr in seq.frames], n_frames, n,
            [2 * (n_frames - 1), 0, 0, 0, 0][:len(counters)])
        runs[tag], launches[tag] = (poses, ate0, path), n
        del run
    for name, p in runs["arith"][0].items():
        check(np.array_equal(p, runs["jpeg"][0][name]),
              f"(u2) arith {name}: not the baseline tree's trajectory")
    check(launches["arith"] == launches["jpeg"],
          f"(u2): launches {launches}")
    # a mask as a lossless JPEG, a frame as a lossless WebP: decode ms
    lossless = os.path.join(tmp, "u2_mask_lossless.jpg")
    with open(lossless, "wb") as f:
        f.write(enc.write_lossless_jpeg([rows[0][3].astype(np.int64)],
                                        precision=8, predictor=1))
    webp_path = os.path.join(tmp, "u2_frame.webp")
    write_lossless_webp(webp_path, runs[("frames", 0)])
    ms = {"lossless": [], "webp": []}
    for _ in range(5):
        t0 = time.perf_counter()
        m = datasets.imread(lossless, datasets.IMREAD_GRAYSCALE)
        t1 = time.perf_counter()
        w = datasets.imread(webp_path)
        ms["lossless"].append(1e3 * (t1 - t0))
        ms["webp"].append(1e3 * (time.perf_counter() - t1))
    check(np.array_equal(m, rows[0][3]) and np.array_equal(
        w, runs[("frames", 0)]), "(u2): the lossless JPEG or WebP frame")
    decode.update({k: float(np.median(v)) for k, v in ms.items()})
    print(f"(u2) CLI KITTI VO on the committed .jpg frames and on their "
          f"arithmetic re-coding with GIF masks, {n_frames} 1242x375 frames "
          f"(one listed frame missing: no StopFrame): launches {launches}, "
          f"trajectories equal, camera ATE {runs['jpeg'][1]:.5f} m over "
          f"{runs['jpeg'][2]:.3f} m; host decode ms (median) of a frame: "
          f"baseline JPEG {decode['jpeg']['frame']:.2f}, arithmetic JPEG "
          f"{decode['arith']['frame']:.2f}, lossless WebP "
          f"{decode['webp']:.2f}; of a mask: PNG "
          f"{decode['jpeg']['mask']:.2f}, GIF {decode['arith']['mask']:.2f}, "
          f"lossless JPEG {decode['lossless']:.2f}")
    return launches, decode


def run_infer_u_formats(counters, tmp, dev="cuda"):
    """(u3): ``infer_nets`` on the card on the new formats against the
    same run on a PNG of the same pixels: flow on a lossless WebP pair of
    the committed KITTI frames 0 and 1 (kernels 3 and 4, 5 launches each),
    the Mask R-CNN R-50-FPN detector on a GIF of bench-clip frame
    INFER_FRAME (posterised to 216 colours) read as PIL reads it (kernel 5
    twice). Returns each part's launches."""
    from vido_slam_tpu_torch import infer_nets
    from vido_slam_tpu_torch.io import datasets
    from vido_slam_tpu_torch.io.datasets import read_flo

    enc = image_encoders()
    root = os.path.dirname(os.path.abspath(__file__))
    kitti = os.path.join(root, JPEG_FIXTURES, "kitti")
    d = os.path.join(tmp, "u3")
    os.makedirs(d)
    inputs = {}
    for k, fname in enumerate(sorted(os.listdir(kitti))[:2]):
        bgr = datasets.imread(os.path.join(kitti, fname))
        inputs[f"webp{k}"] = os.path.join(d, f"pair{k}.webp")
        write_lossless_webp(inputs[f"webp{k}"], bgr)
        inputs[f"png{k}"] = os.path.join(d, f"pair{k}.png")
        write_png(inputs[f"png{k}"], bgr)
        check(np.array_equal(datasets.imread(inputs[f"webp{k}"]), bgr)
              and np.array_equal(datasets.read_rgb_pil(inputs[f"webp{k}"]),
                                 bgr[..., ::-1]), f"(u3): WebP frame {k}")
    clip = np.load(os.path.join(root, ONLINE_CLIP))["clip"]
    rgb = np.ascontiguousarray(clip[INFER_FRAME]) // 51 * 51
    levels = np.arange(0, 256, 51, dtype=np.uint8)
    pal = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"),
                   -1).reshape(-1, 3)
    index = (rgb[..., 0] // 51 * 36 + rgb[..., 1] // 51 * 6
             + rgb[..., 2] // 51).astype(np.uint8)
    inputs["gif"] = os.path.join(d, "frame.gif")
    table = np.zeros((256, 3), np.uint8)
    table[:len(pal)] = pal
    with open(inputs["gif"], "wb") as f:
        f.write(enc.write_gif((rgb.shape[1], rgb.shape[0]),
                              [enc.gif_frame(index, min_code_size=8)],
                              palette=table))
    check(np.array_equal(datasets.read_rgb_pil(inputs["gif"]), rgb),
          "(u3): the GIF frame")
    inputs["gif_png"] = os.path.join(d, "frame_gif.png")
    write_png(inputs["gif_png"], rgb[..., ::-1])
    parts, refusals = {}, []

    def call(argv):
        try:
            quiet(lambda: infer_nets.main(argv))
        except ValueError as e:
            # random Mask R-CNN weights give inverted boxes: the CLI
            # refuses the drawing after writing the JSON, as JAX's does
            refusals.append(str(e))

    def run(argv, part, out):
        argv = argv + ["--out", out] + ([] if dev == "cuda"
                                        else ["--device", dev])
        n = launches_of(counters, lambda: call(argv))[1]
        parts.setdefault(part, n)
        check(n == parts[part], f"(u3) {part}: launches {n}, "
              f"{parts[part]} on the other input")
        return out
    a = run(["flow", "--first", inputs["webp0"], "--second",
             inputs["webp1"]], "flow", os.path.join(d, "flow_webp"))
    b = run(["flow", "--first", inputs["png0"], "--second", inputs["png1"]],
            "flow", os.path.join(d, "flow_png"))
    fa, fb = (read_flo(os.path.join(x, "flow.flo")) for x in (a, b))
    fgap = float(np.abs(fa - fb).max()) / max(1.0, float(np.abs(fb).max()))
    dets = []
    for key in ("gif", "gif_png"):
        out = run(["detector", "--family", "maskrcnn", "--image",
                   inputs[key]], "maskrcnn", os.path.join(d, "det_" + key))
        dets.append(json_detections(os.path.join(
            out, "maskrcnn_detections.json")))
    check(len(refusals) in (0, 2) and len(set(refusals)) <= 1,
          f"(u3): the CLI's refusals {refusals}")
    n = max(len(x["valid"]) for x in dets)
    m = match_detections(padded(dets[0], n), padded(dets[1], n),
                         DETECTOR_THRESHOLDS["maskrcnn"])
    want = {"flow": [0, 0, 5, 5, 0], "maskrcnn": [0, 0, 0, 0, 2]}
    check(fa.shape == (375, 1242, 2) and fgap <= FLOW_BAR
          and not m["unexplained"]
          and all(parts[k] == want[k][:len(counters)] for k in want),
          f"(u3): flow {fgap:.2e}, maskrcnn {m}, launches {parts}")
    print(f"(u3) infer_nets: flow on a lossless WebP pair against the PNG "
          f"pair {fgap:.2e} of max(|flow|, 1) (bar {FLOW_BAR:.0e}; "
          f"{'bit-equal' if fgap == 0 else 'not bit-equal'}), launches "
          f"{parts['flow']}; Mask R-CNN on a GIF read as PIL reads it "
          f"against a PNG of the same pixels: {m['valid'][0]} and "
          f"{m['valid'][1]} detections matched, launches "
          f"{parts['maskrcnn']}")
    return parts


def run_phase_u(counters, tmp, dev="cuda"):
    """Phase (u): (u1) the committed fixtures of tests/data/{jpeg24, gif,
    webp} against cv2's and PIL's digests; (u2) the CLI on a baseline-JPEG
    KITTI tree and its arithmetic-coded twin with GIF masks; (u3)
    ``infer_nets`` on a lossless WebP pair and a GIF. Returns each part's
    launches and the decode ms."""
    root = os.path.dirname(os.path.abspath(__file__))
    cards = card_line() if dev == "cuda" else "cpu"
    t0 = time.perf_counter()
    held = check_format_fixtures(root, U_FIXTURES)
    print(f"(u1) fixtures: arithmetic-coded JPEG (sequential, DAC and "
          f"restarts, progressive with successive approximation, gray, "
          f"cut), lossless JPEG (2-8 bits, predictors, point transform, "
          f"RGB with restarts, 4:2:0, CMYK; JFIF and 12-bit as None), "
          f"12-bit lossy and SOF11 (None), GIF (writers, local tables, "
          f"interlace, offset and transparency, deferred clear, no table, "
          f"animation, cut), lossless WebP (writers, alpha, palettes, every "
          f"predictor mode, cross-colour, cache, LZ77, meta codes, "
          f"animation): {held} reads bit-equal to cv2's and PIL's (C++ "
          f"and plain)")
    launches, decode = run_u_trees(counters, tmp, dev)
    parts = {f"u2_{k}": v for k, v in launches.items()}
    parts.update(run_infer_u_formats(counters, tmp, dev))
    print(f"phase (u): {time.perf_counter() - t0:.1f} s; card {cards}")
    return {**parts, "decode_ms": decode}


# ---------------------------------------------------------------------------
# phase 4 (v): the formats PIL opens and cv2 does not (ROADMAP.md queue 1
# item 29)
# ---------------------------------------------------------------------------

V_FIXTURES = ("pil29",)
V_FORMATS = ("tga", "pcx", "sgi", "qoi", "ico")
V_DECODE_REPS = 5
V_BATCH = len(V_FORMATS)     # one training step over the whole COCO tree


def write_pil29(path, fmt, bgr):
    """An (H, W, 3) BGR frame as one of item 29's formats, by the test-side
    writers (the card's machine has no PIL): run-length Targa, PCX of three
    planes, run-length SGI, QOI, or an icon of one 24-bit BMP entry (at
    most 256 pixels a side)."""
    enc = image_encoders()
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    H, W = bgr.shape[:2]
    data = {"tga": lambda: enc.write_tga(bgr, 10, 24),
            "pcx": lambda: enc.write_pcx(np.ascontiguousarray(
                rgb.transpose(0, 2, 1)), 8),
            "sgi": lambda: enc.write_sgi(rgb),
            "qoi": lambda: enc.write_qoi(rgb),
            "ico": lambda: enc.write_ico([enc.dib(bgr, 24)],
                                         [(W, H, 0, 24)])}[fmt]()
    with open(path, "wb") as f:
        f.write(data)


def run_v_decode(tmp):
    """(v2): a 1242x375 KITTI frame (the committed tests/data/jpeg frame 0
    as cv2 decodes it) as run-length TGA, PCX, run-length SGI, QOI and
    PNG, each read by ``read_rgb_pil`` (bit-equal to the frame) on the
    host: the median ms of V_DECODE_REPS reads."""
    from vido_slam_tpu_torch.io import datasets

    root = os.path.dirname(os.path.abspath(__file__))
    kitti = os.path.join(root, JPEG_FIXTURES, "kitti")
    bgr = datasets.imread(os.path.join(kitti, sorted(os.listdir(kitti))[0]))
    rgb = bgr[..., ::-1]
    ms = {}
    for fmt in ("tga", "pcx", "sgi", "qoi", "png"):
        path = os.path.join(tmp, f"v2.{fmt}")
        if fmt == "png":
            write_png(path, bgr)
        else:
            write_pil29(path, fmt, bgr)
        times = []
        for _ in range(V_DECODE_REPS):
            t1 = time.perf_counter()
            got = datasets.read_rgb_pil(path)
            times.append(time.perf_counter() - t1)
            check(np.array_equal(got, rgb), f"(v2) {fmt}: not the frame")
        ms[fmt] = 1e3 * float(np.median(times))
    return ms, bgr.shape


def write_coco_json(path, names, sizes, seed):
    """An ``instances`` json of the images ``names`` of (height, width)
    ``sizes``: three boxes each (two with polygons), drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    for i, (name, (h, w)) in enumerate(zip(names, sizes)):
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w})
        for k in range(3):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            bw, bh = rng.uniform(16, w / 2), rng.uniform(16, h / 2)
            ann = {"id": 10 * i + k + 1, "image_id": i + 1,
                   "category_id": [1, 3, 7][k], "bbox": [x, y, bw, bh],
                   "iscrowd": 0}
            if k != 2:
                ann["segmentation"] = [[x, y, x + bw, y, x + bw * 0.8,
                                        y + bh, x, y + bh * 0.7]]
            annotations.append(ann)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": f"c{c}"}
                                  for c in (1, 3, 7)]}, f)


def write_v_coco(tmp, clip):
    """(v3)'s COCO tree: bench-clip frames as TGA, PCX, SGI, QOI and ICO
    (the icon cropped to 256 wide), three boxes each (two with polygons),
    and the ``instances`` json. Returns (ann file, image root, the RGB of
    each file as written)."""
    root = os.path.join(tmp, "coco_v")
    os.makedirs(root)
    names, sizes, pixels = [], [], []
    for i, fmt in enumerate(V_FORMATS):
        bgr = np.ascontiguousarray(clip[2 * i][..., ::-1])
        if fmt == "ico":
            bgr = np.ascontiguousarray(bgr[:, :256])
        names.append(f"frame{i}.{fmt}")
        write_pil29(os.path.join(root, names[-1]), fmt, bgr)
        pixels.append(bgr[..., ::-1])
        sizes.append(bgr.shape[:2])
    ann = os.path.join(tmp, "instances_v.json")
    write_coco_json(ann, names, sizes, 29)
    return ann, root, pixels


def run_v_training(counters, tmp, clip, dev="cuda", coco=None, tag="v3"):
    """(v3): one step of ``python -m vido_slam_tpu_torch.train_maskrcnn``
    in-process on the COCO tree of ``write_v_coco`` (or ``coco``, another
    writer's (ann file, image root, file names, pixels)) (R-50-FPN at
    TRAIN_INPUT, all its images in the batch, each read by
    ``read_rgb_pil`` first and held to the pixels written): kernel 5
    forward and 5b backward twice an image; then both kernels against
    their plain versions on the step's arguments. Returns the launches and
    the max errors (kernel 5, 5b)."""
    from vido_slam_tpu_torch import train_maskrcnn
    from vido_slam_tpu_torch.io import datasets
    from vido_slam_tpu_torch.models.maskrcnn import roi_heads

    if coco is None:
        ann, root, pixels = write_v_coco(tmp, clip)
        files = [f"frame{i}.{fmt}" for i, fmt in enumerate(V_FORMATS)]
    else:
        ann, root, files, pixels = coco
    for name, want in zip(files, pixels):
        got = datasets.read_rgb_pil(os.path.join(root, name))
        check(np.array_equal(got, want), f"({tag}) {name}: not the frame")
    batch = len(files)
    h, w = TRAIN_INPUT
    argv = ["--ann-file", ann, "--image-root", root, "--batch",
            str(batch), "--input-h", str(h), "--input-w", str(w), "--lr",
            "1e-3", "--iters", "1", "--log-period", "1",
            "--checkpoint-period", "100000", "--out",
            os.path.join(tmp, f"train_{tag}")] + (
                [] if dev == "cuda" else ["--device", dev])
    lines = []
    rec = GradArgs(roi_heads.roi_align_multilevel)
    roi_heads.roi_align_multilevel = rec
    try:
        _, launches = launches_of(counters, lambda: train_maskrcnn.main(
            argv, lines.append))
    finally:
        roi_heads.roi_align_multilevel = rec.wrapper
    expect = [0, 0, 0, 0, 2 * batch, 2 * batch]
    loss = float(re.search(r"loss ([0-9.naif+-]+) ", lines[-1]).group(1))
    check(math.isfinite(loss) and (dev != "cuda" or launches == expect),
          f"({tag}) training step: loss {loss}, launches {launches}, not "
          f"{expect}")
    if dev != "cuda":
        return launches, loss, 0.0, 0.0
    cases = [(f"({tag}) image {i // 2 + 1} "
              f"{'box' if i % 2 == 0 else 'mask'} head", rec.calls[i][0],
              rec.grads[i])
             for i in range(len(rec.calls))]
    err5 = check_roi_align([(name, ([f.detach() for f in args[0]],)
                             + tuple(args[1:])) for name, args, _ in cases])
    err5b = check_roi_backward(cases, timed=False)
    return launches, loss, err5, err5b


def run_v_infer(counters, tmp, clip, dev="cuda"):
    """(v3): ``infer_nets detector`` (Mask R-CNN R-50-FPN) on a QOI of
    bench-clip frame INFER_FRAME against the same run on a PNG of the same
    pixels: kernel 5 twice on each, the detections matched. Returns the
    launches."""
    from vido_slam_tpu_torch import infer_nets

    bgr = np.ascontiguousarray(clip[INFER_FRAME][..., ::-1])
    paths = {"qoi": os.path.join(tmp, "v3.qoi"),
             "png": os.path.join(tmp, "v3.png")}
    write_pil29(paths["qoi"], "qoi", bgr)
    write_png(paths["png"], bgr)
    dets, counts, refusals = [], [], []
    for key, path in paths.items():
        out = os.path.join(tmp, f"det_v_{key}")
        argv = ["detector", "--family", "maskrcnn", "--image", path,
                "--out", out] + ([] if dev == "cuda" else ["--device", dev])

        def call():
            try:
                quiet(lambda: infer_nets.main(argv))
            except ValueError as e:      # random weights' inverted boxes
                refusals.append(str(e))
        counts.append(launches_of(counters, call)[1])
        dets.append(json_detections(os.path.join(
            out, "maskrcnn_detections.json")))
    n = max(len(x["valid"]) for x in dets)
    m = match_detections(padded(dets[0], n), padded(dets[1], n),
                         DETECTOR_THRESHOLDS["maskrcnn"])
    want = [0, 0, 0, 0, 2][:len(counters)]
    check(counts[0] == counts[1] and (dev != "cuda" or counts[0] == want)
          and not m["unexplained"] and len(refusals) in (0, 2),
          f"(v3) infer_nets on a QOI: launches {counts}, {m}, {refusals}")
    return counts[0], m


def run_phase_v(counters, tmp, dev="cuda"):
    """Phase (v): (v1) the committed fixtures of tests/data/pil29 against
    cv2's (None) and PIL's digests; (v2) a KITTI frame's decode ms as TGA,
    PCX, SGI, QOI and PNG; (v3) a detector training step on a COCO tree of
    TGA, PCX, SGI, QOI and ICO images (kernels 5 and 5b, held against
    their plain versions) and ``infer_nets detector`` on a QOI. Returns
    each part's launches, the decode ms and kernel 5's and 5b's errors."""
    from vido_slam_tpu_torch.ops import roi_align

    root = os.path.dirname(os.path.abspath(__file__))
    cards = card_line() if dev == "cuda" else "cpu"
    t0 = time.perf_counter()
    held = check_format_fixtures(root, V_FIXTURES)
    print(f"(v1) fixtures: Targa (every type and depth PIL reads, run-length "
          f"across rows, maps, orientations), PCX (1-bit planes, padded "
          f"rows, palettes), SGI (run-length at 1 and 2 bytes, shared "
          f"rows), QOI, XBM, IM (gray, palette, RGB, 16-bit, float), ICO "
          f"(BMP and PNG entries), MSP (v1, v2), and files PIL fails on: "
          f"{held} reads bit-equal to PIL's, None as cv2 (C++ and plain)")
    ms, shape = run_v_decode(tmp)
    print(f"(v2) read_rgb_pil ms a {shape[1]}x{shape[0]} frame (median of "
          f"{V_DECODE_REPS}, host): " + ", ".join(
              f"{k.upper()} {v:.2f}" for k, v in ms.items())
          + f"; card {cards}")
    clip = np.load(os.path.join(root, ONLINE_CLIP))["clip"]
    counters_v = counters + [roi_align.roi_align_multilevel_backward]
    train, loss, err5, err5b = run_v_training(counters_v, tmp, clip, dev)
    print(f"(v3) detector training step on a COCO tree of "
          f"{', '.join(f.upper() for f in V_FORMATS)} images (R-50-FPN "
          f"{TRAIN_INPUT[1]}x{TRAIN_INPUT[0]}, batch {V_BATCH}): loss "
          f"{loss:.4f}, launches {train} (kernel 5 and 5b); kernel 5 on the "
          f"step's calls max error {err5:.3e}, 5b {err5b:.3e}")
    infer, m = run_v_infer(counters, tmp, clip, dev)
    print(f"(v3) infer_nets detector on a QOI frame against a PNG of the "
          f"same pixels: {m['valid'][0]} and {m['valid'][1]} detections "
          f"matched, launches {infer}")
    secs = time.perf_counter() - t0
    print(f"phase (v): {secs:.1f} s; card {cards}")
    summarize("v", f"{held} fixture reads; decode ms " + ", ".join(
        f"{k} {v:.2f}" for k, v in ms.items()) + f"; training launches "
        f"{train}, kernel 5 err {err5:.2e}, 5b err {err5b:.2e}; infer "
        f"launches {infer}; {secs:.1f} s")
    return {"v3_train": train, "v3_infer": infer + [0]}, ms, err5, err5b


# ---------------------------------------------------------------------------
# phase 4 (w): the TIFF modes of ROADMAP.md queue 1 item 26c, part 1
# ---------------------------------------------------------------------------

W_FIXTURES = ("tiff26c",)
W_DECODE_REPS = 5
W_FORMATS = ("jpeg", "ycbcr", "cmyk", "lzma")   # (w3)'s COCO tree


def kitti_jpg(k=0):
    """The committed KITTI frame ``k`` of tests/data/jpeg (a cv2 baseline
    JPEG, 1242x375, 4:2:0): (its path, its bytes)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        JPEG_FIXTURES, "kitti")
    path = os.path.join(root, sorted(os.listdir(root))[k])
    with open(path, "rb") as f:
        return path, f.read()


def ycbcr_of(rgb):
    """JPEG's full-range YCbCr of (H, W, 3) RGB, rounded: the samples a
    YCbCr TIFF holds (libtiff converts them back by its own tables)."""
    v = rgb.astype(np.float64)
    y = 0.299 * v[..., 0] + 0.587 * v[..., 1] + 0.114 * v[..., 2]
    cb = 128 + (v[..., 2] - y) / 1.772
    cr = 128 + (v[..., 0] - y) / 1.402
    return np.clip(np.round(np.stack([y, cb, cr], -1)), 0, 255).astype(
        np.uint8)


def write_tiff26c(path, fmt, rgb):
    """An (H, W, 3) RGB frame as one of item 26c's TIFF modes, by the
    test-side writers (the card's machine has no PIL): "ycbcr" 2x2 YCbCr
    units in LZW strips of 16 rows; "cmyk" the inks 255 - R, G, B and no
    black, LZW (both libraries give the frame back); "lzma" RGB in LZMA
    strips of 64 rows; "g4" the frame's green above 127 as a T.6 mask."""
    enc = image_encoders()
    if fmt == "ycbcr":
        chunks = enc.ycbcr_chunks(ycbcr_of(rgb), (2, 2), rows_per_strip=16)
        enc.write_tiff(path, rgb, photometric=6, compression=5,
                       rows_per_strip=16, tags={530: (3, [2, 2])},
                       chunks=[enc.lzw_encode(c) for c in chunks])
    elif fmt == "cmyk":
        ink = np.concatenate([255 - rgb, np.zeros_like(rgb[..., :1])], -1)
        enc.write_tiff(path, ink, photometric=5, compression=5,
                       rows_per_strip=16)
    elif fmt == "lzma":
        enc.write_tiff(path, rgb, photometric=2, compression=34925,
                       rows_per_strip=64)
    else:
        mask = (rgb[..., 1] > 127).astype(np.uint8)
        enc.write_tiff(path, mask, bits=1, photometric=0, compression=4,
                       chunks=[enc.fax_encode(mask, 4)])


def run_w_decode(tmp):
    """(w2): the committed KITTI frame 0 (1242x375) as JPEG-in-TIFF (its
    own 4:2:0 stream), LZW YCbCr (2x2), LZW CMYK, LZMA RGB, a T.6 mask
    and PNG, each decoded on the host (``imread``, ``read_rgb_pil`` for
    LZMA, which cv2 does not read) and held to what it must give: the ms
    median of W_DECODE_REPS reads."""
    from vido_slam_tpu_torch.io import datasets, tiff

    jpg, data = kitti_jpg(0)
    bgr = datasets.imread(jpg)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    ms = {}
    for fmt in ("jpeg", "ycbcr", "cmyk", "lzma", "g4", "png"):
        path = os.path.join(tmp, f"w2_{fmt}.tif")
        if fmt == "jpeg":
            image_encoders().jpeg_to_tiff(path, data)
        elif fmt == "png":
            write_png(path, bgr)
        else:
            write_tiff26c(path, fmt, rgb)
        if fmt == "lzma":
            read = lambda: datasets.read_rgb_pil(path)  # noqa: E731
            want = rgb
        elif fmt == "g4":
            read = lambda: datasets.imread(  # noqa: E731
                path, datasets.IMREAD_GRAYSCALE)
            want = np.where(rgb[..., 1] > 127, 0, 255).astype(np.uint8)
        else:
            read = lambda: datasets.imread(path)  # noqa: E731
            want = None if fmt == "ycbcr" else bgr
        times = []
        for _ in range(W_DECODE_REPS):
            t1 = time.perf_counter()
            got = read()
            times.append(time.perf_counter() - t1)
        if want is None:
            # the YCbCr round trip: the plain codecs' read, near the frame
            with open(path, "rb") as f:
                plain = tiff.read_cv2(f.read(), 1, plain=True)
            err = np.abs(got.astype(int) - bgr).mean()
            check(np.array_equal(got, plain) and err < 8,
                  f"(w2) ycbcr: plain read differs or mean error {err:.2f}")
        else:
            check(np.array_equal(got, want), f"(w2) {fmt}: not the frame")
        ms[fmt] = 1e3 * float(np.median(times))
    return ms, bgr.shape


def run_w_cli(counters, tmp, dev="cuda", n_frames=FORMAT_FRAMES):
    """(w3): the CLI on (t2)'s KITTI configuration over the committed
    KITTI .jpg frames each moved into a JPEG-in-TIFF (under its .jpg
    name: imread tells the format by the signature), depth and masks as
    PNG, one more frame listed and missing (no StopFrame); each frame
    decoded bit-equal to its .jpg. Returns kernel 1's launches (a list as
    ``launches_of``), the camera ATE and the trajectory's length."""
    from vido_slam_tpu_torch.io import datasets

    seq = offline_sequence(n_frames, dev, KITTI_CONFIG)
    rows = demo_rows(seq, KITTI_CONFIG, dev)
    convert = image_encoders().jpeg_to_tiff

    def jpeg_tiff(path, bgr):
        k = int(os.path.basename(path)[:10])
        src, data = kitti_jpg(k)
        convert(path, data)
        check(np.array_equal(datasets.imread(path), datasets.imread(src)),
              f"(w3) {os.path.basename(path)}: not the .jpg's pixels")
    root = os.path.join(tmp, "w3_kitti")
    tree = write_tree(root, "kitti", rows, jpg=jpeg_tiff)
    with open(os.path.join(root, "times.txt"), "a") as f:
        f.write(f"{n_frames / 10.0:.6f}\n")          # its image is missing
    cfg_path = os.path.join(tmp, "w3.yaml")
    write_config(cfg_path, dict(KITTI_CONFIG, slam_mode=0, **tree))
    out = os.path.join(tmp, "w3_out", "")
    run, n, _, batches = run_demo(
        [cfg_path, "--output", out, "--device", dev], counters)
    check(not batches, f"(w3) {len(batches)} full batches")
    ate0, _, path, _ = check_demo(
        run, out, [fr.Tcw_gt for fr in seq.frames], n_frames, n,
        [2 * (n_frames - 1), 0, 0, 0, 0][:len(counters)])
    del run
    return n, ate0, path


def write_w_coco(tmp, clip):
    """(w3)'s COCO tree: the committed KITTI frame 1 as JPEG-in-TIFF and
    bench-clip frames as LZW YCbCr, LZW CMYK and LZMA RGB TIFFs, with the
    ``instances`` json. Returns (ann file, image root, file names, the RGB
    ``read_rgb_pil`` must give: the .jpg's decode, the plain codecs' cv2
    read of the YCbCr file (cv2 and PIL read it alike), held near its
    frame, the frames)."""
    from vido_slam_tpu_torch.io import datasets, tiff

    root = os.path.join(tmp, "coco_w")
    os.makedirs(root)
    names, sizes, pixels = [], [], []
    for i, fmt in enumerate(W_FORMATS):
        name = f"frame{i}.tif"
        path = os.path.join(root, name)
        if fmt == "jpeg":
            src, data = kitti_jpg(1)
            image_encoders().jpeg_to_tiff(path, data)
            rgb = np.ascontiguousarray(datasets.imread(src)[..., ::-1])
        else:
            rgb = np.ascontiguousarray(clip[2 * i])
            write_tiff26c(path, fmt, rgb)
            if fmt == "ycbcr":
                with open(path, "rb") as f:
                    rgb = tiff.read_cv2(f.read(), 1, plain=True)[..., ::-1]
                err = np.abs(rgb.astype(int) - clip[2 * i]).mean()
                check(err < 8, f"(w3) ycbcr: mean error {err:.2f}")
        names.append(name)
        sizes.append(rgb.shape[:2])
        pixels.append(rgb)
    ann = os.path.join(tmp, "instances_w.json")
    write_coco_json(ann, names, sizes, 26)
    return ann, root, names, pixels


def run_w_infer(counters, tmp, dev="cuda"):
    """(w3): ``infer_nets detector`` (Mask R-CNN R-50-FPN) on the committed
    KITTI frame 2 as JPEG-in-TIFF against the same run on a PNG of its
    pixels: kernel 5 twice on each, the detections matched. Returns the
    launches."""
    from vido_slam_tpu_torch import infer_nets
    from vido_slam_tpu_torch.io import datasets

    src, data = kitti_jpg(2)
    paths = {"tif": os.path.join(tmp, "w3.tif"),
             "png": os.path.join(tmp, "w3.png")}
    image_encoders().jpeg_to_tiff(paths["tif"], data)
    write_png(paths["png"], datasets.imread(src))
    dets, counts, refusals = [], [], []
    for key, path in paths.items():
        out = os.path.join(tmp, f"det_w_{key}")
        argv = ["detector", "--family", "maskrcnn", "--image", path,
                "--out", out] + ([] if dev == "cuda" else ["--device", dev])

        def call():
            try:
                quiet(lambda: infer_nets.main(argv))
            except ValueError as e:      # random weights' inverted boxes
                refusals.append(str(e))
        counts.append(launches_of(counters, call)[1])
        dets.append(json_detections(os.path.join(
            out, "maskrcnn_detections.json")))
    n = max(len(x["valid"]) for x in dets)
    m = match_detections(padded(dets[0], n), padded(dets[1], n),
                         DETECTOR_THRESHOLDS["maskrcnn"])
    want = [0, 0, 0, 0, 2][:len(counters)]
    check(counts[0] == counts[1] and (dev != "cuda" or counts[0] == want)
          and not m["unexplained"] and len(refusals) in (0, 2),
          f"(w3) infer_nets on a JPEG-in-TIFF: launches {counts}, {m}, "
          f"{refusals}")
    return counts[0], m


def run_phase_w(counters, tmp, dev="cuda"):
    """Phase (w): (w1) the committed fixtures of tests/data/tiff26c
    against cv2's and PIL's digests (C++ and plain codecs); (w2) a KITTI
    frame's host decode ms as JPEG-in-TIFF, LZW YCbCr, LZW CMYK, LZMA, a
    T.6 mask and PNG; (w3) the CLI on JPEG-in-TIFF KITTI frames (kernel
    1), a detector training step on a COCO tree of JPEG-in-TIFF, YCbCr,
    CMYK and LZMA TIFFs (kernels 5 and 5b, held against their plain
    versions) and ``infer_nets detector`` on a JPEG-in-TIFF (kernel 5).
    Imports ``lzma`` first: a Python without it fails here. Returns each
    part's launches, the decode ms and kernel 5's and 5b's errors."""
    import lzma

    from vido_slam_tpu_torch.ops import roi_align

    check(lzma.decompress(lzma.compress(b"26c")) == b"26c",
          "(w) the standard library's lzma")
    root = os.path.dirname(os.path.abspath(__file__))
    cards = card_line() if dev == "cuda" else "cpu"
    t0 = time.perf_counter()
    held = check_format_fixtures(root, W_FIXTURES)
    print(f"(w1) fixtures: JPEG-in-TIFF (YCbCr 1x1, 2x1, 2x2, tiles, "
          f"big-endian; RGB, gray, CMYK), YCbCr units (2x2, 2x1, 4x2 tiles, "
          f"reference black and white), CMYK (8, 16 bits, extra, InkSet 2), "
          f"CCITT (runs, T.4 1-D and 2-D, T.6, word-aligned), fill order 2, "
          f"2-/4-bit gray, 1-/2-/4-bit palettes, signed, 32-bit, 16- and "
          f"64-bit float, LZMA: {held} reads bit-equal to cv2's and PIL's "
          f"(None where they fail; C++ and plain)")
    ms, shape = run_w_decode(tmp)
    print(f"(w2) host decode ms a {shape[1]}x{shape[0]} frame (median of "
          f"{W_DECODE_REPS}): " + ", ".join(
              f"{k} {v:.2f}" for k, v in ms.items())
          + f" (LZMA by read_rgb_pil, the T.6 mask gray); card {cards}")
    cli, ate, length = run_w_cli(counters, tmp, dev)
    print(f"(w3) CLI KITTI VO on {FORMAT_FRAMES} JPEG-in-TIFF frames "
          f"(bit-equal to their .jpg): launches {cli}, camera ATE "
          f"{ate:.5f} m over {length:.3f} m")
    clip = np.load(os.path.join(root, ONLINE_CLIP))["clip"]
    counters_w = counters + [roi_align.roi_align_multilevel_backward]
    train, loss, err5, err5b = run_v_training(
        counters_w, tmp, clip, dev, coco=write_w_coco(tmp, clip), tag="w3")
    print(f"(w3) detector training step on a COCO tree of JPEG-in-TIFF, "
          f"LZW YCbCr, LZW CMYK and LZMA TIFFs (R-50-FPN "
          f"{TRAIN_INPUT[1]}x{TRAIN_INPUT[0]}, batch {len(W_FORMATS)}): "
          f"loss {loss:.4f}, launches {train} (kernel 5 and 5b); kernel 5 "
          f"on the step's calls max error {err5:.3e}, 5b {err5b:.3e}")
    infer, m = run_w_infer(counters, tmp, dev)
    print(f"(w3) infer_nets detector on a JPEG-in-TIFF frame against a PNG "
          f"of the same pixels: {m['valid'][0]} and {m['valid'][1]} "
          f"detections matched, launches {infer}")
    secs = time.perf_counter() - t0
    print(f"phase (w): {secs:.1f} s; card {cards}")
    summarize("w", f"{held} fixture reads; decode ms " + ", ".join(
        f"{k} {v:.2f}" for k, v in ms.items()) + f"; CLI launches {cli}; "
        f"training launches {train}, kernel 5 err {err5:.2e}, 5b err "
        f"{err5b:.2e}; infer launches {infer}; {secs:.1f} s")
    return ({"w3_cli": cli + [0], "w3_train": train, "w3_infer": infer + [0]},
            ms, err5, err5b)


# ---------------------------------------------------------------------------
# phase (x): lossy WebP (item 26d): a VP8 frame, its ALPH alpha, an
# animation's first frame
# ---------------------------------------------------------------------------

X_FIXTURES = ("webp26d", "webp26d_clip", "webp26d_kitti")
X_DECODE_REPS = 5
X_KITTI = os.path.join("tests", "data", "webp26d_kitti")
X_CLIP = os.path.join("tests", "data", "webp26d_clip")


def x_reference(directory):
    """The digests of cv2's and PIL's reads of a committed fixture
    directory (tests/data/<name>.npz)."""
    root = os.path.dirname(os.path.abspath(__file__))
    return np.load(os.path.join(root, directory + ".npz"))


def x_kitti(k=0):
    """The committed KITTI frame ``k`` as PIL's lossy WebP (quality 80):
    (its path, its bytes, its name)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), X_KITTI)
    name = sorted(os.listdir(root))[k]
    path = os.path.join(root, name)
    with open(path, "rb") as f:
        return path, f.read(), os.path.splitext(name)[0]


def run_x_decode(tmp):
    """(x2): the committed KITTI frame 0 (1242x375) as lossy WebP, the
    same frame with a VP8L-compressed ALPH chunk (a ramp, vertical filter;
    VP8X), as lossless WebP (of its decode) and as PNG, each read by
    ``imread`` on the host and held to what it must give (the lossy ones
    to the digest of cv2's read: alpha leaves the colour read as it is):
    the ms median of X_DECODE_REPS reads."""
    from vido_slam_tpu_torch.io import datasets

    enc = image_encoders()
    path, data, name = x_kitti(0)
    ref = x_reference(X_KITTI)
    bgr = datasets.imread(path)
    check(image_digest(bgr) == str(ref[name]), "(x2) the lossy frame")
    H, W = bgr.shape[:2]
    yy, xx = np.mgrid[:H, :W]
    alpha = ((xx // 8 + yy // 8) % 256).astype(np.uint8)
    frame = data[20:20 + int.from_bytes(data[16:20], "little")]
    files = {"lossy": path, "lossy_alpha": os.path.join(tmp, "x2a.webp"),
             "lossless": os.path.join(tmp, "x2l.webp"),
             "png": os.path.join(tmp, "x2.png")}
    with open(files["lossy_alpha"], "wb") as f:
        f.write(enc.webp_file([enc.vp8x_chunk(W, H, 0x10),
                               enc.alph_chunk(alpha, 1, 2),
                               enc.webp_chunk(b"VP8 ", frame)]))
    write_lossless_webp(files["lossless"], bgr)
    write_png(files["png"], bgr)
    ms = {}
    for key, p in files.items():
        times = []
        for _ in range(X_DECODE_REPS):
            t1 = time.perf_counter()
            got = datasets.imread(p)
            times.append(time.perf_counter() - t1)
            check(np.array_equal(got, bgr), f"(x2) {key}: not the frame")
        ms[key] = 1e3 * float(np.median(times))
    return ms, bgr.shape


def run_x_cli(counters, tmp, dev="cuda", n_frames=FORMAT_FRAMES):
    """(x3): the CLI on (t2)'s KITTI configuration over the committed
    lossy WebP KITTI frames (under their .jpg names: imread tells the
    format by the signature), depth and masks as PNG, one more frame
    listed and missing (no StopFrame); each frame held to the digest of
    cv2's read. Returns kernel 1's launches, the camera ATE and the
    trajectory's length."""
    from vido_slam_tpu_torch.io import datasets

    seq = offline_sequence(n_frames, dev, KITTI_CONFIG)
    rows = demo_rows(seq, KITTI_CONFIG, dev)
    ref = x_reference(X_KITTI)

    def lossy(path, bgr):
        _, data, name = x_kitti(int(os.path.basename(path)[:10]))
        with open(path, "wb") as f:
            f.write(data)
        check(image_digest(datasets.imread(path)) == str(ref[name]),
              f"(x3) {os.path.basename(path)}: not cv2's read")
    root = os.path.join(tmp, "x3_kitti")
    tree = write_tree(root, "kitti", rows, jpg=lossy)
    with open(os.path.join(root, "times.txt"), "a") as f:
        f.write(f"{n_frames / 10.0:.6f}\n")         # its image is missing
    cfg_path = os.path.join(tmp, "x3.yaml")
    write_config(cfg_path, dict(KITTI_CONFIG, slam_mode=0, **tree))
    out = os.path.join(tmp, "x3_out", "")
    run, n, _, batches = run_demo(
        [cfg_path, "--output", out, "--device", dev], counters)
    check(not batches, f"(x3) {len(batches)} full batches")
    ate0, _, path, _ = check_demo(
        run, out, [fr.Tcw_gt for fr in seq.frames], n_frames, n,
        [2 * (n_frames - 1), 0, 0, 0, 0][:len(counters)])
    del run
    return n, ate0, path


def write_x_coco(tmp):
    """(x3)'s COCO tree: the five committed bench-clip lossy WebPs (PIL's,
    two with VP8L alpha, an animation; cv2's), with the ``instances``
    json; each read by ``read_rgb_pil`` and held to the digest of PIL's
    read. Returns (ann file, image root, file names, the RGB reads)."""
    from vido_slam_tpu_torch.io import datasets

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), X_CLIP)
    ref = x_reference(X_CLIP)
    root = os.path.join(tmp, "coco_x")
    os.makedirs(root)
    names, sizes, pixels = [], [], []
    for name in sorted(os.listdir(src)):
        with open(os.path.join(src, name), "rb") as f:
            data = f.read()
        with open(os.path.join(root, name), "wb") as f:
            f.write(data)
        rgb = datasets.read_rgb_pil(os.path.join(root, name))
        check(image_digest(rgb) == str(ref[os.path.splitext(name)[0]
                                           + "_pil"]),
              f"(x3) {name}: not PIL's read")
        names.append(name)
        sizes.append(rgb.shape[:2])
        pixels.append(rgb)
    ann = os.path.join(tmp, "instances_x.json")
    write_coco_json(ann, names, sizes, 23)
    return ann, root, names, pixels


def run_x_flow(counters, tmp, dev="cuda"):
    """(x3): ``infer_nets flow`` on the committed lossy WebP KITTI frames 0
    and 1 against the same run on PNGs of their pixels: kernels 3 and 4
    five times each on both, the flows within FLOW_BAR of max(|flow|, 1).
    Returns the launches and the flows' gap."""
    from vido_slam_tpu_torch import infer_nets
    from vido_slam_tpu_torch.io import datasets
    from vido_slam_tpu_torch.io.datasets import read_flo

    d = os.path.join(tmp, "x3_flow")
    os.makedirs(d)
    inputs = {}
    for k in (0, 1):
        inputs[f"webp{k}"], _, _ = x_kitti(k)
        inputs[f"png{k}"] = os.path.join(d, f"pair{k}.png")
        write_png(inputs[f"png{k}"], datasets.imread(inputs[f"webp{k}"]))
    counts, flows = [], []
    for key in ("webp", "png"):
        out = os.path.join(d, key)
        argv = ["flow", "--first", inputs[f"{key}0"], "--second",
                inputs[f"{key}1"], "--out", out] + (
                    [] if dev == "cuda" else ["--device", dev])
        counts.append(launches_of(counters, lambda: quiet(
            lambda: infer_nets.main(argv)))[1])
        flows.append(read_flo(os.path.join(out, "flow.flo")))
    gap = float(np.abs(flows[0] - flows[1]).max()) / max(
        1.0, float(np.abs(flows[1]).max()))
    want = [0, 0, 5, 5, 0][:len(counters)]
    check(counts[0] == counts[1] and (dev != "cuda" or counts[0] == want)
          and flows[0].shape == (375, 1242, 2) and gap <= FLOW_BAR,
          f"(x3) flow on a lossy WebP pair: launches {counts}, gap {gap}")
    return counts[0], gap


def run_phase_x(counters, tmp, dev="cuda"):
    """Phase (x): (x1) the committed fixtures of tests/data/webp26d,
    webp26d_clip and webp26d_kitti against cv2's and PIL's digests (the
    plain decoders too on webp26d); (x2) a KITTI frame's host decode ms as
    lossy WebP, lossy WebP with VP8L alpha, lossless WebP and PNG; (x3)
    the CLI on lossy WebP KITTI frames (kernel 1), a detector training
    step on a COCO tree of lossy WebPs (kernels 5 and 5b, held against
    their plain versions) and ``infer_nets flow`` on a lossy WebP pair
    (kernels 3 and 4). Returns each part's launches, the decode ms and
    kernel 5's and 5b's errors."""
    from vido_slam_tpu_torch.ops import roi_align

    root = os.path.dirname(os.path.abspath(__file__))
    cards = card_line() if dev == "cuda" else "cpu"
    t0 = time.perf_counter()
    held = check_format_fixtures(root, X_FIXTURES)
    print(f"(x1) fixtures: PIL's and cv2's lossy files (qualities, methods, "
          f"raw, VP8L and level-reduced alpha, an animation), ALPH filters "
          f"raw and VP8L, a frame at an offset on an animation's canvas, "
          f"random-syntax VP8 frames (segments, filter deltas, the simple "
          f"filter, 2/4/8 partitions, quantisers 0 and 127, category 6, "
          f"every mode), a cut partition and a bad ALPH header, 5 "
          f"bench-clip and 12 KITTI frames: {held} reads bit-equal to "
          f"cv2's and PIL's (None where they fail; C++ and plain)")
    ms, shape = run_x_decode(tmp)
    print(f"(x2) host decode ms a {shape[1]}x{shape[0]} frame (median of "
          f"{X_DECODE_REPS}): " + ", ".join(
              f"{k} {v:.2f}" for k, v in ms.items()) + f"; card {cards}")
    cli, ate, length = run_x_cli(counters, tmp, dev)
    print(f"(x3) CLI KITTI VO on {FORMAT_FRAMES} lossy WebP frames (each "
          f"cv2's read): launches {cli}, camera ATE {ate:.5f} m over "
          f"{length:.3f} m")
    clip = np.load(os.path.join(root, ONLINE_CLIP))["clip"]
    counters_x = counters + [roi_align.roi_align_multilevel_backward]
    train, loss, err5, err5b = run_v_training(
        counters_x, tmp, clip, dev, coco=write_x_coco(tmp), tag="x3")
    print(f"(x3) detector training step on a COCO tree of lossy WebPs "
          f"(R-50-FPN {TRAIN_INPUT[1]}x{TRAIN_INPUT[0]}, batch 5, two with "
          f"alpha, one an animation): loss {loss:.4f}, launches {train} "
          f"(kernel 5 and 5b); kernel 5 on the step's calls max error "
          f"{err5:.3e}, 5b {err5b:.3e}")
    flow, gap = run_x_flow(counters, tmp, dev)
    print(f"(x3) infer_nets flow on a lossy WebP pair against PNGs of the "
          f"same pixels: {gap:.2e} of max(|flow|, 1) (bar {FLOW_BAR:.0e}), "
          f"launches {flow}")
    secs = time.perf_counter() - t0
    print(f"phase (x): {secs:.1f} s; card {cards}")
    summarize("x", f"{held} fixture reads; decode ms " + ", ".join(
        f"{k} {v:.2f}" for k, v in ms.items()) + f"; CLI launches {cli}; "
        f"training launches {train}, kernel 5 err {err5:.2e}, 5b err "
        f"{err5b:.2e}; flow launches {flow}; {secs:.1f} s")
    return ({"x3_cli": cli + [0], "x3_train": train, "x3_flow": flow + [0]},
            ms, err5, err5b)


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
# phase 4 (n): training (ROADMAP.md items 19b and 20)
# ---------------------------------------------------------------------------

TRAIN_ITERS = 6
TRAIN_INPUT = (544, 800)     # (height, width): the JAX CLI's default input
TRAIN_CHECK = (128, 160)     # the card-against-CPU detector step
DEPTH_STEPS = 5
DEPTH_BATCH = 4
# (n3)'s bars on each key's gradient, card against CPU, over the key's
# max |g|. A step takes discrete decisions on rounded values: the RPN's
# top-k and NMS order proposals by score, the stem's max pool picks a
# winner, each relu a side. Where two candidates lie a few ulps apart the
# card's float32 sums can order them otherwise than the CPU's, and one
# such decision moves the gradient by far more than its rounding: at
# TRAIN_CHECK the card swaps two proposals whose scores are 2 ulps apart
# and one max-pool winner, 4.5e-3 of a key's max (StepTape replays the
# CPU's decisions and finds them). So the card's own step is held within
# GRAD_BAR_CARD, and the step with all the CPU's decisions within the CPU
# tests' GRAD_BAR.
GRAD_BAR_CARD = 1e-2
GRAD_BAR = 1e-3


class GradArgs(KernelArgs):
    """A ``KernelArgs`` that also keeps the gradient that reaches each
    recorded call's output in the backward pass (kernel 5b's grad_out)."""

    def __init__(self, wrapper, n_args=6):
        super().__init__(wrapper, n_args)
        self.grads = {}

    def __call__(self, *args, **kw):
        out = super().__call__(*args, **kw)
        if self.on and out.requires_grad:
            i = len(self.calls) - 1
            out.register_hook(
                lambda g, i=i: self.grads.__setitem__(i, g.clone()))
        return out


def roi_grads_plain(args, g):
    """The plain gradient of kernel 5's output ``g`` with respect to the
    features: the autograd of roi_align_multilevel_ref on the same
    tensors."""
    import torch
    from vido_slam_tpu_torch.ops import roi_align

    feats, rois, levels, scales, r, s = args
    fs = [f.detach().clone().requires_grad_() for f in feats]
    with torch.enable_grad():
        out = roi_align.roi_align_multilevel_ref(fs, rois, levels, scales, r,
                                                 s)
        return torch.autograd.grad(out, fs, g, allow_unused=True,
                                   materialize_grads=True)


def check_roi_backward(cases, timed=True):
    """Kernel 5b against the autograd of kernel 5's plain version on each
    (name, forward args, grad_out) case: the plain gradient is not all
    zero and the max error <= 1e-5 max |plain gradient| (atomics add in a
    run-to-run order: a bar, not the bits; measured against the gradient
    itself, so a trainer's small gradients are held as tightly as random
    ones). Returns max_abs_err and, when ``timed``, (ms, plain_ms,
    bound_ms, bound_by) with the kernel timed as a CUDA-graph replay of 20
    calls and the plain version by events over 3."""
    import torch
    from vido_slam_tpu_torch.ops import roi_align

    err = ms = plain_ms = 0.0
    nbytes = flops = 0
    for name, args, g in cases:
        feats, rois, levels, scales, r, s = args
        shapes = roi_align.level_sizes(feats)
        lv = levels.to(torch.int32).contiguous()

        def kernel():
            return roi_align.roi_align_multilevel_backward(
                g, shapes, rois, lv, scales, r, s)
        got = kernel()
        ref = roi_grads_plain(args, g)
        torch.cuda.synchronize()
        e = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        gmax = max(float(b.abs().max()) for b in ref)
        check(gmax > 0 and math.isfinite(e) and e <= 1e-5 * gmax,
              ("roi_align_multilevel_backward", name, e, gmax))
        err = max(err, e)
        line = (f"roi_align_multilevel_backward {name}: max error {e:.3e} "
                f"(bar {1e-5 * gmax:.1e}: {e / gmax:.2e} of the gradient's "
                f"max {gmax:.3e})")
        if not timed:
            print(line)
            continue
        k_ms = time_cuda_graph(kernel, 20)
        p_ms = time_cuda(lambda: roi_grads_plain(args, g), 3)
        R, C = rois.shape[0], feats[0].shape[1]
        b_ = roi_align.backward_nbytes(shapes, R, C, r)
        f_ = roi_align.backward_operations(R, C, r, s)
        print(f"{line}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, {b_} "
              f"bytes, {f_} flops")
        ms += k_ms
        plain_ms += p_ms
        nbytes += b_
        flops += f_
    if not timed:
        return err
    return err, (ms, plain_ms) + bound(nbytes, flops)


def train_detector_cli(out_dir, counters, names):
    """(n1): ``python -m vido_slam_tpu_torch.train_maskrcnn`` in-process on
    the card: R-50-FPN, --synthetic, batch 2, TRAIN_INPUT, lr 1e-3,
    TRAIN_ITERS iterations, a log line each; kernel 5 forward and 5b
    backward twice an image a step. Returns (final state, log lines, the
    host seconds of each iteration, launches)."""
    from vido_slam_tpu_torch import train_maskrcnn

    h, w = TRAIN_INPUT
    lines, stamps = [], []

    def log(line):
        stamps.append(time.perf_counter())
        lines.append(line)
        print(f"  {line}")

    argv = ["--synthetic", "--batch", "2", "--input-h", str(h), "--input-w",
            str(w), "--lr", "1e-3", "--iters", str(TRAIN_ITERS),
            "--log-period", "1", "--checkpoint-period", "100000", "--out",
            out_dir]
    t0 = time.perf_counter()
    final, launches = launches_of(counters,
                                  lambda: train_maskrcnn.main(argv, log))
    expect = [0, 0, 0, 0, 2 * 2 * TRAIN_ITERS, 2 * 2 * TRAIN_ITERS]
    check(launches == expect,
          f"(n1) detector training: {names} launched {launches} times over "
          f"{TRAIN_ITERS} steps of 2 images, not {expect}")
    check(len(lines) == TRAIN_ITERS, f"(n1) {len(lines)} log lines")
    secs = np.diff([t0] + stamps)
    return final, lines, secs, launches


class StepTape:
    """One detector step's discrete decisions, recorded or replayed: the
    proposals ``select_over_all_levels`` keeps, the side of zero each
    relu's input takes (its gradient mask: 1 above, 1/2 at, 0 below) and
    the input that wins each window of the stem's max pool. A step that
    replays another's tape (``replay``) takes that step's proposals
    (``proposals=True``), and with ``units=True`` computes each relu as
    ``x * mask`` and each max-pool window as its taped winner: the same
    values wherever both steps decide alike, the taped step's gradient
    where this step's rounding falls the other way. Every step's tape also
    keeps its own decisions, FPN levels and the gradient that reaches each
    ROIAlign call's output."""

    def __init__(self, replay=None, proposals=False, units=False):
        self.replay = replay
        self.use_proposals = proposals
        self.use_units = units
        self.masks, self.sites, self.winners = [], [], []
        self.proposals, self.levels = [], []
        self.pooled_grads = {}

    def relu(self, x):
        import torch
        from vido_slam_tpu_torch.models.layers import relu

        f = sys._getframe(1)
        self.sites.append(f"{os.path.basename(f.f_code.co_filename)}:"
                          f"{f.f_lineno}")
        # twice the mask, in a byte
        self.masks.append((2 * (x > 0) + (x == 0)).to(torch.uint8).cpu())
        if self.replay is None or not self.use_units:
            return relu(x)
        m = self.replay.masks[len(self.masks) - 1].to(x.device, x.dtype)
        return x * (0.5 * m)

    def max_pool(self, x, k, stride, padding):
        import torch.nn.functional as F

        out, idx = F.max_pool2d(x, k, stride, padding, return_indices=True)
        self.winners.append(idx.cpu())
        if self.replay is None or not self.use_units:
            return out
        idx = self.replay.winners[len(self.winners) - 1].to(x.device)
        return x.flatten(2).gather(2, idx.flatten(2)).view_as(out)

    def patch(self):
        """Installs the tape in the detector's modules; returns the undo."""
        from vido_slam_tpu_torch.models.maskrcnn import (backbone, losses,
                                                         roi_heads, rpn)

        saved = [(m, "relu", m.relu) for m in (backbone, rpn, roi_heads,
                                               losses)]
        saved += [(backbone, "max_pool", backbone.max_pool),
                  (losses, "select_over_all_levels",
                   losses.select_over_all_levels),
                  (roi_heads, "roi_align_multilevel",
                   roi_heads.roi_align_multilevel)]
        select, pool = saved[-2][2], saved[-1][2]

        def taped_select(*args):
            out = select(*args)
            if self.replay is not None and self.use_proposals:
                out = tuple(t.to(out[0].device)
                            for t in self.replay.proposals[len(self.proposals)])
            self.proposals.append(tuple(t.detach().cpu() for t in out))
            return out

        def taped_pool(feats, rois, levels, *args):
            out = pool(feats, rois, levels, *args)
            i = len(self.levels)
            self.levels.append(levels.cpu())
            if out.requires_grad:
                out.register_hook(lambda g: self.pooled_grads.__setitem__(
                    i, g.detach().cpu()))
            return out

        for m, name, _ in saved[:4]:
            setattr(m, name, self.relu)
        backbone.max_pool = self.max_pool
        losses.select_over_all_levels = taped_select
        roi_heads.roi_align_multilevel = taped_pool

        def undo():
            for m, name, fn in saved:
                setattr(m, name, fn)
        return undo


def detector_step(where, cfg, image, boxes, masks, tape):
    """One detector step of ``check_detector_step`` on ``where`` with the
    tape installed: (loss parts, each key's gradient on the CPU)."""
    import torch
    from vido_slam_tpu_torch.models.maskrcnn import losses
    from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNN
    from vido_slam_tpu_torch.parallel.train import (compute_grads,
                                                    trainable_state)
    from vido_slam_tpu_torch.utils import prng

    G = boxes.shape[0]
    model = MaskRCNN(cfg, seed=0, device=where)
    state = trainable_state(model)
    tg = losses.DetectionTargets(
        boxes=torch.tensor(boxes, device=where),
        labels=torch.tensor([3, 7] + [0] * (G - 2), device=where),
        masks=torch.tensor(masks, device=where),
        valid=torch.arange(G, device=where) < 2)
    undo = tape.patch()
    try:
        parts = losses.maskrcnn_loss(model, torch.tensor(image, device=where),
                                     tg, prng.PRNGKey(5, device=where))
        compute_grads(sum(parts.values()), state)
    finally:
        undo()
    return ({k: float(v.detach()) for k, v in parts.items()},
            {k: v.grad.cpu() for k, v in state.items()})


def step_gaps(ref, run):
    """(the loss parts' largest relative difference, each key's gradient
    difference over its max |g|) of a step against the reference step."""
    (p0, g0), (p1, g1) = ref, run
    parts = max(abs(p1[k] - p0[k]) / max(abs(p0[k]), 1e-3) for k in p0)
    grads = {k: float((g1[k] - g0[k]).abs().max())
             / max(float(g0[k].abs().max()), 1e-30) for k in g0}
    return parts, grads


def tape_differences(cpu, card):
    """Text: where a card step decides otherwise than the CPU's: relu
    inputs on the other side of zero by call site, max-pool windows won by
    another input, proposals that are not the CPU's (by more than 1e-3 px
    or in validity; the first four with their scores, and the CPU's
    nearest row to the card's box), ROIs at another FPN level by ROIAlign
    call, and each ROIAlign call's output gradient apart over its max."""
    import collections

    flips = collections.Counter()
    for site, a, b in zip(cpu.sites, cpu.masks, card.masks):
        n = int((a != b).sum())
        if n:
            flips[site] += n
    winners = sum(int((a != b).sum()) for a, b in zip(cpu.winners,
                                                      card.winners))
    (bc, sc, vc), (bd, sd, vd) = cpu.proposals[0], card.proposals[0]
    rows = ((bc - bd).abs().amax(1) > 1e-3) | (vc != vd)
    moved = []
    for i in rows.nonzero()[:4, 0].tolist():
        j = int((bc - bd[i]).abs().amax(1).argmin())
        moved.append(f"row {i}: CPU {bc[i].tolist()} score {float(sc[i]):.9g}"
                     f", card {bd[i].tolist()} score {float(sd[i]):.9g} (the "
                     f"CPU's row {j})")
    levels = [int((a != b).sum()) for a, b in zip(cpu.levels, card.levels)]
    pooled = [float((card.pooled_grads[i] - g).abs().max())
              / max(float(g.abs().max()), 1e-30)
              for i, g in sorted(cpu.pooled_grads.items())]
    return (f"relu inputs on the other side of 0 by site {dict(flips)} (of "
            f"{sum(int(m.numel()) for m in cpu.masks)} over "
            f"{len(cpu.masks)} calls), {winners} max-pool windows won by "
            f"another input, {int(rows.sum())} of {bc.shape[0]} proposals "
            f"not the CPU's {moved}, ROIs at another FPN level {levels} "
            f"(box, mask head), the pooled features' gradient apart by "
            + ", ".join(f"{x:.2e}" for x in pooled)
            + " of its max (box, mask head)")


def check_detector_step(dev):
    """(n3): one detector step at TRAIN_CHECK (the CPU tests' one block a
    stage, two objects, a 0..1 image) on the CPU and three times on the
    card (``StepTape``): with its own decisions, with the CPU's proposals,
    and with all of the CPU's decisions (proposals, relu sides, max-pool
    winners). Prints where each card step decides otherwise and its gaps.
    Checks: every step's loss parts within 1e-4 relative of the CPU's
    (the CPU tests' bar); with all of the CPU's decisions each key's
    gradient within the CPU tests' 1e-3 of its max |g|, with its own
    within GRAD_BAR_CARD. Returns (the loss parts' largest relative gap,
    each step's largest gradient gap)."""
    from vido_slam_tpu_torch.models.maskrcnn.backbone import ResNetConfig
    from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNNConfig

    h, w = TRAIN_CHECK
    cfg = MaskRCNNConfig(resnet=ResNetConfig(stage_blocks=(1, 1, 1, 1)),
                         input_h=h, input_w=w)
    G = 6
    boxes = np.zeros((G, 4), np.float32)
    boxes[0] = [30, 30, 80, 90]
    boxes[1] = [100, 20, 140, 60]
    masks = np.zeros((G, h // 2, w // 2), np.float32)
    masks[0, 15:45, 15:40] = 1.0
    masks[1, 10:30, 50:70] = 1.0
    image = np.random.RandomState(1).uniform(0, 1, (1, 3, h, w)).astype(
        np.float32)
    cpu_tape = StepTape()
    ref = detector_step("cpu", cfg, image, boxes, masks, cpu_tape)
    gaps = {}
    for name, kw in (("own", {}), ("the CPU's proposals",
                                   dict(proposals=True)),
                     ("all the CPU's", dict(proposals=True, units=True))):
        tape = StepTape(cpu_tape, **kw)
        run = detector_step(dev, cfg, image, boxes, masks, tape)
        e_parts, rel = step_gaps(ref, run)
        worst = sorted(rel, key=rel.get, reverse=True)[:3]
        gaps[name] = (e_parts, rel[worst[0]])
        print(f"(n3) card with {name} decisions: "
              + tape_differences(cpu_tape, tape)
              + f"; loss parts {e_parts:.2e} relative to the CPU's ("
              + ", ".join(f"{k} {run[0][k]:.7f}/{ref[0][k]:.7f}"
                          for k in ref[0])
              + "); gradients " + ", ".join(
                  f"{k} {rel[k]:.2e} (max |g| "
                  f"{float(ref[1][k].abs().max()):.3e})" for k in worst))
    for name, (e_parts, _) in gaps.items():
        check(e_parts <= 1e-4, f"(n3) loss parts with {name} decisions: "
              f"{e_parts:.2e} relative")
    same = gaps["all the CPU's"][1]
    check(same <= GRAD_BAR, f"(n3) gradients with all the CPU's decisions: "
          f"{same:.2e} of a key's max |g|")
    check(gaps["own"][1] <= GRAD_BAR_CARD, f"(n3) gradients with the card's "
          f"own decisions: {gaps['own'][1]:.2e} of a key's max |g|")
    return max(e for e, _ in gaps.values()), {k: g for k, (_, g) in
                                               gaps.items()}


def depth_batches(dev):
    """(n4)'s self-supervised batch: DEPTH_BATCH samples of three
    consecutive frames (prev, centre, next) of the bench clip at 640x192,
    RGB in [0, 1], with MonoDepth2's KITTI intrinsics (trainer.py's K)
    scaled to the frame."""
    import torch
    from vido_slam_tpu_torch.models.monodepth2_train import SelfSupBatch

    clip = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ONLINE_CLIP))["clip"]
    rgb = clip[..., ::-1].astype(np.float32) / 255.0
    H, W = rgb.shape[1:3]
    K = np.array([[0.58 * W, 0, 0.5 * W, 0], [0, 1.92 * H, 0.5 * H, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)

    def frames(offset):
        x = rgb[offset:offset + DEPTH_BATCH].transpose(0, 3, 1, 2)
        return torch.tensor(np.ascontiguousarray(x), device=dev)
    Ks = torch.tensor(np.broadcast_to(K, (DEPTH_BATCH, 4, 4)).copy(),
                      device=dev)
    return SelfSupBatch(color=frames(1), prev=frames(0), next=frames(2),
                        K=Ks, inv_K=torch.linalg.inv(Ks))


def train_depth(dev, counters, names):
    """(n4): ``make_selfsup_train_step`` at 640x192, batch DEPTH_BATCH,
    DEPTH_STEPS Adam steps (finite losses; the first step's loss within
    1e-4 relative of the port's on the CPU), then one supervised
    ``make_train_step``. Returns (losses, the steady steps' seconds, the
    first loss's relative error against the CPU, the supervised loss)."""
    import torch
    from vido_slam_tpu_torch.models.monodepth2 import MonoDepth2
    from vido_slam_tpu_torch.models.monodepth2_train import (
        SelfSupModel, make_selfsup_train_step, selfsup_loss)
    from vido_slam_tpu_torch.parallel.train import (init_train_state,
                                                    make_train_step)
    from vido_slam_tpu_torch.utils import prng

    batch = depth_batches(dev)
    with torch.no_grad():
        cpu_loss, _ = selfsup_loss(
            SelfSupModel(seed=0, device="cpu"),
            type(batch)(*(x.cpu() if x is not None else None
                          for x in batch)), prng.PRNGKey(0))
    model = SelfSupModel(seed=0, device=dev)
    step = make_selfsup_train_step(model, lr=1e-4)
    losses, secs = [], []
    key = prng.PRNGKey(0, device=dev)

    def run():
        for i in range(DEPTH_STEPS):
            k = key if i == 0 else prng.fold_in(key, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(batch, k)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    _, launches = launches_of(counters, run)
    check(launches == [0] * len(counters),
          f"(n4) depth training: {names} launched {launches} times")
    rel = abs(losses[0] - float(cpu_loss)) / abs(float(cpu_loss))
    check(all(math.isfinite(x) for x in losses) and rel <= 1e-4,
          f"(n4) self-supervised losses {losses}, first against the CPU's "
          f"{float(cpu_loss):.7f}: {rel:.2e} relative")
    net = MonoDepth2(seed=0, device=dev)
    state = init_train_state(net, lr=1e-4)
    target = 1.0 / torch.linspace(2.0, 80.0, 192, device=dev)[:, None] \
        .expand(DEPTH_BATCH, 192, 640)
    state, sup = make_train_step()(state, {"image": batch.color,
                                           "target": target})
    check(state.step == 1 and math.isfinite(float(sup)),
          f"(n4) supervised step: loss {float(sup)}")
    return losses, secs[1:], rel, float(sup)


def run_phase_n(dev, counters, names):
    """Phase (n), training: (n1) the detector CLI at full width, (n2)
    kernels 5 and 5b against their plain versions on one step's arguments
    and 5b at phase (d)'s inference shapes, (n3) a detector step card
    against CPU, (n4) MonoDepth2's self-supervised and supervised steps.
    Returns (kernel 5's and 5b's launches in (n1), 5b's max error, 5b's
    timing on the step, 5b's timing at the inference shapes, kernel 5's
    timing and max error on the step)."""
    import torch
    from vido_slam_tpu_torch import convert
    from vido_slam_tpu_torch.models.maskrcnn import roi_heads
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           MaskRCNNConfig)
    from vido_slam_tpu_torch.utils.checkpoint import load_params

    t0 = time.perf_counter()
    card = card_line()
    rec = GradArgs(roi_heads.roi_align_multilevel)
    roi_heads.roi_align_multilevel = rec
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            final, lines, secs, launches = train_detector_cli(
                out_dir, counters, names)
            saved = load_params(os.path.join(out_dir, "model_final"))
    finally:
        roi_heads.roi_align_multilevel = rec.wrapper
    loss_re = re.compile(r"loss ([0-9.naif+-]+) ")
    train_losses = [float(loss_re.search(x).group(1)) for x in lines]
    check(all(math.isfinite(x) for x in train_losses),
          f"(n1) losses {train_losses}")
    h, w = TRAIN_INPUT
    reloaded = MaskRCNN(MaskRCNNConfig(input_h=h, input_w=w), device=dev)
    reloaded.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
        {k: v.numpy() for k, v in saved.items()}, device=dev), strict=True)
    same = all(torch.equal(reloaded.state_dict()[k].cpu(), v.cpu())
               for k, v in final.items())
    check(same, "(n1) model_final reloads into the detector bit-equal")
    s_it = float(np.median(secs[1:]))
    print(f"(n1) detector training, R-50-FPN {w}x{h}, synthetic batch 2, lr "
          f"1e-3: losses {train_losses}, launches {launches} (kernel 5 and "
          f"5b), s/it median {s_it:.3f} over iterations 2-{TRAIN_ITERS} "
          f"(first {secs[0]:.2f} s; host clock between log lines), "
          f"model_final reloads bit-equal; card {card}")
    # (n2) kernel 5b on the last step's four calls (two images, box and
    # mask heads), then at phase (d)'s inference shapes
    n = len(rec.calls)
    step_cases = [(f"training step {TRAIN_ITERS} image {1 + (i - n + 4) // 2}"
                   f" {'box' if i % 2 == 0 else 'mask'} head",
                   rec.calls[i][0], rec.grads[i]) for i in range(n - 4, n)]
    del rec
    fwd_cases = [(name, ([f.detach() for f in args[0]],) + tuple(args[1:]))
                 for name, args, _ in step_cases]
    err_fwd = check_roi_align(fwd_cases)
    fwd_ms = time_roi_align(fwd_cases)
    err, step_timing = check_roi_backward(step_cases)
    # the trainer's grad_out is zero outside the sampled ROIs and small:
    # the same calls again with a grad_out of N(0, 1) on every element
    gen = torch.Generator(device=dev).manual_seed(7)
    err = max(err, check_roi_backward(
        [(f"{name}, grad_out N(0, 1)", args,
          torch.randn(g.shape, generator=gen, device=dev))
         for name, args, g in step_cases], timed=False))
    rng = np.random.RandomState(7)
    infer_cases = []
    for name, args in roi_cases(rng, dev):
        R, C, r = args[1].shape[0], args[0][0].shape[1], args[4]
        infer_cases.append((name, args,
                            torch.randn(R, C, r, r, device=dev)))
    e2, infer_timing = check_roi_backward(infer_cases)
    err = max(err, e2)
    share = (fwd_ms[0] + step_timing[0]) / 2 / (1e3 * s_it)
    print(f"(n2) kernel 5b on a step's four calls: {step_timing[0]:.4f} ms "
          f"(plain {step_timing[1]:.3f} ms, bound {step_timing[2]:.6f} ms "
          f"by {step_timing[3]}), kernel 5 on the same calls "
          f"{fwd_ms[0]:.4f} ms; kernels 5 and 5b per image a step "
          f"{(fwd_ms[0] + step_timing[0]) / 2:.4f} ms, "
          f"{100 * 2 * share:.3f} % of a {1e3 * s_it:.1f} ms step; at "
          f"(d)'s inference shapes {infer_timing[0]:.4f} ms (bound "
          f"{infer_timing[2]:.6f} ms)")
    # (n3) one detector step, card against CPU
    e_parts, e_grads = check_detector_step(dev)
    print(f"(n3) detector step {TRAIN_CHECK[1]}x{TRAIN_CHECK[0]} card against "
          f"CPU: loss parts {e_parts:.2e} relative (bar 1e-4), gradients "
          f"over a key's max |g|: " + ", ".join(
              f"{k} decisions {g:.2e}" for k, g in e_grads.items())
          + f" (bars {GRAD_BAR_CARD:.0e} on the card's own, {GRAD_BAR:.0e} "
          f"on the CPU's)")
    # (n4) MonoDepth2
    d_losses, d_secs, rel, sup = train_depth(dev, counters, names)
    print(f"(n4) MonoDepth2 self-supervised, 640x192 batch {DEPTH_BATCH}, "
          f"{DEPTH_STEPS} Adam steps: losses {d_losses}, first against the "
          f"CPU {rel:.2e} relative, s/it median {np.median(d_secs):.3f} "
          f"(steps 2-{DEPTH_STEPS}, host clock over torch.cuda.synchronize);"
          f" supervised step loss {sup:.6f}; card {card}")
    print(f"phase (n): {time.perf_counter() - t0:.1f} s")
    return launches, err, step_timing, infer_timing, fwd_ms, err_fwd


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


# ---------------------------------------------------------------------------
# phase (o): the depth data pipeline and the single-device evaluation paths
# ---------------------------------------------------------------------------

MONO_SIZE = (192, 640)   # (height, width): MonoDepth2's training input
MONO_BATCH = 4
MONO_STEPS = 3
# the JAX defaults of multi_sequence_tracking (parallel/slam_eval.py:143)
MULTI_KW = dict(n_bg=800, n_obj=500, max_objects=4, ba_points=400,
                ba_iters=5)
WINDOW_PROBLEMS = 8
WINDOW_SHAPE = (20, 1000)   # (W, P): the tracker's window and BA points
EVAL_FRAMES = 4
# (o4)'s class 3 bias: scores of 0.97-0.98, none equal. At MASK_LIFT every
# score is exactly 1.0, so the box head's NMS keeps boxes in proposal order,
# and ulps in the RPN's scores reorder it: on the CPU alone a 1e-6 relative
# change of the input takes AP50 against the unchanged run to 0.88, and
# to 1.0 at this lift
EVAL_LIFT = 8.0


def host_timed(fn, dev="cuda"):
    """(fn(), host seconds), ending in torch.cuda.synchronize on a card."""
    import torch

    card = torch.device(dev).type == "cuda"
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if card:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_batch(a, b) -> bool:
    """Every field of two SelfSupBatches equal to the bit (None alike)."""
    import torch

    return all(x is y if x is None or y is None
               else torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def run_depth_pipeline(dev, counters, names, tmp, mono_size=MONO_SIZE):
    """(o1): one epoch of MonoSequenceDataset batches over the KITTI JPEGs
    and over the bench clip as PNGs, on ``dev``, the first batch again on
    the CPU; then MONO_STEPS self-supervised steps on the KITTI batches.
    Returns the launches of the steps."""
    import torch
    from vido_slam_tpu_torch.data import mono_dataset
    from vido_slam_tpu_torch.models.monodepth2_train import (
        SelfSupModel, make_selfsup_train_step)
    from vido_slam_tpu_torch.utils import prng

    root = os.path.dirname(os.path.abspath(__file__))
    clip = np.load(os.path.join(root, ONLINE_CLIP))["clip"]
    png_dir = os.path.join(tmp, "clip_png")
    os.makedirs(png_dir)
    for k, frame in enumerate(clip):
        write_png(os.path.join(png_dir, f"{k:06d}.png"),
                  np.repeat(np.repeat(frame, 2, 0), 2, 1), level=1)
    sources = {
        "KITTI JPEG 1242x375": os.path.join(root, JPEG_FIXTURES, "kitti"),
        "bench clip PNG 1280x384": png_dir}
    draws = []
    sample = mono_dataset.sample_jitter_params

    def recorded(rng):
        draws.append(sample(rng))
        return draws[-1]
    mono_dataset.sample_jitter_params = recorded
    batches = {}
    try:
        for name, path in sources.items():
            draws.clear()
            ds = mono_dataset.MonoSequenceDataset(path, *mono_size, seed=0)
            got, secs = host_timed(
                lambda: list(ds.epoch_batches(MONO_BATCH, device=dev)), dev)
            n_draws = len(draws)
            first_cpu = next(mono_dataset.MonoSequenceDataset(
                path, *mono_size, seed=0).epoch_batches(MONO_BATCH,
                                                        device="cpu"))
            b = got[0]
            check(len(got) == len(ds) // MONO_BATCH
                  and tuple(b.color.shape) == (MONO_BATCH, 3) + mono_size
                  and b.color.device.type == torch.device(dev).type
                  and all(bool(((x >= 0) & (x <= 1)).all())
                          for x in (b.color, b.color_aug)),
                  (f"(o1) {name}: {len(got)} batches of "
                   f"{tuple(b.color.shape)} on {b.color.device}"))
            check(same_batch(b, first_cpu),
                  f"(o1) {name}: the CPU's first batch differs from the "
                  f"card's")
            text = ", ".join("(%.4f, %.4f, %.4f, %+.4f)" % d
                             for d in draws[:n_draws])
            print(f"(o1) {name}: {len(ds)} triplets, {len(got)} batches of "
                  f"{MONO_BATCH} at {mono_size[1]}x{mono_size[0]} on "
                  f"{b.color.device} in {secs:.3f} s "
                  f"({1e3 * secs / len(got):.1f} ms a batch, host numpy), "
                  f"{n_draws} jittered items, draws (b, c, s, h) [{text}]; "
                  f"the first batch built on the CPU bit-equal")
            batches[name] = got
    finally:
        mono_dataset.sample_jitter_params = sample
    model = SelfSupModel(seed=0, device=dev)
    step = make_selfsup_train_step(model, lr=1e-4)
    key = prng.PRNGKey(0, device=dev)
    kitti = batches["KITTI JPEG 1242x375"]

    def train():
        return [float(step(b, key if i == 0 else prng.fold_in(key, i)))
                for i, b in enumerate(kitti[:MONO_STEPS])]
    (losses, secs), launches = launches_of(
        counters, lambda: host_timed(train, dev))
    check(launches == [0] * len(counters)
          and all(math.isfinite(x) for x in losses),
          f"(o1) self-supervised steps: losses {losses}, {names} launched "
          f"{launches} times")
    print(f"(o1) MonoDepth2 self-supervised trainer, {MONO_STEPS} steps on "
          f"the KITTI batches: losses {[round(x, 6) for x in losses]}, "
          f"launches {launches}, {secs:.3f} s")
    return launches


def run_multi_sequence(seq, counters, names, n_frames=N_FRAMES,
                       dev="cuda", kw=MULTI_KW):
    """(o2): multi_sequence_tracking over two n_frames sequences of the
    offline scene (its first and its last n_frames frames) on ``dev``.
    Returns (launches, kernel 1's max error on one frame's calls, the
    result, its inputs (cfg, depths, flows, masks))."""
    import torch
    from vido_slam_tpu_torch.config import config_from_dict
    from vido_slam_tpu_torch.estimation import pose
    from vido_slam_tpu_torch.metrics import ate_rmse, camera_centers
    from vido_slam_tpu_torch.parallel.slam_eval import multi_sequence_tracking
    from vido_slam_tpu_torch.tracking import Tracker

    cfg = config_from_dict(OFFLINE_CONFIG)
    starts = (0, len(seq.frames) - n_frames)
    seqs = [seq.frames[s:s + n_frames] for s in starts]

    def stacked(field, dtype):
        return torch.stack([torch.stack([torch.as_tensor(getattr(f, field),
                                                         device=dev)
                                         for f in fr]) for fr in seqs]
                           ).to(dtype)
    depths, flows = stacked("depth", torch.float32), stacked("flow",
                                                             torch.float32)
    masks = stacked("mask", torch.int32)
    recorder = KernelArgs(pose.pose_lm_batched)
    pose.pose_lm_batched = recorder
    try:
        (res, secs), launches = launches_of(counters, lambda: host_timed(
            lambda: multi_sequence_tracking(cfg, depths, flows, masks,
                                            **kw, device=dev), dev))
    finally:
        pose.pose_lm_batched = recorder.wrapper
    S, T = len(seqs), n_frames
    expect = [2 * S * (T - 1), 0, 0, 0, 0]
    check(launches == expect,
          f"(o2) multi_sequence_tracking: {names} launched {launches} "
          f"times, not {expect}")
    err = 0.0
    if torch.device(dev).type == "cuda":
        calls, k = recorder.frame_calls()
        err = check_pose_lm(
            [(f"(o2) call pair {k} {what}", args, kw_, True)
             for what, (args, kw_) in zip(("camera", "objects"), calls)],
            seq.scene.cam)
    tracker_kw = dict(n_bg=kw["n_bg"], n_obj=kw["n_obj"],
                      max_objects=kw["max_objects"], local_ba=True,
                      fused_ba=True, ba_max_points=kw["ba_points"],
                      ba_iters=kw["ba_iters"])
    report = []
    for s, frames in enumerate(seqs):
        tracker = Tracker(cfg, seed=s, device=dev, **tracker_kw)
        poses = np.stack([np.asarray(tracker.track(f.depth, f.flow, f.mask))
                          for f in frames])
        tracker.finish()
        est = res.Tcw[s].cpu().numpy()
        diff = float(np.abs(est - poses).max())
        gt = np.stack([f.Tcw_gt for f in frames]).astype(np.float64)
        gt = gt @ np.linalg.inv(gt[0])
        ate = ate_rmse(est, gt, align=False)
        c = camera_centers(gt)
        path = float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
        check(np.isfinite(est).all() and diff <= 1e-5 and ate < 0.01 * path,
              f"(o2) sequence {s}: {diff} from its Tracker, ATE {ate} m over "
              f"{path} m")
        report.append(f"sequence {s} (frames {starts[s]}-"
                      f"{starts[s] + T - 1}): ATE {ate:.4f} m over "
                      f"{path:.2f} m ({100 * ate / path:.3f} %), "
                      f"{diff:.2e} from Tracker(seed={s}), inliers at the "
                      f"last frame {int(res.n_inliers[s, -1])}")
    print(f"(o2) multi_sequence_tracking S={S} T={T} at "
          f"{seq.scene.cam.width}x{seq.scene.cam.height} ({kw}): launches "
          f"{launches}, {secs:.3f} s ({1e3 * secs / (S * (T - 1)):.2f} ms "
          f"a tracked frame); " + "; ".join(report))
    return launches, err, res, (cfg, depths, flows, masks)


def window_problems(rng, S, W, P, noise=0.005):
    """S consistent window problems laid out as tests/test_parallel.py's
    ``make_problem`` lays them: forward motion of (0.05, 0, 0.4) m and 0.02
    rad of yaw a frame, P points 8-16 m ahead, camera-frame observations
    with ``noise`` m of noise, the poses after the first perturbed by
    N(0, 0.01^2) twists and the points by 0.02 m, all numpy-seeded.
    Returns the BatchedWindowProblem fields and the true poses, on the
    CPU."""
    import torch
    from vido_slam_tpu_torch.geometry.se3 import (exp_se3, inverse_se3,
                                                  make_se3)
    from vido_slam_tpu_torch.geometry.so3 import exp_so3

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))
    step = make_se3(exp_so3(t([0.0, 0.02, 0.0])), t([0.05, 0.0, 0.4]))
    fields = {k: [] for k in ("Twc0", "odom", "odom_valid", "X0", "obs",
                              "obs_valid", "point_valid", "frame_valid")}
    gts = []
    for _ in range(S):
        Twc = [torch.eye(4)]
        for _ in range(W - 1):
            Twc.append(Twc[-1] @ step)
        Twc = torch.stack(Twc)
        X = t(rng.uniform(-4, 4, (P, 3)) + [0.0, 0.0, 12.0])
        Tcw = inverse_se3(Twc)
        obs = torch.einsum("wij,pj->wpi", Tcw[:, :3, :3], X) \
            + Tcw[:, None, :3, 3] + t(rng.normal(0, noise, (W, P, 3)))
        Twc0 = Twc @ exp_se3(t(rng.normal(0, 0.01, (W, 6))))
        Twc0[0] = Twc[0]
        fields["Twc0"].append(Twc0)
        fields["odom"].append(inverse_se3(Twc[:-1]) @ Twc[1:])
        fields["odom_valid"].append(torch.ones(W - 1, dtype=torch.bool))
        fields["X0"].append(X + t(rng.normal(0, 0.02, (P, 3))))
        fields["obs"].append(obs)
        fields["obs_valid"].append(torch.ones(W, P, dtype=torch.bool))
        fields["point_valid"].append(torch.ones(P, dtype=torch.bool))
        fields["frame_valid"].append(torch.ones(W, dtype=torch.bool))
        gts.append(Twc)
    return ({k: torch.stack(v) for k, v in fields.items()},
            torch.stack(gts))


def run_window_evaluation(dev="cuda", S=WINDOW_PROBLEMS, shape=WINDOW_SHAPE):
    """(o3): evaluate_sequences on S window problems on ``dev``, each held
    against solve_window_ba alone."""
    from vido_slam_tpu_torch.estimation.window_ba import solve_window_ba
    from vido_slam_tpu_torch.parallel.eval import (BatchedWindowProblem,
                                                   evaluate_sequences)

    fields, gt = window_problems(np.random.RandomState(16), S, *shape)
    probs = BatchedWindowProblem(**{k: v.to(dev) for k, v in fields.items()})
    (res, ate), secs = host_timed(
        lambda: evaluate_sequences(probs, gt.to(dev), device=dev), dev)
    diff = 0.0
    for s in range(S):
        ref = solve_window_ba(*(x[s] for x in probs), max_iters=15)
        diff = max(diff, float((res.Twc[s] - ref.Twc).abs().max()),
                   float((res.points[s] - ref.points).abs().max()))
    ate = ate.cpu().numpy()
    check(diff <= 1e-5 and bool((ate < 0.01).all()),
          f"(o3) evaluate_sequences: {diff} from solve_window_ba, ATE {ate}")
    print(f"(o3) evaluate_sequences: {S} problems W={shape[0]} "
          f"P={shape[1]}, ATE {np.round(ate, 6).tolist()} m, iterations "
          f"{res.num_iters.tolist()}, {diff:.2e} from solve_window_ba alone; "
          f"{secs:.3f} s")


def run_coco_evaluation(dev, counters, names, n_frames=EVAL_FRAMES):
    """(o4): sharded_coco_evaluation of (d)'s detector over n_frames clip
    frames on ``dev``, the ground truth the port's CPU detections. Returns
    (launches, kernel 5's max error on the first image's calls, the run:
    model, images, gts, out_hw and scores)."""
    import torch
    from vido_slam_tpu_torch.models.maskrcnn import roi_heads
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           RESNET50_FPN)
    from vido_slam_tpu_torch.parallel import eval as peval

    clip, model = mask_inputs(dev)
    model = lifted(model, EVAL_LIFT)
    h, w = model.cfg.input_h, model.cfg.input_w
    # 0..1 frames, as the parity tests feed the random detector: on raw
    # 0..255 frames it saturates and most of its boxes collapse to no area,
    # which no IoU can match
    images = torch.cat([frame_at(clip[k], h, w, 1.0 / 255.0)
                        for k in range(n_frames)])
    out_hw = tuple(clip.shape[1:3])
    cpu_model = lifted(MaskRCNN(RESNET50_FPN, seed=0, device="cpu"),
                       EVAL_LIFT)
    cpu_out, cpu_secs = host_timed(lambda: peval.sharded_detection_inference(
        cpu_model, images.cpu(), device="cpu"), "cpu")
    del cpu_model
    gts = [{k: p[k] for k in ("boxes", "labels", "masks")} for p in
           peval.predictions_from_output(cpu_out, (h, w), out_hw)]
    recorder = KernelArgs(roi_heads.roi_align_multilevel, 6)
    roi_heads.roi_align_multilevel = recorder
    try:
        (scores, secs), launches = launches_of(counters, lambda: host_timed(
            lambda: peval.sharded_coco_evaluation(model, images, gts,
                                                  out_hw=out_hw,
                                                  device=dev), dev))
    finally:
        roi_heads.roi_align_multilevel = recorder.wrapper
    expect = [0, 0, 0, 0, 2 * n_frames]
    check(launches == expect,
          f"(o4) sharded_coco_evaluation: {names} launched {launches} times,"
          f" not {expect}")
    err = 0.0
    if torch.device(dev).type == "cuda":
        err = check_roi_align([(f"(o4) image 1 {what}", args) for what,
                               (args, _) in zip(("box head", "mask head"),
                                                recorder.calls[:2])])
    out, infer_secs = host_timed(lambda: peval.sharded_detection_inference(
        model, images, device=dev), dev)
    ap50 = peval.detection_ap50(out.boxes, out.scores, out.valid,
                                cpu_out.boxes, cpu_out.valid)
    b, m = scores["bbox"], scores["segm"]
    check(min(b["AP50"], m["AP50"], ap50) >= 0.9,
          f"(o4) card against CPU: bbox AP50 {b['AP50']}, segm AP50 "
          f"{m['AP50']}, detection_ap50 {ap50}")
    n_valid = cpu_out.valid.sum(1).tolist()
    print(f"(o4) sharded_coco_evaluation: R-50-FPN {w}x{h} over {n_frames} "
          f"clip frames pasted at {out_hw[1]}x{out_hw[0]}, ground truth the "
          f"CPU's detections ({n_valid} a frame, {cpu_secs:.2f} s on the "
          f"CPU): bbox mAP {b['mAP']:.4f} AP50 {b['AP50']:.4f}, segm mAP "
          f"{m['mAP']:.4f} AP50 {m['AP50']:.4f}, detection_ap50 {ap50:.4f}; "
          f"launches {launches}; {secs:.3f} s with the paste and the "
          f"scoring, inference alone {1e3 * infer_secs / n_frames:.1f} ms "
          f"an image")
    return launches, err, dict(model=model, images=images, gts=gts,
                               out_hw=out_hw, scores=scores)


def run_phase_o(dev, counters, names, seq):
    """Phase (o). Returns each part's launches ({part: launches}), the
    max errors of kernels 1 and 5 held there, and (o2)'s and (o4)'s runs
    for phase (p) ({"o2": (result, inputs), "o4": run})."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        depth_launches = run_depth_pipeline(dev, counters, names, tmp)
    multi_launches, err_lm, multi, multi_inputs = run_multi_sequence(
        seq, counters, names)
    run_window_evaluation()
    coco_launches, err_roi, coco = run_coco_evaluation(dev, counters, names)
    print(f"phase (o): {time.perf_counter() - t0:.1f} s; card "
          f"{card_line()}")
    return ({"o1": depth_launches, "o2": multi_launches,
             "o4": coco_launches}, err_lm, err_roi,
            {"o2": (multi, multi_inputs), "o4": coco})


# ---------------------------------------------------------------------------
# phase 4 (p): the multi-device paths; (q): the inference CLI
# ---------------------------------------------------------------------------

MESH_STEPS = 3       # (p1): detector steps at (n1)'s shapes, each way
MESH_DEPTH_STEPS = 2
MESH_BAR = 1e-6      # (p): the mesh at world size 1 against one device
GRAD_BAR_5B = 1e-5   # kernel 5b's bar (atomics): of a key's max |g|
BACKGROUND_TIMEOUT = 600.0
# the gloo runs of (p), each in processes of its own while the card works:
# the dry run on 8 ranks, and the CLI on 4 as dp 2 x tp 2 at the CPU
# tests' size; and the CLI under torchrun on one NCCL rank at (n1)'s size
CLI_ARGS = ["--synthetic", "--iters", "2", "--batch", "2", "--lr", "1e-3",
            "--log-period", "1"]


def start_background(tmp):
    """Start (p)'s three runs in processes of their own, their output in
    files under ``tmp``. Returns {name: (process, log path, out dir)}."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node"]
    cli = ["-m", "vido_slam_tpu_torch.train_maskrcnn"] + CLI_ARGS
    h, w = TRAIN_INPUT
    runs = {
        "dryrun_multichip(8, device='cpu')": [
            sys.executable, "-m", "vido_slam_tpu_torch.parallel.dryrun", "8",
            "--device", "cpu"],
        "CLI on 4 gloo ranks, dp 2 x tp 2, 64x96": torchrun + ["4"] + cli + [
            "--dp", "2", "--tp", "2", "--device", "cpu", "--input-h", "64",
            "--input-w", "96", "--out", os.path.join(tmp, "cli_gloo")],
        f"CLI on 1 NCCL rank, dp 1 x tp 1, {w}x{h}": torchrun + ["1"] + cli
        + ["--dp", "1", "--tp", "1", "--input-h", str(h), "--input-w",
           str(w), "--out", os.path.join(tmp, "cli_nccl")],
    }
    out = {}
    for i, (name, argv) in enumerate(runs.items()):
        log = os.path.join(tmp, f"background_{i}.log")
        with open(log, "w") as f:
            proc = subprocess.Popen(argv, cwd=root, env=env, stdout=f,
                                    stderr=subprocess.STDOUT)
        out[name] = (proc, log, argv[-1] if argv[-2] == "--out" else None,
                     time.perf_counter())
    return out


def finish_background(runs):
    """Wait for (p)'s background runs (each killed past its time) and hold
    them: exit code 0, the dry run's JAX line with mesh (dp 4, tp 2), each
    CLI's two log lines (rank 0's) and a model_final bundle that reloads."""
    import torch
    from vido_slam_tpu_torch import convert
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           MaskRCNNConfig)
    from vido_slam_tpu_torch.utils.checkpoint import load_params

    failed = []
    for name, (proc, log, out_dir, t0) in runs.items():
        try:
            rc = proc.wait(timeout=max(1.0, BACKGROUND_TIMEOUT
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        secs = time.perf_counter() - t0
        with open(log) as f:
            text = f.read()
        if rc != 0:
            failed.append(f"{name}: exit {rc}\n{text[-3000:]}")
            continue
        if out_dir is None:
            line = next((x for x in text.splitlines()
                         if x.startswith("dryrun_multichip ok")), "")
            check("mesh={'dp': 4, 'tp': 2}" in line,
                  f"(p) {name}: no dry-run line in\n{text[-2000:]}")
            print(f"(p) {name}: {line} ({secs:.1f} s)")
            continue
        logs = re.findall(r"^iter \d+/2 .*$", text, re.M)
        check(len(logs) == 2, f"(p) {name}: log lines {logs}")
        saved = load_params(os.path.join(out_dir, "model_final"))
        h, w = (64, 96) if "gloo" in out_dir else TRAIN_INPUT
        model = MaskRCNN(MaskRCNNConfig(input_h=h, input_w=w), device="cpu")
        model.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
            {k: v.numpy() for k, v in saved.items()}, device="cpu"),
            strict=True)
        check(all(bool(torch.isfinite(v).all()) for v in saved.values()),
              f"(p) {name}: non-finite weights")
        print(f"(p) {name}: {logs[-1].strip()}; model_final reloads "
              f"({secs:.1f} s)")
    check(not failed, "(p) background runs failed:\n" + "\n".join(failed))


def state_gap(a: dict, b: dict) -> float:
    """Largest |a - b| of a key over that key's max |b| (1e-30 floor)."""
    return max(float((a[k].float() - v.float()).abs().max())
               / max(float(v.float().abs().max()), 1e-30)
               for k, v in b.items())


def mesh_detector_steps(dev, mesh, counters):
    """(p1): MESH_STEPS detector steps at (n1)'s shapes (R-50-FPN, the CLI's
    synthetic batches of 2, the CLI's SGD solver at lr 1e-3 and its key
    schedule), with ``mesh`` (or on one device without). Returns (losses,
    the first step's gradients, the final state, launches)."""
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           MaskRCNNConfig)
    from vido_slam_tpu_torch.parallel.train import (
        make_detection_optimizer, make_detection_train_step, sharded_leaves,
        trainable_state)
    from vido_slam_tpu_torch.train_maskrcnn import synthetic_batches
    from vido_slam_tpu_torch.utils import prng

    h, w = TRAIN_INPUT
    model = MaskRCNN(MaskRCNNConfig(input_h=h, input_w=w), seed=0,
                     device=dev)
    whole = trainable_state(model)
    params = whole if mesh is None else sharded_leaves(whole, mesh)
    step = make_detection_train_step(
        model, opt=make_detection_optimizer(params, base_lr=1e-3), mesh=mesh,
        params=params)
    batches = synthetic_batches(MESH_STEPS, 2, h, w, 32, seed=0)
    first = {}

    def run():
        key, losses = prng.PRNGKey(0), []
        for b in batches:
            key, k = prng.split(key)
            losses.append(float(step(b, k)))
            if not first:
                first.update({k: v.grad.clone() for k, v in whole.items()})
        return losses
    losses, launches = launches_of(counters, run)
    return losses, first, {k: v.detach() for k, v in
                           model.state_dict().items()}, launches


def run_phase_p(dev, counters, names, o_runs):
    """Phase (p), the multi-device paths on one card: an NCCL process
    group of one rank and ``make_mesh(1)``; (p1) the mesh detector step at
    (n1)'s shapes against the step without a mesh (kernels 5 and 5b 12
    times each); (p2) the mesh self-supervised step at (n4)'s shapes;
    (p3) the mesh ``multi_sequence_tracking`` on (o2)'s sequences; (p4)
    the mesh ``sharded_coco_evaluation`` on (o4)'s frames; (p5)
    ``dryrun_multichip(1)`` on the card. Returns each part's launches."""
    import torch
    import torch.distributed as dist
    from vido_slam_tpu_torch.models.monodepth2_train import (
        SelfSupModel, make_selfsup_train_step)
    from vido_slam_tpu_torch.parallel import eval as peval
    from vido_slam_tpu_torch.parallel.dryrun import dryrun_multichip
    from vido_slam_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from vido_slam_tpu_torch.parallel.slam_eval import multi_sequence_tracking
    from vido_slam_tpu_torch.utils import prng

    t0 = time.perf_counter()
    launches = {}
    init_distributed(dev)
    try:
        mesh = make_mesh(1)
        check(mesh.device.type == torch.device(dev).type,
              f"(p) {mesh} over {dist.get_backend()}")
        # (p1): twice without the mesh (the card's own spread: kernel 5b
        # adds with atomics, cuDNN's backward may too), once with it
        runs = [mesh_detector_steps(dev, None, counters) for _ in range(2)]
        (losses, grads, state, n), secs = host_timed(
            lambda: mesh_detector_steps(dev, mesh, counters), dev)
        (ref_losses, ref_grads, ref_state, ref_n), again = runs
        expect = [0, 0, 0, 0, 4 * MESH_STEPS, 4 * MESH_STEPS]
        check(n == ref_n == again[3] == expect,
              f"(p1) mesh detector steps: {names} launched {n} times (one "
              f"device {ref_n}, {again[3]}), not {expect}")
        grad_gap = state_gap(grads, ref_grads)
        spread = state_gap(again[2], ref_state)
        gap = state_gap(state, ref_state)
        check(losses[0] == ref_losses[0] == again[0][0]
              and grad_gap <= GRAD_BAR_5B
              and gap <= max(MESH_BAR, 2 * spread)
              and all(math.isfinite(x) for x in losses),
              f"(p1) mesh steps {losses} against {ref_losses} and "
              f"{again[0]}: first gradients {grad_gap:.2e} of a key's max, "
              f"final state {gap:.2e} (two runs without the mesh "
              f"{spread:.2e})")
        launches["p1"] = n
        h, w = TRAIN_INPUT
        print(f"(p1) mesh {mesh.shape} {dist.get_backend()} detector steps, "
              f"R-50-FPN {w}x{h} batch 2, SGD lr 1e-3: losses {losses}, "
              f"launches {n}; without the mesh {ref_losses} and "
              f"{again[0]}: the first loss equal to the bit, its gradients "
              f"{grad_gap:.2e} of a key's max (bar {GRAD_BAR_5B:.0e}), the "
              f"final state {gap:.2e} of a key's max, two runs without the "
              f"mesh {spread:.2e} (bar max({MESH_BAR:.0e}, twice that)); "
              f"{secs:.2f} s")
        del state, ref_state, runs, grads, ref_grads
        # (p2)
        batch = depth_batches(dev)
        key = prng.PRNGKey(0, device=dev)
        runs = []
        for m in (None, mesh):
            step = make_selfsup_train_step(SelfSupModel(seed=0, device=dev),
                                           lr=1e-4, mesh=m)
            runs.append(launches_of(counters, lambda: [
                float(step(batch, key if i == 0 else prng.fold_in(key, i)))
                for i in range(MESH_DEPTH_STEPS)]))
        (ref, _), (d_losses, n) = runs
        gap = abs(d_losses[0] - ref[0]) / abs(ref[0])
        check(n == [0] * len(counters) and gap <= MESH_BAR
              and all(math.isfinite(x) for x in d_losses),
              f"(p2) mesh self-supervised steps: losses {d_losses} against "
              f"{ref}, launches {n}")
        print(f"(p2) mesh self-supervised steps, 640x192 batch "
              f"{DEPTH_BATCH}: losses {d_losses} (one device {ref}; the "
              f"first {gap:.2e} relative), launches {n}")
        # (p3)
        res, (cfg, depths, flows, masks) = o_runs["o2"]
        (got, secs), n = launches_of(counters, lambda: host_timed(
            lambda: multi_sequence_tracking(cfg, depths, flows, masks,
                                            **MULTI_KW, mesh=mesh), dev))
        S, T = depths.shape[:2]
        expect = [2 * S * (T - 1), 0, 0, 0, 0, 0]
        gap = max(float((getattr(got, f) - getattr(res, f)).abs().max())
                  for f in ("Tcw", "ba_Twc"))
        check(n == expect and gap <= MESH_BAR
              and torch.equal(got.n_inliers, res.n_inliers),
              f"(p3) mesh multi_sequence_tracking: launches {n} (not "
              f"{expect}), {gap:.2e} from (o2)")
        launches["p3"] = n
        print(f"(p3) mesh multi_sequence_tracking on (o2)'s {S} sequences: "
              f"launches {n}, {gap:.2e} from (o2); {secs:.3f} s")
        # (p4)
        run = o_runs["o4"]
        (scores, secs), n = launches_of(counters, lambda: host_timed(
            lambda: peval.sharded_coco_evaluation(
                run["model"], run["images"], run["gts"],
                out_hw=run["out_hw"], mesh=mesh), dev))
        B = run["images"].shape[0]
        expect = [0, 0, 0, 0, 2 * B, 0]
        same = all(scores[t]["AP50"] == run["scores"][t]["AP50"]
                   for t in ("bbox", "segm"))
        check(n == expect and same,
              f"(p4) mesh sharded_coco_evaluation: launches {n} (not "
              f"{expect}), AP50 {[scores[t]['AP50'] for t in scores]} "
              f"against (o4)'s {[run['scores'][t]['AP50'] for t in scores]}")
        launches["p4"] = n
        print(f"(p4) mesh sharded_coco_evaluation on (o4)'s {B} frames: "
              f"bbox AP50 {scores['bbox']['AP50']:.4f}, segm AP50 "
              f"{scores['segm']['AP50']:.4f} (as (o4)), launches {n}; "
              f"{secs:.3f} s")
        # (p5)
        out, secs = host_timed(lambda: dryrun_multichip(1, device=dev), dev)
        check(out["det_batch"] == 1
              and out["ba_cost"][1] < 0.1 * out["ba_cost"][0],
              f"(p5) dryrun_multichip(1): {out}")
        print(f"(p5) dryrun_multichip(1) on the card: {out}; {secs:.2f} s")
    finally:
        dist.destroy_process_group()
    print(f"phase (p): {time.perf_counter() - t0:.1f} s; card {card_line()}")
    return launches


INFER_FRAME = 0      # the bench-clip frame of (q)'s detectors
DEPTH_BAR = 1e-4     # (q): of the disparity's max, card against CPU
FLOW_BAR = 1e-3      # (q): of max(|flow|, 1)
DETECTOR_THRESHOLDS = {"fbnet": 0.05, "retinanet": 0.05, "maskrcnn": 0.8}


def quiet(fn):
    """fn() with its standard output dropped (the CLIs print a line an
    image)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def json_detections(path) -> dict:
    """A detections JSON as match_detections' slots."""
    with open(path) as f:
        dets = json.load(f)["detections"]
    return {"boxes": np.asarray([d["box"] for d in dets],
                                np.float64).reshape(-1, 4),
            "scores": np.asarray([d["score"] for d in dets], np.float64),
            "labels": np.asarray([d["label"] for d in dets], np.int64),
            "valid": np.ones(len(dets), bool)}


def padded(d: dict, n: int) -> dict:
    k = n - len(d["valid"])
    return {"boxes": np.pad(d["boxes"], ((0, k), (0, 0))),
            "scores": np.pad(d["scores"], (0, k)),
            "labels": np.pad(d["labels"], (0, k)),
            "valid": np.pad(d["valid"], (0, k))}


def run_phase_q(dev, counters, names, tmp):
    """Phase (q), ``python -m vido_slam_tpu_torch.infer_nets`` (in-process)
    on the card, each output held against the same CLI with ``--device
    cpu``: ``depth`` over the 24 committed KITTI frames (1242x375, PIL's
    LANCZOS down to 640x192), ``flow`` on their first pair (kernels 3 and
    4, 5 launches each), ``detector`` for each family on bench-clip frame
    INFER_FRAME written as a PNG. Returns each part's launches."""
    from vido_slam_tpu_torch import infer_nets
    from vido_slam_tpu_torch.io.datasets import read_flo
    from vido_slam_tpu_torch.io.png import write_png

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    kitti = os.path.join(root, JPEG_FIXTURES, "kitti")
    frames = sorted(os.listdir(kitti))

    def both(argv, part):
        """The CLI on the card (its launches and seconds), then on the CPU.
        Returns the two output directories."""
        outs = []
        for d in ("cuda", "cpu"):
            out = os.path.join(tmp, f"{part}_{d}")
            extra = [] if d == "cuda" else ["--device", "cpu"]
            (_, secs), n = launches_of(counters, lambda: host_timed(
                lambda: quiet(lambda: infer_nets.main(
                    argv + ["--out", out] + extra)), d))
            if d == "cuda":
                launches[part], seconds[part] = n, secs
            outs.append(out)
        return outs
    launches, seconds = {}, {}
    # depth
    card, cpu = both(["depth", "--images", kitti], "depth")
    gap = 0.0
    for name in frames:
        stem = os.path.splitext(name)[0]
        a = np.load(os.path.join(card, f"{stem}_disp.npy"))
        b = np.load(os.path.join(cpu, f"{stem}_disp.npy"))
        check(a.shape == b.shape == (375, 1242) and np.isfinite(a).all(),
              f"(q) depth {name}: {a.shape}")
        gap = max(gap, float(np.abs(a - b).max()) / float(np.abs(b).max()))
        check(os.path.exists(os.path.join(card, f"{stem}_disp.png")),
              f"(q) depth {name}: no PNG")
    check(gap <= DEPTH_BAR and launches["depth"] == [0] * len(counters),
          f"(q) depth: card against CPU {gap:.2e} of the max, launches "
          f"{launches['depth']}")
    print(f"(q) depth over {len(frames)} KITTI frames: card against CPU "
          f"{gap:.2e} of the disparity's max (bar {DEPTH_BAR:.0e}), "
          f"{1e3 * seconds['depth'] / len(frames):.1f} ms a frame (reading "
          f"and LANCZOS on the host included)")
    # flow
    card, cpu = both(["flow", "--first", os.path.join(kitti, frames[0]),
                      "--second", os.path.join(kitti, frames[1])], "flow")
    a = read_flo(os.path.join(card, "flow.flo"))
    b = read_flo(os.path.join(cpu, "flow.flo"))
    gap = float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
    expect = [0, 0, 5, 5, 0]
    check(a.shape == (375, 1242, 2) and gap <= FLOW_BAR
          and launches["flow"] == expect,
          f"(q) flow: {a.shape}, card against CPU {gap:.2e}, launches "
          f"{launches['flow']} (not {expect})")
    print(f"(q) flow on KITTI frames {frames[0]}, {frames[1]}: |max| "
          f"{float(np.abs(b).max()):.4f} px, card against CPU {gap:.2e} of "
          f"max(|flow|, 1) (bar {FLOW_BAR:.0e}), launches {launches['flow']},"
          f" {seconds['flow']:.3f} s")
    # the detectors on a clip frame
    clip = np.load(os.path.join(root, ONLINE_CLIP))["clip"]
    image = os.path.join(tmp, "clip_frame.png")
    write_png(image, np.ascontiguousarray(clip[INFER_FRAME][..., ::-1]))
    expects = {"fbnet": [0, 0, 0, 0, 1], "retinanet": [0] * 5,
               "maskrcnn": [0, 0, 0, 0, 2]}
    for family, expect in expects.items():
        argv = ["detector", "--family", family, "--image", image]
        refusals = []
        if family == "maskrcnn":
            # its random init gives a box with x1 < x0 or y1 < y0 on every
            # clip frame: after the JSON, the drawing refuses it on either
            # device, as Pillow refuses it in the JAX CLI
            for d in ("cuda", "cpu"):
                def call():
                    try:
                        quiet(lambda: infer_nets.main(
                            argv + ["--out", os.path.join(
                                tmp, f"{family}_{d}")]
                            + ([] if d == "cuda" else ["--device", "cpu"])))
                    except ValueError as e:
                        return str(e)
                    return None
                msg, n = launches_of(counters, call)
                refusals.append(msg)
                if d == "cuda":
                    launches[family] = n
            check(refusals[0] is not None and refusals[0] == refusals[1],
                  f"(q) maskrcnn: refusals {refusals}")
            card = os.path.join(tmp, f"{family}_cuda")
            cpu = os.path.join(tmp, f"{family}_cpu")
        else:
            card, cpu = both(argv, family)
            check(os.path.exists(os.path.join(card,
                                              f"{family}_annotated.png")),
                  f"(q) {family}: no annotated PNG")
        a = json_detections(os.path.join(card, f"{family}_detections.json"))
        b = json_detections(os.path.join(cpu, f"{family}_detections.json"))
        n = max(len(a["valid"]), len(b["valid"]))
        m = match_detections(padded(a, n), padded(b, n),
                             DETECTOR_THRESHOLDS[family])
        check(not m["unexplained"] and launches[family] == expect,
              f"(q) {family}: {m}, launches {launches[family]} (not "
              f"{expect})")
        print(f"(q) detector {family} on clip frame {INFER_FRAME} (640x192): "
              f"card {m['valid'][0]} detections, CPU {m['valid'][1]}, boxes "
              f"matched {m['boxes_matched']}, slots differing "
              f"{m['slots_differ']} (each within a margin), launches "
              f"{launches[family]}"
              + (f"; both refuse the drawing: {refusals[0]}" if refusals
                 else ""))
    print(f"phase (q): {time.perf_counter() - t0:.1f} s; card {card_line()}")
    return launches


# ---------------------------------------------------------------------------
# phase 4 (r): the C facade, the standalone host, the file prefetcher and
# the deformable detector in bf16 (ROADMAP.md items 22, 10c and 19c)
# ---------------------------------------------------------------------------

RUNNER_FRAMES = 3
# the camera of the JAX package's facade scene (simple_scene(256, 160)) for
# the standalone host's fixed 160x256 frames
RUNNER_CONFIG = {
    "Camera.width": 256, "Camera.height": 160, "Camera.fx": 200.0,
    "Camera.fy": 200.0, "Camera.cx": 128.0, "Camera.cy": 80.0,
    "Camera.bf": 40.0, "ChooseData": 1, "DepthMapFactor": 100,
    "Camera.fps": 10, "MaxTrackPointBG": 600, "WINDOW_SIZE": 4,
    "slam_mode": 0,
}
RUNNER_TIMEOUT = 600.0
RESULT_TXTS = ("obj_mot_rgbd_new.txt", "initial_rgbd_new.txt",
               "refined_rgbd_new.txt", "cam_pose_gt.txt")


def host_frames(inputs):
    """(a)'s frames as a C caller holds them: contiguous host arrays of raw
    depth (float32), flow (float32), mask (int32) and the ground truth."""
    return [(np.ascontiguousarray(raw.cpu().numpy(), np.float32),
             np.ascontiguousarray(flow.cpu().numpy(), np.float32),
             np.ascontiguousarray(mask.cpu().numpy(), np.int32),
             np.ascontiguousarray(gt, np.float32))
            for raw, flow, mask, gt in inputs]


def result_txts(save, d, tag) -> dict:
    prefix = os.path.join(d, tag + "_")
    save(prefix)
    out = {}
    for name in RESULT_TXTS:
        with open(prefix + name, "rb") as f:
            out[name] = f.read()
    return out


def run_facade(inputs, counters, names, card, dev="cuda"):
    """(r1): (a)'s 24 frames at 1280x560 through the C facade
    (``vido_system_init_ex`` with (a)'s tracker arguments, on the card),
    loaded by ctypes into this process, then through the Python ``System``
    on the card: every pose, every frame's ``GetFrameOutputArray`` rows
    and the four result txts equal, kernel 1 twice a tracked frame in
    each. ``dev="cpu"`` (a rehearsal) adds ``{"device": "cpu"}`` to the
    arguments. Returns the facade run's launches and both ms a frame."""
    import ctypes
    import torch
    from vido_slam_tpu_torch import native_system
    from vido_slam_tpu_torch.system import Sensor, System

    dev = torch.device(dev).type
    lib = native_system.facade()
    frames = host_frames(inputs)
    n = len(frames)
    H, W = frames[0][0].shape

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    kw = dict(TRACKER_KW, **({"device": "cpu"} if dev == "cpu" else {}))
    with tempfile.TemporaryDirectory() as d:
        cfg = os.path.join(d, "kaist.yaml")
        write_config(cfg, OFFLINE_CONFIG)
        sys_c = lib.vido_system_create()
        check(bool(sys_c), "(r1): vido_system_create failed")
        check(lib.vido_system_init_ex(sys_c, cfg.encode(), 2,
                                      json.dumps(kw).encode()) == 0,
              "(r1): vido_system_init_ex failed")
        pose = np.zeros(16, np.float32)
        c_poses, c_ms = [], []
        for c in counters:
            c.launches = 0
        for k, (raw, flow, mask, gt) in enumerate(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = lib.vido_system_track(sys_c, None, ptr(raw), ptr(flow),
                                       ptr(mask), ptr(gt), k / 10.0, H, W,
                                       ptr(pose))
            torch.cuda.synchronize()
            c_ms.append(1e3 * (time.perf_counter() - t0))
            check(rc == 0, f"(r1): vido_system_track failed on frame {k}")
            c_poses.append(pose.reshape(4, 4).copy())
        launches = [c.launches for c in counters]
        check(launches == [2 * (n - 1), 0, 0, 0, 0],
              f"(r1) facade: {names} launched {launches} times over "
              f"{n - 1} tracked frames")
        c_rows = []
        for k in range(n):
            out = np.zeros((64, 10), np.float64)
            m = lib.vido_system_get_objects(sys_c, k, ptr(out), 64)
            check(0 <= m <= 64, f"(r1): get_objects gave {m}")
            c_rows.append(out[:m])
        c_txt = result_txts(lambda p: check(
            lib.vido_system_save(sys_c, p.encode()) == 0,
            "(r1): vido_system_save failed"), d, "c")
        lib.vido_system_destroy(sys_c)

        system = System()
        system.Init(cfg, Sensor.RGBD, **kw)
        check(system.tracker.device.type == dev, f"(r1): not on {dev}")
        py_poses, py_ms = [], []
        for c in counters:
            c.launches = 0
        for k, (raw, flow, mask, gt) in enumerate(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Tcw = system.TrackRGBD(None, raw, flow, mask, gt, None, k / 10.0)
            torch.cuda.synchronize()
            py_ms.append(1e3 * (time.perf_counter() - t0))
            py_poses.append(np.asarray(Tcw, np.float32))
        py_launches = [c.launches for c in counters]
        check(py_launches == launches, f"(r1) Python System: {names} "
              f"launched {py_launches} times, the facade {launches}")
        same_poses = all(np.array_equal(a, b)
                         for a, b in zip(c_poses, py_poses))
        py_rows = [system.GetFrameOutputArray(k) for k in range(n)]
        same_rows = all(a.shape == b.shape and np.array_equal(a, b)
                        for a, b in zip(c_rows, py_rows))
        py_txt = result_txts(system.SaveResultsIJRR2020, d, "py")
        gap = max(float(np.abs(a - b).max())
                  for a, b in zip(c_poses, py_poses))
        check(same_poses and same_rows and c_txt == py_txt,
              ("(r1) facade against the Python System", same_poses,
               same_rows, c_txt == py_txt, gap))
        with_obj = sum(len(r) > 0 for r in c_rows)
        check(with_obj > (n - 1) // 2,
              f"(r1): objects on {with_obj} of {n} frames")
    c_med = float(np.median(c_ms[4:]))
    py_med = float(np.median(py_ms[4:]))
    print(f"(r1) C facade (vido_system_init_ex with (a)'s tracker "
          f"arguments, loaded by ctypes) on (a)'s {n} frames {W}x{H}: "
          f"launches {launches}, poses, GetFrameOutputArray rows "
          f"({sum(len(r) for r in c_rows)} over {with_obj} frames) and the "
          f"four result txts equal to the Python System's on the card; "
          f"ms/frame median facade {c_med:.2f}, Python System {py_med:.2f} "
          f"(frames 4-{n - 1}, host clock over torch.cuda.synchronize); "
          f"card {card}")
    return launches, c_med, py_med


def run_standalone_host(card, dev="cuda"):
    """(r2): ``run_vido_native`` (``vido_system_init``: on the card) as a
    subprocess over RUNNER_FRAMES synthetic frames; its printed
    translations equal the Python ``System``'s on the card on the same
    frames, rebuilt in numpy, and it ends with ``ok``. ``dev="cpu"`` (a
    rehearsal) passes ``{"device": "cpu"}``. Returns its seconds."""
    import torch
    from vido_slam_tpu_torch import native_system
    from vido_slam_tpu_torch.system import Sensor, System

    dev = torch.device(dev).type
    exe = native_system.runner()
    with tempfile.TemporaryDirectory() as d:
        cfg = os.path.join(d, "runner.yaml")
        write_config(cfg, RUNNER_CONFIG)
        t0 = time.perf_counter()
        extra = [json.dumps({"device": "cpu"})] if dev == "cpu" else []
        proc = subprocess.run([exe, cfg, str(RUNNER_FRAMES), *extra], cwd=d,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, timeout=RUNNER_TIMEOUT)
        secs = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        check(proc.returncode == 0 and lines and lines[-1] == "ok",
              f"(r2) run_vido_native: exit {proc.returncode}\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        system = System()
        system.Init(cfg, Sensor.RGBD, **({"device": "cpu"} if extra else {}))
        check(system.tracker.device.type == dev, f"(r2): not on {dev}")
        H, W = RUNNER_CONFIG["Camera.height"], RUNNER_CONFIG["Camera.width"]
        depth = native_system.runner_depth(H, W)
        flow = np.zeros((H, W, 2), np.float32)
        mask = np.zeros((H, W), np.int32)
        want = []
        for t in range(RUNNER_FRAMES):
            p = np.asarray(system.TrackRGBD(None, depth, flow, mask, None,
                                            None, t / 10.0), np.float32)
            want.append(f"frame {t}: t = [{p[0, 3]:.4f} {p[1, 3]:.4f} "
                        f"{p[2, 3]:.4f}]")
        got = [ln for ln in lines if ln.startswith("frame ")]
        check(got == want, ("(r2) run_vido_native's translations", got,
                            want))
    print(f"(r2) run_vido_native {os.path.basename(exe)} (a C++ process "
          f"embedding CPython, vido_system_init on the card): "
          f"{RUNNER_FRAMES} frames {W}x{H}, {got[-1]!r} as the Python "
          f"System, 'ok'; {secs:.1f} s with the interpreter's start; card "
          f"{card}")
    return secs


def run_prefetcher(root, n_frames):
    """(r3): ``FilePrefetcher`` over a KAIST tree's files (image, depth,
    flow, mask of each frame, in frame order): its bytes equal the files;
    ms to read a frame's four files with it and with ``open().read()``
    (both from the page cache: the tree was just written). Returns
    (ms with, ms without)."""
    from vido_slam_tpu_torch.io.native import FilePrefetcher

    stems = sorted(os.path.splitext(f)[0]
                   for f in os.listdir(os.path.join(root, "image")))
    stems = stems[:n_frames]
    paths = [os.path.join(root, sub, stem + ext) for stem in stems
             for sub, ext in (("image", ".png"), ("depth", ".png"),
                              ("flow", ".flo"), ("mask", ".png"))]
    t0 = time.perf_counter()
    plain = []
    for p in paths:
        with open(p, "rb") as f:
            plain.append(f.read())
    plain_ms = 1e3 * (time.perf_counter() - t0) / len(stems)
    pf = FilePrefetcher(paths, n_threads=2, max_ahead=8)
    t0 = time.perf_counter()
    got = [pf.get(i) for i in range(len(paths))]
    pf_ms = 1e3 * (time.perf_counter() - t0) / len(stems)
    pf.close()
    check(got == plain, "(r3): the prefetcher's bytes differ from the files")
    print(f"(r3) FilePrefetcher (2 threads, 8 ahead) over (h)'s KAIST tree, "
          f"{len(stems)} frames x 4 files ({sum(map(len, got))} bytes): "
          f"bytes equal to the files; ms to read a frame's files "
          f"{pf_ms:.3f} with it, {plain_ms:.3f} with open().read() (page "
          f"cache; for information: the CLI reads without it); card "
          f"{card_line()}")
    return pf_ms, plain_ms


def dcn_detector(dev, dtype, cfg):
    """The X-101-32x8d-FPN-DCN detector of (m1) on ``dev``: seed 0, cast to
    ``dtype`` as ``PerceptionModel`` casts it, offset convs by
    ``deformed`` and class 3 lifted."""
    from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNN

    model = MaskRCNN(cfg, seed=0, device=dev)
    if dtype is not None:
        model.to(dtype)
    return lifted(deformed(model))


def run_dcn_bf16(dev, counters, names, card):
    """(r4): ``PerceptionModel(mask_cfg=RESNEXT101_FPN_DCN, mask_dtype=
    bf16)`` (offset convs by ``deformed``, class 3 lifted) through
    ``perception_mask`` over DCN_FRAMES clip frames at 1280x560, the
    detector at 1088x800, after a warm-up frame: kernel 5's bf16 build
    twice a frame, labelled pixels in every mask; the build held against
    its plain version on the last frame's calls and timed there; the
    float32 DCN detector over the same frames in this call; the bf16
    detector on the card against the port on the CPU in bf16 at 320x256
    (``match_detections``: validity and labels equal slot by slot except
    within a bf16 margin of a threshold, as (j1) holds its detections; the
    boxes matched at IoU >= 0.9 are printed: bf16 roundings of the card's
    and the CPU's convolutions part through the 33 blocks). Returns
    (launches, max error, timing)."""
    import torch
    from vido_slam_tpu_torch.io.synthetic import driving_clip
    from vido_slam_tpu_torch.models.maskrcnn import roi_heads
    from vido_slam_tpu_torch.models.maskrcnn import model as mm
    from vido_slam_tpu_torch.models.maskrcnn.model import RESNEXT101_FPN_DCN
    from vido_slam_tpu_torch.models.perception import PerceptionModel
    from vido_slam_tpu_torch.ops import roi_align

    bf = torch.bfloat16
    c = OFFLINE_CONFIG
    clip = driving_clip(height=FLOW_H, width=FLOW_W, n_frames=1 + DCN_FRAMES,
                        fx=c["Camera.fx"], fy=c["Camera.fy"], device=dev)
    model = PerceptionModel(FLOW_H, FLOW_W, mask_cfg=RESNEXT101_FPN_DCN,
                            mask_dtype=bf, device=dev)
    mask_model = lifted(deformed(model.mask_model))
    check(next(mask_model.parameters()).dtype == bf,
          "(r4): mask_dtype did not cast the DCN detector")
    run_mask_path(clip[:1], mask_model, counters)
    rec = KernelArgs(roi_heads.roi_align_multilevel, 6)
    roi_heads.roi_align_multilevel = rec
    try:
        masks, dets, times, launches = run_mask_path(
            clip[1:1 + DCN_FRAMES], mask_model, counters)
    finally:
        roi_heads.roi_align_multilevel = rec.wrapper
    check(launches == [0, 0, 0, 0, 2 * DCN_FRAMES],
          f"(r4): {names} launched {launches} times over {DCN_FRAMES} "
          f"frames, not [0, 0, 0, 0, {2 * DCN_FRAMES}]")
    check(all(a[0][0].dtype == bf for a, _ in rec.calls),
          "(r4): kernel 5 was not given bf16 features")
    n_valid = check_masks(masks, dets, "(r4) bf16 DCN frame")
    cases = [(f"(r4) DCN bf16 frame {DCN_FRAMES} {what}", args)
             for what, (args, _) in zip(("box head", "mask head"),
                                        rec.calls[-2:])]
    err = max(check_bf16_kernel(n, roi_align.roi_align_multilevel,
                                roi_align.roi_align_multilevel_ref, a)
              for n, a in cases)
    timing = time_bf16(cases, roi_align.roi_align_multilevel,
                       roi_align.roi_align_multilevel_ref,
                       lambda a: (roi_align.nbytes(*a),
                                  roi_align.operations_bf16(*a)),
                       roi_plan_bf16)
    del model, mask_model, masks, dets, rec, cases
    f32 = dcn_detector(dev, None, RESNEXT101_FPN_DCN)
    run_mask_path(clip[:1], f32, counters)
    _, _, f32_times, _ = run_mask_path(clip[1:1 + DCN_FRAMES], f32, counters)
    del f32
    # the card against the CPU, both in bf16, at 320x256
    h, w = FAMILY_CHECK
    cfg = mm.MaskRCNNConfig(resnet=RESNEXT101_FPN_DCN.resnet, input_h=h,
                            input_w=w)
    x = frame_at(clip[0], h, w, 1 / 255.0)
    out = {}
    for d in (dev, "cpu"):
        det = mm.maskrcnn_inference(dcn_detector(d, bf, cfg), x.to(d))
        out[str(d)] = detections(det)
    r = match_detections(out[str(dev)], out["cpu"], cfg.confidence_threshold)
    check(not r["unexplained"] and min(r["valid"]) > 0,
          ("(r4) bf16 DCN detector card against CPU", r))
    ms = float(np.median(times)) * 1e3
    f32_ms = float(np.median(f32_times)) * 1e3
    print(f"(r4) X-101-32x8d-FPN-DCN with mask_dtype=torch.bfloat16 "
          f"({FLOW_W}x{FLOW_H}, detector at {RESNEXT101_FPN_DCN.input_w}x"
          f"{RESNEXT101_FPN_DCN.input_h}): launches {launches} (kernel 5's "
          f"bf16 build), valid detections {n_valid}; ms/frame median bf16 "
          f"{ms:.2f} ({[round(1e3 * t, 2) for t in times]}), float32 "
          f"{f32_ms:.2f} ({[round(1e3 * t, 2) for t in f32_times]}) in this "
          f"call; card vs CPU in bf16 at {w}x{h}: {r}; kernel 5 bf16 on the "
          f"last frame: {timing[0]:.4f} ms (float32 build on the same "
          f"values {timing[4]:.4f}), plain {timing[1]:.3f} ms, bound "
          f"{timing[2]:.6f} ms by {timing[3]}, max error {err:.3e}; card "
          f"{card}")
    return launches, err, timing


def run_phase_r(dev, counters, names, inputs, prefetch):
    """Phase (r): (r1)-(r4) above; ``prefetch`` is (r3)'s result, taken
    inside phase (h) while its KAIST tree exists. Returns each kernel's
    launches in (r1) and (r4), kernel 5's bf16 error and timing in (r4)."""
    t0 = time.perf_counter()
    card = card_line()
    r1, _, _ = run_facade(inputs, counters, names, card, dev)
    run_standalone_host(card, dev)
    check(prefetch is not None, "(r3) did not run")
    r4, err, timing = run_dcn_bf16(dev, counters, names, card)
    print(f"phase (r): {time.perf_counter() - t0:.1f} s")
    return {"r1": r1, "r4": r4}, err, timing


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
    from vido_slam_tpu_torch import native_system
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
            for name in ("png_unfilter", "jpeg_decode", "tiff_decode",
                         "gif_decode", "webp_decode")]
    host.append(os.path.basename(host_build.build("file_prefetcher",
                                                  ["-pthread"])))
    host += [os.path.basename(native_system.library_path()),
             os.path.basename(native_system.runner())]
    print(f"host build of the PNG unfilter, the JPEG, TIFF, GIF and WebP "
          f"decoders, the file prefetcher, the C facade and its standalone "
          f"host {host}: {time.perf_counter() - t0:.1f} s")
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
    seeded_roi = roi_cases(rng, dev)
    err_roi = check_roi_align(seeded_roi)
    err_roi_bf16 = check_roi_align_bf16(seeded_roi)
    del seeded_roi
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
        summarize("ab"[own], f"{path}: ATE {ate:.4f} m, launches "
                  f"{launches}, median {1e3 * np.median(steady):.2f} "
                  f"ms/frame")
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
    summarize("f", f"init frame {init_frame}, ATE SE(3) {ate_se3:.5f} m, "
              f"launches {launches}, median {1e3 * np.median(steady):.2f} "
              f"ms/frame")
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
    summarize("c", f"launches {launches}, median "
              f"{1e3 * np.median(steady):.2f} ms/pair")
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
    summarize("d", f"R-50-FPN launches {launches_roi} over {MASK_FRAMES} "
              f"frames; X-101 launches {launches}, {n_x101} detections")
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
    summarize("e", f"launches {launches}, median {online_ms:.2f} ms/frame")
    frame_online = frames[1].clone()
    ref_l.update(e_poses=system.map.poses, e_launches=launches)
    del system, outputs

    # (g) online VIO: phase (e)'s configuration and clip as IMU_RGBD
    system, times, after, scales, launches = run_online_vio(
        frames, tcw, model, counters)
    attempts = check_online_vio(system, after, scales, launches,
                                launches_online)
    launches_online_vio = launches
    summarize("g", f"attempts {attempts}, launches {launches}")
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
    summarize("l", f"launches {pipelined_launches}")
    del ref_l, frames, model

    # (j) bf16 perception: the online cell with the JAX bench's default
    # mask_dtype, and one call each with flow_dtype and compute_dtype
    bf16 = run_phase_j(dev, counters, names, online_ms)
    summarize("j", "bf16 builds: " + ", ".join(
        f"{k} err {v[1]:.2e}" for k, v in bf16.items() if v[1] is not None))

    # (h) the offline demo from files: the CLI on trees written here
    prefetch = {}
    demo_launches = run_phase_h(
        counters, names, seq, init_frame, vio_attempts,
        lambda root, n: prefetch.update(r3=run_prefetcher(root, n)))

    summarize("h", f"launches {demo_launches}")

    # (i) weights and sessions in and out
    phase_i_launches, phase_i_err = run_phase_i(dev, counters, names, seq,
                                                vo_poses)

    # (k) JPEG frames: the committed fixtures, and the CLI on a KITTI tree
    # of the committed .jpg frames
    summarize("i", f"launches {phase_i_launches}")
    jpeg_launches = run_phase_k(counters, names)
    summarize("k", f"launches {jpeg_launches}")

    # (s) progressive, multi-scan and DHT-less JPEG and BMP: the fixtures,
    # the CLI on progressive KITTI frames, infer_nets on a BMP frame
    with tempfile.TemporaryDirectory() as tmp:
        format_launches = run_phase_s(counters, tmp)
    summarize("s", f"launches {format_launches}")

    # (t) PBM/PGM/PPM, PAM, PFM, TIFF, HDR, Sun raster and CMYK/YCCK JPEG:
    # the fixtures, the CLI on PPM/PGM and TIFF trees, infer_nets on them
    with tempfile.TemporaryDirectory() as tmp:
        formats_t = run_phase_t(counters, tmp)
    summarize("t", f"launches {formats_t}")

    # (u) arithmetic-coded, lossless and 12-bit JPEG, GIF and lossless
    # WebP: the fixtures, the CLI on an arithmetic-coded tree with GIF
    # masks, infer_nets on a WebP pair and a GIF
    with tempfile.TemporaryDirectory() as tmp:
        formats_u = run_phase_u(counters, tmp)
    summarize("u", f"launches {formats_u}")

    # (v) TGA, PCX, SGI, QOI, XBM, IM, ICO and MSP (the formats PIL opens
    # and cv2 does not): the fixtures, decode ms, a detector training step
    # on a COCO tree of them, infer_nets on a QOI
    with tempfile.TemporaryDirectory() as tmp:
        formats_v, decode_v, err_roi_v, err_5b_v = run_phase_v(counters, tmp)
    err_roi = max(err_roi, err_roi_v)

    # (w) item 26c's TIFF modes: the fixtures, decode ms, the CLI on
    # JPEG-in-TIFF KITTI frames, a detector training step on JPEG-in-TIFF,
    # YCbCr, CMYK and LZMA TIFFs, infer_nets on a JPEG-in-TIFF
    with tempfile.TemporaryDirectory() as tmp:
        formats_w, decode_w, err_roi_w, err_5b_w = run_phase_w(counters, tmp)
    err_roi = max(err_roi, err_roi_w)

    # (x) lossy WebP (item 26d): the fixtures, decode ms, the CLI on lossy
    # WebP KITTI frames, a detector training step on lossy WebPs,
    # infer_nets flow on a lossy WebP pair
    with tempfile.TemporaryDirectory() as tmp:
        formats_x, decode_x, err_roi_x, err_5b_x = run_phase_x(counters, tmp)
    err_roi = max(err_roi, err_roi_x)

    # (m) the detector families: the DCN X-101, FBNet, RetinaNet, the
    # keypoint head and ROIPool
    family_launches, family_err, family_timing = run_phase_m(dev, counters,
                                                             names)
    summarize("m", f"launches {family_launches}, kernel 5 err "
              f"{family_err:.2e}")

    # (n) training: the detector CLI (kernels 5 and 5b), a detector step
    # card against CPU, MonoDepth2's self-supervised and supervised steps
    counters_n = counters + [roi_align.roi_align_multilevel_backward]
    train_launches, err_5b, timing_5b, infer_5b, train_fwd, err_train = \
        run_phase_n(dev, counters_n, [c.__name__ for c in counters_n])
    err_roi = max(err_roi, err_train)
    summarize("n", f"training launches {train_launches}, 5b err "
              f"{err_5b:.2e}")

    # (o) the depth data pipeline and the single-device evaluation paths
    eval_launches, err_lm_o, err_roi_o, o_runs = run_phase_o(
        dev, counters, names, seq)
    summarize("o", f"launches {eval_launches}")

    # (p) the multi-device paths on NCCL at world size 1, with the gloo
    # runs in processes of their own; (q) the inference CLI on the card
    with tempfile.TemporaryDirectory() as tmp:
        background = start_background(tmp)
        try:
            mesh_launches = run_phase_p(dev, counters_n,
                                        [c.__name__ for c in counters_n],
                                        o_runs)
            del o_runs
            infer_launches = run_phase_q(dev, counters, names, tmp)
        finally:
            finish_background(background)
    summarize("p", f"launches {mesh_launches}")
    summarize("q", f"launches {infer_launches}")

    # (r) the C facade and its standalone host on the card, the prefetcher
    # (its part ran in (h)), the DCN detector in bf16
    facade_launches, err_roi_r, timing_dcn_bf16 = run_phase_r(
        dev, counters, names, main_path_inputs(seq, "cuda", N_FRAMES),
        prefetch.get("r3"))
    summarize("r", f"launches {facade_launches}")

    # phase 3 on the arguments the main paths gave the kernels in one frame
    recorder, launches_lm = runs["pose_lm_batched"]
    calls, k = recorder.frame_calls()
    frame = [(f"main path frame {k} {what}", args, kw, True)
             for what, (args, kw) in zip(("camera", "objects"), calls)]
    err_lm = max(err_lm, err_lm_o, check_pose_lm(frame, cam))
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
        # phase (s): (s2) the CLI on progressive frames, (s3) infer_nets
        # on the BMP and progressive inputs
        e["image_formats_launches"] = {
            part: n[i] for part, n in format_launches.items()
            if part != "decode_ms"}
        # phase (t): (t2) the CLI on the PNG, PPM/PGM and TIFF trees, (t3)
        # infer_nets on PPM, TIFF and CMYK JPEG inputs
        e["image_formats_t_launches"] = {
            part: n[i] for part, n in formats_t.items()
            if part != "decode_ms"}
        # phase (u): (u2) the CLI on the baseline and arithmetic-coded
        # trees, (u3) infer_nets on a lossless WebP pair and a GIF
        e["image_formats_u_launches"] = {
            part: n[i] for part, n in formats_u.items()
            if part != "decode_ms"}
        # phase (v): (v3) the training step on the COCO tree of item 29's
        # formats and infer_nets on a QOI
        e["image_formats_v_launches"] = {part: n[i] for part, n in
                                         formats_v.items()}
        # phase (w): (w3) the CLI on JPEG-in-TIFF frames, the training step
        # on item 26c's TIFFs and infer_nets on a JPEG-in-TIFF
        e["image_formats_w_launches"] = {part: n[i] for part, n in
                                         formats_w.items()}
        # phase (x): (x3) the CLI on lossy WebP frames, the training step on
        # lossy WebPs and infer_nets flow on a lossy WebP pair
        e["image_formats_x_launches"] = {part: n[i] for part, n in
                                         formats_x.items()}
        # (l1) offline VO, (l2) bJoint, (l3) online pairs, (l4) online VIO
        # pairs, all pipelined
        for cell, key in (("l1", "pipelined_vo"), ("l2", "pipelined_joint"),
                          ("l3", "pipelined_pairs"),
                          ("l4", "pipelined_vio_pairs")):
            e[f"{key}_launches"] = pipelined_launches[cell][i]
        # the bf16 build (phase (j)): its launches there, its device ms on
        # the arguments (j) gave it, the float32 build's on the same values
        n, err, t, *path = bf16.get(e["name"], (None, None, (None,) * 5))
        e.update(bf16_launches=n, bf16_max_abs_err=err, bf16_ms=t[0],
                 bf16_plain_ms=t[1], bf16_bound_ms=t[2], bf16_bound_by=t[3],
                 f32_ms_same_values=t[4])
        # kernels 3 and 4's bf16 builds at the flow path's five levels
        for p in path:
            e.update(bf16_flow_path_ms=p[0], bf16_flow_path_plain_ms=p[1],
                     bf16_flow_path_bound_ms=p[2],
                     bf16_flow_path_bound_by=p[3],
                     bf16_flow_path_f32_ms=p[4])
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
        e["training_launches"] = train_launches[i]
        # phase (p): (p1) the mesh detector steps, (p3) the mesh
        # multi_sequence_tracking, (p4) the mesh sharded_coco_evaluation;
        # phase (q): the inference CLI's flow and detectors
        e["multi_device_launches"] = {part: n[i] for part, n in
                                      mesh_launches.items()}
        e["infer_nets_launches"] = {part: n[i] for part, n in
                                    infer_launches.items()}
        # phase (o): (o1) the depth trainer on the dataset's batches, (o2)
        # multi_sequence_tracking, (o4) sharded_coco_evaluation
        e["evaluation_launches"] = {part: n[i] for part, n in
                                    eval_launches.items()}
        if e["name"] == "roi_align_multilevel":
            e["max_abs_err"] = max(e["max_abs_err"], err_roi_o)
        # phase (r): (r1) the C facade over (a)'s frames, (r4) the DCN
        # detector in bf16; kernel 5's bf16 build on (r4)'s last frame
        e["facade_launches"] = facade_launches["r1"][i]
        e["dcn_bf16_launches"] = facade_launches["r4"][i]
        if e["name"] == "roi_align_multilevel":
            t = timing_dcn_bf16
            e.update(dcn_bf16_max_abs_err=err_roi_r, dcn_bf16_ms=t[0],
                     dcn_bf16_plain_ms=t[1], dcn_bf16_bound_ms=t[2],
                     dcn_bf16_bound_by=t[3], dcn_bf16_f32_ms_same_values=t[4])
        if e["name"] == "roi_align_multilevel":
            e["bf16_seeded_max_abs_err"] = err_roi_bf16
            e.update(training_step_ms=train_fwd[0],
                     training_step_bound_ms=train_fwd[2])
    entries.append(dict(
        name="roi_align_multilevel_backward", route="cuda",
        source="vido_slam_tpu_torch/csrc/roi_align_backward.cu",
        replaces="vido_slam_tpu/ops/roi_align.py:112 (XLA autodiff of "
                 "roi_align_multilevel; no Pallas kernel)",
        launches=train_launches[5], max_abs_err=max(err_5b, err_5b_v,
                                                    err_5b_w, err_5b_x),
        **dict(zip(keys, timing_5b)), library_ms=None,
        training_launches=train_launches[5],
        image_formats_v_launches={part: n[5] for part, n in
                                  formats_v.items()},
        image_formats_w_launches={part: n[5] for part, n in
                                  formats_w.items()},
        image_formats_x_launches={part: n[5] for part, n in
                                  formats_x.items()},
        multi_device_launches={part: n[5] for part, n in
                               mesh_launches.items()},
        inference_shapes_ms=infer_5b[0],
        inference_shapes_bound_ms=infer_5b[2]))
    summarize("kernels", ", ".join(
        f"{e['name']} launches {e['launches']} err {e['max_abs_err']:.2e}"
        for e in entries))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print_summary()
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException as e:
        print_summary(e)
        raise
    sys.exit(code)
