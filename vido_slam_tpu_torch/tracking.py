"""Per-frame tracking — Tracking::GrabImageRGBD / Track() (Tracking.cc:283-782,
1081-1509); counterpart of ``vido_slam_tpu/tracking.py`` for the VO and VIO
paths: offline from precomputed depth, flow and mask (``track``), or online
from raw BGR frames through an attached perception model (``track_frames``);
background features grid-sampled at random or, with UseSampleFeature=0 and
a gray image, picked by FAST score.

Each frame ``_track_step`` runs on the tracker's device: mask repair, flow
propagation of the feature slots, the camera pose, scene flow and object
selection, up to ``max_objects`` object motions (one batched kernel launch),
feature renewal and, with ``fused_ba``, the window BA over device-side
rings. The pose solves are RANSAC + LM on fixed correspondences, or with
``joint_flow`` (the reference's bJoint) RANSAC + the joint flow+pose solve,
whose optimized flows move the inlier keypoints. The host then copies the
outputs it needs in one transfer, does the tracking-id bookkeeping and the
map records and, by default (``fused_ba=False``, as in the JAX package),
assembles the window BA from the map records and solves it.

With ``use_imu`` (VIO, Tracking.cc:784-1077) the tracker also queues IMU
samples, preintegrates each frame interval, and once the gates open runs
the staged inertial init every frame until it succeeds, then the scale
refinement every ~10 s; either rescales and gravity-aligns the map and the
device state.

With ``pipelined`` (tracking.py:561-575 of the JAX package) the host
records frame t-1 while the device computes frame t: each call enqueues
the step, starts the copy of its outputs to pinned host memory, then
records the previous frame from its finished copy. Records lag one frame
(two with ``track_frames_pair``) until ``finish()``, and the call returns
the device tensor ``state.Tcw`` without waiting for it (``np.asarray`` of
a ``cuda`` tensor fails: call ``.cpu()``). With the fused window BA the
pipelined run computes what the synchronous one does. With the
host-assembled one, the window BA runs over the map up to frame t-1 and
its pose correction lands on frame t's device pose, so it is its own mode
(the JAX package's pipelined one), not the synchronous mode a frame late.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from vido_slam_tpu_torch.config import Config
from vido_slam_tpu_torch.estimation.assembly import (
    assemble_full_problem,
    assemble_static_window,
)
from vido_slam_tpu_torch.estimation.flow_joint import (
    estimate_camera_pose_joint,
    estimate_object_motions_joint_batched,
)
from vido_slam_tpu_torch.estimation.full_ba import solve_full_ba
from vido_slam_tpu_torch.estimation.imu_init import (
    estimate_gravity_direction,
    initialize_imu,
    linear_alignment,
)
from vido_slam_tpu_torch.estimation.pose import (
    estimate_camera_pose,
    estimate_object_motions_batched,
)
from vido_slam_tpu_torch.estimation.window_ba import solve_window_ba
from vido_slam_tpu_torch.frontend.association import update_mask
from vido_slam_tpu_torch.frontend.features import (
    FeatureSet,
    gather_depth_bilinear,
    propagate_features,
    sample_background_features,
    sample_object_points,
)
from vido_slam_tpu_torch.frontend.objects import (
    MAX_SEM,
    ObjectStats,
    ObjectTracker,
    assign_point_labels,
    compute_object_stats,
)
from vido_slam_tpu_torch.frontend.renewal import renew_features
from vido_slam_tpu_torch.frontend.sceneflow import (
    scene_flow_world,
    unproject_to_world,
)
from vido_slam_tpu_torch.geometry.camera import Camera, convert_depth
from vido_slam_tpu_torch.geometry.se3 import inverse_se3
from vido_slam_tpu_torch.imu.preintegration import (
    ImuCalib,
    compose_preints,
    init_preintegration,
    integrate_measurements,
    prepare_segments,
    to_numpy,
)
from vido_slam_tpu_torch.ops.fast import fast_score_map
from vido_slam_tpu_torch.slam_map import FrameRecord, ObjectObservation, SlamMap
from vido_slam_tpu_torch.utils import prng
from vido_slam_tpu_torch.utils.device import resolve_device
from vido_slam_tpu_torch.utils.order import top_k
from vido_slam_tpu_torch.utils.transfer import to_host, to_host_async

MIN_OBJ_INLIERS = 50  # Tracking.cc:1218
# The IMU-side math (preintegration, inertial init, scale refinement) runs
# on the CPU whatever the tracker's device, as the JAX package pins it to
# its host backend (tracking.py:603-611 there): its problems are a few
# hundred floats solved by host-driven loops of tiny ops, where every
# launch and stop test read back from the card would cost more than the
# arithmetic. The tracker's state, the step, the window BA and the kernels
# stay on the card; only the rescale after an init touches the state.
IMU_DEVICE = torch.device("cpu")


class TrackState(NamedTuple):
    """Device-side state carried between frames."""

    stat: FeatureSet
    obj: FeatureSet
    Tcw: torch.Tensor
    velocity: torch.Tensor
    has_velocity: torch.Tensor
    # last frame's world motion per semantic bin (motion-model hypothesis)
    bin_motion: torch.Tensor      # (MAX_SEM, 4, 4)
    bin_has_motion: torch.Tensor  # (MAX_SEM,) bool
    last_mask: torch.Tensor       # (H, W) int32
    last_flow: torch.Tensor       # (H, W, 2)
    # window-BA rings, shifted so that index order is frame order; slot
    # index is track identity
    ba_obs: torch.Tensor          # (W, N_bg, 3) camera-frame backprojections
    ba_obs_valid: torch.Tensor    # (W, N_bg)
    ba_age: torch.Tensor          # (N_bg,) consecutive-valid run of the slot
    ba_Twc: torch.Tensor          # (W, 4, 4)
    ba_odom: torch.Tensor         # (W, 4, 4) motion frame w-1 -> w
    ba_odom_valid: torch.Tensor   # (W,)
    ba_nframes: torch.Tensor      # scalar int32
    key: torch.Tensor             # (2,) threefry key


class StepOutputs(NamedTuple):
    """What the host reads per frame. In light record mode the per-point
    fields are (0,)-shaped placeholders."""

    Tcw: torch.Tensor
    cam_motion: torch.Tensor
    stats: ObjectStats
    obj_sem_values: torch.Tensor   # (K,)
    obj_active: torch.Tensor       # (K,)
    obj_motion: torch.Tensor       # (K, 4, 4)
    obj_ok: torch.Tensor           # (K,)
    obj_num_inliers: torch.Tensor  # (K,)
    obj_centroid: torch.Tensor     # (K, 3)
    obj_speed: torch.Tensor        # (K,)
    point_labels: torch.Tensor     # (N_obj,) int16
    stat_uv: torch.Tensor
    stat_depth: torch.Tensor
    stat_valid: torch.Tensor
    stat_is_new: torch.Tensor
    obj_uv: torch.Tensor
    obj_depth: torch.Tensor
    obj_valid: torch.Tensor
    obj_is_new: torch.Tensor
    obj_sem: torch.Tensor          # int16
    ba_Twc: torch.Tensor           # (W, 4, 4)
    ba_points: torch.Tensor        # (P, 3)
    ba_slots: torch.Tensor         # (P,) int16
    ba_point_ok: torch.Tensor      # (P,)
    ba_nframes: torch.Tensor


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """The online step's gray image of an (H, W, 3) BGR frame:
    0.299 R + 0.587 G + 0.114 B in that order (tracking.py:1259-1261 of the
    JAX package). ``System.TrackRGBD`` takes the channel mean instead."""
    return (0.299 * bgr[..., 2] + 0.587 * bgr[..., 1]
            + 0.114 * bgr[..., 0])


def _select_objects(stats: ObjectStats, max_objects: int):
    """Top-K tracked semantic bins by point count (ties: lower bin)."""
    prio = torch.where(stats.is_tracked, stats.count,
                       torch.full_like(stats.count, -1.0))
    vals, bins = top_k(prio, max_objects)
    active = vals > 0
    return torch.where(active, bins, torch.zeros_like(bins)).to(
        torch.int32), active


def _track_step(state: TrackState, depth, flow, mask, cam: Camera, *,
                n_bg: int, n_obj: int, max_objects: int, th_depth_bg: float,
                th_depth_obj: float, sf_mg_thres: float, sf_ds_thres: float,
                height: int, width: int, joint_flow: bool = False,
                fused_ba: bool = False, ba_window: int = 20,
                ba_points: int = 1000, ba_iters: int = 10,
                record_light: bool = False, use_fast: bool = False,
                gray: Optional[torch.Tensor] = None):
    """One frame; returns (new_state, StepOutputs). With ``use_fast`` the
    renewal samples FAST corners of ``gray`` (H, W)."""
    if use_fast and gray is None:
        raise ValueError("_track_step: use_fast needs the gray image")
    dev = depth.device
    f32 = torch.float32
    keys = prng.split(state.key, 4)
    k_cam, k_obj, k_fresh, k_next = keys[0], keys[1], keys[2], keys[3]
    eye4 = torch.eye(4, dtype=f32, device=dev)

    # 0. mask repair
    mask = update_mask(mask, state.last_mask, state.last_flow)

    # 1. inherit correspondences
    cur_stat = propagate_features(state.stat, depth, mask, flow,
                                  th_depth=th_depth_bg)
    cur_stat = cur_stat._replace(valid=cur_stat.valid & (cur_stat.sem == 0))
    cur_obj = propagate_features(state.obj, depth, mask, flow,
                                 th_depth=th_depth_obj)

    # 2. camera pose
    pts3d_stat = unproject_to_world(cam, state.stat.uv, state.stat.depth,
                                    state.Tcw)
    T_mm = torch.where(state.has_velocity, state.velocity @ state.Tcw,
                       state.Tcw)
    if joint_flow:
        # bJoint (Tracking.cc:1133-1134): inlier keypoints move to
        # obs_last + optimized flow, and their depth is re-read there
        est, flow_opt = estimate_camera_pose_joint(
            k_cam, pts3d_stat, state.stat.uv, cur_stat.uv,
            cur_stat.valid & state.stat.valid, cam, T_mm,
            cam.backproject(cur_stat.uv, cur_stat.depth))
        uv_j = torch.where(est.inliers[:, None], state.stat.uv + flow_opt,
                           cur_stat.uv)
        d_j = gather_depth_bilinear(depth, uv_j)
        cur_stat = cur_stat._replace(
            uv=uv_j, depth=torch.where(est.inliers & (d_j > 0), d_j,
                                       cur_stat.depth))
    else:
        est = estimate_camera_pose(
            k_cam, pts3d_stat, cur_stat.uv, cur_stat.valid & state.stat.valid,
            cam, T_mm, cam.backproject(cur_stat.uv, cur_stat.depth))
    Tcw = est.T
    velocity = Tcw @ inverse_se3(state.Tcw)
    cam_motion = inverse_se3(velocity)

    # 3/4. scene flow + object stats
    obj_valid = cur_obj.valid & state.obj.valid
    pts3d_obj_pre = unproject_to_world(cam, state.obj.uv, state.obj.depth,
                                       state.Tcw)
    _, sf_norm, sf_ok = scene_flow_world(
        cam, state.obj.uv, state.obj.depth, state.Tcw, cur_obj.uv,
        cur_obj.depth, Tcw, state.obj.sem, cur_obj.sem, obj_valid)
    stats = compute_object_stats(
        cur_obj.uv, cur_obj.sem, state.obj.sem, sf_norm, cur_obj.depth, sf_ok,
        height=height, width=width, sf_mg_thres=sf_mg_thres,
        sf_ds_thres=sf_ds_thres, th_depth_obj=th_depth_obj)
    sem_values, active = _select_objects(stats, max_objects)
    # provisional per-point labels: the semantic value itself (the host
    # rewrites them to global tracking ids)
    sem_as_id = torch.arange(MAX_SEM, dtype=torch.int32, device=dev)
    point_labels = assign_point_labels(cur_obj.sem, sf_ok, stats, sem_as_id)

    # 5. object motions
    sv = sem_values.to(torch.int64)
    prev_bins = stats.assoc_prev_sem[sv].to(torch.int64)
    H_mm = state.bin_motion[prev_bins]
    has_mm = state.bin_has_motion[prev_bins] & active
    obj_masks = ((cur_obj.sem[None, :] == sem_values[:, None])
                 & active[:, None] & (point_labels[None, :] > 0))
    obj_pc_cur = cam.backproject(cur_obj.uv, cur_obj.depth)
    obj_keys = prng.split(k_obj, max_objects)
    if joint_flow:
        H, obj_inl, n_inl, obj_flow = estimate_object_motions_joint_batched(
            obj_keys, Tcw, pts3d_obj_pre, state.obj.uv, cur_obj.uv,
            obj_masks, cam, H_mm, has_mm, obj_pc_cur)
    else:
        H, obj_inl, n_inl = estimate_object_motions_batched(
            obj_keys, Tcw, pts3d_obj_pre, cur_obj.uv, obj_masks, cam, H_mm,
            has_mm, obj_pc_cur)
    wK = obj_masks.to(f32)
    cent = (wK @ pts3d_obj_pre) / torch.clamp(wK.sum(dim=1, keepdim=True),
                                              min=1.0)
    sp_v = H[:, :3, 3] - ((torch.eye(3, device=dev) - H[:, :3, :3])
                          @ cent[..., None])[..., 0]
    speed = torch.sqrt(torch.sum(sp_v * sp_v, dim=-1)) * 36.0
    if joint_flow:
        # updateflow write-back (Optimizer.cc:3224-3232); the per-object
        # masks are disjoint, so a masked sum combines the K flow fields
        upd = obj_masks & obj_inl
        moved = upd.any(dim=0)
        fl_comb = torch.sum(upd.to(f32)[..., None] * obj_flow, dim=0)
        uv_j = torch.where(moved[:, None], state.obj.uv + fl_comb,
                           cur_obj.uv)
        d_j = gather_depth_bilinear(depth, uv_j)
        cur_obj = cur_obj._replace(
            uv=uv_j, depth=torch.where(moved & (d_j > 0), d_j,
                                       cur_obj.depth))
    ok = active & (n_inl >= MIN_OBJ_INLIERS)
    H = torch.where(ok[:, None, None], H, eye4)
    speed = torch.where(ok, speed, torch.zeros_like(speed))

    # failed objects' points fall back to -1 (Tracking.cc:1391-1398)
    is_failed_bin = torch.zeros(MAX_SEM + 1, dtype=torch.bool, device=dev)
    is_failed_bin[torch.where(active & ~ok, sv, MAX_SEM)] = True
    sem_c = torch.clamp(cur_obj.sem, 0, MAX_SEM - 1).to(torch.int64)
    point_labels = torch.where(is_failed_bin[:MAX_SEM][sem_c],
                               torch.full_like(point_labels, -1),
                               point_labels)

    # motion table for the next frame: this frame's successful objects only
    ok_idx = torch.where(ok, sv, MAX_SEM)
    bin_motion = torch.cat([state.bin_motion, eye4[None]])
    bin_motion[ok_idx] = H
    bin_motion = bin_motion[:MAX_SEM]
    bin_has_motion = torch.zeros(MAX_SEM + 1, dtype=torch.bool, device=dev)
    bin_has_motion[ok_idx] = True
    bin_has_motion = bin_has_motion[:MAX_SEM]
    obj_inlier_any = torch.any(obj_inl & obj_masks, dim=0)

    # 6. renewal
    score_map = fast_score_map(gray) if use_fast else None
    fresh_bg = sample_background_features(k_fresh, mask, depth, flow,
                                          score_map, n=n_bg,
                                          th_depth=th_depth_bg)
    fresh_obj = sample_object_points(mask, depth, flow, n=n_obj,
                                     th_depth=th_depth_obj)
    renewed_stat, stat_new = renew_features(cur_stat, est.inliers, fresh_bg,
                                            height=height, width=width)
    keep_obj = obj_inlier_any & (point_labels > 0)
    renewed_obj, obj_new = renew_features(cur_obj, keep_obj, fresh_obj,
                                          height=height, width=width)
    fresh_labels = assign_point_labels(renewed_obj.sem, renewed_obj.valid,
                                       stats, sem_as_id)
    point_labels = torch.where(obj_new, fresh_labels, point_labels)

    # 7. window BA over the device rings (PartialBatchOptimization); the
    # host-assembled mode keeps the rings too, so the state is the JAX one
    W = ba_window
    obs_cur = cam.backproject(renewed_stat.uv, renewed_stat.depth)
    prev_valid = state.ba_obs_valid[-1]
    age = torch.where(
        renewed_stat.valid,
        torch.where(stat_new | ~prev_valid, torch.ones_like(state.ba_age),
                    state.ba_age + 1),
        torch.zeros_like(state.ba_age))
    ba_obs = torch.cat([state.ba_obs[1:], obs_cur[None]])
    ba_obs_valid = torch.cat([state.ba_obs_valid[1:], renewed_stat.valid[None]])
    ba_Twc = torch.cat([state.ba_Twc[1:], inverse_se3(Tcw)[None]])
    ba_odom = torch.cat([state.ba_odom[1:], cam_motion[None]])
    # the appended pair's motion is measured this frame, so its odometry
    # edge is always valid
    ba_odom_valid = torch.cat([state.ba_odom_valid[1:],
                               torch.ones(1, dtype=torch.bool, device=dev)])
    nf = torch.clamp(state.ba_nframes + 1, max=W)

    if fused_ba:
        wr = torch.arange(W, device=dev)
        frame_valid = wr >= W - nf
        run = torch.clamp(age, max=W)
        in_run = wr[:, None] >= (W - run)[None, :]
        wv = ba_obs_valid & in_run & frame_valid[:, None]
        count = wv.sum(dim=0)
        score = torch.where(count >= 3, count, torch.full_like(count, -1))
        _, sel = top_k(score, ba_points)
        sel_ok = score[sel] > 0
        # anchors from the first in-run observation through the current
        # ring pose (measurement-derived each solve)
        first_w = torch.argmax(wv.to(torch.int32), dim=0)
        obs_first = ba_obs[first_w, torch.arange(ba_obs.shape[1], device=dev)]
        T_first = ba_Twc[first_w]
        anchors = ((T_first[:, :3, :3] @ obs_first[..., None])[..., 0]
                   + T_first[:, :3, 3])
        res = solve_window_ba(
            torch.where(frame_valid[:, None, None], ba_Twc, eye4),
            ba_odom[1:],
            ba_odom_valid[1:] & frame_valid[:-1] & frame_valid[1:],
            anchors[sel], ba_obs[:, sel], wv[:, sel], sel_ok, frame_valid,
            max_iters=ba_iters)
        Tcw_out = inverse_se3(res.Twc[-1])
        ba_Twc = torch.where(frame_valid[:, None, None], res.Twc, ba_Twc)
        out_ba = (res.Twc, res.points, sel.to(torch.int32), sel_ok, nf)
    else:
        Tcw_out = Tcw
        P = ba_points
        out_ba = (ba_Twc, torch.zeros(P, 3, device=dev),
                  torch.zeros(P, dtype=torch.int32, device=dev),
                  torch.zeros(P, dtype=torch.bool, device=dev), nf)

    new_state = TrackState(
        stat=renewed_stat, obj=renewed_obj, Tcw=Tcw_out, velocity=velocity,
        has_velocity=torch.ones((), dtype=torch.bool, device=dev),
        bin_motion=bin_motion, bin_has_motion=bin_has_motion,
        last_mask=mask, last_flow=flow, ba_obs=ba_obs,
        ba_obs_valid=ba_obs_valid, ba_age=age, ba_Twc=ba_Twc,
        ba_odom=ba_odom, ba_odom_valid=ba_odom_valid, ba_nframes=nf,
        key=k_next)
    common = dict(
        Tcw=Tcw, cam_motion=cam_motion, stats=stats,
        obj_sem_values=sem_values, obj_active=active, obj_motion=H,
        obj_ok=ok, obj_num_inliers=n_inl, obj_centroid=cent, obj_speed=speed,
        ba_Twc=out_ba[0], ba_nframes=out_ba[4])
    if record_light:
        def e(*s, dtype=f32):
            return torch.zeros(s, dtype=dtype, device=dev)
        outputs = StepOutputs(
            **common, point_labels=e(0, dtype=torch.int16), stat_uv=e(0, 2),
            stat_depth=e(0), stat_valid=e(0, dtype=torch.bool),
            stat_is_new=e(0, dtype=torch.bool), obj_uv=e(0, 2),
            obj_depth=e(0), obj_valid=e(0, dtype=torch.bool),
            obj_is_new=e(0, dtype=torch.bool), obj_sem=e(0, dtype=torch.int16),
            ba_points=e(0, 3), ba_slots=e(0, dtype=torch.int16),
            ba_point_ok=e(0, dtype=torch.bool))
    else:
        outputs = StepOutputs(
            **common, point_labels=point_labels.to(torch.int16),
            stat_uv=renewed_stat.uv, stat_depth=renewed_stat.depth,
            stat_valid=renewed_stat.valid, stat_is_new=stat_new,
            obj_uv=renewed_obj.uv, obj_depth=renewed_obj.depth,
            obj_valid=renewed_obj.valid, obj_is_new=obj_new,
            obj_sem=renewed_obj.sem.to(torch.int16), ba_points=out_ba[1],
            ba_slots=out_ba[2].to(torch.int16), ba_point_ok=out_ba[3])
    return new_state, outputs


class Tracker:
    """VO front-end orchestrator (System owns one). Runs on ``device``
    (default ``cuda``; asking for it without a card raises)."""

    def __init__(self, config: Config, *, n_bg: Optional[int] = None,
                 n_obj: int = 4000, max_objects: int = 8, seed: int = 0,
                 local_ba: bool = True, ba_max_points: int = 1000,
                 ba_iters: int = 15, use_imu: bool = False,
                 imu_max_frames: int = 32, imu_max_segments: int = 64,
                 imu_init_stride: int = 3, pipelined: bool = False,
                 joint_flow: bool = False, fused_ba: bool = False,
                 record: str = "auto", lm_pallas: Optional[bool] = None,
                 device=None):
        """The JAX ``Tracker``'s arguments. ``lm_pallas`` picks the JAX
        package's Pallas or XLA LM, which its tests hold equal; here the
        CUDA kernel runs either way. ``use_imu`` turns VIO on; the
        ``imu_*`` arguments shape it: the init window in frames, the
        integration segments an interval, and the stride of the composed
        init pairs. ``pipelined`` records each frame during the next call
        (module docstring); VIO with the host-assembled window BA runs
        unpipelined, as in the JAX package."""
        self.device = resolve_device(device)
        self.cfg = config
        c = config.camera
        self.cam = Camera.create(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
                                 dist=c.dist, width=c.width, height=c.height,
                                 bf=c.bf, fps=c.fps)
        self.n_bg = n_bg or config.system.max_track_points_bg
        self.n_obj = n_obj
        self.max_objects = max_objects
        self.key = prng.PRNGKey(seed, self.device)
        self.map = SlamMap()
        self.object_tracker = ObjectTracker()
        self.state: Optional[TrackState] = None
        self.frame_id = 0
        self.local_ba = local_ba
        # fused: the window BA runs inside the step over device rings;
        # otherwise it is assembled from the map records after each frame
        self.fused_ba = fused_ba and local_ba
        # VIO's map rewrite would race the host-assembled BA in flight
        self.pipelined = pipelined and (not use_imu or self.fused_ba)
        # pipelined: the previous frame's (HostCopy, timestamp, Tcw_gt,
        # step seconds), the window BA in flight (problem, result), and
        # track_frames_pair's two frames a call
        self._pending = None
        self._pending_ba = None
        self._pending_q: list = []
        self.ba_max_points = ba_max_points
        self.ba_iters = ba_iters
        # the reference's bJoint: joint flow+pose solves instead of LM on
        # fixed correspondences
        self.joint_flow = joint_flow
        # UseSampleFeature=0 asks for FAST corners on the gray image
        self.use_fast = not config.system.use_sample_feature
        # attach_perception: (model, depth mode, DepthMapFactor, bf, scale)
        # and the step's arguments at that time
        self._attached = None
        self._frames_kwargs = None
        if record not in ("auto", "full", "light"):
            raise ValueError(f"record must be 'auto', 'full' or 'light', "
                             f"got {record!r}")
        if record == "auto":
            self.record_light = bool(self.fused_ba
                                     and config.system.choose_data != 2)
        else:
            self.record_light = record == "light"
        if self.record_light and local_ba and not self.fused_ba:
            raise ValueError("record='light' needs the fused window BA: the "
                             "host-assembled one reads per-point records")
        # ---- VIO state (Tracking.cc:112-121, 784-1077) ----
        self.use_imu = use_imu
        self.imu_max_frames = imu_max_frames
        self.imu_max_segments = imu_max_segments
        # frames per composed preintegration pair of the init's second
        # candidate (see _try_initialize_imu)
        self.imu_init_stride = imu_init_stride
        self.imu_scale = 1.0           # mScale
        self.imu_initialized = False
        self.imu_init_attempts = 0     # InitializeIMU runs
        self.imu_refine_runs = 0       # ScaleRefinement runs
        self.imu_bias = np.zeros(6, np.float32)
        self.Rwg: Optional[np.ndarray] = None
        self._imu_queue: list = []     # pending samples (.a, .w, .t)
        self._preints: list = []       # one state a consecutive frame pair
        self._last_ts: Optional[float] = None
        self._last_scale_refine_t = 0.0
        if use_imu:
            i = config.imu
            self.imu_calib = ImuCalib.from_config(
                i.Tbc, i.noise_gyro, i.noise_acc, i.gyro_walk, i.acc_walk,
                i.frequency, device=IMU_DEVICE)

    def _step_kwargs(self):
        s = self.cfg.system
        return dict(
            n_bg=self.n_bg, n_obj=self.n_obj, max_objects=self.max_objects,
            th_depth_bg=s.th_depth_bg, th_depth_obj=s.th_depth_obj,
            sf_mg_thres=s.sf_mg_thres, sf_ds_thres=s.sf_ds_thres,
            height=self.cam.height, width=self.cam.width,
            joint_flow=self.joint_flow, fused_ba=self.fused_ba,
            ba_window=s.window_size,
            ba_points=self.ba_max_points, ba_iters=self.ba_iters,
            record_light=self.record_light, use_fast=self.use_fast)

    def _next_key(self):
        keys = prng.split(self.key, 2)
        self.key = keys[0]
        return keys[1]

    def _inputs(self, depth, flow, mask):
        def put(x, dtype):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x))
            return x.to(device=self.device, dtype=dtype)
        return (put(depth, torch.float32), put(flow, torch.float32),
                put(mask, torch.int32))

    def _gray(self, image) -> torch.Tensor:
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.asarray(image, np.float32))
        return image.to(device=self.device, dtype=torch.float32)

    # ------------------------------------------------------------------
    def initialize(self, depth, flow, mask, Tcw_gt=None, timestamp=0.0,
                   image=None):
        """First frame (Tracking::Initialization, Tracking.cc:1512-1580):
        sample features, pose = identity, record. FAST picks the background
        features only when it is on and ``image`` (gray) is given."""
        depth, flow, mask = self._inputs(depth, flow, mask)
        s = self.cfg.system
        dev = self.device
        score_map = None
        if self.use_fast and image is not None:
            score_map = fast_score_map(self._gray(image))
        stat = sample_background_features(self._next_key(), mask, depth, flow,
                                          score_map, n=self.n_bg,
                                          th_depth=s.th_depth_bg)
        obj = sample_object_points(mask, depth, flow, n=self.n_obj,
                                   th_depth=s.th_depth_obj)
        eye4 = torch.eye(4, dtype=torch.float32, device=dev)
        W = s.window_size
        ba_obs = torch.zeros(W, self.n_bg, 3, device=dev)
        ba_obs[-1] = self.cam.backproject(stat.uv, stat.depth)
        ba_obs_valid = torch.zeros(W, self.n_bg, dtype=torch.bool, device=dev)
        ba_obs_valid[-1] = stat.valid
        self.state = TrackState(
            stat=stat, obj=obj, Tcw=eye4, velocity=eye4,
            has_velocity=torch.zeros((), dtype=torch.bool, device=dev),
            bin_motion=eye4.expand(MAX_SEM, 4, 4).clone(),
            bin_has_motion=torch.zeros(MAX_SEM, dtype=torch.bool, device=dev),
            last_mask=mask, last_flow=flow, ba_obs=ba_obs,
            ba_obs_valid=ba_obs_valid, ba_age=stat.valid.to(torch.int32),
            ba_Twc=eye4.expand(W, 4, 4).clone(),
            ba_odom=eye4.expand(W, 4, 4).clone(),
            ba_odom_valid=torch.zeros(W, dtype=torch.bool, device=dev),
            ba_nframes=torch.ones((), dtype=torch.int32, device=dev),
            key=self._next_key())
        h = to_host((stat.uv, stat.depth, stat.valid,
                     unproject_to_world(self.cam, stat.uv, stat.depth, eye4),
                     obj.uv, obj.depth, obj.valid, obj.sem,
                     unproject_to_world(self.cam, obj.uv, obj.depth, eye4)))
        s_uv, s_d, s_v, s_3d, o_uv, o_d, o_v, o_s, o_3d = h
        self.map.add_frame(FrameRecord(
            frame_id=self.frame_id, timestamp=float(timestamp),
            Tcw=np.eye(4, dtype=np.float32),
            Tcw_gt=None if Tcw_gt is None else np.asarray(Tcw_gt),
            stat_uv=s_uv, stat_depth=s_d, stat_valid=s_v,
            stat_is_new=np.ones(self.n_bg, bool), stat_3d=s_3d,
            obj_uv=o_uv, obj_depth=o_d, obj_valid=o_v,
            obj_is_new=np.ones(self.n_obj, bool), obj_sem=o_s,
            obj_label=np.full(self.n_obj, -1, np.int32), obj_3d=o_3d,
            objects=[], timing={}))
        self.frame_id += 1
        self._last_ts = float(timestamp)

    def track(self, depth, flow, mask, Tcw_gt=None, timestamp=None,
              image=None):
        """Process one frame; returns the camera pose Tcw (4, 4), a numpy
        array or, pipelined, the state's device tensor. ``image`` is the
        gray frame that FAST reads (UseSampleFeature=0); without it the
        features are grid-sampled at random, from then on, as in the JAX
        tracker. The default timestamp is frame_id / fps, where pipelined
        frame_id does not count the frame in flight: frames 1 and 2 both
        get 1 / fps there, as in the JAX package."""
        if image is None:
            self.use_fast = False
        if self.state is None:
            self.initialize(depth, flow, mask, Tcw_gt,
                            timestamp if timestamp is not None else 0.0,
                            image=image)
            return np.eye(4, dtype=np.float32)
        if timestamp is None:
            timestamp = self.frame_id / self.cam.fps
        t_start = time.perf_counter()
        # VIO: preintegrate the inter-frame interval (Tracking.cc:784-887)
        if self.use_imu:
            self._vio_sync_before_dispatch()
            if self._last_ts is not None:
                self._preints.append(self._preintegrate_interval(
                    self._last_ts, float(timestamp)))
        self._last_ts = float(timestamp)
        depth, flow, mask = self._inputs(depth, flow, mask)
        gray = self._gray(image) if self.use_fast else None
        self.state, out = _track_step(self.state, depth, flow, mask, self.cam,
                                      gray=gray, **self._step_kwargs())
        return self._post_step(out, float(timestamp), Tcw_gt, t_start)

    def _vio_sync_before_dispatch(self) -> None:
        """Pipelined VIO: where the init or the scale refinement could act
        (``_vio_event_due``), record what is in flight and run it before
        the next dispatch, whose depth and state its rescale changes
        (tracking.py:1090-1097, 1324-1333)."""
        if self.pipelined and self._vio_event_due(self._last_ts):
            self._finalize_pending_ba()
            self._process_pending()
            self._vio_update(self._last_ts)

    def _post_step(self, out, timestamp, Tcw_gt, t_start):
        if self.pipelined:
            # the copy of this frame's outputs rides right behind its step;
            # then the previous window BA is folded into the map and the
            # previous frame recorded while the device works on this one
            copy = to_host_async(out)
            self._finalize_pending_ba()
            self._process_pending()
            self._pending = (copy, timestamp,
                             None if Tcw_gt is None else np.asarray(Tcw_gt),
                             time.perf_counter() - t_start)
            if self.local_ba and not self.fused_ba and len(self.map) >= 3:
                self._dispatch_window_ba()
            # a host copy of the pose would wait for all the work in flight
            return self.state.Tcw
        h = to_host(out)
        self._record_outputs(h, timestamp, Tcw_gt,
                             time.perf_counter() - t_start)
        Tcw = h.Tcw
        if self.fused_ba:
            t0 = time.perf_counter()
            Tcw = self._apply_fused_ba(h)
            self.map.lba_time.append(time.perf_counter() - t0)
        elif self.local_ba and len(self.map) >= 3:
            t0 = time.perf_counter()
            Tcw = self._run_window_ba()
            self.map.lba_time.append(time.perf_counter() - t0)
        if self.use_imu:
            # the map, the state and the preintegrations are aligned here
            self._vio_update(timestamp)
            Tcw = self.map.frames[-1].Tcw
        return np.asarray(Tcw)

    def finish(self):
        """Record what the pipeline holds: the frames in flight and the
        window BA in flight, then, with the host-assembled BA, one more
        window BA over the whole map (tracking.py:1447-1456). Nothing is
        deferred in the synchronous mode."""
        self._drain_pending_q()
        self._finalize_pending_ba()
        if self.pipelined:
            self._process_pending()
            if self.local_ba and not self.fused_ba and len(self.map) >= 3:
                self._dispatch_window_ba()
                self._finalize_pending_ba()

    def _process_pending(self):
        if self._pending is None:
            return
        copy, ts, tgt, dt = self._pending
        self._pending = None
        h = copy.get()
        self._record_outputs(h, ts, tgt, dt)
        if self.fused_ba:
            self._apply_fused_ba(h)

    def _drain_pending_q(self):
        for copy, ts, tgt, dt in self._pending_q:
            h = copy.get()
            self._record_outputs(h, ts, tgt, dt)
            self._apply_fused_ba(h)
        self._pending_q = []

    def _dispatch_window_ba(self):
        """Solve the window BA over the recorded map (up to the previous
        frame) and correct the state's pose on the device by the change
        the BA made to that frame: Tcw <- Tcw Twc0[-1] inv(Twc[-1])
        (tracking.py:1468-1488). The map takes the result in
        ``_finalize_pending_ba``."""
        W = self.cfg.system.window_size
        prob = assemble_static_window(self.map, self.cam, W,
                                      self.ba_max_points)
        frame_valid = np.zeros(W, bool)
        frame_valid[prob.pad:] = True
        res = self._solve_window(prob, frame_valid)
        Twc0_last = torch.from_numpy(prob.Twc0[-1].astype(np.float32)).to(
            self.device)
        corr = Twc0_last @ inverse_se3(res.Twc[-1])
        self.state = self.state._replace(Tcw=self.state.Tcw @ corr)
        self._pending_ba = (prob, res)

    def _finalize_pending_ba(self):
        if self._pending_ba is None:
            return
        prob, res = self._pending_ba
        self._pending_ba = None
        Twc, X = to_host((res.Twc, res.points))
        self._apply_ba_writeback(prob, Twc, X)

    def _apply_ba_writeback(self, prob, Twc, X):
        """The window BA's poses and points into the records of the frames
        it was assembled from, found by frame id: the map may have grown
        since (tracking.py:1498-1519)."""
        idx = {f.frame_id: f for f in self.map.frames}
        for i, fid in enumerate(prob.frame_ids):
            rec = idx.get(fid)
            if rec is not None:
                rec.Tcw = np.linalg.inv(Twc[prob.pad + i]).astype(np.float32)
        for wi in range(prob.pad, self.cfg.system.window_size):
            rec = idx.get(prob.frame_ids[wi - prob.pad])
            if rec is None:
                continue
            sl = prob.slots[wi]
            m = (sl >= 0) & prob.point_valid
            p3d = np.array(rec.stat_3d)
            p3d[sl[m]] = X[m]
            rec.stat_3d = p3d

    # ------------------------------------------------------------------
    # the online path: raw BGR frames -> perception -> tracking step
    # ------------------------------------------------------------------
    def attach_perception(self, model, depth_mode: str,
                          depth_map_factor: Optional[float] = None,
                          bf: Optional[float] = None, scale: float = 1.0):
        """Bind a ``PerceptionModel`` (on the tracker's device); enables
        ``track_frames``. ``scale`` is the base metric scale of the depth
        conversion; each call converts at base x the live IMU scale
        (mScale, Tracking.cc:316-319). The step's arguments, FAST included,
        are those of this call (tracking.py:1230-1275)."""
        if model.device.type != self.device.type:
            raise ValueError(f"attach_perception: the model is on "
                             f"{model.device}, the tracker on {self.device}")
        dm_factor = (depth_map_factor if depth_map_factor is not None
                     else self.cfg.system.depth_map_factor)
        bf_ = bf if bf is not None else self.cfg.camera.bf
        self._attached = (model, depth_mode, dm_factor, bf_, float(scale))
        self._frames_kwargs = self._step_kwargs()

    def _effective_scale(self) -> np.float32:
        """The depth scale of the next call: the attach-time base times the
        IMU scale (updated by _vio_update)."""
        return np.float32(self._attached[4] * self.imu_scale)

    def track_frames(self, prev_bgr, cur_bgr, Tcw_gt=None, timestamp=None):
        """Process one frame from raw (H, W, 3) BGR frames in 0..255 (prev,
        cur) through the attached perception model; returns the camera
        pose Tcw, a numpy array or, pipelined, the state's device tensor
        (tracking.py:1301-1352). The first call initialises from the
        perception alone, without the gray image (grid-random features, as
        the JAX tracker does). The default timestamp counts the frames in
        flight."""
        prev, cur = self._frames(prev_bgr, cur_bgr)
        if self.state is None:
            self._initialize_from_frames(prev, cur, Tcw_gt, timestamp)
            return np.eye(4, dtype=np.float32)
        if timestamp is None:
            n_inflight = ((1 if self._pending is not None else 0)
                          + len(self._pending_q))
            timestamp = (self.frame_id + n_inflight) / self.cam.fps
        t_start = time.perf_counter()
        if self.use_imu:
            self._vio_sync_before_dispatch()
            self._preints.append(
                self._preintegrate_interval(self._last_ts, float(timestamp)))
        self._last_ts = float(timestamp)
        step = self._frames_step(prev, cur, self._effective_scale())
        return self._post_step(step, float(timestamp), Tcw_gt, t_start)

    def _frames(self, *bgr):
        if self._attached is None:
            raise RuntimeError("call attach_perception first")
        return [torch.as_tensor(x, dtype=torch.float32, device=self.device)
                for x in bgr]

    def _initialize_from_frames(self, prev, cur, Tcw_gt, timestamp):
        model, mode, dm_factor, bf_, scale = self._attached
        depth, flow, mask = model.make_slam_forward(
            mode, dm_factor, bf_, scale)(prev, cur)
        self.initialize(depth, flow, mask, Tcw_gt,
                        timestamp if timestamp is not None else 0.0)

    def _frames_step(self, prev, cur, scale):
        """Perception of (prev, cur), the depth at ``scale`` and the step;
        advances the state and returns the step's outputs."""
        model, mode, dm_factor, bf_, _ = self._attached
        out = model(prev, cur)
        depth = convert_depth(out.depth_u16, mode, dm_factor, bf_,
                              scale=scale)
        kw = self._frames_kwargs
        gray = bgr_to_gray(cur) if kw["use_fast"] else None
        self.state, step = _track_step(self.state, depth, out.flow,
                                       out.mask.to(torch.int32), self.cam,
                                       gray=gray, **kw)
        return step

    def track_frames_pair(self, f0, f1, f2, Tcw_gt=None, timestamps=None):
        """Two frames a call, the transitions f0 -> f1 and f1 -> f2, one
        after the other as in ``track_frames`` (tracking.py:1354-1444);
        needs the pipelined fused-BA configuration. The first call only
        initialises frame 0 from (f0, f1); later calls chain at odd offsets
        ((f1, f2, f3), (f3, f4, f5), ...), each processing two frames, and
        return the state's device tensor Tcw. Records lag up to two frames
        until ``finish()``. ``Tcw_gt``: an optional (gtA, gtB);
        ``timestamps``: the two frames' (tA, tB), which VIO needs where
        the camera clock is not index / fps."""
        if self._attached is None:
            raise RuntimeError("call attach_perception first")
        if not (self.pipelined and self.fused_ba):
            raise ValueError(
                "track_frames_pair requires pipelined=True, fused_ba=True")
        prev, mid, cur = self._frames(f0, f1, f2)
        if self.state is None:
            self._initialize_from_frames(prev, mid, None, 0.0)
            return np.eye(4, dtype=np.float32)
        vio_ts = None
        if self.use_imu:
            # the sync point before the dispatch, only where an IMU event
            # could act: its rescale feeds this pair's depth
            if self._vio_event_due(self._last_ts):
                self._drain_pending_q()
                self._vio_update(self._last_ts)
            if timestamps is not None:
                tsA, tsB = float(timestamps[0]), float(timestamps[1])
            else:
                base0 = self.frame_id + len(self._pending_q)
                tsA, tsB = base0 / self.cam.fps, (base0 + 1) / self.cam.fps
            vio_ts = (self._last_ts, tsA, tsB)
        t_start = time.perf_counter()
        scale = self._effective_scale()
        outA = self._frames_step(prev, mid, scale)
        outB = self._frames_step(mid, cur, scale)
        if vio_ts is not None:
            t_prev, tA, tB = vio_ts
            self._preints.append(self._preintegrate_interval(t_prev, tA))
            self._preints.append(self._preintegrate_interval(tA, tB))
        copies = to_host_async(outA), to_host_async(outB)
        # record the previous pair while this one computes
        self._drain_pending_q()
        base = self.frame_id
        if timestamps is not None:
            recA, recB = float(timestamps[0]), float(timestamps[1])
        else:
            recA, recB = base / self.cam.fps, (base + 1) / self.cam.fps
        gts = (None, None) if Tcw_gt is None else Tcw_gt
        dt = time.perf_counter() - t_start
        for copy, ts, gt in zip(copies, (recA, recB), gts):
            self._pending_q.append(
                (copy, ts, None if gt is None else np.asarray(gt), dt))
        self._last_ts = recB
        return self.state.Tcw

    def run_full_batch(self, max_frames: int = 64, max_static: int = 2000,
                       cg_iters: int = 60, max_iters: int = 15):
        """FullBatchOptimization (Optimizer.cc:1235-2178) on the tracker's
        device: the whole-sequence BA with object motions and dynamic
        points. The results go to the refined slots (map.refined_poses,
        map.refined_motions; vmCameraPose_RF / vmRigidMotion_RF,
        Optimizer.cc:2116-2133); the records keep their initial poses.
        The problem spans the last min(len(map), max_frames) records
        without the JAX package's front padding to ``max_frames``: a pad
        frame is pinned and carries no valid edge, so it changes nothing
        but the work of every eager CG product."""
        if self.record_light:
            raise ValueError(
                "run_full_batch needs per-point FrameRecords; construct the "
                "Tracker with record='full' (auto picks it for KITTI mode)")
        prob, stat, motion_ids = assemble_full_problem(
            self.map, self.cam, min(len(self.map), max_frames), max_static,
            self.max_objects, device=self.device)
        res = solve_full_ba(prob, max_iters=max_iters, cg_iters=cg_iters)
        Twc, H, mv = to_host((res.Twc, res.H, prob.motion_valid))
        pad, n = stat.pad, len(stat.frame_ids)
        self.map.refined_poses = np.stack(
            [np.linalg.inv(Twc[pad + i]).astype(np.float32)
             for i in range(n)])
        refined: dict = {}
        for fi in range(n):
            f = pad + fi
            for k in range(self.max_objects):
                tid = int(motion_ids[f, k])
                if tid >= 0 and mv[f, k]:
                    refined.setdefault(tid, {})[stat.frame_ids[fi]] = H[f, k]
        self.map.refined_motions = refined
        return res

    # ------------------------------------------------------------------
    # VIO: IMU queue, preintegration, init and scale refinement
    # (System.cc:74-75 GrabImuData; Tracking.cc:784-887 PreintegrateIMU;
    #  :937-1077 InitializeIMU / ScaleRefinement), on IMU_DEVICE
    # ------------------------------------------------------------------
    def grab_imu_data(self, measurements) -> None:
        """Queue raw IMU samples; each has .a (3,), .w (3,), .t seconds."""
        self._imu_queue.extend(measurements)

    @torch.inference_mode()
    def _preintegrate_interval(self, t0: float, t1: float):
        """The queued samples of [t0, t1] preintegrated at the current
        bias (numpy fields), or None when the queue is empty. Without
        autograd's bookkeeping the ~200 tiny ops a segment take half the
        time."""
        if not self._imu_queue:
            return None
        q = self._imu_queue
        times = np.asarray([m.t for m in q], np.float64)
        accs = np.asarray([np.asarray(m.a) for m in q], np.float32)
        gyros = np.asarray([np.asarray(m.w) for m in q], np.float32)
        a, w, dt = prepare_segments(times, accs, gyros, t0, t1,
                                    self.imu_max_segments)
        st = integrate_measurements(
            init_preintegration(self.imu_bias, device=IMU_DEVICE),
            torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(dt),
            self.imu_calib)
        # drop consumed samples (keep one before t1 for the boundary)
        self._imu_queue = [m for m, k in zip(q, times >= t1 - 0.02) if k]
        return to_numpy(st)

    def _body_pose(self, rec):
        """(Rwb, twb) of a frame record: Twb = Twc Tcb, in float64."""
        Tcb = np.linalg.inv(np.asarray(self.cfg.imu.Tbc, np.float64))
        Twb = np.linalg.inv(np.asarray(rec.Tcw, np.float64)) @ Tcb
        return Twb[:3, :3], Twb[:3, 3]

    def _body_poses(self):
        """(Rwb (n, 3, 3), twb (n, 3)) of every frame in the map."""
        Rwb, twb = zip(*(self._body_pose(rec) for rec in self.map.frames))
        return np.stack(Rwb), np.stack(twb)

    def _stacked_preints(self, preints):
        """A list of preintegration states (None: no samples) padded into
        the fixed (imu_max_frames - 1)-slot arrays ``initialize_imu``
        takes, and the pair validity."""
        M = self.imu_max_frames - 1
        z33 = np.zeros((M, 3, 3), np.float32)
        out = {
            "dts": np.zeros(M, np.float32),
            "dR": np.tile(np.eye(3, dtype=np.float32), (M, 1, 1)),
            "dV": np.zeros((M, 3), np.float32),
            "dP": np.zeros((M, 3), np.float32),
            "JRg": z33.copy(), "JVg": z33.copy(), "JVa": z33.copy(),
            "JPg": z33.copy(), "JPa": z33.copy(),
            "C9": np.tile(np.eye(9, dtype=np.float32) * 1e-6, (M, 1, 1)),
        }
        pv = np.zeros(M, bool)
        for i, st in enumerate(preints[:M]):
            if st is None:
                continue
            out["dts"][i] = st.dT
            for k in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa"):
                out[k][i] = getattr(st, k)
            out["C9"][i] = st.C[:9, :9]
            pv[i] = st.dT > 0
        return out, pv

    def _composed_pairs(self, idxs):
        """One preintegration a pair of consecutive window frames, composed
        from the per-frame ones; None where a sub-pair had no samples. The
        slice is not bounds-checked, as in the JAX package
        (tracking.py:874 there)."""
        pairs = []
        for a, b in zip(idxs[:-1], idxs[1:]):
            subs = self._preints[a:b]
            if any(p is None for p in subs):
                pairs.append(None)
                continue
            st = subs[0]
            for p in subs[1:]:
                st = compose_preints(st, p)
            pairs.append(st)
        return pairs

    @staticmethod
    def _window(n: int, K: int, M: int):
        """Frame indices of the stride-K window ending at frame n - 1."""
        return list(range(n - 1, -1, -K))[::-1][-M:]

    def _strides(self):
        return sorted({1, max(1, int(self.imu_init_stride))})

    def _try_initialize_imu(self, timestamp: float) -> None:
        """InitializeIMU (Tracking.cc:937-1044): needs >= 10 frames and
        >= 2 s of data; estimates gravity, scale and biases and rescales
        the map and the state. The reference retries every frame with no
        upper frame bound (Tracking.cc:1452-1453): past imu_max_frames
        frames the window slides to the most recent ones.

        Two stride candidates, the larger valid scale wins: consecutive
        0.1 s pairs make the alignment an errors-in-variables problem whose
        VO noise pulls the scale toward zero, and composing K pairs into a
        longer baseline grows the signal ~K^2; when the noise is tiny the
        stride only costs pairs. The failure is one-sided, so the larger
        scale is the better-conditioned candidate."""
        n = len(self.map)
        if n < 10:
            return
        M = self.imu_max_frames
        if timestamp - self.map.frames[max(0, n - M)].timestamp < 2.0:
            return
        Rwb, twb = self._body_poses()
        self.imu_init_attempts += 1
        best = None
        for K in self._strides():
            cand = self._init_candidate(K, n, M, Rwb, twb)
            if cand is not None and (best is None
                                     or float(cand.scale) > float(best.scale)):
                best = cand
        if best is None:
            return
        scale = float(best.scale)
        if scale < 0.1:  # Tracking.cc:1008-1012
            return
        Rwg = np.asarray(best.Rwg, np.float64)
        self.Rwg = Rwg
        self.imu_bias = np.concatenate(
            [np.asarray(best.bg), np.asarray(best.ba)]).astype(np.float32)
        if abs(scale - 1.0) > 1e-5:  # Tracking.cc:1016-1020
            self.map.apply_scaled_rotation(Rwg.T, scale)
            self.imu_scale *= scale
            self._rescale_state(scale, Rwg.T)
        self.imu_initialized = True
        self._last_scale_refine_t = timestamp

    def _init_candidate(self, K: int, n: int, M: int, Rwb_np, twb_np):
        """One staged init over the stride-K window (composed
        preintegrations); None when the window has under 5 frames."""
        idxs = self._window(n, K, M)
        n_w = len(idxs)
        if n_w < 5:
            return None
        Rwb = np.tile(np.eye(3, dtype=np.float32), (M, 1, 1))
        twb = np.zeros((M, 3), np.float32)
        Rwb[:n_w] = Rwb_np[idxs]
        twb[:n_w] = twb_np[idxs]
        pp, pv = self._stacked_preints(self._composed_pairs(idxs))
        pv[n_w - 1:] = False
        return initialize_imu(
            torch.from_numpy(Rwb), torch.from_numpy(twb),
            **{k: torch.from_numpy(v) for k, v in pp.items()},
            pair_valid=torch.from_numpy(pv), prior_g=1e2, prior_a=1e9)

    def _rescale_state(self, scale: float, Ryw: np.ndarray) -> None:
        """Bring the tracker's state into the rescaled, gravity-aligned
        world — the state side of Map::ApplyScaledRotation (Map.cc:57-120),
        computed on the state's device (the card), nothing copied to the
        host. Camera-frame quantities (feature depths, the BA ring's
        backprojections) scale by s; the pose becomes
        Tcw' = [Rcw Ryw^T | s tcw]; the ring poses Twc' = [Ryw Rwc |
        s Ryw twc]; the odometry keeps its rotation and scales its
        translation; the velocity and the per-bin object motions are
        dropped and re-seed on the next frame."""
        st = self.state
        dev = st.Tcw.device
        s = torch.tensor(scale, dtype=torch.float32, device=dev)
        R = torch.as_tensor(np.asarray(Ryw, np.float64), dtype=torch.float32,
                            device=dev)
        Tcw = st.Tcw.clone()
        Tcw[:3, :3] = st.Tcw[:3, :3] @ R.T
        Tcw[:3, 3] = s * st.Tcw[:3, 3]
        ba_Twc = st.ba_Twc.clone()
        ba_Twc[:, :3, :3] = R @ st.ba_Twc[:, :3, :3]
        ba_Twc[:, :3, 3] = s * (st.ba_Twc[:, :3, 3] @ R.T)
        ba_odom = st.ba_odom.clone()
        ba_odom[:, :3, 3] = st.ba_odom[:, :3, 3] * s
        self.state = st._replace(
            stat=st.stat._replace(depth=st.stat.depth * s),
            obj=st.obj._replace(depth=st.obj.depth * s),
            Tcw=Tcw, has_velocity=torch.zeros_like(st.has_velocity),
            bin_has_motion=torch.zeros_like(st.bin_has_motion),
            ba_obs=st.ba_obs * s, ba_Twc=ba_Twc, ba_odom=ba_odom)

    def _try_scale_refinement(self, timestamp: float) -> None:
        """ScaleRefinement (Tracking.cc:1046-1077), every ~10 s: the
        stage-B alignment at stride 1 and K, the larger scale wins."""
        if timestamp - self._last_scale_refine_t < 10.0:
            return

        def candidate(K):
            """None unless both frames of every composed pair are in the
            map."""
            idxs = self._window(len(self.map), K, self.imu_max_frames)
            if len(idxs) < 5 or idxs[-1] > len(self._preints):
                return None
            pre = self._composed_pairs(idxs)
            if any(p is None for p in pre):
                return None
            Rwb, twb = zip(*(self._body_pose(self.map.frames[i])
                             for i in idxs))

            def f32(x):
                return torch.from_numpy(np.asarray(x, np.float32))
            dV = f32([p.dV for p in pre])
            pv = torch.tensor([bool(p.dT > 0) for p in pre])
            Rwb_t = f32(np.stack(Rwb))
            Rwg0 = estimate_gravity_direction(Rwb_t, dV, pv)
            _, s, Rwg, _ = linear_alignment(
                Rwb_t, f32(np.stack(twb)), f32([p.dT for p in pre]), dV,
                f32([p.dP for p in pre]), pv, Rwg0)
            return float(s), np.asarray(Rwg)

        self.imu_refine_runs += 1
        best = None
        for K in self._strides():
            c = candidate(K)
            if c is not None and (best is None or c[0] > best[0]):
                best = c
        if best is None:
            return
        scale, Rwg = best
        self._last_scale_refine_t = timestamp
        if scale < 0.1 or abs(scale - 1.0) <= 1e-5:
            return
        Ryw = np.asarray(Rwg, np.float64).T
        self.map.apply_scaled_rotation(Ryw, scale)
        self.imu_scale *= scale
        self._rescale_state(scale, Ryw)

    @torch.no_grad()
    def _vio_update(self, timestamp) -> None:
        """IMU init or scale refinement (Tracking.cc:1452-1480), at a point
        where every frame is recorded and the state is on the last one;
        each applies its own gate."""
        if timestamp is None:
            return
        if not self.imu_initialized:
            self._try_initialize_imu(float(timestamp))
        else:
            self._try_scale_refinement(float(timestamp))

    def _vio_event_due(self, ts) -> bool:
        """Whether ``_vio_update`` at timestamp ``ts`` could act: the gates
        of Tracking.cc:939-949 and :1046-1077, counting the frames in
        flight (tracking.py:1203-1222). The pipelined VIO paths pay their
        sync before the dispatch only where this holds: every frame from
        the 10-frame, 2-s mark until the init succeeds, then once per
        ~10 s for the scale refinement."""
        if ts is None:
            return False
        if not self.imu_initialized:
            n = len(self.map) + len(self._pending_q) \
                + (1 if self._pending is not None else 0)
            if n < 10:
                return False
            t0 = self.map.frames[0].timestamp if len(self.map) else 0.0
            return ts - t0 >= 2.0
        return ts - self._last_scale_refine_t >= 10.0

    # ------------------------------------------------------------------
    def _record_outputs(self, h, timestamp, Tcw_gt, step_time):
        bin_track_id, _ = self.object_tracker.assign_ids(h.stats)
        sem_to_tid = np.zeros(MAX_SEM, np.int32)
        sem_to_tid[: bin_track_id.shape[0]] = bin_track_id
        labels = np.asarray(h.point_labels)
        labels = np.where(labels > 0,
                          sem_to_tid[np.clip(labels, 0, MAX_SEM - 1)], labels)
        obs_list: List[ObjectObservation] = []
        for k in range(self.max_objects):
            if not h.obj_active[k]:
                continue
            sem_v = int(h.obj_sem_values[k])
            status = bool(h.obj_ok[k])
            if not status:
                self.object_tracker.mark_failed(sem_v)
            obs_list.append(ObjectObservation(
                track_id=int(sem_to_tid[sem_v]), sem_value=sem_v,
                motion=h.obj_motion[k], speed_kmh=float(h.obj_speed[k]),
                centroid=h.obj_centroid[k],
                num_inliers=int(h.obj_num_inliers[k]), status=status))
        Tcw_np = np.asarray(h.Tcw, np.float32)
        self.map.add_frame(FrameRecord(
            frame_id=self.frame_id, timestamp=float(timestamp), Tcw=Tcw_np,
            Tcw_gt=None if Tcw_gt is None else np.asarray(Tcw_gt),
            stat_uv=h.stat_uv, stat_depth=h.stat_depth,
            stat_valid=h.stat_valid, stat_is_new=h.stat_is_new,
            stat_3d=self._unproject_np(h.stat_uv, h.stat_depth, Tcw_np),
            obj_uv=h.obj_uv, obj_depth=h.obj_depth, obj_valid=h.obj_valid,
            obj_is_new=h.obj_is_new, obj_sem=np.asarray(h.obj_sem, np.int32),
            obj_label=labels.astype(np.int32),
            obj_3d=self._unproject_np(h.obj_uv, h.obj_depth, Tcw_np),
            objects=obs_list, timing={"track_step": step_time},
            cam_motion=np.asarray(h.cam_motion)))
        self.frame_id += 1

    def _unproject_np(self, uv, depth, Tcw):
        cam = self.cam
        x = (uv[:, 0] - cam.cx) * depth / cam.fx
        y = (uv[:, 1] - cam.cy) * depth / cam.fy
        xc = np.stack([x, y, depth], axis=-1).astype(np.float32)
        Twc = np.linalg.inv(Tcw)
        return (xc @ Twc[:3, :3].T.astype(np.float32)
                + Twc[:3, 3].astype(np.float32)).astype(np.float32)

    def _apply_fused_ba(self, h) -> np.ndarray:
        """Refined window poses overwrite the last nf records; refined
        points land in the newest record's slots."""
        W = h.ba_Twc.shape[0]
        nf = min(int(h.ba_nframes), W, len(self.map))
        recs = self.map.frames[-nf:]
        for i, rec in enumerate(recs):
            rec.Tcw = np.linalg.inv(h.ba_Twc[W - nf + i]).astype(np.float32)
        ok = np.asarray(h.ba_point_ok)
        if ok.size and ok.any():
            p3d = np.array(recs[-1].stat_3d)
            p3d[np.asarray(h.ba_slots)[ok]] = np.asarray(h.ba_points)[ok]
            recs[-1].stat_3d = p3d
        return recs[-1].Tcw

    def _solve_window(self, prob, frame_valid):
        """The assembled window problem solved on the tracker's device."""
        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        return solve_window_ba(
            put(prob.Twc0), put(prob.odom), put(prob.odom_valid),
            put(prob.X0), put(prob.obs), put(prob.obs_valid),
            put(prob.point_valid), put(frame_valid), max_iters=self.ba_iters)

    def _run_window_ba(self) -> np.ndarray:
        """Assemble the static window BA from the map records, solve it on
        the tracker's device and write it back (Tracking.cc:1431-1447 ->
        Optimizer.cc:43-1228; the partial write-back of
        Optimizer.cc:1056-1142): every window record gets its refined pose,
        and every observation slot its track's refined point."""
        W = self.cfg.system.window_size
        prob = assemble_static_window(self.map, self.cam, W,
                                      self.ba_max_points)
        frame_valid = np.zeros(W, bool)
        frame_valid[prob.pad:] = True
        res = self._solve_window(prob, frame_valid)
        # the next frame tracks from the refined pose, on the device
        self.state = self.state._replace(Tcw=inverse_se3(res.Twc[-1]))
        Twc, X = to_host((res.Twc, res.points))
        self._apply_ba_writeback(prob, Twc, X)
        return self.map.frames[-1].Tcw
