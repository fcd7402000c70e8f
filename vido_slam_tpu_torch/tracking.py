"""Per-frame tracking — Tracking::GrabImageRGBD / Track() (Tracking.cc:283-782,
1081-1509); counterpart of ``vido_slam_tpu/tracking.py`` for the offline VO
path: precomputed depth, flow and mask, grid-sampled features, the fused
window BA.

Each frame ``_track_step`` runs on the tracker's device: mask repair, flow
propagation of the feature slots, RANSAC + LM for the camera pose, scene
flow and object selection, RANSAC + LM for up to ``max_objects`` object
motions (one batched LM kernel launch), feature renewal and the window BA
over device-side rings. The host then copies the outputs it needs in one
transfer and does the tracking-id bookkeeping and the map records.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from vido_slam_tpu_torch.config import Config
from vido_slam_tpu_torch.estimation.pose import (
    estimate_camera_pose,
    estimate_object_motions_batched,
)
from vido_slam_tpu_torch.estimation.window_ba import solve_window_ba
from vido_slam_tpu_torch.frontend.association import update_mask
from vido_slam_tpu_torch.frontend.features import (
    FeatureSet,
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
from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.geometry.se3 import inverse_se3
from vido_slam_tpu_torch.slam_map import FrameRecord, ObjectObservation, SlamMap
from vido_slam_tpu_torch.utils import prng
from vido_slam_tpu_torch.utils.device import resolve_device
from vido_slam_tpu_torch.utils.order import top_k
from vido_slam_tpu_torch.utils.transfer import to_host

MIN_OBJ_INLIERS = 50  # Tracking.cc:1218


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


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to vido_slam_tpu_torch yet "
        f"(ROADMAP.md queue 1 item {item})")


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
                height: int, width: int, fused_ba: bool = True,
                ba_window: int = 20, ba_points: int = 1000,
                ba_iters: int = 10, record_light: bool = False):
    """One frame; returns (new_state, StepOutputs)."""
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
    H, obj_inl, n_inl = estimate_object_motions_batched(
        obj_keys, Tcw, pts3d_obj_pre, cur_obj.uv, obj_masks, cam, H_mm,
        has_mm, obj_pc_cur)
    wK = obj_masks.to(f32)
    cent = (wK @ pts3d_obj_pre) / torch.clamp(wK.sum(dim=1, keepdim=True),
                                              min=1.0)
    sp_v = H[:, :3, 3] - ((torch.eye(3, device=dev) - H[:, :3, :3])
                          @ cent[..., None])[..., 0]
    speed = torch.sqrt(torch.sum(sp_v * sp_v, dim=-1)) * 36.0
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
    fresh_bg = sample_background_features(k_fresh, mask, depth, flow,
                                          n=n_bg, th_depth=th_depth_bg)
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

    # 7. window BA over the device rings (PartialBatchOptimization)
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
                 pipelined: bool = False, joint_flow: bool = False,
                 fused_ba: bool = True, record: str = "auto", device=None):
        if joint_flow:
            raise _not_ported("joint_flow=True (the bJoint mode)", 8)
        if local_ba and not fused_ba:
            raise _not_ported("the host-assembled window BA "
                              "(local_ba=True, fused_ba=False)", 9)
        if pipelined:
            raise _not_ported("pipelined=True", 16)
        if use_imu:
            raise _not_ported("use_imu=True (VIO)", 17)
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
        self.fused_ba = fused_ba and local_ba
        self.ba_max_points = ba_max_points
        self.ba_iters = ba_iters
        # UseSampleFeature=0 asks for FAST corners on the gray image
        self.use_fast = not config.system.use_sample_feature
        if record not in ("auto", "full", "light"):
            raise ValueError(f"record must be 'auto', 'full' or 'light', "
                             f"got {record!r}")
        if record == "auto":
            self.record_light = bool(self.fused_ba
                                     and config.system.choose_data != 2)
        else:
            self.record_light = record == "light"

    def _step_kwargs(self):
        s = self.cfg.system
        return dict(
            n_bg=self.n_bg, n_obj=self.n_obj, max_objects=self.max_objects,
            th_depth_bg=s.th_depth_bg, th_depth_obj=s.th_depth_obj,
            sf_mg_thres=s.sf_mg_thres, sf_ds_thres=s.sf_ds_thres,
            height=self.cam.height, width=self.cam.width,
            fused_ba=self.fused_ba, ba_window=s.window_size,
            ba_points=self.ba_max_points, ba_iters=self.ba_iters,
            record_light=self.record_light)

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

    def _check_image(self, image):
        if image is not None and self.use_fast:
            raise _not_ported("FAST features (UseSampleFeature=0 with an "
                              "image)", 11)

    # ------------------------------------------------------------------
    def initialize(self, depth, flow, mask, Tcw_gt=None, timestamp=0.0,
                   image=None):
        """First frame (Tracking::Initialization, Tracking.cc:1512-1580):
        sample features, pose = identity, record."""
        self._check_image(image)
        depth, flow, mask = self._inputs(depth, flow, mask)
        s = self.cfg.system
        dev = self.device
        stat = sample_background_features(self._next_key(), mask, depth, flow,
                                          n=self.n_bg, th_depth=s.th_depth_bg)
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

    def track(self, depth, flow, mask, Tcw_gt=None, timestamp=None,
              image=None) -> np.ndarray:
        """Process one frame; returns the camera pose Tcw (4, 4). Without
        ``image`` the features are grid-sampled (UseSampleFeature=1), from
        then on, as in the JAX tracker."""
        if image is None:
            self.use_fast = False
        self._check_image(image)
        if self.state is None:
            self.initialize(depth, flow, mask, Tcw_gt,
                            timestamp if timestamp is not None else 0.0)
            return np.eye(4, dtype=np.float32)
        if timestamp is None:
            timestamp = self.frame_id / self.cam.fps
        t_start = time.perf_counter()
        depth, flow, mask = self._inputs(depth, flow, mask)
        self.state, out = _track_step(self.state, depth, flow, mask, self.cam,
                                      **self._step_kwargs())
        return self._post_step(out, float(timestamp), Tcw_gt, t_start)

    def _post_step(self, out, timestamp, Tcw_gt, t_start):
        h = to_host(out)
        self._record_outputs(h, timestamp, Tcw_gt,
                             time.perf_counter() - t_start)
        Tcw = h.Tcw
        if self.fused_ba:
            t0 = time.perf_counter()
            Tcw = self._apply_fused_ba(h)
            self.map.lba_time.append(time.perf_counter() - t0)
        return np.asarray(Tcw)

    def finish(self):
        """Nothing is deferred in the synchronous mode; kept for the
        System API (SaveResultsIJRR2020 calls it)."""

    def attach_perception(self, *args, **kwargs):
        raise _not_ported("attach_perception (online perception)", 15)

    def run_full_batch(self, *args, **kwargs):
        raise _not_ported("run_full_batch (full-batch BA)", 18)

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
