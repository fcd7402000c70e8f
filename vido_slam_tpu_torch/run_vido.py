"""Offline demo — the reference's ``run_vido`` binary (vido_slam/demo/
run_vido_slam.cc) on the port; counterpart of ``demo/run_vido.py``.

    python -m vido_slam_tpu_torch.run_vido <config.yaml> [--output results/]
        [--max-frames N] [--online] [--animate] [--view [--view-every N]]
        [--device cuda|cpu]

The config's ``image_path`` names the image directory. KAIST
(``ChooseData: 3``, the default): raw BayerBG frames listed by
``vTimestampsImage.txt``, demosaiced to BGR; ``slam_mode: 1`` runs
IMU_RGBD with the ``imu_path`` samples of each frame interval. KITTI
(``ChooseData: 2``): colour frames listed by ``times.txt``; after the last
frame the StopFrame full-batch BA writes the refined trajectory. Offline,
each image's precomputed flow (.flo), depth (16-bit PNG) and mask (PNG)
are read from the sibling ``flow/``, ``depth/`` and ``mask/`` directories
(run_vido_slam.cc:118-122); ``--online`` computes them instead with
``PerceptionModel`` (MonoDepth2, LiteFlowNet, Mask R-CNN R-50-FPN at
544x800, seeded random weights) through ``System.TrackFrames``. Missing
images are skipped. The result txts of ``SaveResultsIJRR2020`` go to
``--output``. Everything runs on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, NamedTuple, Optional

import numpy as np

from vido_slam_tpu_torch.config import load_config
from vido_slam_tpu_torch.io.datasets import (IMREAD_COLOR, IMREAD_GRAYSCALE,
                                             demosaic_bayer_bg2bgr, imread,
                                             load_depth_png,
                                             load_kaist_image_list,
                                             load_kaist_imu,
                                             load_kitti_image_list,
                                             load_mask_png, read_flo,
                                             sibling_input_paths)
from vido_slam_tpu_torch.system import ImuPoint, Sensor, System

ONLINE_DETECTOR = (544, 800)  # the JAX demo's MaskRCNNConfig(input_h, input_w)


class DemoRun(NamedTuple):
    """What ``main`` ran: the system, and per processed frame the seconds
    of reading its inputs from disk (image, and offline its flow, depth and
    mask) and of tracking it."""

    system: System
    read_s: List[float]
    track_s: List[float]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m vido_slam_tpu_torch.run_vido",
        description="VIDO-SLAM offline demo on the PyTorch port")
    ap.add_argument("config")
    ap.add_argument("--output", default="results/")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--online", action="store_true")
    ap.add_argument("--animate", action="store_true",
                    help="write an animated 3D scene recording "
                    "(scene_3d.gif) beside the result files; needs "
                    "matplotlib and Pillow")
    ap.add_argument("--view", action="store_true",
                    help="live 3D scene viewer (VidoViewer counterpart); "
                    "never gates the pipeline; no-op on headless hosts")
    ap.add_argument("--view-every", type=int, default=5,
                    help="redraw the live viewer every N frames")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tracker and the nets")
    return ap.parse_args(argv)


def _imu_between(imu, t0: Optional[float], t1: float):
    """The samples in (t0, t1] as ImuPoints; None before the first frame."""
    if imu is None or t0 is None:
        return None
    times, accs, gyros = imu
    sel = np.nonzero((times > t0) & (times <= t1))[0]
    return [ImuPoint(a=accs[j], w=gyros[j], t=float(times[j])) for j in sel]


def main(argv: Optional[List[str]] = None) -> DemoRun:
    args = parse_args(argv)
    cfg = load_config(args.config)
    vio = cfg.demo.slam_mode == 1
    kitti = cfg.system.choose_data == 2

    system = System()
    system.Init(args.config, Sensor.IMU_RGBD if vio else Sensor.RGBD,
                device=args.device)
    if kitti:
        frames = load_kitti_image_list(cfg.demo.image_path)
    else:
        frames = load_kaist_image_list(cfg.demo.image_path)
    frames = frames[cfg.demo.start_index:]
    if args.max_frames:
        frames = frames[:args.max_frames]
    imu = load_kaist_imu(cfg.demo.imu_path) if vio and cfg.demo.imu_path \
        else None

    if args.online:
        from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNNConfig
        from vido_slam_tpu_torch.models.perception import PerceptionModel

        h, w = ONLINE_DETECTOR
        system.AttachPerception(PerceptionModel(
            cfg.camera.height, cfg.camera.width,
            MaskRCNNConfig(input_h=h, input_w=w), seed=0,
            device=args.device))

    viewer = None
    if args.view:
        from vido_slam_tpu_torch.viz import LiveViewer

        viewer = LiveViewer(every=args.view_every)
        if not viewer._ok:
            print(f"live viewer disabled: {viewer.disabled_reason}")

    read_s, track_s = [], []
    last_t = prev_bgr = None
    for i, fr in enumerate(frames):
        t0 = time.perf_counter()
        if kitti:
            # KITTI frames are colour images (no Bayer pattern)
            bgr = imread(fr.image_path, IMREAD_COLOR)
        else:
            raw = imread(fr.image_path, IMREAD_GRAYSCALE)
            bgr = None if raw is None else demosaic_bayer_bg2bgr(raw)
        if bgr is None:
            print(f"skip missing {fr.image_path}")
            continue
        if not args.online:
            flo_p, dep_p, msk_p = sibling_input_paths(fr.image_path)
            flow = read_flo(flo_p)
            depth_raw = load_depth_png(dep_p)
            mask = load_mask_png(msk_p)
        t1 = time.perf_counter()
        meas = _imu_between(imu, last_t, fr.timestamp)
        last_t = fr.timestamp
        if args.online:
            if prev_bgr is None:
                prev_bgr = bgr
            Tcw = system.TrackFrames(prev_bgr.astype(np.float32),
                                     bgr.astype(np.float32),
                                     timestamp=fr.timestamp,
                                     imu_measurements=meas)
            prev_bgr = bgr
        else:
            Tcw = system.TrackRGBD(bgr, depth_raw, flow, mask,
                                   timestamp=fr.timestamp,
                                   imu_measurements=meas,
                                   nImage=len(frames))
        read_s.append(t1 - t0)
        track_s.append(time.perf_counter() - t1)
        if i % 10 == 0:
            print(f"frame {i}/{len(frames)} t={fr.timestamp:.2f} "
                  f"pos={np.linalg.inv(Tcw)[:3, 3]}")
        if viewer is not None and len(system.tracker.map) > 1:
            viewer.update(system.tracker.map, image=bgr[..., ::-1])

    if viewer is not None:
        viewer.close()
    os.makedirs(args.output, exist_ok=True)
    system.SaveResultsIJRR2020(os.path.join(args.output, ""))
    if read_s:
        print(f"{len(read_s)} frames on {system.tracker.device}: "
              f"{1e3 * (sum(read_s) + sum(track_s)) / len(read_s):.2f} ms a "
              f"frame, of which reading {1e3 * sum(read_s) / len(read_s):.2f}"
              f" ms")
    if args.animate and len(system.tracker.map) > 1:
        from vido_slam_tpu_torch.viz import render_scene_animation

        gif = os.path.join(args.output, "scene_3d.gif")
        n = render_scene_animation(system.tracker.map, gif)
        print(f"wrote {gif} ({n} frames)")
    print("done.")
    return DemoRun(system, read_s, track_s)


if __name__ == "__main__":
    main()
