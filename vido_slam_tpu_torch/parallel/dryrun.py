"""The multi-device dry run — counterpart of
``__graft_entry__.py::dryrun_multichip`` (:85-250): the five sharded
surfaces of the JAX package, in its order, on an n-rank (dp, tp) mesh at
tiny shapes:

1. the supervised depth train step (MonoDepth2, Adam; tp = 2 when n is
   even);
2. the window BA on dp perturbed problems at ``max_iters`` 0 and 10 (the
   cost must fall below a tenth);
3. Mask R-CNN R-50-FPN detection inference on dp images;
4. the tiny detector's (one block a stage, 64 FPN channels) train step;
5. multi-sequence SLAM on dp synthetic sequences.

The inputs are the JAX run's: ``utils/prng`` draws them from the same keys
bit for bit (``normal`` within an ulp). ``params`` = (MonoDepth2's, the
R-50-FPN's, the tiny detector's) parameter dicts in the JAX layout, as
numpy arrays, lets a caller pass in the JAX package's; without them the
port's own seeded inits are used, which draw other numbers.

Run it with ``python -m vido_slam_tpu_torch.parallel.dryrun N [--device
cpu]``. On the CPU it spawns N gloo processes, one thread each; on
``cuda`` it needs N cards (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import argparse
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                               spawn)
from vido_slam_tpu_torch.utils import prng
from vido_slam_tpu_torch.utils.device import resolve_device


def _uniform(key, shape, lo, hi) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=lo, maxval=hi)``."""
    return torch.maximum(prng.uniform(key, shape) * (hi - lo) + lo,
                         torch.tensor(float(lo)))


def _window_problems(S: int, W: int = 4, P: int = 16):
    """The dry run's S perturbed window problems (__graft_entry__.py:
    137-166): points 2 m around (0, 0, 8), the camera moving 0.2 m a frame
    along x, observations from the true state, poses after the first and
    the points perturbed by 0.05 N(0, 1)."""
    from vido_slam_tpu_torch.parallel.eval import BatchedWindowProblem

    k_pts, k_dT, k_dX = prng.split(prng.PRNGKey(1), 3)
    pts = _uniform(k_pts, (S, P, 3), -2.0, 2.0) \
        + torch.tensor([0.0, 0.0, 8.0])
    t = torch.arange(W, dtype=torch.float32)[:, None] \
        * torch.tensor([0.2, 0.0, 0.0])
    Twc = torch.eye(4).expand(S, W, 4, 4).clone()
    Twc[:, :, :3, 3] = t
    obs = pts[:, None, :, :] - Twc[:, :, None, :3, 3]
    odom = torch.eye(4).expand(S, W - 1, 4, 4).clone()
    odom[:, :, 0, 3] = 0.2
    Twc0 = Twc.clone()
    Twc0[:, 1:, :3, 3] += 0.05 * prng.normal(k_dT, (S, W - 1, 3))
    X0 = pts + 0.05 * prng.normal(k_dX, (S, P, 3))
    return BatchedWindowProblem(
        Twc0=Twc0, odom=odom, odom_valid=torch.ones(S, W - 1, dtype=bool),
        X0=X0, obs=obs, obs_valid=torch.ones(S, W, P, dtype=bool),
        point_valid=torch.ones(S, P, dtype=bool),
        frame_valid=torch.ones(S, W, dtype=bool))


SLAM_CONFIG = {
    "Camera.width": 96, "Camera.height": 64, "Camera.fx": 80.0,
    "Camera.fy": 80.0, "Camera.cx": 48.0, "Camera.cy": 32.0,
    "Camera.bf": 16.0, "ThDepthBG": 60.0, "MaxTrackPointBG": 200,
    "WINDOW_SIZE": 3}
SLAM_KW = dict(n_bg=200, n_obj=100, max_objects=2, ba_points=100,
               ba_iters=3)


def slam_sequences(S: int, dev):
    """The dry run's S synthetic sequences of 3 frames at 96x64
    (__graft_entry__.py:217-243, camera SLAM_CONFIG): sequence s moves
    0.25 + 0.05 s m a frame along -z. Returns numpy (depths, flows,
    masks)."""
    from vido_slam_tpu_torch.geometry.camera import Camera
    from vido_slam_tpu_torch.io.synthetic import (SyntheticScene,
                                                  SyntheticSequence,
                                                  translation_se3)

    cam = Camera.create(fx=80.0, fy=80.0, cx=48.0, cy=32.0, width=96,
                        height=64, bf=16.0)
    scene = SyntheticScene(cam=cam, ground_y=1.5, boxes=())
    seqs = [SyntheticSequence(
        scene, [translation_se3([0.0, 0.0, -0.25 - 0.05 * s]).numpy()],
        n_frames=3, device=dev) for s in range(S)]
    arrays = [np.stack([np.stack([getattr(f, k) for f in q.frames])
                        for q in seqs]) for k in ("depth", "flow", "mask")]
    return arrays[0], arrays[1], arrays[2].astype(np.int32)


TINY_DETECTOR = dict(stage_blocks=(1, 1, 1, 1), out_channels=64)


def detector_batch(B: int) -> dict:
    """The tiny detector step's batch of B (__graft_entry__.py:183-199): 0..255
    uniform images at 64x96 and two boxes an image with random masks; its
    step key is PRNGKey(6)."""
    kb = prng.split(prng.PRNGKey(5), 4)
    boxes = torch.tensor([[8.0, 8.0, 40.0, 40.0], [50.0, 20.0, 90.0, 60.0]])
    return {
        "image": prng.uniform(kb[0], (B, 64, 96, 3)) * 255.0,
        "targets": {
            "boxes": boxes.expand(B, 2, 4),
            "labels": torch.ones(B, 2, dtype=torch.int32),
            "masks": (prng.uniform(kb[1], (B, 2, 32, 48)) > 0.5).float(),
            "valid": torch.ones(B, 2, dtype=torch.bool)}}


def run_dryrun(params=None) -> dict:
    """The dry run on this rank of the default process group (every rank
    calls it). Rank 0 prints the JAX package's line. Returns the values
    of that line unrounded: mesh, loss, ba_cost (c0, c1), det_batch,
    det_loss."""
    from vido_slam_tpu_torch.config import config_from_dict
    from vido_slam_tpu_torch.models.maskrcnn.backbone import ResNetConfig
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           MaskRCNNConfig)
    from vido_slam_tpu_torch.models.monodepth2 import MonoDepth2
    from vido_slam_tpu_torch.parallel.eval import (sharded_detection_inference,
                                                   sharded_window_ba)
    from vido_slam_tpu_torch.parallel.slam_eval import multi_sequence_tracking
    from vido_slam_tpu_torch.parallel.train import (init_train_state,
                                                    make_detection_train_step,
                                                    make_train_step)

    n = dist.get_world_size()
    mesh = make_mesh(n, tp=2 if n % 2 == 0 else 1)
    dev, dp = mesh.device, mesh.dp
    depth_p, det_p, tiny_p = params if params is not None else (None,) * 3

    # (1) the supervised depth step
    net = MonoDepth2(seed=0, device=dev)
    if depth_p is not None:
        net.load_state_dict(convert.monodepth2_state_dict_from_numpy(
            depth_p, device=dev), strict=True)
    state = init_train_state(net, mesh=mesh)
    batch = {"image": torch.full((dp, 3, 64, 64), 0.5, device=dev),
             "target": torch.full((dp, 64, 64), 0.2, device=dev)}
    state, loss = make_train_step(mesh=mesh)(state, batch)
    loss = float(loss)
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")

    # (2) the window BA, dp problems
    probs = _window_problems(dp)
    c0 = float(sharded_window_ba(probs, max_iters=0, mesh=mesh).cost.sum())
    res = sharded_window_ba(probs, max_iters=10, mesh=mesh)
    c1 = float(res.cost.sum())
    if not (bool(torch.isfinite(res.cost).all()) and c1 < 0.1 * c0):
        raise RuntimeError(f"sharded BA did not converge: {c0:.4f} -> "
                           f"{c1:.4f}")

    # (3) detection inference, dp images
    det_cfg = MaskRCNNConfig(input_h=64, input_w=96)
    det = MaskRCNN(det_cfg, seed=2, device=dev)
    if det_p is not None:
        det.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
            det_p, device=dev), strict=True)
    images = prng.uniform(prng.PRNGKey(3), (dp, 64, 96, 3)) * 255.0
    out = sharded_detection_inference(
        det, images.permute(0, 3, 1, 2).contiguous(), mesh=mesh)
    del det
    if out.boxes.shape[0] != dp or not bool(
            torch.where(out.valid, torch.isfinite(out.scores),
                        torch.ones_like(out.valid)).all()):
        raise RuntimeError("sharded inference non-finite")

    # (4) the tiny detector's train step
    tiny = MaskRCNNConfig(resnet=ResNetConfig(**TINY_DETECTOR), input_h=64,
                          input_w=96)
    model = MaskRCNN(tiny, seed=4, device=dev)
    if tiny_p is not None:
        model.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
            tiny_p, device=dev), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_detection_train_step(model, lr=1e-4, mesh=mesh)
    det_loss = float(step(detector_batch(dp), prng.PRNGKey(6)))
    if not math.isfinite(det_loss):
        raise RuntimeError("detector train loss non-finite")
    if all(torch.equal(before[k], v) for k, v in model.state_dict().items()):
        raise RuntimeError("detector params did not update")
    del model, before

    # (5) multi-sequence SLAM, dp sequences
    slam = multi_sequence_tracking(config_from_dict(SLAM_CONFIG),
                                   *slam_sequences(dp, dev), **SLAM_KW,
                                   mesh=mesh)
    if tuple(slam.Tcw.shape) != (dp, 3, 4, 4) or not bool(
            torch.isfinite(slam.Tcw).all()):
        raise RuntimeError("multi-seq SLAM non-finite")
    if float((slam.Tcw[0] - slam.Tcw[-1]).abs().max()) <= 1e-4 and dp > 1:
        raise RuntimeError("multi-seq SLAM: the sequences' trajectories "
                           "agree")

    if mesh.rank == 0:
        print(f"dryrun_multichip ok: mesh={mesh.shape} loss={loss:.4f} "
              f"ba_cost {c0:.4f} -> {c1:.4f} "
              f"det_batch={int(out.boxes.shape[0])} det_loss={det_loss:.4f}",
              flush=True)
    return dict(mesh=mesh.shape, loss=loss, ba_cost=(c0, c1),
                det_batch=int(out.boxes.shape[0]), det_loss=det_loss)


def dryrun_multichip(n_devices: int, device=None, params=None) -> dict:
    """The dry run on an n_devices mesh; returns rank 0's values (see
    ``run_dryrun``). ``device="cpu"``: n_devices gloo processes, spawned.
    ``cuda`` (the default): one rank a card; one card runs in this process
    (over the default group if one is initialised, else a group of its
    own), more are spawned."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return spawn(run_dryrun, n_devices, params, device="cpu")[0]
    if n_devices > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip({n_devices}) on cuda needs a "
                           f"card a rank; this host has "
                           f"{torch.cuda.device_count()}")
    if n_devices > 1:
        return spawn(run_dryrun, n_devices, params, device="cuda")[0]
    own = not dist.is_initialized()
    if own:
        init_distributed("cuda")
    try:
        return run_dryrun(params)
    finally:
        if own:
            dist.destroy_process_group()


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
