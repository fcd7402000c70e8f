"""MonoDepth2's self-supervised trainer and its evaluation metrics in NCHW —
counterpart of ``vido_slam_tpu/models/monodepth2_train.py`` (the
reference's vendored trainer.py, layers.py and evaluate_depth.py /
evaluate_pose.py).

The depth net predicts multi-scale disparity for the centre frame, the
pose nets the motion to its temporal neighbours; each neighbour is warped
into the centre view through the depth, and the loss is the per-pixel
minimum over the sources of 0.85 SSIM + 0.15 L1, with identity
reprojection automasking (a 1e-5 normal noise tie-break, drawn by
``utils/prng.normal`` as ``jax.random.normal``) and edge-aware smoothness
1e-3 / 2^s, averaged over 4 scales (trainer.py:341-496). Stereo is off
unless the batch carries the stereo frame and its pose.

The warp samples with ``grid_sample_border``: the JAX package's gather
(torch's grid_sample with border padding and align_corners=True, the
vendored code's torch 0.4.1 default), not ``F.grid_sample``.

What is trained is the whole state of ``SelfSupModel``, BatchNorm
statistics included, as JAX's Adam updates its whole parameter dict
(``parallel/train.py::trainable_state``).

On a (dp, tp) mesh the step is ``parallel/train.py``'s scheme: each dp
rank takes its rows of the global batch (the ``*_aug`` frames too), and
the automasking noise is drawn over the global batch's shape and cut
into the same rows, as JAX draws it inside its global program. The
BatchNorms run on their running statistics (``layers.BatchNorm2d``, as
``models/monodepth2.py:39-46`` of the JAX package), so no batch statistic
crosses ranks: a SyncBatchNorm would change the function.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vido_slam_tpu_torch.models.monodepth2 import (
    DepthDecoder, PoseDecoder, ResNet18Encoder, disp_to_depth,
    init_monodepth2_params, init_pose_decoder_params)
from vido_slam_tpu_torch.ops.warp import resize_bilinear
from vido_slam_tpu_torch.parallel.mesh import Mesh, dp_mean, shard_batch
from vido_slam_tpu_torch.parallel.train import (compute_grads,
                                                make_optimizer, mesh_update,
                                                sharded_leaves,
                                                trainable_state)
from vido_slam_tpu_torch.utils import prng
from vido_slam_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# layers.py counterparts
# ---------------------------------------------------------------------------

def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM loss map, NCHW -> NCHW (layers.py:218-248): reflection pad 1,
    3x3 mean statistics, clamp((1 - SSIM) / 2, 0, 1)."""
    def pool(a):
        return F.avg_pool2d(F.pad(a, (1, 1, 1, 1), mode="reflect"), 3, 1)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = pool(x), pool(y)
    sig_x = pool(x * x) - mu_x * mu_x
    sig_y = pool(y * y) - mu_y * mu_y
    sig_xy = pool(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + c1) * (2 * sig_xy + c2)
    d = (mu_x * mu_x + mu_y * mu_y + c1) * (sig_x + sig_y + c2)
    return torch.clamp((1 - n / d) / 2, 0.0, 1.0)


def reprojection_loss(pred: torch.Tensor, target: torch.Tensor
                      ) -> torch.Tensor:
    """0.85 SSIM + 0.15 L1, channel-meaned -> (N, H, W)
    (trainer.py:393-405)."""
    l1 = torch.mean(torch.abs(target - pred), 1)
    return 0.85 * torch.mean(ssim(pred, target), 1) + 0.15 * l1


def get_smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order disparity smoothness (layers.py:202-215):
    disp (N, 1, H, W), img (N, 3, H, W)."""
    dx = torch.abs(disp[..., :-1] - disp[..., 1:])
    dy = torch.abs(disp[..., :-1, :] - disp[..., 1:, :])
    ix = torch.mean(torch.abs(img[..., :-1] - img[..., 1:]), 1, keepdim=True)
    iy = torch.mean(torch.abs(img[..., :-1, :] - img[..., 1:, :]), 1,
                    keepdim=True)
    return torch.mean(dx * torch.exp(-ix)) + torch.mean(dy * torch.exp(-iy))


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """(N, 3) axis-angle -> (N, 4, 4) rotation (layers.py:64-103:
    Rodrigues with the 1e-7 axis regulariser)."""
    angle = torch.linalg.norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca, sa = torch.cos(angle)[:, 0], torch.sin(angle)[:, 0]
    C = 1 - ca
    x, y, z = axis.unbind(-1)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rows = [[x * x * C + ca, x * y * C - z * sa, z * x * C + y * sa, zero],
            [x * y * C + z * sa, y * y * C + ca, y * z * C - x * sa, zero],
            [z * x * C - y * sa, y * z * C + x * sa, z * z * C + ca, zero],
            [zero, zero, zero, one]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def transformation_from_parameters(axisangle: torch.Tensor,
                                   translation: torch.Tensor,
                                   invert: bool = False) -> torch.Tensor:
    """(N, 3), (N, 3) -> (N, 4, 4): T R forward, R^T (-t) for invert
    (layers.py:28-45)."""
    R = rot_from_axisangle(axisangle)
    t = -translation if invert else translation
    if invert:
        R = R.transpose(1, 2)
    N = R.shape[0]
    eye = torch.eye(4, dtype=R.dtype, device=R.device).expand(N, 4, 4)
    T = torch.cat([torch.cat([eye[:, :3, :3], t[:, :, None]], 2),
                   eye[:, 3:]], 1)
    return torch.matmul(R, T) if invert else torch.matmul(T, R)


def grid_sample_border(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with border padding and align_corners=True (torch
    grid_sample's), as the JAX package gathers it: img (N, C, H, W), grid
    (N, H', W', 2) normalised to [-1, 1] -> (N, C, H', W')."""
    N, C, H, W = img.shape
    Hp, Wp = grid.shape[1:3]
    x = torch.clamp((grid[..., 0] + 1) * 0.5 * (W - 1), 0.0, W - 1.0)
    y = torch.clamp((grid[..., 1] + 1) * 0.5 * (H - 1), 0.0, H - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = (x - x0).reshape(N, 1, -1)
    fy = (y - y0).reshape(N, 1, -1)
    x0i = x0.to(torch.int64).reshape(N, 1, -1)
    y0i = y0.to(torch.int64).reshape(N, 1, -1)
    flat = img.reshape(N, C, H * W)

    def tap(xi, yi):
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return torch.gather(flat, 2, idx.expand(N, C, idx.shape[2]))

    top = tap(x0i, y0i) * (1 - fx) + tap(x0i + 1, y0i) * fx
    bot = tap(x0i, y0i + 1) * (1 - fx) + tap(x0i + 1, y0i + 1) * fx
    return (top * (1 - fy) + bot * fy).reshape(N, C, Hp, Wp)


def project_warp(src: torch.Tensor, depth: torch.Tensor, K: torch.Tensor,
                 inv_K: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """BackprojectDepth + Project3D + grid_sample (layers.py:139-193): the
    source frame (N, 3, H, W) warped into the target view through the
    target's depth (N, H, W) and the relative pose T (target -> source);
    K, inv_K, T (N, 4, 4)."""
    N, H, W = depth.shape
    dev = depth.device
    jj, ii = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([ii.reshape(-1), jj.reshape(-1),
                       torch.ones(H * W, device=dev)], 0)        # (3, HW)
    cam = torch.matmul(inv_K[:, :3, :3], pix)                     # (N, 3, HW)
    cam = depth.reshape(N, 1, -1) * cam
    cam = torch.cat([cam, torch.ones((N, 1, H * W), device=dev)], 1)
    P = torch.matmul(K, T)[:, :3]                                 # (N, 3, 4)
    proj = torch.matmul(P, cam)                                   # (N, 3, HW)
    xy = proj[:, :2] / (proj[:, 2:3] + 1e-7)
    gx = xy[:, 0].reshape(N, H, W) / (W - 1)
    gy = xy[:, 1].reshape(N, H, W) / (H - 1)
    grid = torch.stack([gx, gy], -1) * 2.0 - 1.0
    return grid_sample_border(src, grid)


# ---------------------------------------------------------------------------
# the model: depth encoder/decoder and the separate pose encoder/decoder
# ---------------------------------------------------------------------------

def init_pose_encoder_params(generator: torch.Generator,
                             prefix: str = "pose_encoder"
                             ) -> Dict[str, torch.Tensor]:
    """The ResNet-18 layout with a 6-channel conv1 (two stacked frames): a
    depth encoder's init, conv1 repeated over both frames and halved, as
    the JAX package (and the reference's pretrained loader) builds it."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in init_monodepth2_params(generator).items():
        if not k.startswith("encoder."):
            continue
        if k == "encoder.conv1.weight":
            v = torch.cat([v, v], 1) / 2.0
        out[prefix + k[len("encoder"):]] = v
    return out


def init_selfsup_params(generator: torch.Generator
                        ) -> Dict[str, torch.Tensor]:
    """Depth encoder/decoder + pose encoder/decoder in one flat dict."""
    p = dict(init_monodepth2_params(generator))
    p.update(init_pose_encoder_params(generator))
    p.update(init_pose_decoder_params(generator, num_input_features=1,
                                      num_frames=2))
    return p


class SelfSupModel(nn.Module):
    """The trainer's four nets (trainer.py:51-94, separate_resnet pose):
    ``encoder``/``decoder`` (depth), ``pose_encoder`` (two frames) and
    ``pose_decoder`` (one input feature, two frames), keyed as the JAX
    package's ``init_selfsup_params`` dict, from ``init_selfsup_params``
    of ``seed`` on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, seed: int = 0, device=None):
        super().__init__()
        with torch.device("meta"):
            self.encoder = ResNet18Encoder()
            self.decoder = DepthDecoder()
            self.pose_encoder = ResNet18Encoder(num_input_images=2)
            self.pose_decoder = PoseDecoder(num_input_features=1,
                                            num_frames=2)
        self.load_state_dict(init_selfsup_params(
            torch.Generator().manual_seed(seed)), assign=True)
        self.to(resolve_device(device))


def predict_pose(model: SelfSupModel, frame_a: torch.Tensor,
                 frame_b: torch.Tensor, invert: bool) -> torch.Tensor:
    """separate_resnet pose (trainer.py:276-293): the two frames stacked in
    temporal order, the pose encoder and decoder, the first of the two
    predicted transforms, inverted for a past frame."""
    feats = model.pose_encoder(torch.cat([frame_a, frame_b], 1))
    aa, tt = model.pose_decoder([feats[-1]])
    return transformation_from_parameters(aa[:, 0, 0], tt[:, 0, 0], invert)


class SelfSupBatch(NamedTuple):
    """One minibatch. color/prev/next: (N, 3, H, W) RGB in [0, 1] (H, W
    multiples of 32); K/inv_K (N, 4, 4) at full resolution; stereo and
    stereo_T optional; the *_aug fields are the colour-jittered copies fed
    to the nets (None: the clean frames), the loss always uses the clean
    ones."""
    color: torch.Tensor
    prev: torch.Tensor
    next: torch.Tensor
    K: torch.Tensor
    inv_K: torch.Tensor
    stereo: Optional[torch.Tensor] = None
    stereo_T: Optional[torch.Tensor] = None
    color_aug: Optional[torch.Tensor] = None
    prev_aug: Optional[torch.Tensor] = None
    next_aug: Optional[torch.Tensor] = None


def selfsup_loss(model: SelfSupModel, batch: SelfSupBatch,
                 key: torch.Tensor, *,
                 scales: Tuple[int, ...] = (0, 1, 2, 3),
                 min_depth: float = 0.1, max_depth: float = 100.0,
                 disparity_smoothness: float = 1e-3,
                 automasking: bool = True,
                 rows: Optional[Tuple[int, int]] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total self-supervised loss and an aux dict (each scale's loss,
    the full-resolution depth), as monodepth2_train.py:209-294 of the JAX
    package computes them. ``rows`` = (first, B): the batch is rows
    first.. of a global batch of B, whose noise is drawn whole and cut."""
    N, _, H, W = batch.color.shape
    cur_in = batch.color if batch.color_aug is None else batch.color_aug
    prev_in = batch.prev if batch.prev_aug is None else batch.prev_aug
    next_in = batch.next if batch.next_aug is None else batch.next_aug
    disps = model.decoder(model.encoder(cur_in))

    sources = [(batch.prev, predict_pose(model, prev_in, cur_in, True)),
               (batch.next, predict_pose(model, cur_in, next_in, False))]
    if batch.stereo is not None:
        sources.append((batch.stereo, batch.stereo_T))

    if automasking:
        ident = torch.stack([reprojection_loss(src, batch.color)
                             for src, _ in sources], 1)       # (N, S, H, W)
        first, total = (0, N) if rows is None else rows
        noise = prng.normal(key.to(ident.device),
                            (total,) + tuple(ident.shape[1:]))
        ident = ident + noise[first:first + N] * 1e-5

    total = 0.0
    aux: Dict[str, torch.Tensor] = {}
    for s in scales:
        disp_s = disps[s]
        disp_full = disp_s if s == 0 else resize_bilinear(disp_s, H, W)
        _, depth = disp_to_depth(disp_full[:, 0], min_depth, max_depth)
        if s == 0:
            aux["depth"] = depth
        reproj = torch.stack([reprojection_loss(
            project_warp(src, depth, batch.K, batch.inv_K, T), batch.color)
            for src, T in sources], 1)                         # (N, S, H, W)
        combined = torch.cat([ident, reproj], 1) if automasking else reproj
        loss_s = torch.mean(torch.amin(combined, 1))
        color_s = batch.color if s == 0 else resize_bilinear(
            batch.color, H >> s, W >> s)
        mean_disp = torch.mean(disp_s, (2, 3), keepdim=True)
        smooth = get_smooth_loss(disp_s / (mean_disp + 1e-7), color_s)
        loss_s = loss_s + disparity_smoothness * smooth / (2 ** s)
        aux[f"loss/{s}"] = loss_s
        total = total + loss_s
    return total / len(scales), aux


def make_selfsup_train_step(model: SelfSupModel, lr: float = 1e-4,
                            mesh: Optional[Mesh] = None, **loss_kw):
    """(batch, key) -> loss: one Adam step (1e-4, trainer.py:91) of
    ``selfsup_loss`` over the model's whole state, in place. On a
    ``mesh`` (monodepth2_train.py:302-335 of the JAX package) the batch is
    the global one and the loss the dp mean."""
    whole = trainable_state(model)
    params = whole if mesh is None else sharded_leaves(whole, mesh)
    opt = make_optimizer(params, lr)

    def step(batch: SelfSupBatch, key: torch.Tensor) -> torch.Tensor:
        if mesh is None:
            loss, _ = selfsup_loss(model, batch, key, **loss_kw)
            compute_grads(loss, whole)
            opt.step()
            return loss.detach()
        B = batch.color.shape[0]
        local = shard_batch(batch, mesh)
        loss, _ = selfsup_loss(model, local, key,
                               rows=(mesh.dp_rank * (B // mesh.dp), B),
                               **loss_kw)
        compute_grads(loss, whole)
        mesh_update(opt, whole, params, mesh)
        return dp_mean(loss.detach(), mesh)

    return step


# ---------------------------------------------------------------------------
# evaluation (evaluate_depth.py, evaluate_pose.py)
# ---------------------------------------------------------------------------

def compute_depth_errors(gt: torch.Tensor, pred: torch.Tensor
                         ) -> Dict[str, torch.Tensor]:
    """abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3 over the given pixels
    (evaluate_depth.py:27-45)."""
    thresh = torch.maximum(gt / pred, pred / gt)
    return {
        "abs_rel": torch.mean(torch.abs(gt - pred) / gt),
        "sq_rel": torch.mean((gt - pred) ** 2 / gt),
        "rmse": torch.sqrt(torch.mean((gt - pred) ** 2)),
        "rmse_log": torch.sqrt(torch.mean((torch.log(gt)
                                           - torch.log(pred)) ** 2)),
        "a1": torch.mean((thresh < 1.25).float()),
        "a2": torch.mean((thresh < 1.25 ** 2).float()),
        "a3": torch.mean((thresh < 1.25 ** 3).float()),
    }


def evaluate_depth(pred_disp, gt_depth, *, min_depth: float = 1e-3,
                   max_depth: float = 80.0,
                   median_scaling: bool = True) -> Dict[str, float]:
    """One frame's scores (evaluate_depth.py:135-186): depth = 1/disp
    resized to the GT's size, median-scaled to the GT for a mono model,
    clipped to [min_depth, max_depth], over the pixels with GT > 0.
    pred_disp (h, w), gt_depth (H, W), numpy or tensors."""
    gt = np.asarray(gt_depth)
    H, W = gt.shape
    disp = resize_bilinear(torch.as_tensor(np.asarray(pred_disp, np.float32)
                                           )[None, None], H, W)[0, 0].numpy()
    pred = 1.0 / np.maximum(disp, 1e-12)
    mask = gt > 0
    p, g = pred[mask], gt[mask]
    if median_scaling:
        p = p * np.median(g) / np.median(p)
    p = np.clip(p, min_depth, max_depth)
    return {k: float(v) for k, v in compute_depth_errors(
        torch.as_tensor(g, dtype=torch.float32),
        torch.as_tensor(p, dtype=torch.float32)).items()}


def dump_xyz(rel_transforms) -> np.ndarray:
    """Camera positions (M + 1, 3) from M source->target relative
    transforms (evaluate_pose.py:23-30), starting at the origin."""
    xyzs = [np.zeros(3)]
    cam_to_world = np.eye(4)
    for T in np.asarray(rel_transforms):
        cam_to_world = cam_to_world @ T
        xyzs.append(cam_to_world[:3, 3].copy())
    return np.stack(xyzs)


def compute_ate_snippet(gt_xyz, pred_xyz) -> float:
    """Snippet ATE after first-frame alignment and the closed-form scale
    (evaluate_pose.py:34-46; normalised by N, as the reference does)."""
    gt_xyz = np.asarray(gt_xyz, np.float64)
    pred = np.asarray(pred_xyz, np.float64)
    pred = pred + (gt_xyz[0] - pred[0])[None]
    scale = np.sum(gt_xyz * pred) / max(np.sum(pred ** 2), 1e-12)
    err = pred * scale - gt_xyz
    return float(np.sqrt(np.sum(err ** 2)) / gt_xyz.shape[0])


def evaluate_pose_snippets(pred_rel, gt_rel, track_length: int = 5):
    """The evaluate_pose.py loop (:114-125): each ``track_length``-frame
    window of both relative-pose sequences integrated and scored. Returns
    (mean, std, the list)."""
    pred_rel = np.asarray(pred_rel)
    gt_rel = np.asarray(gt_rel)
    if pred_rel.shape != gt_rel.shape:
        raise ValueError(f"pose sequences differ: {pred_rel.shape} and "
                         f"{gt_rel.shape}")
    ates = []
    for i in range(0, pred_rel.shape[0] - track_length + 2):
        p = dump_xyz(pred_rel[i:i + track_length - 1])
        g = dump_xyz(gt_rel[i:i + track_length - 1])
        ates.append(compute_ate_snippet(g, p))
    return float(np.mean(ates)), float(np.std(ates)), ates
