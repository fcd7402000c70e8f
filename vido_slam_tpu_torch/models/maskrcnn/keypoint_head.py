"""Keypoint R-CNN head in NCHW, inference — counterpart of
``vido_slam_tpu/models/maskrcnn/keypoint_head.py`` (maskrcnn_benchmark's
roi_heads/keypoint_head).

14x14 ROIAlign pooling at each ROI's FPN level (``roi_heads.pooled_
features``: one launch of kernel 5 on the card), eight 3x3 convs of 512
channels with ReLU, ``ConvTranspose2d(512, 17, 4, 2, 1)`` to 28x28, and a
x2 bilinear resize (half-pixel centres, as ``jax.image.resize``'s
"linear" upward) to (R, 17, 56, 56) heatmap logits.

``keypoints_from_heatmaps`` takes each keypoint's argmax on the fixed
56x56 grid (the first cell on ties, as ``jnp.argmax``) and maps the cell
centre into the box, as the JAX package does; the reference resizes each
heatmap to its box's pixel size with cv2 first.

The JAX package stores the transposed conv's weight as (kh, kw, cout,
cin); ``convert.maskrcnn_state_dict_from_numpy`` carries it into torch's
(cin, cout, kh, kw), as it does conv5_mask's.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vido_slam_tpu_torch.models.layers import Conv2d, ConvTranspose2d
from vido_slam_tpu_torch.models.maskrcnn import roi_heads
from vido_slam_tpu_torch.ops.roi_align import true_div
from vido_slam_tpu_torch.ops.warp import resize_bilinear
from vido_slam_tpu_torch.utils.device import resolve_device
from vido_slam_tpu_torch.utils.order import argmax

NUM_KEYPOINTS = 17      # COCO person keypoints
CONV_LAYERS = 8
CONV_DIM = 512
HEATMAP = 56
POOL = 14


class KeypointOutput(NamedTuple):
    xy: torch.Tensor      # (R, 17, 2) image-space keypoint positions
    logits: torch.Tensor  # (R, 17) heatmap logit at the argmax
    probs: torch.Tensor   # (R, 17) spatial-softmax probability there


class KeypointHead(nn.Module):
    """``roi_heads.keypoint``: feature_extractor (conv_fcn1-8) and
    predictor (kps_score_lowres), with ``init_keypoint_params`` of
    ``seed`` on ``device`` (the card unless the caller asks for the CPU).
    Its ``state_dict()`` keys equal the JAX package's parameter names
    under ``roi_heads.keypoint.``."""

    def __init__(self, in_channels: int = 256, seed: int = 0, device=None):
        super().__init__()
        with torch.device("meta"):
            self.feature_extractor = nn.Module()
            cin = in_channels
            for i in range(1, CONV_LAYERS + 1):
                setattr(self.feature_extractor, f"conv_fcn{i}",
                        Conv2d(cin, CONV_DIM, 3, 1, 1))
                cin = CONV_DIM
            self.predictor = nn.Module()
            self.predictor.kps_score_lowres = ConvTranspose2d(
                CONV_DIM, NUM_KEYPOINTS, 4, 2, 1)
        prefix = "roi_heads.keypoint."
        self.load_state_dict({k[len(prefix):]: v for k, v in
                              init_keypoint_params(
                                  torch.Generator().manual_seed(seed),
                                  in_channels).items()}, assign=True)
        self.to(resolve_device(device))


@torch.no_grad()
def keypoint_head_forward(head: KeypointHead, feats: List[torch.Tensor],
                          boxes: torch.Tensor) -> torch.Tensor:
    """P2..P5 (each (1, C, H, W)) and boxes (R, 4) in input-image
    coordinates -> (R, 17, 56, 56) heatmap logits."""
    x = roi_heads.pooled_features(feats, boxes, POOL)
    fe = head.feature_extractor
    for i in range(1, CONV_LAYERS + 1):
        x = F.relu(getattr(fe, f"conv_fcn{i}")(x))
    x = head.predictor.kps_score_lowres(x)                  # (R, 17, 28, 28)
    return resize_bilinear(x, HEATMAP, HEATMAP)


def keypoints_from_heatmaps(logits: torch.Tensor,
                            boxes: torch.Tensor) -> KeypointOutput:
    """heatmaps_to_keypoints on the fixed grid (keypoint_head.py:77-97 of
    the JAX package): logits (R, 17, 56, 56), boxes (R, 4)."""
    R = logits.shape[0]
    flat = logits.reshape(R, NUM_KEYPOINTS, HEATMAP * HEATMAP).float()
    best = flat.amax(-1)
    pos = argmax(flat)
    x_int = (pos % HEATMAP).float()
    y_int = torch.div(pos, HEATMAP, rounding_mode="floor").float()
    w = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1.0)[:, None]
    h = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1.0)[:, None]
    x = true_div((x_int + 0.5) * w, HEATMAP) + boxes[:, 0][:, None]
    y = true_div((y_int + 0.5) * h, HEATMAP) + boxes[:, 1][:, None]
    prob = torch.take_along_dim(torch.softmax(flat, -1), pos[..., None],
                                dim=-1)[..., 0]
    return KeypointOutput(xy=torch.stack([x, y], -1), logits=best,
                          probs=prob)


def init_keypoint_params(generator: torch.Generator,
                         in_channels: int = 256) -> Dict[str, torch.Tensor]:
    """Random parameters on the CPU with the JAX package's keys and torch
    layouts, drawn from ``generator`` as its ``init_keypoint_params`` draws
    them (not its numbers): Kaiming fan-out normals, zero biases."""
    p: Dict[str, torch.Tensor] = {}
    pre = "roi_heads.keypoint"
    cin = in_channels
    for i in range(1, CONV_LAYERS + 1):
        std = (2.0 / (3 * 3 * CONV_DIM)) ** 0.5
        p[f"{pre}.feature_extractor.conv_fcn{i}.weight"] = torch.randn(
            (CONV_DIM, cin, 3, 3), generator=generator) * std
        p[f"{pre}.feature_extractor.conv_fcn{i}.bias"] = torch.zeros(CONV_DIM)
        cin = CONV_DIM
    std = (2.0 / (4 * 4 * NUM_KEYPOINTS)) ** 0.5
    p[f"{pre}.predictor.kps_score_lowres.weight"] = torch.randn(
        (CONV_DIM, NUM_KEYPOINTS, 4, 4), generator=generator) * std
    p[f"{pre}.predictor.kps_score_lowres.bias"] = torch.zeros(NUM_KEYPOINTS)
    return p
