"""RetinaNet in NCHW, inference — counterpart of
``vido_slam_tpu/models/maskrcnn/retinanet.py`` (maskrcnn_benchmark's
rpn/retinanet).

The ResNet + FPN backbone of Mask R-CNN (``backbone.py``) and a head shared
by the levels: a class tower and a box tower of four 3x3 convs with ReLU
each, then 3x3 predictors of 9 anchors x 80 classes and 9 x 4 deltas. 9
anchors a cell: 3 aspect ratios x 3 octave scales. Inference per level: the
best class score of each anchor, the 1000 best above 0.05 (a stable top-k
over scores with -inf below the threshold, so the tie order is
``lax.top_k``'s), decoded with weights (10, 10, 5, 5) and clipped; then
one class-aware NMS 0.4 to 100 detections over all levels.

The JAX package's quirks are copied: its levels are P3-P6 of the FPN and
P7 = P6[::2, ::2] (not the reference's P6/P7 convs on C5), and the
class-aware NMS offsets each box by ``label * 10000.0`` in float32, so the
IoUs are those of the offset boxes, rounded as there.

Parameter names equal the JAX package's (``backbone.body...``,
``rpn.head.cls_tower.0.weight``, ...); ``RetinaNet.state_dict()`` takes
the JAX dict through ``convert.maskrcnn_state_dict_from_numpy``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vido_slam_tpu_torch.models.layers import Conv2d
from vido_slam_tpu_torch.models.maskrcnn.backbone import (
    Backbone, ResNetConfig, init_resnet_fpn_params)
from vido_slam_tpu_torch.models.maskrcnn.rpn import (generate_cell_anchors,
                                                     grid_anchors)
from vido_slam_tpu_torch.ops.nms import clip_boxes, decode_boxes, nms
from vido_slam_tpu_torch.utils.device import resolve_device
from vido_slam_tpu_torch.utils.order import argmax, top_k

ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_STRIDES = (8, 16, 32, 64, 128)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
SCALES_PER_OCTAVE = 3
NUM_ANCHORS = len(ASPECT_RATIOS) * SCALES_PER_OCTAVE
NUM_CLASSES_FG = 80
PRE_NMS_TOP_N = 1000
INFERENCE_TH = 0.05
NMS_TH = 0.4
DETECTIONS = 100
PRIOR_PROB = 0.01


def retina_cell_anchors(level: int) -> np.ndarray:
    """(9, 4) anchors of level 0..4 (P3..P7): 3 octave scales x 3
    ratios."""
    stride, base = ANCHOR_STRIDES[level], ANCHOR_SIZES[level]
    return np.concatenate([
        generate_cell_anchors(stride, base * 2.0 ** (o / SCALES_PER_OCTAVE),
                              ASPECT_RATIOS)
        for o in range(SCALES_PER_OCTAVE)], axis=0)


def _tower(channels: int) -> nn.Sequential:
    """Four 3x3 convs with ReLU; the ReLU modules at the odd indices keep
    the checkpoint's conv keys at 0, 2, 4, 6."""
    layers = []
    for _ in range(4):
        layers += [Conv2d(channels, channels, 3, 1, 1), nn.ReLU()]
    return nn.Sequential(*layers)


class RetinaNetHead(nn.Module):
    """``rpn.head``: cls_tower, bbox_tower, cls_logits, bbox_pred."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.cls_tower = _tower(channels)
        self.bbox_tower = _tower(channels)
        self.cls_logits = Conv2d(channels, NUM_ANCHORS * NUM_CLASSES_FG, 3,
                                 1, 1)
        self.bbox_pred = Conv2d(channels, NUM_ANCHORS * 4, 3, 1, 1)

    def forward(self, feat: torch.Tensor):
        """One level (1, C, H, W) -> (class logits (H*W*9, 80), deltas
        (H*W*9, 4)), location-major, anchor-minor."""
        cls = self.cls_logits(self.cls_tower(feat))[0].permute(1, 2, 0)
        box = self.bbox_pred(self.bbox_tower(feat))[0].permute(1, 2, 0)
        return cls.reshape(-1, NUM_CLASSES_FG), box.reshape(-1, 4)


class RetinaNet(nn.Module):
    """RetinaNet on the ResNet + FPN of ``resnet_cfg`` with
    ``init_retinanet_params`` of ``seed``, on ``device`` (the card unless
    the caller asks for the CPU)."""

    def __init__(self, resnet_cfg: ResNetConfig = ResNetConfig(),
                 seed: int = 0, device=None):
        super().__init__()
        self.resnet_cfg = resnet_cfg
        with torch.device("meta"):
            self.backbone = Backbone(resnet_cfg)
            self.rpn = nn.Module()
            self.rpn.head = RetinaNetHead(resnet_cfg.out_channels)
        self.load_state_dict(init_retinanet_params(
            torch.Generator().manual_seed(seed), resnet_cfg), assign=True)
        self.to(resolve_device(device))
        self._anchors: Dict[tuple, torch.Tensor] = {}

    def anchors(self, level: int, height: int, width: int,
                device: torch.device) -> torch.Tensor:
        key = (level, height, width, device)
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(grid_anchors(
                height, width, ANCHOR_STRIDES[level],
                retina_cell_anchors(level))).to(device)
        return self._anchors[key]


class RetinaNetOutput(NamedTuple):
    boxes: torch.Tensor    # (100, 4)
    scores: torch.Tensor   # (100,)
    labels: torch.Tensor   # (100,) int64, 1..80 (0 in padded slots)
    valid: torch.Tensor    # (100,) bool


def _level_candidates(model: RetinaNet, level: int, feat: torch.Tensor,
                      input_h: int, input_w: int):
    """One level's PRE_NMS_TOP_N candidates (boxes, scores, labels, valid),
    padded as retinanet.py:95-118 pads them."""
    cls, deltas = model.rpn.head(feat)
    anchors = model.anchors(level, feat.shape[2], feat.shape[3], feat.device)
    scores = torch.sigmoid(cls)
    best = scores.amax(-1)
    lab = argmax(scores) + 1
    k = min(PRE_NMS_TOP_N, best.shape[0])
    v, idx = top_k(torch.where(best > INFERENCE_TH, best,
                               torch.full_like(best, -float("inf"))), k)
    ok = torch.isfinite(v)
    bx = clip_boxes(decode_boxes(deltas[idx], anchors[idx],
                                 (10.0, 10.0, 5.0, 5.0)), input_h, input_w)
    lab = lab[idx]
    if k < PRE_NMS_TOP_N:
        pad = PRE_NMS_TOP_N - k
        bx = F.pad(bx, (0, 0, 0, pad))
        v = F.pad(v, (0, pad), value=-float("inf"))
        ok = F.pad(ok, (0, pad))
        lab = F.pad(lab, (0, pad))
    return bx, torch.where(ok, v, torch.zeros_like(v)), lab, ok


@torch.no_grad()
def retinanet_inference(model: RetinaNet, image: torch.Tensor, input_h: int,
                        input_w: int) -> RetinaNetOutput:
    """image (1, 3, input_h, input_w) float32 -> 100 detections
    (retinanet.py:80-141 of the JAX package)."""
    if tuple(image.shape) != (1, 3, input_h, input_w):
        raise ValueError(f"retinanet_inference: image {tuple(image.shape)}, "
                         f"expected (1, 3, {input_h}, {input_w})")
    feats = model.backbone(image)                          # P2..P6
    levels = feats[1:5] + [feats[4][:, :, ::2, ::2]]       # P3..P6, P7
    boxes, scores, labels, valid = (torch.cat(x) for x in zip(*(
        _level_candidates(model, li, f, input_h, input_w)
        for li, f in enumerate(levels))))
    off = labels.to(torch.float32)[:, None] * 10000.0
    kidx, kok = nms(boxes + off, scores, valid, NMS_TH, DETECTIONS)
    return RetinaNetOutput(boxes=boxes[kidx], scores=scores[kidx],
                           labels=labels[kidx], valid=kok)


def init_retinanet_params(generator: torch.Generator,
                          resnet_cfg: ResNetConfig = ResNetConfig()
                          ) -> Dict[str, torch.Tensor]:
    """Random parameters on the CPU with the JAX package's keys and torch
    layouts, drawn from ``generator`` as its ``init_retinanet_params``
    draws them (not its numbers): the backbone's init, the head's convs
    N(0, 0.01^2) with zero biases but the class logits' prior bias
    -log((1 - 0.01) / 0.01) (retinanet.py:66-77 of the reference)."""
    p = init_resnet_fpn_params(generator, resnet_cfg)
    C = resnet_cfg.out_channels

    def add_conv(name, cin, cout, bias=0.0):
        p[name + ".weight"] = torch.randn((cout, cin, 3, 3),
                                          generator=generator) * 0.01
        p[name + ".bias"] = torch.full((cout,), bias)

    for i in range(4):
        add_conv(f"rpn.head.cls_tower.{2 * i}", C, C)
        add_conv(f"rpn.head.bbox_tower.{2 * i}", C, C)
    add_conv("rpn.head.cls_logits", C, NUM_ANCHORS * NUM_CLASSES_FG,
             -math.log((1 - PRIOR_PROB) / PRIOR_PROB))
    add_conv("rpn.head.bbox_pred", C, NUM_ANCHORS * 4)
    return p
