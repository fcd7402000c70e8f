"""ROI box and mask heads in NCHW — counterpart of
``vido_slam_tpu/models/maskrcnn/roi_heads.py`` (maskrcnn_benchmark's FPN
heads: modeling/roi_heads/{box_head,mask_head}, modeling/poolers.py).

- Pooler: each ROI goes to FPN level floor(4 + log2(sqrt(area) / 224 +
  1e-6)) clamped to [2, 5], and is pooled there only: one launch of the
  multilevel ROIAlign kernel (``ops/roi_align.py``) per head.
- Box head: 7x7 pooling, fc6 and fc7 (1024), cls_score (81), bbox_pred
  (324).
- Post-processing: softmax, per-class decode with weights (10, 10, 5, 5),
  clip, score > 0.05, per-class NMS 0.5 over the 64 best of each of the 80
  classes in one batched call, the best 100 over all classes.
- Mask head: 14x14 pooling, four 3x3 convs with ReLU, a 2x2 stride-2
  transposed conv, the 81-class 1x1 logits, sigmoid, the detection's own
  class.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn as nn

from vido_slam_tpu_torch.models.layers import (Conv2d, ConvTranspose2d,
                                               Linear, relu)
from vido_slam_tpu_torch.ops.nms import (box_area, clip_boxes, decode_boxes,
                                         nms)
from vido_slam_tpu_torch.ops.roi_align import roi_align_multilevel, true_div
from vido_slam_tpu_torch.utils.order import top_k

NUM_CLASSES = 81
SCORE_THRESH = 0.05
NMS_THRESH = 0.5
DETECTIONS_PER_IMG = 100
BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
POOLER_SCALES = (0.25, 0.125, 0.0625, 0.03125)
CANDIDATES_PER_CLASS = 64


def assign_fpn_level(rois: torch.Tensor) -> torch.Tensor:
    """LevelMapper (poolers.py:11-44) in float32, as roi_heads.py:38-44
    (the division rounded once on the card too): index 0..3 of levels
    2..5, int32."""
    s = torch.sqrt(torch.clamp(box_area(rois), min=1e-6))
    lvl = torch.floor(4.0 + torch.log2(true_div(s, 224.0) + 1e-6))
    return (torch.clamp(lvl, 2, 5) - 2).to(torch.int32)


def pooled_features(feats: List[torch.Tensor], rois: torch.Tensor,
                    resolution: int) -> torch.Tensor:
    """(R, C, res, res): each ROI pooled at its assigned level of P2..P5."""
    return roi_align_multilevel(feats, rois, assign_fpn_level(rois),
                                POOLER_SCALES, resolution, 2)


class Detections(NamedTuple):
    boxes: torch.Tensor    # (D, 4)
    scores: torch.Tensor   # (D,)
    labels: torch.Tensor   # (D,) int64, 1..80
    valid: torch.Tensor    # (D,) bool


class BoxHead(nn.Module):
    """``roi_heads.box``: feature_extractor (fc6, fc7) and predictor."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.feature_extractor = nn.Module()
        self.feature_extractor.fc6 = Linear(channels * 7 * 7, 1024)
        self.feature_extractor.fc7 = Linear(1024, 1024)
        self.predictor = nn.Module()
        self.predictor.cls_score = Linear(1024, NUM_CLASSES)
        self.predictor.bbox_pred = Linear(1024, NUM_CLASSES * 4)


class MaskHead(nn.Module):
    """``roi_heads.mask``: feature_extractor (mask_fcn1-4) and predictor
    (conv5_mask, mask_fcn_logits)."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.feature_extractor = nn.Module()
        for i in range(1, 5):
            setattr(self.feature_extractor, f"mask_fcn{i}",
                    Conv2d(channels, channels, 3, 1, 1))
        self.predictor = nn.Module()
        self.predictor.conv5_mask = ConvTranspose2d(channels, channels, 2,
                                                    2, 0)
        self.predictor.mask_fcn_logits = Conv2d(channels, NUM_CLASSES, 1)


def box_head_forward(head: BoxHead, feats: List[torch.Tensor],
                     rois: torch.Tensor):
    """P2..P5 and proposals (R, 4) -> (class logits (R, 81), deltas
    (R, 81, 4)). NCHW pooling flattens in torch's order directly (the JAX
    package transposes first, roi_heads.py:80)."""
    x = pooled_features(feats, rois, 7).flatten(1)
    fe, pr = head.feature_extractor, head.predictor
    x = relu(fe.fc7(relu(fe.fc6(x))))
    return pr.cls_score(x), pr.bbox_pred(x).reshape(-1, NUM_CLASSES, 4)


def _decode_class_boxes(deltas: torch.Tensor,
                        rois: torch.Tensor) -> torch.Tensor:
    """(R, 81, 4) boxes: every class's deltas decoded against its ROI with
    the box coder weights (10, 10, 5, 5)."""
    return decode_boxes(deltas, rois[:, None, :], BBOX_REG_WEIGHTS)


def postprocess_detections(logits: torch.Tensor, deltas: torch.Tensor,
                           rois: torch.Tensor, roi_valid: torch.Tensor,
                           image_h: int, image_w: int) -> Detections:
    """box_head/inference.py as roi_heads.py:121-157 computes it, in
    float32: per class c in 1..80 the 64 best valid scores above 0.05,
    NMS 0.5 among them (the 80 classes in one batched call), then the best
    100 of all classes' kept boxes. Every selection is a stable top-k
    (ties toward the lower index, as ``lax.top_k``)."""
    logits = logits.to(torch.float32)
    probs = torch.softmax(logits, -1)
    boxes_all = clip_boxes(_decode_class_boxes(deltas.to(torch.float32),
                                               rois.to(torch.float32)),
                           image_h, image_w)
    c_scores = probs[:, 1:].T                                  # (80, R)
    c_boxes = boxes_all[:, 1:].permute(1, 0, 2)                # (80, R, 4)
    s = torch.where(roi_valid & (c_scores > SCORE_THRESH), c_scores,
                    -float("inf"))
    vals, idx = top_k(s, CANDIDATES_PER_CLASS)                 # (80, K)
    cand = torch.take_along_dim(c_boxes, idx[..., None], dim=1)
    kidx, kok = nms(cand, vals, torch.isfinite(vals), NMS_THRESH,
                    CANDIDATES_PER_CLASS)
    cb = torch.take_along_dim(cand, kidx[..., None], dim=1)
    cs = torch.take_along_dim(vals, kidx, dim=1)
    labels = torch.arange(1, NUM_CLASSES, device=logits.device)[:, None] \
        .expand(kok.shape)
    fs = torch.where(kok.reshape(-1), cs.reshape(-1), -float("inf"))
    vals, idx = top_k(fs, DETECTIONS_PER_IMG)
    return Detections(boxes=cb.reshape(-1, 4)[idx], scores=vals,
                      labels=labels.reshape(-1)[idx],
                      valid=torch.isfinite(vals))


def mask_head_forward(head: MaskHead, feats: List[torch.Tensor],
                      det: Detections) -> torch.Tensor:
    """(D, 28, 28) sigmoid masks of each detection's own class."""
    x = pooled_features(feats, det.boxes, 14)
    fe, pr = head.feature_extractor, head.predictor
    for i in range(1, 5):
        x = relu(getattr(fe, f"mask_fcn{i}")(x))
    x = relu(pr.conv5_mask(x))
    probs = torch.sigmoid(pr.mask_fcn_logits(x))               # (D, 81, 28, 28)
    return probs[torch.arange(probs.shape[0], device=probs.device),
                 det.labels]
