"""Region Proposal Network in NCHW — counterpart of
``vido_slam_tpu/models/maskrcnn/rpn.py`` (maskrcnn_benchmark's FPN RPN:
modeling/rpn/{rpn.py,anchor_generator.py,inference.py}).

Anchors follow the Detectron rounding recipe (numpy, copied from the JAX
package). Per level: sigmoid objectness top-k (1000), box decoding with
unit weights, clip, NMS 0.7, 1000 kept; then the top 1000 over all levels.
Every shape is fixed and every selection carries a validity mask, so the
levels' NMS runs as one call batched over the levels.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vido_slam_tpu_torch.models.layers import Conv2d
from vido_slam_tpu_torch.ops.nms import (clip_boxes, decode_boxes, nms,
                                         remove_small_boxes)
from vido_slam_tpu_torch.utils.order import top_k

ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_STRIDES = (4, 8, 16, 32, 64)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
PRE_NMS_TOP_N = 1000
POST_NMS_TOP_N = 1000
FPN_POST_NMS_TOP_N = 1000
NMS_THRESH = 0.7


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack([x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                      x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)])


def generate_cell_anchors(stride: int, size: int,
                          ratios=ASPECT_RATIOS) -> np.ndarray:
    """Detectron _generate_anchors: base [0, 0, stride-1, stride-1], ratio
    enumeration with rounding, then scale by size / stride. (A, 4)."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float64)
    w, h, xc, yc = _whctrs(base)
    size_ratios = (w * h) / np.asarray(ratios, np.float64)
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * np.asarray(ratios))
    ratio_anchors = _mkanchors(ws, hs, xc, yc)
    out = []
    scale = size / stride
    for a in ratio_anchors:
        w, h, xc, yc = _whctrs(a)
        out.append(_mkanchors(np.array([w * scale]), np.array([h * scale]),
                              xc, yc))
    return np.vstack(out).astype(np.float32)


def grid_anchors(height: int, width: int, stride: int,
                 cell: np.ndarray) -> np.ndarray:
    """(H*W*A, 4), location-major, anchor-minor (anchor_generator.py)."""
    sx = np.arange(width) * stride
    sy = np.arange(height) * stride
    shifts = np.stack([np.tile(sx, height), np.repeat(sy, width)] * 2,
                      axis=1).astype(np.float32)
    return (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)


class RPNHead(nn.Module):
    """The 3x3 conv and the two 1x1 predictors, shared by all levels."""

    def __init__(self, channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, 1, 1)
        self.cls_logits = Conv2d(channels, num_anchors, 1)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feat: torch.Tensor):
        """One level (1, C, H, W) -> (objectness (H*W*A,), deltas
        (H*W*A, 4)) in the anchors' location-major order (rpn.py:75-81,
        107-108)."""
        t = F.relu(self.conv(feat))
        logits = self.cls_logits(t)[0].permute(1, 2, 0).reshape(-1)
        deltas = self.bbox_pred(t)[0].permute(1, 2, 0).reshape(-1, 4)
        return logits, deltas


def rpn_head_concat(head: RPNHead, feats: List[torch.Tensor]):
    """``head`` over all levels in one pass (rpn.py:84-110): the levels
    (1, C, H_l, W_l) stacked along rows, widths zero-padded to the widest,
    one zero row after each level so that the 3x3 conv sees each level's
    own zero padding; the three convs run once and each level's rows and
    columns are cut back out. Equal to ``head`` level by level up to the
    convolutions' summation order. Returns [(objectness, deltas)] as
    ``RPNHead.forward`` gives them."""
    w_max = max(f.shape[3] for f in feats)
    fcat = torch.cat([F.pad(f, (0, w_max - f.shape[3], 0, 1))
                      for f in feats], dim=2)
    t = F.relu(head.conv(fcat))
    logits, deltas = head.cls_logits(t)[0], head.bbox_pred(t)[0]
    out, row = [], 0
    for f in feats:
        h, w = f.shape[2], f.shape[3]
        lg = logits[:, row:row + h, :w].permute(1, 2, 0).reshape(-1)
        dl = deltas[:, row:row + h, :w].permute(1, 2, 0).reshape(-1, 4)
        out.append((lg, dl))
        row += h + 1
    return out


def _topk_padded(scores: torch.Tensor, k: int):
    """top_k of k entries; with fewer than k scores the rest are -inf
    slots whose index clamps to the last score (rpn.py:121-126)."""
    n = scores.shape[0]
    if n < k:
        scores = F.pad(scores, (0, k - n), value=-float("inf"))
    vals, idx = top_k(scores, k)
    return vals, torch.clamp(idx, max=n - 1), torch.isfinite(vals)


def level_candidates(objectness: torch.Tensor, deltas: torch.Tensor,
                     anchors: torch.Tensor, image_h: int, image_w: int):
    """One level's NMS input: the PRE_NMS_TOP_N best anchors by sigmoid
    objectness (padded), decoded and clipped -> (boxes (PRE, 4), scores
    (PRE,), valid (PRE,))."""
    scores = torch.sigmoid(objectness.to(torch.float32))
    svals, sidx, svalid = _topk_padded(scores, PRE_NMS_TOP_N)
    boxes = decode_boxes(deltas.to(torch.float32)[sidx], anchors[sidx])
    boxes = clip_boxes(boxes, image_h, image_w)
    return boxes, svals, svalid & remove_small_boxes(boxes, 0)


def nms_levels(boxes: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor):
    """NMS 0.7 of candidates stacked over a leading axis of levels, each
    row on its own -> (boxes, scores, valid), POST_NMS_TOP_N a row."""
    keep_idx, keep_ok = nms(boxes, scores, valid, NMS_THRESH, POST_NMS_TOP_N)
    return (torch.take_along_dim(boxes, keep_idx[..., None], dim=-2),
            torch.take_along_dim(scores, keep_idx, dim=-1), keep_ok)


def select_proposals_level(objectness: torch.Tensor, deltas: torch.Tensor,
                           anchors: torch.Tensor, image_h: int, image_w: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One level -> (boxes (POST, 4), scores (POST,), valid (POST,))
    (rpn.py:129-147). The detector runs the levels' NMS as one batched call
    (``nms_levels``), which gives each level this result."""
    return nms_levels(*level_candidates(objectness, deltas, anchors, image_h,
                                        image_w))


def select_over_all_levels(boxes: List[torch.Tensor],
                           scores: List[torch.Tensor],
                           valids: List[torch.Tensor]):
    """Concatenate the levels and keep the global top 1000
    (rpn.py:150-159)."""
    b = torch.cat(boxes)
    v = torch.cat(valids)
    s = torch.where(v, torch.cat(scores), -float("inf"))
    vals, idx = top_k(s, FPN_POST_NMS_TOP_N)
    return b[idx], vals, torch.isfinite(vals)
