"""Fixed-shape NMS and box utilities — counterpart of
``vido_slam_tpu/ops/nms.py`` (maskrcnn_benchmark's nms and boxlist ops).

Boxes are (x1, y1, x2, y2) with the +1 area convention. ``nms`` is the JAX
package's parallel fixpoint, not greedy NMS: it returns a fixed number of
indices with a validity mask, and it is batched over any leading axes
(the per-class NMS of the box head runs all 80 classes in one call).
"""

from __future__ import annotations

import torch

from vido_slam_tpu_torch.utils.order import argsort, top_k

BBOX_XFORM_CLIP = 4.135166556742356  # log(1000 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(x2 - x1 + 1) * (y2 - y1 + 1) (structures/bounding_box.py)."""
    return (boxes[..., 2] - boxes[..., 0] + 1) \
        * (boxes[..., 3] - boxes[..., 1] + 1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (..., N, M) of a (..., N, 4) and b (..., M, 4) with the
    +1 convention (boxlist_ops.boxlist_iou)."""
    area_a = box_area(a)
    area_b = box_area(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + 1, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :]
                               - inter, min=1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float, max_out: int, sweeps: int = 16):
    """Boxes (..., N, 4), scores and valid (..., N) -> (indices (..., max_out),
    keep_valid (..., max_out)): the kept boxes' indices in score order,
    then the suppressed and invalid ones in index order.

    The fixpoint of nms.py:39-91: boxes sorted by a stable argsort of
    -score (invalid ones at the lowest float), then ``sweeps`` rounds of
    keep = valid & ~(some higher-scored kept box overlaps by more than the
    threshold). A box whose suppression chain is at most ``sweeps`` deep is
    final; a converged state is a fixpoint, so always running ``sweeps``
    rounds gives the JAX function's early-exit result without reading the
    state back to the host. It differs from greedy NMS only for deeper
    chains, where it matches the JAX function."""
    N = boxes.shape[-2]
    s = torch.where(valid, scores,
                    torch.full_like(scores, torch.finfo(scores.dtype).min))
    order = argsort(-s)
    b = torch.take_along_dim(boxes, order[..., None], dim=-2)
    v = torch.take_along_dim(valid, order, dim=-1)
    ii = torch.arange(N, device=boxes.device)
    # strict[..., j, i]: j ranks above i and overlaps it
    strict = (box_iou(b, b) > iou_threshold) & (ii[:, None] < ii[None, :])
    keep = v
    for _ in range(sweeps):
        keep = v & ~(strict & keep[..., :, None]).any(-2)
    # kept first in score order, ties (the rest) toward the lower index
    prio = keep.to(torch.float32) * (N - ii).to(torch.float32)
    _, sel = top_k(prio, max_out)
    return (torch.take_along_dim(order, sel, dim=-1),
            torch.take_along_dim(keep, sel, dim=-1))


def clip_boxes(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """BoxList.clip_to_image: x in [0, W-1], y in [0, H-1]."""
    x1 = torch.clamp(boxes[..., 0], 0, width - 1)
    y1 = torch.clamp(boxes[..., 1], 0, height - 1)
    x2 = torch.clamp(boxes[..., 2], 0, width - 1)
    y2 = torch.clamp(boxes[..., 3], 0, height - 1)
    return torch.stack([x1, y1, x2, y2], -1)


def remove_small_boxes(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Validity of boxes with both sides (+1) at least ``min_size``."""
    ws = boxes[..., 2] - boxes[..., 0] + 1
    hs = boxes[..., 3] - boxes[..., 1] + 1
    return (ws >= min_size) & (hs >= min_size)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 bbox_xform_clip: float = BBOX_XFORM_CLIP) -> torch.Tensor:
    """BoxCoder.decode (modeling/box_coder.py): deltas (..., 4) dx, dy, dw,
    dh against anchors (..., 4) broadcast to them."""
    wx, wy, ww, wh = weights
    widths = anchors[..., 2] - anchors[..., 0] + 1
    heights = anchors[..., 3] - anchors[..., 1] + 1
    ctr_x = anchors[..., 0] + 0.5 * widths
    ctr_y = anchors[..., 1] + 0.5 * heights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=bbox_xform_clip)
    dh = torch.clamp(deltas[..., 3] / wh, max=bbox_xform_clip)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w - 1,
                        pred_ctr_y + 0.5 * pred_h - 1], -1)
