"""Mask R-CNN training losses in NCHW — counterpart of
``vido_slam_tpu/models/maskrcnn/losses.py`` (the reference's
rpn/loss.py, roi_heads/box_head/loss.py, roi_heads/mask_head/loss.py).

- RPN: anchors matched to the ground truth at IoU >= 0.7 (positive) and
  < 0.3 (negative), each GT's best anchor forced positive; 256 sampled an
  image at a positive fraction of 0.5; objectness BCE and smooth L1
  (beta 1/9) on the deltas, each summed over the sample and divided by 256.
- Box head: the 1000 proposals (built from detached scores and deltas)
  matched at IoU >= 0.5, 512 sampled at 0.25 positive; softmax CE over 81
  classes and smooth L1 on the matched class's deltas, weights
  (10, 10, 5, 5), each over 512.
- Mask head: 64 of the sampled positives, per-pixel BCE against the
  matched GT mask cropped bilinearly to the box at 28x28 and thresholded
  at 0.5.

Fixed shapes, as in the JAX package: GT objects pad to G with a validity
mask, and sampling is a noisy top-k (uniform draws of ``utils/prng.py``,
bit-equal to ``jax.random``, ranked by ``utils/order.top_k``: ties, the
-inf entries among them, go to the lower index as ``lax.top_k`` gives
them). Both heads pool through ``roi_align_multilevel``, which on the card
is kernel 5 with its backward kernel, so the box and mask losses reach the
FPN and the backbone.

The loss runs on ``model``'s own tensors: to train, give its parameters
and buffers ``requires_grad`` (``parallel/train.py::trainable_state``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from vido_slam_tpu_torch.models.layers import relu
from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNN
from vido_slam_tpu_torch.models.maskrcnn.roi_heads import (
    BBOX_REG_WEIGHTS, box_head_forward, pooled_features)
from vido_slam_tpu_torch.models.maskrcnn.rpn import (
    level_candidates, nms_levels, select_over_all_levels)
from vido_slam_tpu_torch.ops.nms import box_iou
from vido_slam_tpu_torch.ops.roi_align import true_div
from vido_slam_tpu_torch.utils import prng
from vido_slam_tpu_torch.utils.order import argmax, top_k

RPN_POS_IOU = 0.7
RPN_NEG_IOU = 0.3
RPN_BATCH = 256
RPN_POS_FRAC = 0.5
ROI_POS_IOU = 0.5
ROI_BATCH = 512
ROI_POS_FRAC = 0.25
MASK_ROIS = 64


class DetectionTargets(NamedTuple):
    boxes: torch.Tensor   # (G, 4) xyxy
    labels: torch.Tensor  # (G,) integer in 1..80
    masks: torch.Tensor   # (G, Hm, Wm) binary, image space (low-res ok)
    valid: torch.Tensor   # (G,) bool


def _encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                  weights) -> torch.Tensor:
    """BoxCoder.encode, extents floored at 1 px before the division and
    the log (clipped proposals can be degenerate)."""
    wx, wy, ww, wh = weights
    aw = torch.clamp(anchors[:, 2] - anchors[:, 0] + 1, min=1.0)
    ah = torch.clamp(anchors[:, 3] - anchors[:, 1] + 1, min=1.0)
    ax = anchors[:, 0] + 0.5 * aw
    ay = anchors[:, 1] + 0.5 * ah
    gw = torch.clamp(boxes[:, 2] - boxes[:, 0] + 1, min=1.0)
    gh = torch.clamp(boxes[:, 3] - boxes[:, 1] + 1, min=1.0)
    gx = boxes[:, 0] + 0.5 * gw
    gy = boxes[:, 1] + 0.5 * gh
    return torch.stack([wx * (gx - ax) / aw, wy * (gy - ay) / ah,
                        ww * torch.log(gw / aw), wh * torch.log(gh / ah)], -1)


def _smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, true_div(0.5 * x * x, beta), ax - 0.5 * beta)


def _match(anchors: torch.Tensor, targets: DetectionTargets, pos_iou: float,
           neg_iou: float):
    """(matched GT index, is_pos, is_neg) per anchor; every valid GT's best
    anchor (the first among equals) is positive. Where several GTs name the
    same best anchor, the last of them sets it, as JAX's scatter does on
    the CPU; padded GTs (IoU -1 everywhere) name anchor 0."""
    iou = box_iou(anchors, targets.boxes)                      # (A, G)
    iou = torch.where(targets.valid[None, :], iou, -1.0)
    best_gt = argmax(iou)
    best_iou = iou.amax(1)
    is_pos = best_iou >= pos_iou
    is_neg = (best_iou < neg_iou) & (best_iou >= 0)
    per_gt_best = argmax(iou.T)                                # (G,)
    G = per_gt_best.shape[0]
    last = torch.full((anchors.shape[0],), -1, dtype=torch.int64,
                      device=anchors.device).scatter_reduce(
        0, per_gt_best, torch.arange(G, device=anchors.device), "amax")
    force = (last >= 0) & targets.valid[last.clamp(min=0)]
    is_pos = is_pos | force
    return best_gt, is_pos, is_neg & ~is_pos


def _sample(key: torch.Tensor, is_pos: torch.Tensor, is_neg: torch.Tensor,
            batch: int, pos_frac: float) -> torch.Tensor:
    """Noisy top-k subsampling to fixed counts: the weight of each element,
    1 if sampled and 0 otherwise."""
    n = is_pos.shape[0]
    n_pos = min(int(batch * pos_frac), n)
    n_neg = min(batch - n_pos, n)
    kp, kn = prng.split(key)
    inf = torch.tensor(-float("inf"), device=is_pos.device)
    rp = torch.where(is_pos, prng.uniform(kp, is_pos.shape), inf)
    rn = torch.where(is_neg, prng.uniform(kn, is_neg.shape), inf)
    _, pi = top_k(rp, n_pos)
    _, ni = top_k(rn, n_neg)
    w = torch.zeros(is_pos.shape, dtype=torch.float32, device=is_pos.device)
    w = w.index_add(0, pi, torch.isfinite(rp[pi]).float())
    w = w.index_add(0, ni, torch.isfinite(rn[ni]).float())
    return torch.clamp(w, max=1.0)


def _crop_mask_to_box(masks: torch.Tensor, boxes: torch.Tensor,
                      out: int = 28) -> torch.Tensor:
    """Bilinear crops of image-space masks (N, Hm, Wm) to their boxes
    (N, 4), out x out each: Wy @ mask @ Wx^T."""
    Hm, Wm = masks.shape[1:]
    x1, y1, x2, y2 = boxes.unbind(-1)
    frac = true_div(torch.arange(out, dtype=torch.float32,
                                 device=masks.device) + 0.5, out)
    xs = x1[:, None] + frac * torch.clamp(x2 - x1, min=1.0)[:, None]
    ys = y1[:, None] + frac * torch.clamp(y2 - y1, min=1.0)[:, None]
    kx = torch.arange(Wm, dtype=torch.float32, device=masks.device)
    ky = torch.arange(Hm, dtype=torch.float32, device=masks.device)
    Wx = torch.clamp(1.0 - (xs[..., None] - kx).abs(), min=0.0)
    Wy = torch.clamp(1.0 - (ys[..., None] - ky).abs(), min=0.0)
    return Wy @ masks @ Wx.transpose(1, 2)


def _bce_with_logits(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return relu(x) - x * target \
        + torch.log1p(torch.exp(-x.abs()))


def maskrcnn_loss(model: MaskRCNN, image: torch.Tensor,
                  targets: DetectionTargets,
                  key: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The five loss parts of one image (1, 3, input_h, input_w) against
    its targets, drawn from ``key`` (losses.py:142-238 of the JAX
    package)."""
    cfg = model.cfg
    H, W = cfg.input_h, cfg.input_w
    feats = model.backbone(image)                              # P2..P6
    k_rpn, k_roi = prng.split(key)

    # ---- RPN ----
    heads = [model.rpn.head(f) for f in feats]
    rpn_cls, rpn_box, per_level = [], [], []
    for li, (f, (obj, dl)) in enumerate(zip(feats, heads)):
        anchors = model.anchors(li, f.shape[2], f.shape[3], f.device)
        gt_idx, is_pos, is_neg = _match(anchors, targets, RPN_POS_IOU,
                                        RPN_NEG_IOU)
        w = _sample(prng.fold_in(k_rpn, li), is_pos, is_neg, RPN_BATCH,
                    RPN_POS_FRAC)
        bce = _bce_with_logits(obj, is_pos.float())
        rpn_cls.append(torch.sum(bce * w) / RPN_BATCH)
        tgt = _encode_boxes(targets.boxes[gt_idx], anchors, (1.0,) * 4)
        diff = torch.where(is_pos[:, None], dl - tgt, 0.0)
        rpn_box.append(torch.sum(_smooth_l1(diff).sum(-1) * w) / RPN_BATCH)
        per_level.append(level_candidates(obj.detach(), dl.detach(), anchors,
                                          H, W))
    boxes, scores, valid = nms_levels(*(torch.stack(x)
                                        for x in zip(*per_level)))
    proposals, _, pvalid = select_over_all_levels(
        boxes.unbind(), scores.unbind(), valid.unbind())

    # ---- box head ----
    gt_idx, is_pos, is_neg = _match(proposals, targets, ROI_POS_IOU,
                                    ROI_POS_IOU)
    is_pos = is_pos & pvalid
    is_neg = is_neg & pvalid
    w = _sample(k_roi, is_pos, is_neg, ROI_BATCH, ROI_POS_FRAC)
    p2_p5 = feats[:4]
    logits, deltas = box_head_forward(model.roi_heads.box, p2_p5, proposals)
    cls_target = torch.where(is_pos, targets.labels[gt_idx].long(), 0)
    logp = F.log_softmax(logits, -1)
    ce = -torch.take_along_dim(logp, cls_target[:, None], dim=1)[:, 0]
    cls_loss = torch.sum(ce * w) / ROI_BATCH
    tgt = _encode_boxes(targets.boxes[gt_idx], proposals, BBOX_REG_WEIGHTS)
    dsel = deltas[torch.arange(deltas.shape[0], device=deltas.device),
                  cls_target]
    bdiff = torch.where(is_pos[:, None], dsel - tgt, 0.0)
    box_loss = torch.sum(_smooth_l1(bdiff).sum(-1) * w) / ROI_BATCH

    # ---- mask head, on sampled positives ----
    rp = torch.where(is_pos & (w > 0), prng.uniform(k_roi, is_pos.shape),
                     torch.tensor(-float("inf"), device=w.device))
    _, mi = top_k(rp, MASK_ROIS)
    m_ok = torch.isfinite(rp[mi])
    m_rois = proposals[mi]
    x = pooled_features(p2_p5, m_rois, 14)
    head = model.roi_heads.mask
    fe, pr = head.feature_extractor, head.predictor
    for i in range(1, 5):
        x = relu(getattr(fe, f"mask_fcn{i}")(x))
    x = relu(pr.conv5_mask(x))
    mlogits = pr.mask_fcn_logits(x)                    # (64, 81, 28, 28)
    msel = mlogits[torch.arange(MASK_ROIS, device=x.device), cls_target[mi]]
    m_gt = _crop_mask_to_box(targets.masks[gt_idx[mi]].float(), m_rois)
    m_gt = (m_gt > 0.5).float()
    mb = _bce_with_logits(msel, m_gt)
    mask_loss = torch.sum(mb.mean((1, 2)) * m_ok) / MASK_ROIS

    return {
        "loss_objectness": sum(rpn_cls),
        "loss_rpn_box_reg": sum(rpn_box),
        "loss_classifier": cls_loss,
        "loss_box_reg": box_loss,
        "loss_mask": mask_loss,
    }


def total_loss(model: MaskRCNN, image: torch.Tensor,
               targets: DetectionTargets, key: torch.Tensor) -> torch.Tensor:
    return sum(maskrcnn_loss(model, image, targets, key).values())
