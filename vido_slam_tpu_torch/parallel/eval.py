"""Batched evaluation — counterpart of ``vido_slam_tpu/parallel/eval.py``.

The JAX package stacks S window problems into one vmapped program and
shards it over a mesh's ``dp`` axis; detection inference and COCO scoring
shard the image batch the same way. Here each function takes a ``device``
(``cuda`` unless the caller passes ``"cpu"``) and runs the batch on it one
item after another: each window problem keeps its own LM stop, as JAX's
vmapped ``while_loop`` freezes a finished problem while the others
iterate. Given a ``mesh`` (``parallel/mesh.py``; its device is then the
one used), each dp rank runs its rows of the batch with that same code
and the results are all-gathered over the dp group, so every rank holds
the whole stacked result, as JAX replicates it and as the reference's
``_accumulate_predictions_from_multiple_gpus`` gathers it. The tp ranks of
one dp row compute the same rows; the gather takes them once. dp must
divide the batch (``shard_batch``), as JAX's sharding requires.

On the card, ``sharded_detection_inference`` runs kernel 5 (the FPN
multilevel ROIAlign) twice an image, and ``sharded_window_ba`` runs the
window BA's own torch ops (no TPU kernel). The mask paste, the prediction
dicts and the AP are host numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vido_slam_tpu_torch.data.coco_eval import compute_map
from vido_slam_tpu_torch.estimation.window_ba import (WindowBAResult,
                                                      solve_window_ba)
from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNNOutput,
                                                       maskrcnn_inference)
from vido_slam_tpu_torch.parallel.mesh import (Mesh, gather_batch,
                                               shard_batch)
from vido_slam_tpu_torch.utils.device import resolve_device


class BatchedWindowProblem(NamedTuple):
    """S stacked fixed-shape window problems (leading axis = sequence)."""

    Twc0: torch.Tensor         # (S, W, 4, 4)
    odom: torch.Tensor         # (S, W-1, 4, 4)
    odom_valid: torch.Tensor   # (S, W-1)
    X0: torch.Tensor           # (S, P, 3)
    obs: torch.Tensor          # (S, W, P, 3)
    obs_valid: torch.Tensor    # (S, W, P)
    point_valid: torch.Tensor  # (S, P)
    frame_valid: torch.Tensor  # (S, W)


_FLOAT_FIELDS = ("Twc0", "odom", "X0", "obs")


def sharded_window_ba(probs: BatchedWindowProblem, max_iters: int = 15,
                      device=None, mesh: Optional[Mesh] = None
                      ) -> WindowBAResult:
    """Solve S window problems on ``device``, each by ``solve_window_ba``
    with its own stop; on a ``mesh``, S/dp of them a dp rank. Returns the
    stacked result: Twc (S, W, 4, 4), points (S, P, 3), cost (S,),
    num_iters (S,) int32."""
    if mesh is not None:
        return gather_batch(sharded_window_ba(
            shard_batch(probs, mesh), max_iters, mesh.device), mesh)
    dev = resolve_device(device)
    probs = BatchedWindowProblem(**{
        k: torch.as_tensor(v, device=dev, dtype=torch.float32
                           if k in _FLOAT_FIELDS else torch.bool)
        for k, v in probs._asdict().items()})
    results = [solve_window_ba(*(x[s] for x in probs), max_iters=max_iters)
               for s in range(probs.Twc0.shape[0])]
    return WindowBAResult(
        Twc=torch.stack([r.Twc for r in results]),
        points=torch.stack([r.points for r in results]),
        cost=torch.stack([torch.as_tensor(r.cost, device=dev)
                          for r in results]),
        num_iters=torch.tensor([int(r.num_iters) for r in results],
                               dtype=torch.int32, device=dev))


def evaluate_sequences(probs: BatchedWindowProblem, gt_Twc,
                       max_iters: int = 15, device=None,
                       mesh: Optional[Mesh] = None):
    """The S solves (``sharded_window_ba``) and each sequence's ATE RMSE
    against the ground-truth camera-to-world poses (S, W, 4, 4). Returns
    (result, ate (S,))."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    res = sharded_window_ba(probs, max_iters, dev, mesh)
    c_est = res.Twc[..., :3, 3]
    c_gt = torch.as_tensor(gt_Twc, device=dev, dtype=torch.float32)[
        ..., :3, 3]
    fv = torch.as_tensor(probs.frame_valid, device=dev, dtype=torch.float32)
    d2 = torch.sum((c_est - c_gt) ** 2, dim=-1) * fv
    ate = torch.sqrt(torch.sum(d2, dim=-1)
                     / torch.clamp(fv.sum(-1), min=1.0))
    return res, ate


# ---------------------------------------------------------------------------
# detection inference and evaluation — the counterpart of the reference's
# detection eval loop (maskrcnn_benchmark/engine/inference.py:11-86) on one
# device: the images one after another, the outputs stacked as the JAX
# package's gathered batch
# ---------------------------------------------------------------------------

def sharded_detection_inference(model, images, device=None,
                                mesh: Optional[Mesh] = None
                                ) -> MaskRCNNOutput:
    """Mask R-CNN inference (``maskrcnn_inference``) on B preprocessed
    images (B, 3, H, W), one image a call on ``device``, where ``model``
    must already be; on a ``mesh``, B/dp images a dp rank (dp must divide
    B, parallel/eval.py:95 of the JAX package). Returns a MaskRCNNOutput
    with a leading B."""
    if mesh is not None:
        return gather_batch(sharded_detection_inference(
            model, shard_batch(images, mesh), mesh.device), mesh)
    images = torch.as_tensor(images, device=resolve_device(device),
                             dtype=torch.float32)
    outs = [maskrcnn_inference(model, images[b:b + 1].contiguous())
            for b in range(images.shape[0])]
    return MaskRCNNOutput(*(torch.stack(x) for x in zip(*outs)))


def paste_instance_masks_np(boxes, masks28, valid, out_hw, in_hw,
                            mask_threshold: float = 0.5) -> np.ndarray:
    """Per-instance full-image binary masks, host numpy — the Masker of
    the reference's eval prep (mask_head/inference.py): expand_boxes
    scale (28+2)/28, pad 1, then — like paste_mask_in_image — the
    expanded box is ROUNDED TO INTEGER bounds (`box.to(torch.int32)`,
    TO_REMOVE=1) before the bilinear resize and integer paste, so
    thresholded masks land on the same pixels as the reference eval.
    boxes (D, 4) in model-input coords; returns (D, out_h, out_w) bool."""
    out_h, out_w = out_hw
    in_h, in_w = in_hw
    boxes = np.asarray(boxes, np.float64) * np.asarray(
        [out_w / in_w, out_h / in_h, out_w / in_w, out_h / in_h])
    masks = np.pad(np.asarray(masks28, np.float64),
                   ((0, 0), (1, 1), (1, 1)))  # (D, 30, 30)
    valid = np.asarray(valid, bool)
    D = boxes.shape[0]
    out = np.zeros((D, out_h, out_w), bool)
    ks = np.arange(30, dtype=np.float64)
    xs = np.arange(out_w, dtype=np.float64)
    ys = np.arange(out_h, dtype=np.float64)
    for d in range(D):
        if not valid[d]:
            continue
        x0, y0, x1, y1 = boxes[d]
        cx, cy = (x0 + x1) * 0.5, (y0 + y1) * 0.5
        hw = (x1 - x0) * 0.5 * (30.0 / 28.0)
        hh = (y1 - y0) * 0.5 * (30.0 / 28.0)
        # torch `.to(torch.int32)` truncates toward zero
        bx0 = float(np.trunc(cx - hw))
        bx1 = float(np.trunc(cx + hw))
        by0 = float(np.trunc(cy - hh))
        by1 = float(np.trunc(cy + hh))
        w = max(bx1 - bx0 + 1.0, 1.0)   # TO_REMOVE = 1
        h = max(by1 - by0 + 1.0, 1.0)
        # F.interpolate(align_corners=False): out pixel j samples input
        # coordinate (j+0.5)*(30/size)-0.5, edge-clamped
        u = np.clip((xs - bx0 + 0.5) * (30.0 / w) - 0.5, 0.0, 29.0)
        v = np.clip((ys - by0 + 0.5) * (30.0 / h) - 0.5, 0.0, 29.0)
        Rx = np.maximum(0.0, 1.0 - np.abs(u[:, None] - ks))  # (W, 30)
        Ry = np.maximum(0.0, 1.0 - np.abs(v[:, None] - ks))  # (H, 30)
        val = Ry @ masks[d] @ Rx.T
        # integer paste window [y_0, y_1) x [x_0, x_1)
        inside = ((ys[:, None] >= max(by0, 0.0))
                  & (ys[:, None] < min(by1 + 1.0, float(out_h)))
                  & (xs[None, :] >= max(bx0, 0.0))
                  & (xs[None, :] < min(bx1 + 1.0, float(out_w))))
        out[d] = (val > mask_threshold) & inside
    return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def predictions_from_output(out, in_hw, out_hw=None, with_masks=True):
    """A MaskRCNNOutput with a leading batch dim -> the per-image
    prediction dicts ``data/coco_eval.compute_map`` consumes. Drops invalid
    slots; rescales boxes from model-input to ``out_hw`` coordinates and
    pastes per-instance binary masks (prepare_for_coco_segmentation's
    role in the reference eval)."""
    in_h, in_w = in_hw
    out_h, out_w = out_hw if out_hw is not None else in_hw
    sx, sy = out_w / in_w, out_h / in_h
    boxes = _np(out.boxes)
    scores = _np(out.scores)
    labels = _np(out.labels)
    valid = _np(out.valid).astype(bool)
    masks28 = _np(out.masks28)
    preds = []
    for i in range(boxes.shape[0]):
        v = valid[i]
        p = {
            "boxes": boxes[i][v] * np.asarray([sx, sy, sx, sy]),
            "scores": scores[i][v],
            "labels": labels[i][v],
        }
        if with_masks:
            p["masks"] = paste_instance_masks_np(
                boxes[i][v], masks28[i][v], np.ones(int(v.sum()), bool),
                (out_h, out_w), in_hw)
        preds.append(p)
    return preds


def sharded_coco_evaluation(model, images, ground_truth, out_hw=None,
                            iou_types=("bbox", "segm"), device=None,
                            mesh: Optional[Mesh] = None):
    """The reference's eval loop (engine/inference.py:11-86):
    ``sharded_detection_inference`` over the batch (on a ``mesh``, dp
    sharded and gathered), the prediction dicts, and the FULL COCO protocol
    (``data/coco_eval.compute_map``) for each iou_type on the gathered
    predictions. Returns {iou_type: metrics dict} with mAP/AP50/AP75,
    APsmall..AR100."""
    out = sharded_detection_inference(model, images, device, mesh)
    cfg = model.cfg
    preds = predictions_from_output(
        out, (cfg.input_h, cfg.input_w), out_hw,
        with_masks="segm" in iou_types)
    return {
        t: compute_map(preds, ground_truth, iou_type=t) for t in iou_types
    }


def detection_ap50(pred_boxes, pred_scores, pred_valid,
                   gt_boxes, gt_valid) -> float:
    """Single-class average precision at IoU 0.5 over a batch — the
    small-scale stand-in for COCO mAP. pred_boxes (B, D, 4), pred_scores
    (B, D), pred_valid (B, D); gt_boxes (B, G, 4), gt_valid (B, G).
    Host-side numpy."""
    pred_boxes = _np(pred_boxes)
    pred_scores = _np(pred_scores)
    pred_valid = _np(pred_valid)
    gt_boxes = _np(gt_boxes)
    gt_valid = _np(gt_valid)

    rows = []
    n_gt = int(gt_valid.sum())
    for b in range(pred_boxes.shape[0]):
        for d in np.argsort(-pred_scores[b]):
            if not pred_valid[b, d]:
                continue
            rows.append((float(pred_scores[b, d]), b, pred_boxes[b, d]))
    rows.sort(key=lambda r: -r[0])

    def iou(a, bx):
        x1 = np.maximum(a[0], bx[:, 0])
        y1 = np.maximum(a[1], bx[:, 1])
        x2 = np.minimum(a[2], bx[:, 2])
        y2 = np.minimum(a[3], bx[:, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (bx[:, 2] - bx[:, 0]) * (bx[:, 3] - bx[:, 1]) - inter)
        return inter / np.maximum(ua, 1e-9)

    matched = [set() for _ in range(gt_boxes.shape[0])]
    tp, fp = [], []
    for score, b, box in rows:
        g = gt_boxes[b][gt_valid[b]]
        if g.shape[0] == 0:
            fp.append(1)
            tp.append(0)
            continue
        ious = iou(box, g)
        j = int(np.argmax(ious))
        if ious[j] >= 0.5 and j not in matched[b]:
            matched[b].add(j)
            tp.append(1)
            fp.append(0)
        else:
            tp.append(0)
            fp.append(1)
    if not tp or n_gt == 0:
        return 0.0
    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1e-9)
    # standard all-points interpolation
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        p = precision[recall >= r]
        ap += (p.max() if p.size else 0.0) / 101
    return float(ap)
