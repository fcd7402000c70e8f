"""COCO-style detection evaluation — the port's copy of
``vido_slam_tpu/data/coco_eval.py``, the counterpart of maskrcnn_benchmark's
coco_eval (reference src/thirdparty/mask_rcnn/maskrcnn_benchmark/data/
datasets/evaluation/coco/coco_eval.py:42-50, which defers to pycocotools)
in plain numpy, protocol-complete:

  - iou_type "bbox" | "segm" | "keypoints" (the reference's three
    iou_types; segm from binary instance masks — the counterpart of
    prepare_for_coco_segmentation's pasted masks; keypoints scored with
    OKS and the COCO-17 sigmas);
  - crowd handling (pycocotools semantics: crowd GTs are ignore-regions —
    IoU = intersection / det-area, multiple detections may match, matched
    detections are dropped from both TP and FP);
  - area ranges all/small/medium/large (GTs outside the range become
    ignore; unmatched detections outside the range are dropped);
  - maxDets caps (AP at 100; AR reported at 1/10/100).

The matcher/accumulator follows pycocotools COCOeval.evaluateImg /
accumulate: greedy per-category matching at IoU thresholds 0.5:0.95:0.05,
GTs sorted ignore-last, 101-point interpolated precision. The JAX package
validates it against hand-computed fixtures (tests/test_coco_eval_protocol.py);
tests/test_torch_coco_eval.py holds this copy to it on those fixtures.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 0.955, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)

AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}

# COCO 17-keypoint OKS sigmas (pycocotools COCOeval.__init__ self.kpt_oks_sigmas)
KPT_OKS_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
    1.07, 1.07, .87, .87, .89, .89]) / 10.0


def _box_iou(a: np.ndarray, b: np.ndarray, b_crowd: np.ndarray) -> np.ndarray:
    """(N, 4) dets x (M, 4) gts xyxy -> (N, M) IoU; crowd gt columns use
    intersection / det-area (pycocotools maskUtils.iou iscrowd semantics)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    denom = np.where(b_crowd[None, :], area_a[:, None], union)
    return inter / np.maximum(denom, 1e-12)


def _mask_iou(a: np.ndarray, b: np.ndarray, b_crowd: np.ndarray) -> np.ndarray:
    """(N, H, W) x (M, H, W) binary -> (N, M) mask IoU with crowd semantics."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    af = a.reshape(len(a), -1).astype(np.float64)
    bf = b.reshape(len(b), -1).astype(np.float64)
    inter = af @ bf.T
    area_a = af.sum(1)
    area_b = bf.sum(1)
    union = area_a[:, None] + area_b[None, :] - inter
    denom = np.where(b_crowd[None, :], area_a[:, None], union)
    return inter / np.maximum(denom, 1e-12)


def _oks(dt_kp: np.ndarray, gt_kp: np.ndarray, gt_box: np.ndarray,
         gt_area: np.ndarray) -> np.ndarray:
    """(N, K, 3) det keypoints x (M, K, 3) gt keypoints -> (N, M) OKS
    (pycocotools computeOks). gt visibility v>0 selects scored keypoints;
    a gt with no labeled keypoint scores against the box-expanded region."""
    N, M = len(dt_kp), len(gt_kp)
    out = np.zeros((N, M))
    if N == 0 or M == 0:
        return out
    var = (KPT_OKS_SIGMAS[:gt_kp.shape[1]] * 2.0) ** 2
    for j in range(M):
        g = gt_kp[j]
        vg = g[:, 2]
        k1 = int(np.count_nonzero(vg > 0))
        x0, y0, x1, y1 = gt_box[j]
        w, h = x1 - x0, y1 - y0
        for i in range(N):
            d = dt_kp[i]
            if k1 > 0:
                dx = d[:, 0] - g[:, 0]
                dy = d[:, 1] - g[:, 1]
            else:
                # gt has no labeled keypoints: measure distance to the
                # widened box (pycocotools z/dx clip construction)
                zx0, zx1 = x0 - w, x1 + w
                zy0, zy1 = y0 - h, y1 + h
                dx = np.maximum(zx0 - d[:, 0], 0) + np.maximum(d[:, 0] - zx1, 0)
                dy = np.maximum(zy0 - d[:, 1], 0) + np.maximum(d[:, 1] - zy1, 0)
            e = (dx ** 2 + dy ** 2) / var / max(gt_area[j], 1e-12) / 2.0
            if k1 > 0:
                e = e[vg > 0]
            out[i, j] = np.mean(np.exp(-e)) if len(e) else 0.0
    return out


def _eval_img(p_scores, ious, gt_ignore, gt_crowd, dt_ignore_area, thr):
    """pycocotools evaluateImg inner matcher for ONE (image, category,
    area-range, threshold). Detections are pre-sorted by score desc; gts
    pre-sorted ignore-last. Returns (dt_matched, dt_ignored) bool arrays."""
    n_dt, n_gt = ious.shape
    gt_taken = np.zeros(n_gt, bool)
    dt_m = np.zeros(n_dt, bool)
    dt_ig = np.zeros(n_dt, bool)
    for i in range(n_dt):
        best, bj = min(thr, 1.0 - 1e-10), -1
        for j in range(n_gt):
            if gt_taken[j] and not gt_crowd[j]:
                continue
            # gts sorted ignore-last: once past a match to a non-ignored
            # gt, stop at the first ignored one
            if bj > -1 and not gt_ignore[bj] and gt_ignore[j]:
                break
            if ious[i, j] < best:
                continue
            best = ious[i, j]
            bj = j
        if bj == -1:
            dt_ig[i] = dt_ignore_area[i]
            continue
        gt_taken[bj] = True
        dt_m[i] = not gt_ignore[bj]
        dt_ig[i] = gt_ignore[bj]
    return dt_m, dt_ig


def _ap_from_matches(scores, matched, ignored, n_gt) -> (float, float):
    """101-point interpolated AP + best recall (COCOeval.accumulate)."""
    if n_gt == 0:
        return np.nan, np.nan
    order = np.argsort(-np.asarray(scores, np.float64), kind="mergesort")
    m = np.asarray(matched, bool)[order]
    ig = np.asarray(ignored, bool)[order]
    keep = ~ig
    tp = m[keep].astype(np.float64)
    fp = 1.0 - tp
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-12)
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    if len(precision) == 0:
        return 0.0, 0.0
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    prec_at = np.where(
        idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0
    )
    return float(np.mean(prec_at)), float(recall[-1])


def _get(d, key, n, default=None, shape=()):
    v = d.get(key)
    if v is None:
        if default is None:
            return None
        return np.full((n,) + shape, default)
    return np.asarray(v)


def compute_map(
    predictions: Sequence[Dict[str, np.ndarray]],
    ground_truth: Sequence[Dict[str, np.ndarray]],
    iou_type: str = "bbox",
    max_det: int = 100,
    area_ranges: Optional[Dict[str, tuple]] = None,
) -> Dict[str, float]:
    """Full COCOeval protocol for one iou_type.

    predictions per image: 'boxes' (N, 4 xyxy), 'scores' (N,), 'labels'
    (N,); plus 'masks' (N, H, W) binary for segm, 'keypoints' (N, K, 3)
    for keypoints. ground_truth per image: 'boxes', 'labels', optional
    'iscrowd' (M,), 'areas' (M,), and 'masks'/'keypoints' to match.
    Returns mAP/AP50/AP75, APsmall/medium/large, AR@1/10/100, per_category.
    """
    assert len(predictions) == len(ground_truth)
    if area_ranges is None:
        area_ranges = (AREA_RANGES if iou_type != "keypoints" else
                       {k: AREA_RANGES[k] for k in ("all", "medium", "large")})
    cats = sorted(
        {int(c) for g in ground_truth for c in np.asarray(g["labels"]).ravel()}
    )

    # per-image, per-category IoU matrices computed ONCE (shared across
    # thresholds and area ranges, like pycocotools computeIoU)
    per_img = []  # list of dict cat -> (p_scores, ious, gt_crowd, gt_area, p_area)
    for pred, gt in zip(predictions, ground_truth):
        g_lab = np.asarray(gt["labels"]).ravel()
        p_lab = np.asarray(pred["labels"]).ravel()
        g_crowd = _get(gt, "iscrowd", len(g_lab), 0).astype(bool)
        g_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        if "areas" in gt and gt["areas"] is not None:
            g_area = np.asarray(gt["areas"], np.float64)
        elif iou_type == "segm" and gt.get("masks") is not None:
            g_area = np.asarray(gt["masks"]).reshape(len(g_lab), -1).sum(1)
        else:
            g_area = ((g_boxes[:, 2] - g_boxes[:, 0])
                      * (g_boxes[:, 3] - g_boxes[:, 1]))
        p_boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        p_scores = np.asarray(pred["scores"], np.float64).ravel()
        if iou_type == "segm" and pred.get("masks") is not None:
            p_area = np.asarray(pred["masks"]).reshape(len(p_lab), -1).sum(1)
        else:
            p_area = ((p_boxes[:, 2] - p_boxes[:, 0])
                      * (p_boxes[:, 3] - p_boxes[:, 1]))
        entry = {}
        for cat in cats:
            gs = g_lab == cat
            ps = p_lab == cat
            order = np.argsort(-p_scores[ps], kind="mergesort")[:max_det]
            pi = np.nonzero(ps)[0][order]
            gi = np.nonzero(gs)[0]
            if iou_type == "bbox":
                ious = _box_iou(p_boxes[pi], g_boxes[gi], g_crowd[gi])
            elif iou_type == "segm":
                pm = np.asarray(pred["masks"])[pi] if len(pi) else \
                    np.zeros((0, 1, 1), bool)
                gm = np.asarray(gt["masks"])[gi] if len(gi) else \
                    np.zeros((0, 1, 1), bool)
                ious = _mask_iou(pm, gm, g_crowd[gi])
            elif iou_type == "keypoints":
                pk = np.asarray(pred["keypoints"])[pi] if len(pi) else \
                    np.zeros((0, 17, 3))
                gk = np.asarray(gt["keypoints"])[gi] if len(gi) else \
                    np.zeros((0, 17, 3))
                ious = _oks(pk, gk, g_boxes[gi], g_area[gi])
            else:
                raise ValueError(f"unknown iou_type {iou_type}")
            entry[cat] = (p_scores[pi], ious, g_crowd[gi], g_area[gi],
                          p_area[pi],
                          (np.asarray(gt.get("keypoints"))[gi]
                           if iou_type == "keypoints" else None))
        per_img.append(entry)

    results = {}
    per_cat_ap = {}
    for rng_name, (amin, amax) in area_ranges.items():
        ap_cat_thr: Dict[int, List[float]] = {c: [] for c in cats}
        rec_cat = {}
        for ti, thr in enumerate(IOU_THRESHOLDS):
            for cat in cats:
                scores_all, matched_all, ignored_all, n_gt = [], [], [], 0
                for entry in per_img:
                    p_scores, ious, g_crowd, g_area, p_area, g_kp = entry[cat]
                    # gt ignore: crowd, outside area range, or (keypoints)
                    # no labeled keypoint
                    g_ig = g_crowd | (g_area < amin) | (g_area > amax)
                    if iou_type == "keypoints" and g_kp is not None \
                            and len(g_kp):
                        g_ig = g_ig | (np.count_nonzero(
                            g_kp[:, :, 2] > 0, axis=1) == 0)
                    # sort gts ignore-last (stable)
                    g_order = np.argsort(g_ig, kind="mergesort")
                    g_ig_s = g_ig[g_order]
                    g_crowd_s = g_crowd[g_order]
                    ious_s = ious[:, g_order] if ious.size else ious
                    dt_out = (p_area < amin) | (p_area > amax)
                    dt_m, dt_ig = _eval_img(
                        p_scores, ious_s, g_ig_s, g_crowd_s, dt_out, thr)
                    n_gt += int(np.count_nonzero(~g_ig))
                    scores_all.extend(p_scores)
                    matched_all.extend(dt_m)
                    ignored_all.extend(dt_ig)
                ap, rec = _ap_from_matches(
                    scores_all, matched_all, ignored_all, n_gt)
                ap_cat_thr[cat].append(ap)
                if rng_name == "all":
                    if ti == 0:
                        results.setdefault("_ap50", {})[cat] = ap
                    if abs(thr - 0.75) < 1e-9:
                        results.setdefault("_ap75", {})[cat] = ap
                rec_cat.setdefault(cat, []).append(rec)

        def nanmean(vals):
            vals = [v for v in vals if not (isinstance(v, float) and np.isnan(v))]
            return float(np.mean(vals)) if vals else float("nan")

        cat_ap = {c: nanmean(v) for c, v in ap_cat_thr.items()}
        key = "mAP" if rng_name == "all" else f"AP{rng_name}"
        results[key] = nanmean(cat_ap.values())
        if rng_name == "all":
            per_cat_ap = cat_ap
            results["AR100"] = nanmean(
                [nanmean(v) for v in rec_cat.values()])

    def nanmean(vals):
        vals = [v for v in vals if not (isinstance(v, float) and np.isnan(v))]
        return float(np.mean(vals)) if vals else float("nan")

    results["AP50"] = nanmean(results.pop("_ap50", {}).values())
    results["AP75"] = nanmean(results.pop("_ap75", {}).values())
    results["per_category"] = per_cat_ap

    # AR at smaller det caps (area range "all")
    results["AR1"] = _ar_at_cap(per_img, cats, area_ranges["all"], 1,
                                iou_type)
    results["AR10"] = _ar_at_cap(per_img, cats, area_ranges["all"], 10,
                                 iou_type)
    return results


def _ar_at_cap(per_img, cats, rng, cap, iou_type):
    """Average recall at a detection cap over IoU thresholds and categories."""
    amin, amax = rng
    recs = []
    for cat in cats:
        cat_recs = []
        for thr in IOU_THRESHOLDS:
            matched, n_gt = 0, 0
            for entry in per_img:
                p_scores, ious, g_crowd, g_area, p_area, g_kp = entry[cat]
                g_ig = g_crowd | (g_area < amin) | (g_area > amax)
                if iou_type == "keypoints" and g_kp is not None and len(g_kp):
                    g_ig = g_ig | (np.count_nonzero(
                        g_kp[:, :, 2] > 0, axis=1) == 0)
                g_order = np.argsort(g_ig, kind="mergesort")
                ious_s = ious[:cap, g_order] if ious.size else ious[:cap]
                dt_m, _ = _eval_img(
                    p_scores[:cap], ious_s, g_ig[g_order],
                    g_crowd[g_order], np.zeros(min(cap, len(p_scores)), bool),
                    thr)
                matched += int(np.count_nonzero(dt_m))
                n_gt += int(np.count_nonzero(~g_ig))
            if n_gt:
                cat_recs.append(matched / n_gt)
        if cat_recs:
            recs.append(float(np.mean(cat_recs)))
    return float(np.mean(recs)) if recs else float("nan")


def coco_map(
    predictions: Sequence[Dict[str, np.ndarray]],
    ground_truth: Sequence[Dict[str, np.ndarray]],
    iou_type: str = "bbox",
) -> Dict[str, float]:
    """Back-compat wrapper: full-protocol eval, original key set plus the
    protocol extras (APsmall/medium/large, AR1/10/100)."""
    return compute_map(predictions, ground_truth, iou_type=iou_type)
