"""The port's COCO evaluation (``data/coco_eval.py``) against the JAX
package's: every fixture of tests/test_coco_eval_protocol.py, run with
``compute_map`` standing for both packages' (each call scored by both and
compared, the fixture's own asserts on JAX's result), and random box,
mask and keypoint cases through ``compute_map`` and ``coco_map``.

Bar: every metric, per-category AP included, equal to 1e-12 (NaN where
JAX gives NaN).
"""

import importlib.util
import inspect
import math
import os

import numpy as np
import pytest

from vido_slam_tpu.data import coco_eval as jce
from vido_slam_tpu_torch.data import coco_eval as tce

HERE = os.path.dirname(os.path.abspath(__file__))


def same_metrics(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            same_metrics(g, w)
        elif isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), k
        else:
            assert abs(g - w) <= 1e-12, (k, g, w)


def both(pred, gt, *args, **kw):
    """JAX's ``compute_map`` with the port's held to it."""
    want = jce.compute_map(pred, gt, *args, **kw)
    same_metrics(tce.compute_map(pred, gt, *args, **kw), want)
    return want


def _protocol_module():
    spec = importlib.util.spec_from_file_location(
        "coco_eval_protocol", os.path.join(HERE, "test_coco_eval_protocol.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.compute_map = both
    return mod


PROTOCOL = _protocol_module()
FIXTURES = [(cls, name) for cls in (PROTOCOL.TestBBoxProtocol,
                                    PROTOCOL.TestSegmProtocol,
                                    PROTOCOL.TestKeypointsProtocol)
            for name, _ in inspect.getmembers(cls, inspect.isfunction)
            if name.startswith("test_")]


def test_constants_equal_jax():
    np.testing.assert_array_equal(tce.IOU_THRESHOLDS, jce.IOU_THRESHOLDS)
    np.testing.assert_array_equal(tce.RECALL_POINTS, jce.RECALL_POINTS)
    np.testing.assert_array_equal(tce.KPT_OKS_SIGMAS, jce.KPT_OKS_SIGMAS)
    assert tce.AREA_RANGES == jce.AREA_RANGES


@pytest.mark.parametrize("cls,name", FIXTURES,
                         ids=[f"{c.__name__}.{n}" for c, n in FIXTURES])
def test_protocol_fixture_equal_jax(cls, name):
    assert len(FIXTURES) == 11
    getattr(cls(), name)()


def _random_case(rng, n_img, H=48, W=64, cats=(1, 2, 5)):
    """Per-image predictions and ground truth: jittered copies of the
    GT boxes, masks and keypoints, junk detections, crowd GTs, ties in
    score, an image without GT (odd images carry their GT areas)."""
    preds, gts = [], []
    for i in range(n_img):
        G = 0 if i == 1 else rng.randint(1, 6)
        xy = rng.uniform(0, [W - 8, H - 8], (G, 2))
        wh = rng.uniform(2, 40, (G, 2))
        g_boxes = np.concatenate([xy, np.minimum(xy + wh, [W, H])], 1)
        g_lab = rng.choice(cats, G)
        crowd = rng.uniform(0, 1, G) < 0.2
        g_masks = np.zeros((G, H, W), bool)
        for k, b in enumerate(g_boxes.astype(int)):
            g_masks[k, b[1]:b[3] + 1, b[0]:b[2] + 1] = True
        g_kp = np.zeros((G, 17, 3))
        g_kp[..., 0] = rng.uniform(g_boxes[:, :1], g_boxes[:, 2:3], (G, 17))
        g_kp[..., 1] = rng.uniform(g_boxes[:, 1:2], g_boxes[:, 3:4], (G, 17))
        g_kp[..., 2] = rng.randint(0, 3, (G, 17))
        if G:
            g_kp[0, :, 2] = 0       # a GT with no labelled keypoint
        # at least one detection: JAX's segm areas cannot reshape an empty
        # mask stack
        D = rng.randint(1, 2 * G + 4)
        src = rng.randint(0, max(G, 1), D)
        p_boxes = rng.uniform(0, [W, H, W, H], (D, 4))
        p_boxes[:, 2:] = np.maximum(p_boxes[:, 2:], p_boxes[:, :2] + 1)
        real = (rng.uniform(0, 1, D) < 0.7) & (G > 0)
        if G:
            p_boxes[real] = g_boxes[src[real]] + rng.normal(0, 2, (
                int(real.sum()), 4))
        p_lab = np.where(real, g_lab[src] if G else 0, rng.choice(cats, D))
        scores = np.round(rng.uniform(0, 1, D), 1)     # ties
        p_masks = np.zeros((D, H, W), bool)
        for k, b in enumerate(np.clip(p_boxes, 0, [W, H, W, H]).astype(int)):
            p_masks[k, b[1]:b[3] + 1, b[0]:b[2] + 1] = True
        p_kp = np.zeros((D, 17, 3))
        if G:
            p_kp[real] = g_kp[src[real]] + rng.normal(0, 1.5, (
                int(real.sum()), 17, 3))
        p_kp[..., 2] = 1
        preds.append({"boxes": p_boxes, "scores": scores, "labels": p_lab,
                      "masks": p_masks, "keypoints": p_kp})
        gt = {"boxes": g_boxes, "labels": g_lab, "iscrowd": crowd,
              "masks": g_masks, "keypoints": g_kp}
        if i % 2:
            gt["areas"] = wh[:, 0] * wh[:, 1]
        gts.append(gt)
    return preds, gts


@pytest.mark.parametrize("iou_type", ["bbox", "segm", "keypoints"])
def test_random_cases_equal_jax(iou_type):
    rng = np.random.RandomState({"bbox": 0, "segm": 1, "keypoints": 2}[
        iou_type])
    for case in range(3):
        preds, gts = _random_case(rng, 6)
        want = jce.compute_map(preds, gts, iou_type=iou_type)
        same_metrics(tce.compute_map(preds, gts, iou_type=iou_type), want)
        same_metrics(tce.coco_map(preds, gts, iou_type=iou_type),
                     jce.coco_map(preds, gts, iou_type=iou_type))
        kw = dict(iou_type=iou_type, max_det=3,
                  area_ranges={"all": (0.0, 1e10), "mid": (64.0, 900.0)})
        same_metrics(tce.compute_map(preds, gts, **kw),
                     jce.compute_map(preds, gts, **kw))
        assert 0.0 < want["AP50"] <= 1.0
