"""The port's single-device evaluation paths (``parallel/eval.py``,
``parallel/slam_eval.py``) against the JAX package's on the CPU, the JAX
functions on a mesh of one device.

Bars: ``evaluate_sequences`` at tests/test_parallel.py's ``make_problem``
size (S 8, W 6, P 60): poses within 1e-4 and ATE within 1e-5 of JAX's,
every ATE under 0.01; detection inference with a one-block-a-stage
R-50-FPN at 128x160 (JAX's init, class 3 lifted to 30): validity and
labels equal, boxes within 1e-3 px, masks28 within 1e-4; the COCO scores
of both on the same ground truth equal to 1e-12; ``paste_instance_masks_
np``, ``predictions_from_output`` and ``detection_ap50`` equal to JAX's;
``multi_sequence_tracking`` at S 2, T 4, 128x80 within 1e-4 of a JAX
``Tracker`` per sequence (tests/test_parallel.py:235's bar) and within
1e-6 of the port's own ``Tracker`` per sequence (the tracker turns the
window's newest pose into Tcw on the host). The ``slow`` case holds it to
JAX's own ``multi_sequence_tracking`` at that test's size (S 4, T 6).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.models.maskrcnn import backbone as jb
from vido_slam_tpu.models.maskrcnn import model as jm
from vido_slam_tpu.parallel import eval as je
from vido_slam_tpu.parallel.mesh import make_mesh
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.models.maskrcnn import backbone as tb
from vido_slam_tpu_torch.models.maskrcnn import model as tm
from vido_slam_tpu_torch.parallel import eval as te
from vido_slam_tpu_torch.parallel import slam_eval as tse
from vido_slam_tpu_torch.tracking import Tracker

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 128, 160
BLOCKS = (1, 1, 1, 1)
LIFT = 30.0


def _jax_parallel_tests():
    spec = importlib.util.spec_from_file_location(
        "jax_parallel_tests", os.path.join(HERE, "test_parallel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TESTS = _jax_parallel_tests()


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1, dp=1, tp=1)


# ---------------------------------------------------------------------------
# the batched window BA
# ---------------------------------------------------------------------------

def test_evaluate_sequences_matches_jax(mesh):
    problems, gts = zip(*(JAX_TESTS.make_problem(jax.random.PRNGKey(s))
                          for s in range(8)))
    stacked = {k: np.stack([np.asarray(p[k]) for p in problems])
               for k in problems[0]}
    gt = np.stack([np.asarray(g) for g in gts])
    j_res, j_ate = je.evaluate_sequences(
        mesh, je.BatchedWindowProblem(**{k: jnp.asarray(v) for k, v in
                                         stacked.items()}),
        jnp.asarray(gt), max_iters=12)
    t_res, t_ate = te.evaluate_sequences(
        te.BatchedWindowProblem(**stacked), gt, max_iters=12, device="cpu")
    assert t_res.Twc.shape == (8, 6, 4, 4) and t_ate.shape == (8,)
    np.testing.assert_allclose(t_res.Twc.numpy(), np.asarray(j_res.Twc),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_res.points.numpy(), np.asarray(j_res.points),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_ate.numpy(), np.asarray(j_ate), atol=1e-5,
                               rtol=0)
    assert (t_ate.numpy() < 0.01).all()
    # the defaults: 15 iterations, as JAX's sharded_window_ba
    res = te.sharded_window_ba(te.BatchedWindowProblem(**stacked),
                               device="cpu")
    assert res.num_iters.dtype == torch.int32 and res.cost.shape == (8,)
    assert int(res.num_iters.max()) <= 15


# ---------------------------------------------------------------------------
# detection inference and its COCO evaluation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def detector():
    j_cfg = jm.MaskRCNNConfig(resnet=jb.ResNetConfig(stage_blocks=BLOCKS),
                              input_h=H, input_w=W)
    p = jax.jit(jm.init_maskrcnn_params, static_argnums=1)(
        jax.random.PRNGKey(0), j_cfg)
    p = {k: np.array(v) for k, v in p.items()}
    p["roi_heads.box.predictor.cls_score.bias"][3] = LIFT
    model = tm.MaskRCNN(tm.MaskRCNNConfig(
        resnet=tb.ResNetConfig(stage_blocks=BLOCKS), input_h=H, input_w=W),
        device="cpu")
    model.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
        p, device="cpu"), strict=True)
    images = np.random.RandomState(1).uniform(0, 1, (3, H, W, 3)).astype(
        np.float32)
    return j_cfg, p, model, images


@pytest.fixture(scope="module")
def inference(detector, mesh):
    j_cfg, p, model, images = detector
    want = je.sharded_detection_inference(
        mesh, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(images),
        j_cfg)
    want = jax.tree_util.tree_map(np.asarray, want)
    got = te.sharded_detection_inference(
        model, torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
        device="cpu")
    return got, want


def test_detection_inference_matches_jax(inference):
    got, want = inference
    assert tuple(got.boxes.shape) == want.boxes.shape[:1] + (100, 4)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    v = want.valid
    assert v.sum(1).min() >= 10
    np.testing.assert_allclose(got.boxes.numpy()[v], want.boxes[v],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.masks28.numpy(), want.masks28, atol=1e-4,
                               rtol=0)


def _ground_truth(want, in_hw, out_hw):
    """Every other valid JAX detection of each image as a ground-truth
    object, its box shifted by up to 4 px and its pasted mask cut."""
    rng = np.random.RandomState(2)
    preds = je.predictions_from_output(want, in_hw, out_hw)
    gts = []
    for p in preds:
        keep = np.arange(len(p["scores"])) % 2 == 0
        boxes = p["boxes"][keep] + rng.uniform(-4, 4, (int(keep.sum()), 4))
        masks = p["masks"][keep].copy()
        masks[:, ::3] = False
        gts.append({"boxes": boxes, "labels": p["labels"][keep],
                    "masks": masks})
    return gts


def test_coco_evaluation_matches_jax(detector, inference, mesh):
    """The port's ``sharded_coco_evaluation`` against JAX's own on the same
    ground truth (JAX's call runs its inference again)."""
    j_cfg, p, model, images = detector
    got, want = inference
    out_hw = (96, 120)
    gts = _ground_truth(want, (H, W), out_hw)
    t_scores = te.sharded_coco_evaluation(
        model, torch.from_numpy(images.transpose(0, 3, 1, 2).copy()), gts,
        out_hw=out_hw, device="cpu")
    j_scores = je.sharded_coco_evaluation(
        mesh, {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(images), j_cfg, gts, out_hw=out_hw)
    assert set(t_scores) == set(j_scores) == {"bbox", "segm"}
    for t in j_scores:
        for k, w in j_scores[t].items():
            if k == "per_category":
                continue
            g = t_scores[t][k]
            assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= 1e-12, \
                (t, k, g, w)
    assert 0.1 < j_scores["bbox"]["AP50"] <= 1.0


def test_predictions_paste_and_ap50_equal_jax(inference):
    got, want = inference
    for out_hw in (None, (200, 250)):
        t_preds = te.predictions_from_output(got._replace(
            boxes=torch.tensor(want.boxes),
            masks28=torch.tensor(want.masks28)), (H, W), out_hw)
        j_preds = je.predictions_from_output(want, (H, W), out_hw)
        for a, b in zip(t_preds, j_preds):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    rng = np.random.RandomState(3)
    boxes = np.concatenate([rng.uniform(-20, 100, (12, 2)),
                            rng.uniform(110, 300, (12, 2))], 1)
    masks = rng.uniform(0, 1, (12, 28, 28))
    valid = rng.uniform(0, 1, 12) > 0.2
    np.testing.assert_array_equal(
        te.paste_instance_masks_np(boxes, masks, valid, (90, 130), (H, W)),
        je.paste_instance_masks_np(boxes, masks, valid, (90, 130), (H, W)))
    gt = want.boxes[:, :5] + rng.uniform(-3, 3, (3, 5, 4))
    gt_valid = want.valid[:, :5]
    for pb in (want.boxes, want.boxes + 40.0):
        assert te.detection_ap50(got.boxes, got.scores, got.valid, gt,
                                 gt_valid) == \
            je.detection_ap50(want.boxes, want.scores, want.valid, gt,
                              gt_valid)
        assert te.detection_ap50(pb, want.scores, want.valid, gt,
                                 gt_valid) == \
            je.detection_ap50(pb, want.scores, want.valid, gt, gt_valid)


# ---------------------------------------------------------------------------
# multi-sequence SLAM tracking
# ---------------------------------------------------------------------------

def _sequences(S, T):
    """tests/test_parallel.py's synthetic sequences, the first S, T frames
    each: numpy depths, flows and masks (S, T, ...)."""
    case = JAX_TESTS.TestMultiSequenceSLAM()
    case.S, case.T = S, T
    cam, _, seqs = case._sequences()
    cfg = case._cfg(cam)
    arrays = [np.stack([np.stack([np.asarray(getattr(f, k)) for f in sq.frames])
                        for sq in seqs]) for k in ("depth", "flow", "mask")]
    arrays[2] = arrays[2].astype(np.int32)
    cfg_dict = {"Camera.width": cam.width, "Camera.height": cam.height,
                "Camera.fx": float(cam.fx), "Camera.fy": float(cam.fy),
                "Camera.cx": float(cam.cx), "Camera.cy": float(cam.cy),
                "Camera.bf": float(cam.bf), "ThDepthBG": 80.0,
                "MaxTrackPointBG": 400, "WINDOW_SIZE": 4}
    return cfg, cfg_dict, arrays


KW = dict(n_bg=400, n_obj=200, max_objects=2, ba_points=200, ba_iters=5)


def test_multi_sequence_tracking_matches_trackers():
    from vido_slam_tpu.tracking import Tracker as JTracker
    S, T = 2, 4
    j_cfg, cfg_dict, (depths, flows, masks) = _sequences(S, T)
    cfg = config_from_dict(cfg_dict)
    res = tse.multi_sequence_tracking(cfg, depths, flows, masks, **KW,
                                      device="cpu")
    assert res.Tcw.shape == (S, T, 4, 4) and res.ba_Twc.shape == (S, 4, 4, 4)
    assert res.n_inliers.dtype == torch.int32
    np.testing.assert_array_equal(res.Tcw[:, 0].numpy(),
                                  np.broadcast_to(np.eye(4), (S, 4, 4)))
    tracker_kw = dict(n_bg=400, n_obj=200, max_objects=2, local_ba=True,
                      fused_ba=True, ba_max_points=200, ba_iters=5)
    for s in range(S):
        jt = JTracker(j_cfg, seed=s, **tracker_kw)
        tt = Tracker(cfg, seed=s, device="cpu", **tracker_kw)
        want, mine = [], []
        for t in range(T):
            want.append(np.asarray(jt.track(jnp.asarray(depths[s, t]),
                                            jnp.asarray(flows[s, t]),
                                            jnp.asarray(masks[s, t]))))
            mine.append(np.asarray(tt.track(depths[s, t], flows[s, t],
                                            masks[s, t])))
        jt.finish()
        tt.finish()
        got = res.Tcw[s].numpy()
        np.testing.assert_allclose(got, np.stack(want), atol=1e-4, rtol=0,
                                   err_msg=f"sequence {s} against JAX")
        np.testing.assert_allclose(got, np.stack(mine), atol=1e-6, rtol=0,
                                   err_msg=f"sequence {s} against the "
                                           f"port's Tracker")
        np.testing.assert_allclose(res.ba_Twc[s].numpy(),
                                   tt.state.ba_Twc.numpy(), atol=1e-6,
                                   rtol=0)
        assert int(res.n_inliers[s, 0]) == int(
            tt.map.frames[0].stat_valid.sum())
        assert int(res.n_inliers[s, -1]) == int(
            tt.state.ba_obs_valid[-1].sum())
    assert np.abs(res.Tcw[0].numpy() - res.Tcw[1].numpy()).max() > 1e-3


@pytest.mark.slow
def test_multi_sequence_tracking_matches_jax_lockstep(mesh):
    """JAX's own vmapped ``multi_sequence_tracking`` at tests/
    test_parallel.py's size: poses within 1e-4, n_inliers equal."""
    from vido_slam_tpu.parallel.slam_eval import (
        multi_sequence_tracking as j_multi)
    S, T = 4, 6
    j_cfg, cfg_dict, (depths, flows, masks) = _sequences(S, T)
    want = j_multi(mesh, j_cfg, jnp.asarray(depths), jnp.asarray(flows),
                   jnp.asarray(masks), **KW)
    got = tse.multi_sequence_tracking(config_from_dict(cfg_dict), depths,
                                      flows, masks, **KW, device="cpu")
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(want.Tcw),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.ba_Twc.numpy(), np.asarray(want.ba_Twc),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.n_inliers.numpy(),
                                  np.asarray(want.n_inliers))


def test_entry_points_take_the_card_unless_asked(detector):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, model, images = detector
    pr, gt = JAX_TESTS.make_problem(jax.random.PRNGKey(0))
    probs = te.BatchedWindowProblem(**{k: np.asarray(v)[None]
                                       for k, v in pr.items()})
    calls = [
        lambda: te.sharded_window_ba(probs),
        lambda: te.evaluate_sequences(probs, np.asarray(gt)[None]),
        lambda: te.sharded_detection_inference(model, images[:1]),
        lambda: te.sharded_coco_evaluation(model, images[:1], [{}]),
        lambda: tse.multi_sequence_tracking(
            config_from_dict({}), np.zeros((1, 2, 8, 8), np.float32),
            np.zeros((1, 2, 8, 8, 2), np.float32),
            np.zeros((1, 2, 8, 8), np.int32)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
