"""The port's detection ops (``ops/nms.py``, ``ops/roi_align.py``) against
the JAX package on the same numpy-seeded inputs.

Tolerances: box utilities 1e-5 (float32 arithmetic of the same formulas);
ROIAlign single level and multilevel atol 2e-5, rtol 1e-5 (the bars of
tests/test_detection_ops.py:151-176); the plain version through the
Pallas kernel in interpret mode atol 2e-4, rtol 1e-4 (that of
tests/test_detection_ops.py:179-203). NMS indices and validity exactly,
padded slots included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vido_slam_tpu.ops import nms as j_nms
from vido_slam_tpu.ops import roi_align as j_roi
from vido_slam_tpu_torch.ops import nms as t_nms
from vido_slam_tpu_torch.ops import roi_align as t_roi

torch.set_num_threads(1)

SCALES = (0.25, 0.125, 0.0625, 0.03125)


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def nchw1(hwc):
    """(H, W, C) numpy -> (1, C, H, W) float32 tensor."""
    return t32(np.asarray(hwc).transpose(2, 0, 1)[None])


def random_boxes(rng, n, lo=0.0, hi=100.0, side=(4.0, 40.0)):
    ctr = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(*side, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# box utilities and NMS
# ---------------------------------------------------------------------------

def test_box_utils_match_jax():
    rng = np.random.RandomState(0)
    a = random_boxes(rng, 30, -20, 120)
    b = random_boxes(rng, 17, -20, 120)
    np.testing.assert_allclose(t_nms.box_iou(t32(a), t32(b)).numpy(),
                               np.asarray(j_nms.box_iou(a, b)), atol=1e-6)
    np.testing.assert_array_equal(t_nms.clip_boxes(t32(a), 90, 110).numpy(),
                                  np.asarray(j_nms.clip_boxes(a, 90, 110)))
    np.testing.assert_array_equal(
        t_nms.remove_small_boxes(t32(a), 12.0).numpy(),
        np.asarray(j_nms.remove_small_boxes(a, 12.0)))
    deltas = rng.normal(0, 1, (30, 4)).astype(np.float32)
    deltas[0, 2:] = 9.0                      # past the exp clip
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        np.testing.assert_allclose(
            t_nms.decode_boxes(t32(deltas), t32(a), w).numpy(),
            np.asarray(j_nms.decode_boxes(deltas, a, w)), rtol=1e-5,
            atol=1e-4)


def chain_boxes(n):
    """n boxes along x, each overlapping its neighbours above IoU 0.5 and no
    other: greedy NMS keeps every other one, and the fixpoint needs about
    one sweep per link to settle."""
    x = np.arange(n, dtype=np.float32) * 3.0
    return np.stack([x, np.zeros(n), x + 11.0, np.full(n, 11.0)],
                    1).astype(np.float32), np.linspace(
        1.0, 0.5, n).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "ties and invalid", "chain 10",
                                  "chain 40", "batched"])
def test_nms_matches_jax(case):
    rng = np.random.RandomState(len(case))
    if case.startswith("chain"):
        boxes, scores = chain_boxes(int(case.split()[1]))
        valid = np.ones(len(scores), bool)
    else:
        n = 90
        boxes = random_boxes(rng, n)
        scores = rng.uniform(size=n).astype(np.float32)
        valid = rng.uniform(size=n) < 0.9
        if case == "ties and invalid":
            scores = np.round(scores * 4) / 4      # many exact ties
            valid[:20] = False
    if case == "batched":
        boxes = np.stack([boxes, random_boxes(rng, 90)])
        scores = np.stack([scores, rng.uniform(size=90).astype(np.float32)])
        valid = np.stack([valid, np.ones(90, bool)])
    max_out = min(64, boxes.shape[-2])
    got_i, got_v = t_nms.nms(t32(boxes), t32(scores), torch.from_numpy(valid),
                             0.5, max_out)
    for b in range(boxes.shape[0] if case == "batched" else 1):
        sl = (b,) if case == "batched" else ()
        want_i, want_v = j_nms.nms(jnp.asarray(boxes[sl]),
                                   jnp.asarray(scores[sl]),
                                   jnp.asarray(valid[sl]), 0.5, max_out)
        np.testing.assert_array_equal(got_i[sl].numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v[sl].numpy(), np.asarray(want_v))
    if case == "chain 10":
        # a settled chain: greedy NMS keeps every other box
        kept = got_i[got_v].tolist()
        assert kept == list(range(0, 10, 2))


# ---------------------------------------------------------------------------
# kernel 5's plain version: ROIAlign
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res", [7, 14])
def test_roi_align_single_level_matches_jax(res):
    rng = np.random.RandomState(1)
    feat = rng.randn(12, 16, 5).astype(np.float32)
    rois = np.asarray([[4, 4, 40, 30], [0, 0, 63, 47], [10, 8, 20, 20],
                       [-30, -9, 3, 2], [60, 40, 90, 70], [7, 7, 7.5, 7.2]],
                      np.float32)
    want = np.asarray(j_roi.roi_align(jnp.asarray(feat), jnp.asarray(rois),
                                      0.25, res, 2))
    got = t_roi.roi_align(nchw1(feat), t32(rois), 0.25, res, 2)
    assert got.shape == (6, 5, res, res)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=2e-5, rtol=1e-5)


def pyramid_case(rng, C, R, shapes=((34, 50), (17, 25), (9, 13), (5, 7))):
    """Four FPN-shaped levels of a 136 x 200 image and ROIs spanning every
    level, partly outside the image, under 1 px, and with samples exactly
    at -1 and size - 1 of their level."""
    feats = [rng.randn(h, w, C).astype(np.float32) for h, w in shapes]
    x1 = rng.uniform(-20, 180, R)
    y1 = rng.uniform(-20, 120, R)
    ww, hh = np.exp(rng.uniform(np.log(0.2), np.log(900), (2, R)))
    rois = np.stack([x1, y1, x1 + ww, y1 + hh], 1).astype(np.float32)
    # level 0 (scale 1/4), 28 x 28 boxes: bins of 1, samples at
    # y1 / 4 + 0.25 + k / 2; from -5 the first sample is at -1, from 129
    # the second one at 33 = H - 1
    rois[:4] = [[-5, -5, 23, 23], [100, 129, 128, 157], [0, 0, 0.5, 0.3],
                [190, 130, 260, 170]]
    # one ROI on each level
    rois[4:8] = [[10, 10, 69, 69], [20, 20, 169, 169], [0, 0, 299, 299],
                 [-100, -100, 499, 499]]
    levels = np.array(j_roi_levels(rois))
    return feats, rois, levels


def j_roi_levels(rois):
    from vido_slam_tpu.models.maskrcnn.roi_heads import assign_fpn_level

    return assign_fpn_level(jnp.asarray(rois))


@pytest.mark.parametrize("res,C,R", [(7, 16, 64), (14, 8, 37), (7, 3, 1)])
def test_roi_align_multilevel_ref_matches_jax(res, C, R):
    rng = np.random.RandomState(res * C + R)
    feats, rois, levels = pyramid_case(rng, C, max(R, 8))
    rois, levels = rois[:R], levels[:R]
    if R > 8:
        assert set(levels.tolist()) == {0, 1, 2, 3}
    want = np.asarray(j_roi.roi_align_multilevel(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois),
        jnp.asarray(levels), SCALES, res, 2))
    got = t_roi.roi_align_multilevel_ref(
        [nchw1(f) for f in feats], t32(rois), torch.from_numpy(levels),
        SCALES, res, 2)
    assert got.shape == (R, C, res, res)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("res,R", [(7, 37), (14, 11)])
def test_plain_version_through_the_pallas_kernel(res, R):
    """The plain version's weights in the Pallas kernel's banded layout,
    through ``roi_align_fused_pallas`` in interpret mode (C = 64, its
    channel tile), give the plain version's output: the CPU check against
    the TPU kernel itself."""
    rng = np.random.RandomState(res + R)
    feats, rois, levels = pyramid_case(rng, 64, R)
    tf = [nchw1(f) for f in feats]
    fcat, Ry, Rx = t_roi.banded_weights(tf, t32(rois),
                                        torch.from_numpy(levels), SCALES, res)
    assert fcat.shape == (34 + 17 + 9 + 5, 50, 64)
    got = np.asarray(j_roi.roi_align_fused_pallas(
        jnp.asarray(fcat), jnp.asarray(Ry), jnp.asarray(Rx), res,
        interpret=True))
    want = t_roi.roi_align_multilevel_ref(tf, t32(rois),
                                          torch.from_numpy(levels), SCALES,
                                          res)
    np.testing.assert_allclose(got, want.permute(0, 2, 3, 1).numpy(),
                               atol=2e-4, rtol=1e-4)


def test_roi_align_counts():
    """The bound's counts on a hand-countable case: one ROI on a 10 x 12
    level whose 7 x 7 bins sample rows 1.25..7.75 and columns 2.25..8.75,
    so rows 1..8 and columns 2..9 carry weight (64 texels)."""
    feat = torch.empty((1, 4, 10, 12))
    rois = torch.tensor([[8.0, 4.0, 36.0, 32.0]])   # x 2..9, y 1..8 at 1/4
    lv = torch.zeros(1, dtype=torch.int32)
    assert t_roi.nbytes([feat], rois, lv, (0.25,), 7) \
        == 4 * (4 * 49 + 64 * 4) + 20
    assert t_roi.operations(rois, 4, 7) == 4 * 49 * 4 * 10 + 2 * 7 * 2 * 12
    # two ROIs on the same texels count them once
    two = torch.cat([rois, rois])
    lv2 = torch.zeros(2, dtype=torch.int32)
    assert t_roi.nbytes([feat], two, lv2, (0.25,), 7) \
        == 4 * (2 * 4 * 49 + 64 * 4) + 40


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _wrapper_case():
    rng = np.random.RandomState(5)
    feats, rois, levels = pyramid_case(rng, 6, 20)
    return [nchw1(f) for f in feats], t32(rois), torch.from_numpy(levels)


def test_wrapper_takes_the_plain_version_for_cpu_tensors(monkeypatch):
    feats, rois, levels = _wrapper_case()
    before = t_roi.roi_align_multilevel.launches
    torch.testing.assert_close(
        t_roi.roi_align_multilevel(feats, rois, levels, SCALES, 7),
        t_roi.roi_align_multilevel_ref(feats, rois, levels, SCALES, 7),
        rtol=0, atol=0)
    assert t_roi.roi_align_multilevel.launches == before

    def refuse(name):
        raise AssertionError(f"{name} built a kernel for CPU tensors")

    monkeypatch.setattr("vido_slam_tpu_torch.utils.cuda_build.load", refuse)
    t_roi.roi_align_multilevel(feats, rois, levels.long(), SCALES, 14)


def test_wrapper_rejects_bad_inputs():
    feats, rois, levels = _wrapper_case()
    meta = torch.empty(rois.shape, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        t_roi.roi_align_multilevel(feats, meta, levels, SCALES)
    with pytest.raises(TypeError):
        t_roi.roi_align_multilevel([f.double() for f in feats], rois.double(),
                                   levels, SCALES)
    with pytest.raises(ValueError, match="contiguous"):
        t_roi.roi_align_multilevel(
            [feats[0].transpose(2, 3)] + feats[1:], rois, levels, SCALES)
    with pytest.raises(ValueError):
        t_roi.roi_align_multilevel(feats, rois, levels.float(), SCALES)
    with pytest.raises(ValueError):
        t_roi.roi_align_multilevel(feats, rois, levels[:3], SCALES)
    with pytest.raises(ValueError):
        t_roi.roi_align_multilevel(feats + feats[:1], rois, levels,
                                   SCALES + (0.01,))
    with pytest.raises(ValueError):
        t_roi.roi_align_multilevel([feats[0], feats[1][:, :3].contiguous()]
                                   + feats[2:], rois, levels, SCALES)
    with pytest.raises(ValueError):
        t_roi.roi_align_multilevel(feats, rois, levels, SCALES, 33)
