"""The port's detector training (``models/maskrcnn/losses.py``,
``parallel/train.py``, ``ops/roi_align.py``'s gradient, ``utils/prng.
fold_in``) against the JAX package on the same numpy-seeded inputs and the
same parameters (the JAX init carried across by
``convert.maskrcnn_state_dict_from_numpy``), at 128x160 with a ResNet cut
to one block a stage.

Bars: ``fold_in`` and the schedule equal; ``_encode_boxes``,
``_smooth_l1`` and ``_crop_mask_to_box`` within 1e-6 of max(1, |value|);
``_match`` and ``_sample`` equal; the five loss parts within 1e-4
relative; the gradient of ``total_loss`` for every key (FrozenBN weights,
biases and statistics included) within 1e-3 of that key's max |g| (the
loss sums float32 convolutions in another order, and the gradient of a
FrozenBN's running_var scales as rsqrt(var)^3); one SGD step of the same
gradients within 1e-5; the ROIAlign gradient within 1e-5 of max |g|.
The JAX references share one module fixture: one compile of
``value_and_grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vido_slam_tpu.models.maskrcnn import backbone as jb
from vido_slam_tpu.models.maskrcnn import losses as jl
from vido_slam_tpu.models.maskrcnn import model as jm
from vido_slam_tpu.ops import roi_align as j_roi
from vido_slam_tpu.parallel import train as jt
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models.maskrcnn import backbone as tb
from vido_slam_tpu_torch.models.maskrcnn import losses as tl
from vido_slam_tpu_torch.models.maskrcnn import model as tm
from vido_slam_tpu_torch.ops import roi_align as t_roi
from vido_slam_tpu_torch.parallel import train as tt
from vido_slam_tpu_torch.utils import prng

torch.set_num_threads(1)

H, W = 128, 160
BLOCKS = (1, 1, 1, 1)


def j_cfg():
    return jm.MaskRCNNConfig(resnet=jb.ResNetConfig(stage_blocks=BLOCKS),
                             input_h=H, input_w=W)


def t_cfg():
    return tm.MaskRCNNConfig(resnet=tb.ResNetConfig(stage_blocks=BLOCKS),
                             input_h=H, input_w=W)


def close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * scale, (err, scale)
    return err


def toy_targets(G=6):
    """Two valid objects and padding, masks at half resolution."""
    boxes = np.zeros((G, 4), np.float32)
    labels = np.zeros(G, np.int32)
    valid = np.zeros(G, bool)
    boxes[0] = [30, 30, 80, 90]
    labels[0] = 3
    boxes[1] = [100, 20, 140, 60]
    labels[1] = 7
    valid[:2] = True
    masks = np.zeros((G, H // 2, W // 2), np.float32)
    masks[0, 15:45, 15:40] = 1.0
    masks[1, 10:30, 50:70] = 1.0
    return dict(boxes=boxes, labels=labels, masks=masks, valid=valid)


def j_targets(t):
    return jl.DetectionTargets(**{k: jnp.asarray(v) for k, v in t.items()})


def t_targets(t):
    return tl.DetectionTargets(
        boxes=torch.from_numpy(t["boxes"]),
        labels=torch.from_numpy(t["labels"]).long(),
        masks=torch.from_numpy(t["masks"]),
        valid=torch.from_numpy(t["valid"]))


@pytest.fixture(scope="module")
def params():
    p = jax.jit(jm.init_maskrcnn_params, static_argnums=1)(
        jax.random.PRNGKey(0), j_cfg())
    return {k: np.array(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(1).uniform(0, 1, (1, H, W, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_ref(params, image):
    """The JAX loss parts and the gradient of their sum, one compile."""
    tg = j_targets(toy_targets())
    key = jax.random.PRNGKey(5)

    def f(p):
        parts = jl.maskrcnn_loss(p, jnp.asarray(image), tg, key, j_cfg())
        return sum(parts.values()), parts

    (total, parts), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()})
    return dict(total=float(total),
                parts={k: float(v) for k, v in parts.items()},
                grads={k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def port_run(params, image):
    model = tm.MaskRCNN(t_cfg(), device="cpu")
    model.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
        params, device="cpu"), strict=True)
    state = tt.trainable_state(model)
    parts = tl.maskrcnn_loss(
        model, torch.from_numpy(image).permute(0, 3, 1, 2).contiguous(),
        t_targets(toy_targets()), prng.PRNGKey(5))
    tt.compute_grads(sum(parts.values()), state)
    return dict(model=model, state=state,
                parts={k: float(v.detach()) for k, v in parts.items()},
                grads={k: v.grad.clone() for k, v in state.items()})


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("data", [0, 1, 4, 1000, 2 ** 32 - 1])
def test_fold_in_bit_equal(seed, data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    got = prng.fold_in(prng.PRNGKey(seed), data).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_normal_matches_jax():
    """``normal`` draws the same uniforms as JAX; erf_inv's log1p rounds
    differently for about one draw in a hundred (an ulp or so, a few 1e-4
    where the polynomial branch flips at w = 5)."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (4, 5000)))
    got = prng.normal(prng.PRNGKey(3), (4, 5000)).numpy()
    assert np.mean(got != want) < 0.02
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_encode_smooth_l1_crop_match_jax():
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    anchors = np.concatenate([a, a + rng.uniform(-2, 60, (50, 2))], 1) \
        .astype(np.float32)
    b = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    boxes = np.concatenate([b, b + rng.uniform(1, 60, (50, 2))], 1) \
        .astype(np.float32)
    w = (10.0, 10.0, 5.0, 5.0)
    close(tl._encode_boxes(torch.from_numpy(boxes), torch.from_numpy(anchors),
                           w),
          jl._encode_boxes(jnp.asarray(boxes), jnp.asarray(anchors), w), 1e-6)
    x = rng.normal(0, 0.3, (1000,)).astype(np.float32)
    close(tl._smooth_l1(torch.from_numpy(x)), jl._smooth_l1(jnp.asarray(x)),
          1e-6)
    masks = (rng.uniform(0, 1, (5, 40, 48)) > 0.5).astype(np.float32)
    rois = np.concatenate([rng.uniform(0, 30, (5, 2)),
                           rng.uniform(35, 60, (5, 2))], 1).astype(np.float32)
    want = jax.vmap(jl._crop_mask_to_box)(jnp.asarray(masks),
                                          jnp.asarray(rois))
    close(tl._crop_mask_to_box(torch.from_numpy(masks),
                               torch.from_numpy(rois)), want, 1e-6)


def test_match_and_sample_equal_jax():
    """Anchors of one level against padded targets; the forced anchors and
    JAX's scatter order (the padded GTs name anchor 0) included."""
    from vido_slam_tpu.models.maskrcnn import rpn as jr
    cell = jr.generate_cell_anchors(8, 64)
    anchors = jr.grid_anchors(16, 20, 8, cell)
    t = toy_targets()
    for pos, neg in ((0.7, 0.3), (0.5, 0.5)):
        jg, jp, jn = jl._match(jnp.asarray(anchors), j_targets(t), pos, neg)
        tg, tp, tn = tl._match(torch.from_numpy(anchors), t_targets(t), pos,
                               neg)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        for seed, batch, frac in ((1, 256, 0.5), (2, 512, 0.25), (3, 64, 0.5)):
            jw = jl._sample(jax.random.PRNGKey(seed), jp, jn, batch, frac)
            tw = tl._sample(prng.PRNGKey(seed), tp, tn, batch, frac)
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------

def test_loss_parts_match_jax(jax_ref, port_run):
    assert set(port_run["parts"]) == set(jax_ref["parts"])
    for k, want in jax_ref["parts"].items():
        got = port_run["parts"][k]
        assert abs(got - want) <= 1e-4 * max(abs(want), 1e-3), (k, got, want)
    assert jax_ref["parts"]["loss_mask"] > 0
    assert jax_ref["parts"]["loss_box_reg"] > 0


def test_gradient_of_every_key_matches_jax(jax_ref, port_run):
    got = convert.convert_state_dict(port_run["grads"])
    want = jax_ref["grads"]
    assert set(got) == set(want)
    bad = []
    for k in want:
        assert got[k].shape == want[k].shape, k
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(got[k] - want[k]).max())
        if err > 1e-3 * scale + 1e-12:
            bad.append((k, err, scale))
    assert not bad, bad
    # the box and mask losses reach the backbone through ROIAlign, and the
    # FrozenBN statistics take a gradient
    assert np.abs(got["backbone.body.stem.bn1.running_var"]).max() > 0
    assert np.abs(got["roi_heads.mask.feature_extractor.mask_fcn1.weight"]
                  ).max() > 0


def test_sgd_step_for_step_equals_optax(jax_ref, params):
    """Three steps of ``make_detection_optimizer`` on the same gradients
    (JAX's, then x0.5, then x-1) as optax's chain: parameters within
    1e-5."""
    kw = dict(base_lr=0.02, warmup_iters=2, weight_decay=1e-4)
    jopt = jt.make_detection_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    model = tm.MaskRCNN(t_cfg(), device="cpu")
    model.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
        params, device="cpu"), strict=True)
    state = tt.trainable_state(model)
    opt = tt.make_detection_optimizer(state, **kw)
    tgrads = convert.maskrcnn_state_dict_from_numpy(jax_ref["grads"],
                                                    device="cpu")
    @jax.jit
    def jstep(g, jstate, jp):
        upd, jstate = jopt.update(g, jstate, jp)
        return optax.apply_updates(jp, upd), jstate

    for factor in (1.0, 0.5, -1.0):
        g = {k: jnp.asarray(v) * factor for k, v in jax_ref["grads"].items()}
        jp, jstate = jstep(g, jstate, jp)
        for k, v in state.items():
            v.grad = tgrads[k] * factor
        opt.step()
        got = convert.convert_state_dict(model.state_dict())
        for k in jp:
            close(got[k], np.asarray(jp[k]), 1e-5)


@pytest.mark.parametrize("step", [0, 250, 499, 500, 120000, 160000])
def test_schedule_equal(step):
    want = np.asarray(jt.warmup_multistep_schedule()(step))
    got = tt.warmup_multistep_schedule()(step).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got == want, (got, want)


def test_roi_align_gradient_matches_jax_grad():
    """The plain path of the differentiable ROIAlign against ``jax.grad``
    of the JAX package's XLA ROIAlign (what its trainer differentiates):
    the gradient with respect to each level within 1e-5 of max |g|; the
    ROIs refuse a gradient, and the backward kernel's wrapper refuses CPU
    tensors."""
    rng = np.random.RandomState(4)
    shapes = [(32, 40), (16, 20), (8, 10), (4, 5)]
    C = 8
    feats = [rng.normal(0, 1, (h, w, C)).astype(np.float32) for h, w in shapes]
    x1 = rng.uniform(-10, 140, 30)
    y1 = rng.uniform(-10, 110, 30)
    rois = np.stack([x1, y1, x1 + rng.uniform(0, 120, 30),
                     y1 + rng.uniform(0, 120, 30)], 1).astype(np.float32)
    levels = rng.randint(0, 4, 30).astype(np.int32)
    scales = (0.25, 0.125, 0.0625, 0.03125)
    g_out = rng.normal(0, 1, (30, 7, 7, C)).astype(np.float32)

    def f(fs):
        out = j_roi.roi_align_multilevel(tuple(fs), jnp.asarray(rois),
                                         jnp.asarray(levels), scales, 7, 2)
        return jnp.sum(out * g_out)
    want = jax.grad(f)([jnp.asarray(x) for x in feats])
    tf = [torch.from_numpy(x.transpose(2, 0, 1)[None].copy())
          .requires_grad_() for x in feats]
    out = t_roi.roi_align_multilevel(tf, torch.from_numpy(rois),
                                     torch.from_numpy(levels), scales, 7, 2)
    out.backward(torch.from_numpy(g_out.transpose(0, 3, 1, 2).copy()))
    for t, w in zip(tf, want):
        close(t.grad[0].numpy().transpose(1, 2, 0), w,
              1e-5 * max(1.0, float(np.abs(w).max())))
    with pytest.raises(ValueError, match="CUDA"):
        t_roi.roi_align_multilevel_backward(
            torch.from_numpy(g_out.transpose(0, 3, 1, 2).copy()), shapes,
            torch.from_numpy(rois), torch.from_numpy(levels), scales, 7, 2)
    with pytest.raises(RuntimeError, match="ROIs"):
        t_roi.roi_align_multilevel(
            tf, torch.from_numpy(rois).requires_grad_(),
            torch.from_numpy(levels), scales, 7, 2)


# ---------------------------------------------------------------------------
# the RetinaNet and keypoint losses (library functions)
# ---------------------------------------------------------------------------

def test_sigmoid_focal_loss_matches_jax():
    from vido_slam_tpu.models.maskrcnn import retinanet as jr
    from vido_slam_tpu_torch.models.maskrcnn import retinanet as trn
    rng = np.random.RandomState(2)
    logits = rng.normal(0, 3, (200, 80)).astype(np.float32)
    onehot = (rng.uniform(0, 1, (200, 80)) > 0.9).astype(np.float32)
    close(trn.sigmoid_focal_loss(torch.from_numpy(logits),
                                 torch.from_numpy(onehot)),
          jr.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(onehot)),
          1e-6)


def test_keypoint_targets_and_loss_match_jax():
    from vido_slam_tpu.models.maskrcnn import keypoint_head as jk
    from vido_slam_tpu_torch.models.maskrcnn import keypoint_head as tk
    rng = np.random.RandomState(3)
    R = 12
    x0 = rng.uniform(0, 100, (R, 2))
    rois = np.concatenate([x0, x0 + rng.uniform(5, 80, (R, 2))], 1) \
        .astype(np.float32)
    kp = (rois[:, None, :2] + rng.uniform(-0.1, 1.1, (R, 17, 2))
          * (rois[:, None, 2:] - rois[:, None, :2])).astype(np.float32)
    kp[0, 0] = rois[0, 2:]                     # on the far edge
    vis = rng.uniform(0, 1, (R, 17)) > 0.3
    roi_valid = np.arange(R) < R - 2
    logits = rng.normal(0, 2, (R, 17, 56, 56)).astype(np.float32)
    jt_, jv = jk.keypoints_to_heatmap(jnp.asarray(kp), jnp.asarray(vis),
                                      jnp.asarray(rois))
    tt_, tv = tk.keypoints_to_heatmap(torch.from_numpy(kp),
                                      torch.from_numpy(vis),
                                      torch.from_numpy(rois))
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(jt_))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.asarray(jv).any() and not np.asarray(jv).all()
    want = jk.keypoint_loss(jnp.asarray(logits.transpose(0, 2, 3, 1)),
                            jnp.asarray(kp), jnp.asarray(vis),
                            jnp.asarray(rois), jnp.asarray(roi_valid))
    got = tk.keypoint_loss(torch.from_numpy(logits), torch.from_numpy(kp),
                           torch.from_numpy(vis), torch.from_numpy(rois),
                           torch.from_numpy(roi_valid))
    close(got, want, 1e-6)


def test_keypoint_targets_of_integer_keypoints_in_integer_boxes_equal_jax():
    """Integer keypoints in integer boxes of every width 1-399: a cell is
    floor((kp - x0) * 56 / w), so one rounding more than JAX's (the
    reciprocal times 56) moves a keypoint into the next cell at some
    widths. The targets must equal JAX's cell for cell."""
    from vido_slam_tpu.models.maskrcnn import keypoint_head as jk
    from vido_slam_tpu_torch.models.maskrcnn import keypoint_head as tk
    rng = np.random.RandomState(4)
    R = 399
    w = np.arange(1, R + 1)
    h = rng.randint(1, 400, R)
    x0 = rng.randint(0, 300, R)
    y0 = rng.randint(0, 300, R)
    rois = np.stack([x0, y0, x0 + w, y0 + h], 1).astype(np.float32)
    kp = np.stack([
        x0[:, None] + np.floor(rng.uniform(0, 1, (R, 17)) * (w[:, None] + 1)),
        y0[:, None] + np.floor(rng.uniform(0, 1, (R, 17)) * (h[:, None] + 1)),
    ], -1).astype(np.float32)
    vis = rng.uniform(0, 1, (R, 17)) > 0.1
    jt_, jv = jk.keypoints_to_heatmap(jnp.asarray(kp), jnp.asarray(vis),
                                      jnp.asarray(rois))
    tt_, tv = tk.keypoints_to_heatmap(torch.from_numpy(kp),
                                      torch.from_numpy(vis),
                                      torch.from_numpy(rois))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(jt_))
    assert np.asarray(jv).sum() > 0.8 * R * 17
