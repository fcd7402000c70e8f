"""The port's detector trainer and evaluation functions on a (dp 2, tp 1)
mesh of two gloo ranks, against the JAX package's functions and the port's
single-device ones on the CPU.

The two ranks are spawned once (``parallel/mesh.py::spawn``, a ``file://``
store in a temporary directory) and run every check; this process holds
their results. JAX is imported here only, inside the fixtures.

- The detector train step at dp 2 with the tiny config (one block a
  stage, 64 FPN channels, 64x96, B 2; tests/test_parallel.py:163's batch):
  the loss within 1e-5 relative of JAX's single-device loss on the same
  batch and key (per-image keys ``split(key, 2)``), the gradient within
  1e-5 of each key's max |g| of the port's mesh-less step's.
- ``run_detection_training`` on that mesh: rank 0 alone writes
  ``model_0000002.npz`` and ``model_final.npz``, which both packages load,
  and logs 3 lines.
- ``sharded_window_ba`` and ``evaluate_sequences`` (S 4, tests/
  test_parallel.py's ``make_problem``) within 1e-6 of the port's single
  device, and within test_torch_parallel_eval.py's JAX bars (poses 1e-4,
  ATE 1e-5); ``multi_sequence_tracking`` at S 3 (so one sequence is a
  pad) within 1e-6 of the port's single device and 1e-4 of a JAX
  ``Tracker`` a sequence; ``sharded_detection_inference`` and
  ``sharded_coco_evaluation`` (B 4, a one-block-a-stage R-50-FPN at
  128x160, class 3 lifted) equal to one device, with the same AP.
"""

import os

import numpy as np
import pytest
import torch

from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.config import config_from_dict
from vido_slam_tpu_torch.models.maskrcnn.backbone import ResNetConfig
from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNN, MaskRCNNConfig
from vido_slam_tpu_torch.parallel import eval as te
from vido_slam_tpu_torch.parallel import mesh as tmesh
from vido_slam_tpu_torch.parallel import train as tt
from vido_slam_tpu_torch.parallel.dryrun import (SLAM_CONFIG, SLAM_KW,
                                                 slam_sequences)
from vido_slam_tpu_torch.parallel.slam_eval import multi_sequence_tracking
from vido_slam_tpu_torch.utils import prng
from vido_slam_tpu_torch.utils.checkpoint import load_params

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = MaskRCNNConfig(resnet=ResNetConfig(stage_blocks=(1, 1, 1, 1),
                                          out_channels=64),
                      input_h=64, input_w=96)
EVAL = MaskRCNNConfig(resnet=ResNetConfig(stage_blocks=(1, 1, 1, 1)),
                      input_h=128, input_w=160)
KEY = 3
LIFT = 30.0


def detector_batch():
    """tests/test_parallel.py:166-178's batch of 2."""
    rng = np.random.RandomState(0)
    B, G = 2, 4
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.zeros((B, G), np.int32)
    valid = np.zeros((B, G), bool)
    masks = np.zeros((B, G, 32, 48), np.float32)
    boxes[:, 0] = [10, 10, 50, 40]
    labels[:, 0] = 3
    valid[:, 0] = True
    masks[:, 0, 5:20, 5:25] = 1.0
    return {"image": rng.rand(B, 64, 96, 3).astype(np.float32) * 50,
            "targets": {"boxes": boxes, "labels": labels, "masks": masks,
                        "valid": valid}}


def tiny_model(params):
    model = MaskRCNN(TINY, device="cpu")
    model.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
        params, device="cpu"), strict=True)
    return model


def eval_model():
    model = MaskRCNN(EVAL, seed=0, device="cpu")
    with torch.no_grad():
        model.roi_heads.box.predictor.cls_score.bias[3] = LIFT
    return model


def eval_images():
    return torch.rand(4, 3, 128, 160, generator=torch.Generator()
                      .manual_seed(1))


def numpy_tree(x):
    """Tensors of a result (a tuple or NamedTuple of them) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return type(x)(*map(numpy_tree, x)) if hasattr(x, "_fields") \
        else type(x)(map(numpy_tree, x))


def dp_rank(tiny_params, probs, gt, gts, out_dir):
    """Every check of the dp 2 mesh on this rank."""
    mesh = tmesh.make_mesh(dp=2)
    out = {}
    model = tiny_model(tiny_params)
    step = tt.make_detection_train_step(model, lr=1e-4, mesh=mesh)
    out["loss"] = float(step(detector_batch(), prng.PRNGKey(KEY)))
    out["grads"] = convert.convert_state_dict(
        {k: v.grad for k, v in tt.trainable_state(model).items()})
    logs = []
    tt.run_detection_training(
        convert.maskrcnn_state_dict_from_numpy(tiny_params, device="cpu"),
        [detector_batch()], None, TINY,
        num_iters=3, base_lr=1e-4, warmup_iters=2, checkpoint_period=2,
        log_period=1, output_dir=out_dir, log_fn=logs.append, mesh=mesh)
    out["logs"] = logs
    out["window_ba"] = numpy_tree(te.sharded_window_ba(probs, mesh=mesh))
    out["evaluate"] = numpy_tree(te.evaluate_sequences(probs, gt,
                                                       max_iters=12,
                                                       mesh=mesh))
    out["multi"] = numpy_tree(multi_sequence_tracking(
        config_from_dict(SLAM_CONFIG), *slam_sequences(3, "cpu"), **SLAM_KW,
        mesh=mesh))
    model = eval_model()
    out["inference"] = numpy_tree(te.sharded_detection_inference(
        model, eval_images(), mesh=mesh))
    out["coco"] = te.sharded_coco_evaluation(model, eval_images(), gts,
                                             out_hw=(96, 120), mesh=mesh)
    return out


@pytest.fixture(scope="module")
def tiny_params():
    import jax

    from vido_slam_tpu.models.maskrcnn import backbone as jb
    from vido_slam_tpu.models.maskrcnn import model as jm

    cfg = jm.MaskRCNNConfig(resnet=jb.ResNetConfig(stage_blocks=(1, 1, 1, 1),
                                                   out_channels=64),
                            input_h=64, input_w=96)
    p = jax.jit(jm.init_maskrcnn_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    return {k: np.array(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def window_problems():
    """S 4 window problems of tests/test_parallel.py's ``make_problem``."""
    import importlib.util

    import jax

    spec = importlib.util.spec_from_file_location(
        "jax_parallel_tests", os.path.join(HERE, "test_parallel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    problems, gts = zip(*(mod.make_problem(jax.random.PRNGKey(s))
                          for s in range(4)))
    probs = {k: np.stack([np.asarray(p[k]) for p in problems])
             for k in problems[0]}
    return probs, np.stack([np.asarray(g) for g in gts])


@pytest.fixture(scope="module")
def single():
    """The port's single-device inference of the evaluation batch, and a
    ground truth from it: every other detection, its box moved up to 4
    px and its mask cut."""
    model = eval_model()
    out = te.sharded_detection_inference(model, eval_images(), device="cpu")
    rng = np.random.RandomState(2)
    gts = []
    for p in te.predictions_from_output(out, (128, 160), (96, 120)):
        keep = np.arange(len(p["scores"])) % 2 == 0
        masks = p["masks"][keep].copy()
        masks[:, ::3] = False
        gts.append({"boxes": p["boxes"][keep]
                    + rng.uniform(-4, 4, (int(keep.sum()), 4)),
                    "labels": p["labels"][keep], "masks": masks})
    return out, gts


@pytest.fixture(scope="module")
def ranks(tiny_params, window_problems, single, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("train"))
    probs, gt = window_problems
    res = tmesh.spawn(dp_rank, 2, tiny_params, te.BatchedWindowProblem(
        **probs), gt, single[1], out_dir)
    return res, out_dir


def test_detector_step_matches_jax_and_the_single_device_step(
        tiny_params, ranks):
    import jax
    import jax.numpy as jnp

    from vido_slam_tpu.models.maskrcnn import backbone as jb
    from vido_slam_tpu.models.maskrcnn import model as jm
    from vido_slam_tpu.models.maskrcnn.losses import (DetectionTargets,
                                                      total_loss)

    res, _ = ranks
    cfg = jm.MaskRCNNConfig(resnet=jb.ResNetConfig(stage_blocks=(1, 1, 1, 1),
                                                   out_channels=64),
                            input_h=64, input_w=96)
    batch = detector_batch()
    t = batch["targets"]
    p = {k: jnp.asarray(v) for k, v in tiny_params.items()}

    @jax.jit
    def loss(img, boxes, labels, masks, valid, key):
        keys = jax.random.split(key, img.shape[0])
        return jnp.mean(jax.vmap(lambda i, b, lb, m, v, k: total_loss(
            p, i[None], DetectionTargets(boxes=b, labels=lb, masks=m,
                                         valid=v), k, cfg))(
            img, boxes, labels, masks, valid, keys))
    want = float(loss(batch["image"], t["boxes"], t["labels"], t["masks"],
                      t["valid"], jax.random.PRNGKey(KEY)))
    for r in res:
        assert abs(r["loss"] - want) <= 1e-5 * abs(want), (r["loss"], want)
    model = tiny_model(tiny_params)
    single = float(tt.make_detection_train_step(model, lr=1e-4)(
        batch, prng.PRNGKey(KEY)))
    assert abs(single - want) <= 1e-5 * abs(want)
    grads = convert.convert_state_dict(
        {k: v.grad for k, v in tt.trainable_state(model).items()})
    for r in res:
        assert set(r["grads"]) == set(grads)
        for k, g in grads.items():
            scale = float(np.abs(g).max())
            err = float(np.abs(r["grads"][k] - g).max())
            assert err <= 1e-5 * scale, (k, err, scale)


def test_training_loop_on_the_mesh_checkpoints_from_rank_0(ranks):
    from vido_slam_tpu.utils.checkpoint import load_params as jax_load

    res, out_dir = ranks
    assert len(res[0]["logs"]) == 3 and "loss" in res[0]["logs"][0]
    assert res[1]["logs"] == []
    assert sorted(os.listdir(out_dir)) == ["model_0000002.npz",
                                          "model_final.npz"]
    for name in ("model_0000002", "model_final"):
        path = os.path.join(out_dir, name)
        mine, theirs = load_params(path), jax_load(path)
        assert set(mine) == set(theirs)
        for k, v in theirs.items():
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(v))
    # the loop's final weights reload into the detector
    tiny_model(jax_load(os.path.join(out_dir, "model_final")))


def test_window_ba_on_the_mesh_matches_one_device_and_jax(window_problems,
                                                          ranks):
    import jax.numpy as jnp

    from vido_slam_tpu.parallel import eval as je
    from vido_slam_tpu.parallel.mesh import make_mesh

    probs, gt = window_problems
    res, _ = ranks
    one = te.sharded_window_ba(te.BatchedWindowProblem(**probs),
                               device="cpu")
    one_res, one_ate = te.evaluate_sequences(te.BatchedWindowProblem(**probs),
                                             gt, max_iters=12, device="cpu")
    j_res, j_ate = je.evaluate_sequences(
        make_mesh(1, dp=1, tp=1),
        je.BatchedWindowProblem(**{k: jnp.asarray(v) for k, v in
                                   probs.items()}), jnp.asarray(gt),
        max_iters=12)
    for r in res:
        ba = r["window_ba"]
        for name in ("Twc", "points", "cost"):
            np.testing.assert_allclose(getattr(ba, name),
                                       getattr(one, name).numpy(),
                                       atol=1e-6, rtol=0, err_msg=name)
        np.testing.assert_array_equal(ba.num_iters, one.num_iters.numpy())
        got, ate = r["evaluate"]
        np.testing.assert_allclose(got.Twc, one_res.Twc.numpy(), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(ate, one_ate.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.Twc, np.asarray(j_res.Twc), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(got.points, np.asarray(j_res.points),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(ate, np.asarray(j_ate), atol=1e-5, rtol=0)
        assert (ate < 0.01).all()


def test_multi_sequence_tracking_pads_on_the_mesh(ranks):
    import jax.numpy as jnp

    from vido_slam_tpu.config import config_from_dict as j_config
    from vido_slam_tpu.tracking import Tracker as JTracker

    res, _ = ranks
    depths, flows, masks = slam_sequences(3, "cpu")
    one = multi_sequence_tracking(config_from_dict(SLAM_CONFIG), depths,
                                  flows, masks, **SLAM_KW, device="cpu")
    kw = SLAM_KW
    for r in res:
        got = r["multi"]
        assert got.Tcw.shape == (3, 3, 4, 4)
        for name in ("Tcw", "ba_Twc"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(one, name).numpy(), atol=1e-6,
                                       rtol=0, err_msg=name)
        np.testing.assert_array_equal(got.n_inliers, one.n_inliers.numpy())
    for s in range(3):
        jt = JTracker(j_config(SLAM_CONFIG), seed=s, n_bg=kw["n_bg"],
                      n_obj=kw["n_obj"], max_objects=kw["max_objects"],
                      local_ba=True, fused_ba=True,
                      ba_max_points=kw["ba_points"], ba_iters=kw["ba_iters"])
        want = [np.asarray(jt.track(jnp.asarray(depths[s, t]),
                                    jnp.asarray(flows[s, t]),
                                    jnp.asarray(masks[s, t])))
                for t in range(3)]
        jt.finish()
        np.testing.assert_allclose(res[0]["multi"].Tcw[s], np.stack(want),
                                   atol=1e-4, rtol=0, err_msg=f"sequence {s}")


def test_detection_evaluation_on_the_mesh_equals_one_device(single, ranks):
    res, _ = ranks
    out, gts = single
    assert int(out.valid.sum(1).min()) >= 5
    scores = te.sharded_coco_evaluation(eval_model(), eval_images(), gts,
                                        out_hw=(96, 120), device="cpu")
    for r in res:
        for name, want in out._asdict().items():
            np.testing.assert_array_equal(getattr(r["inference"], name),
                                          want.numpy(), err_msg=name)
        for t, metrics in scores.items():
            for k, v in metrics.items():
                if k != "per_category":
                    assert r["coco"][t][k] == v or (np.isnan(v) and np.isnan(
                        r["coco"][t][k])), (t, k)
    assert 0.1 < scores["bbox"]["AP50"] <= 1.0
