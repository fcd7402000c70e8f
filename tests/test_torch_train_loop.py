"""The port's detector training loop against the JAX package's:
``run_detection_training`` for 3 iterations at batch 2 on the synthetic
batches of both CLIs (``synthetic_batches``), at 128x160 with a ResNet of
one block a stage and 64 FPN channels, the JAX run on a mesh of one CPU
device, base lr 1e-4: each iteration's logged loss within 1e-3 relative
(the log prints 4 decimals); the port's ``model_final.npz`` has the keys
and shapes of JAX's ``model_final``, and each tensor's three-step change
from the initial parameters agrees within 5e-2 of its largest entry
(measured 1.7e-2 at worst: each step's gradient parts from JAX's by up to
1e-3 of its max, test_torch_train_maskrcnn.py, and momentum carries the
first steps' differences into the third; a FrozenBN bias that starts at
zero is all change). The random detector's loss falls from 31.6 to 8.7 in
these three steps, so each step amplifies the float32 differences of the
gradients (1e-5 relative at the second iteration, 6e-4 at the third); at
the smoke recipe's lr 1e-3 (31.6 to 6.5) the third iteration's losses
part by 2e-3.
"""

import re

import jax
import numpy as np
import torch

from vido_slam_tpu.models.maskrcnn import backbone as jb
from vido_slam_tpu.models.maskrcnn import model as jm
from vido_slam_tpu.parallel import mesh as jmesh
from vido_slam_tpu.parallel import train as jt
from vido_slam_tpu.utils.checkpoint import load_params as j_load_params
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch import train_maskrcnn as cli
from vido_slam_tpu_torch.models.maskrcnn import backbone as tb
from vido_slam_tpu_torch.models.maskrcnn import model as tm
from vido_slam_tpu_torch.parallel import train as tt
from vido_slam_tpu_torch.utils.checkpoint import load_params

torch.set_num_threads(1)

H, W = 128, 160
RESNET = dict(stage_blocks=(1, 1, 1, 1), out_channels=64)
LOSS = re.compile(r"iter (\d+)/\d+  loss ([0-9.]+) ")


def run_both(tmp_path):
    jcfg = jm.MaskRCNNConfig(resnet=jb.ResNetConfig(**RESNET), input_h=H,
                             input_w=W)
    tcfg = tm.MaskRCNNConfig(resnet=tb.ResNetConfig(**RESNET), input_h=H,
                             input_w=W)
    params = jax.jit(jm.init_maskrcnn_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    params = {k: np.array(v) for k, v in params.items()}
    batches = cli.synthetic_batches(2, 2, H, W, 8, seed=3)
    kw = dict(num_iters=3, base_lr=1e-4, warmup_iters=2, log_period=1,
              checkpoint_period=100, seed=3)
    logs = {"jax": [], "port": []}
    jt.run_detection_training(params, batches, jmesh.make_mesh(1, tp=1),
                              jcfg, output_dir=str(tmp_path / "jax"),
                              log_fn=logs["jax"].append, **kw)
    tt.run_detection_training(
        convert.maskrcnn_state_dict_from_numpy(params, device="cpu"),
        batches, "cpu", tcfg, output_dir=str(tmp_path / "port"),
        log_fn=logs["port"].append, **kw)
    return logs, params


def test_three_iterations_match_jax(tmp_path):
    logs, params = run_both(tmp_path)
    losses = {k: [float(LOSS.match(line).group(2)) for line in v]
              for k, v in logs.items()}
    assert len(losses["port"]) == len(losses["jax"]) == 3
    for got, want in zip(losses["port"], losses["jax"]):
        assert abs(got - want) <= 1e-3 * max(abs(want), 1.0), losses
    # JAX writes an orbax directory where orbax is installed, else .npz
    want = {k: np.asarray(v) for k, v in j_load_params(
        str(tmp_path / "jax" / "model_final")).items()}
    got = {k: v.numpy() for k, v in load_params(
        str(tmp_path / "port" / "model_final")).items()}
    assert set(got) == set(want)
    rel = {}
    for k in want:
        assert got[k].shape == want[k].shape, k
        step = want[k] - params[k]
        rel[k] = float(np.abs(got[k] - want[k]).max()) \
            / max(float(np.abs(step).max()), 1e-30)
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 5e-2, (worst, rel[worst])
