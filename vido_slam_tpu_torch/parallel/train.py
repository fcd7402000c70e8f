"""Training steps and loops for the perception networks — counterpart of
``vido_slam_tpu/parallel/train.py``, on one device or, given a ``mesh``
(``parallel/mesh.py``), over a (dp, tp) process mesh.

- The supervised depth step: ``depth_loss`` (L1 between MonoDepth2's
  disparity and a target inverse depth) under Adam (``make_optimizer``:
  optax's ``adam``; torch's Adam adds ``eps`` after the square root as
  optax does).
- The detector: ``warmup_multistep_schedule``, the reference's SGD solver
  (``make_detection_optimizer``), ``make_detection_train_step`` (the mean
  of the images' ``total_loss``) and ``run_detection_training`` with its
  log line and checkpoints.

What is trained is every floating tensor of the model's state dict: the
parameters and also the buffers, the FrozenBN and BatchNorm weights,
biases and running statistics among them, since the JAX package
differentiates and updates its whole parameter dict (the reference
freezes those). ``trainable_state`` gives them ``requires_grad`` and
returns them keyed as the state dict, which is the JAX dict's keying. A
tensor that the loss does not reach gets a zero gradient, as under
``jax.grad``, so weight decay and momentum still move it.

Entry points take the device of the model they are given; the models
themselves default to the card (``device="cpu"`` for the CPU).

On a mesh, a step computes what the JAX package's GSPMD program computes
(train.py:70-91, 185-199) with the forms of ``vido_slam_tpu_torch``'s
single-device step:

- each dp rank takes its rows of the global batch (``shard_batch``), and
  the per-image keys are the rows of ``split(key, B)`` over the global B;
- each tp rank keeps and updates only its ``param_spec`` shard of every
  trainable tensor, and its optimizer's state has the same shards; the
  forward runs with the whole tensors, all-gathered over the tp group
  after each update (so the model always holds the current weights);
- the gradient is the dp mean of the ranks' local mean-loss gradients
  (equal shard sizes: the global mean), summed over the dp group and
  divided by dp; each rank then updates its slice. Adam and
  ``DetectionSGD`` are elementwise, so the sharded update equals the
  whole one;
- the loss returned is the dp mean, JAX's global loss.

tp is computed by gathering the weights, not by splitting each conv's
output channels and gathering the activations: the numbers are the same
and it is the least code; tp ranks of one dp row repeat the same rows.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from vido_slam_tpu_torch.models.maskrcnn.losses import (DetectionTargets,
                                                        total_loss)
from vido_slam_tpu_torch.models.maskrcnn.model import MaskRCNN
from vido_slam_tpu_torch.parallel.mesh import (Mesh, dp_mean, gather_params,
                                               param_spec, shard_batch,
                                               shard_params)
from vido_slam_tpu_torch.utils import prng
from vido_slam_tpu_torch.utils.checkpoint import save_torch_state_dict
from vido_slam_tpu_torch.utils.device import resolve_device


def trainable_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters and floating buffers, keyed as its state dict,
    each made a leaf that requires a gradient (in place: the model computes
    with these very tensors)."""
    sd = model.state_dict(keep_vars=True)
    for v in sd.values():
        if v.is_floating_point():
            v.requires_grad_(True)
    return {k: v for k, v in sd.items() if v.is_floating_point()}


def compute_grads(loss: torch.Tensor,
                  params: Dict[str, torch.Tensor]) -> None:
    """Gradients of ``loss`` into ``params``' ``.grad``, zero where the loss
    does not reach."""
    for v in params.values():
        v.grad = None
    loss.backward()
    for v in params.values():
        if v.grad is None:
            v.grad = torch.zeros_like(v)


def mesh_update(opt: torch.optim.Optimizer, whole: Dict[str, torch.Tensor],
                shards: Dict[str, torch.Tensor], mesh: Mesh) -> None:
    """One optimizer step on a mesh, after ``compute_grads`` into the whole
    tensors ``whole``: their gradients become the dp mean (one all-reduce
    over the dp group), each shard of ``shards`` (which ``opt`` holds)
    takes its slice, ``opt`` steps, and the shards are gathered back into
    ``whole``."""
    if mesh.dp > 1:
        flat = torch.cat([v.grad.reshape(-1) for v in whole.values()])
        flat = dp_mean(flat, mesh)
        at = 0
        for v in whole.values():
            v.grad = flat[at:at + v.numel()].view(v.shape)
            at += v.numel()
    for k, s in shards.items():
        g = whole[k].grad
        d = param_spec(k, g, mesh.tp)
        if d is not None:
            n = g.shape[d] // mesh.tp
            g = g.narrow(d, mesh.tp_rank * n, n)
        s.grad = g.contiguous()
    opt.step()
    gather_params(shards, mesh, whole)


def sharded_leaves(whole: Dict[str, torch.Tensor],
                   mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The optimizer's tensors on a mesh: leaves holding this rank's
    shards."""
    return {k: v.requires_grad_(True)
            for k, v in shard_params(whole, mesh).items()}


# ---------------------------------------------------------------------------
# the supervised depth step
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    """``params`` are what ``opt`` holds: the trainable state itself, or on
    a mesh this rank's shards of it."""
    model: nn.Module
    params: Dict[str, torch.Tensor]
    opt: torch.optim.Optimizer
    step: int


def depth_loss(net: nn.Module, batch) -> torch.Tensor:
    """L1 between the predicted disparity and the target inverse depth:
    batch["image"] (N, 3, H, W) RGB in [0, 1], batch["target"] (N, H, W)."""
    pred = net.decoder(net.encoder(batch["image"]))[0][:, 0]
    return torch.mean(torch.abs(pred - batch["target"]))


def make_optimizer(params: Dict[str, torch.Tensor],
                   lr: float = 1e-4) -> torch.optim.Optimizer:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8 after the square root)."""
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def init_train_state(net: nn.Module, lr: float = 1e-4,
                     mesh: Optional[Mesh] = None) -> TrainState:
    """The trainable state of ``net`` under Adam; on a ``mesh`` the
    optimizer holds this rank's shards (``net`` on the mesh's device)."""
    params = trainable_state(net)
    if mesh is not None:
        params = sharded_leaves(params, mesh)
    return TrainState(net, params, make_optimizer(params, lr), 0)


def make_train_step(loss_fn: Callable = depth_loss,
                    mesh: Optional[Mesh] = None):
    """(state, batch) -> (state, loss): one optimizer step of ``loss_fn``
    over the state's model, in place. On a ``mesh`` (the state's, from
    ``init_train_state(..., mesh=mesh)``) the batch is the global one:
    each dp rank takes its rows and the loss is the dp mean."""

    def step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        if mesh is None:
            loss = loss_fn(state.model, batch)
            compute_grads(loss, state.params)
            state.opt.step()
            return state._replace(step=state.step + 1), loss.detach()
        whole = trainable_state(state.model)
        loss = loss_fn(state.model, shard_batch(batch, mesh))
        compute_grads(loss, whole)
        mesh_update(state.opt, whole, state.params, mesh)
        return (state._replace(step=state.step + 1),
                dp_mean(loss.detach(), mesh))

    return step


# ---------------------------------------------------------------------------
# detection training (the reference's tools/train_net.py)
# ---------------------------------------------------------------------------

def warmup_multistep_schedule(
    base_lr: float = 0.01,
    warmup_factor: float = 1.0 / 3.0,
    warmup_iters: int = 500,
    steps: Tuple[int, ...] = (120000, 160000),
    gamma: float = 0.1,
) -> Callable[[int], torch.Tensor]:
    """WarmupMultiStepLR (solver/lr_scheduler.py): a linear warmup from
    warmup_factor * base_lr over warmup_iters, then base_lr * gamma^(the
    milestones passed). Returns step -> float32 lr, computed in float32 in
    the JAX function's order (train.py:96-119)."""
    f32 = torch.float32

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=f32)
        alpha = torch.where(step >= warmup_iters, torch.tensor(1.0, dtype=f32),
                            step / torch.tensor(float(max(warmup_iters, 1)),
                                                dtype=f32))
        warm = torch.tensor(warmup_factor, dtype=f32) * (1.0 - alpha) + alpha
        n_passed = torch.stack([(step >= s).to(f32) for s in steps]).sum() \
            if steps else torch.tensor(0.0, dtype=f32)
        return torch.tensor(base_lr, dtype=f32) * warm \
            * torch.tensor(gamma, dtype=f32) ** n_passed

    return lr


class DetectionSGD(torch.optim.SGD):
    """The reference solver (solver/build.py make_optimizer) as
    train.py:122-153 chains it in optax: weight decay on tensors with
    ndim > 1; tensors with ndim <= 1 (biases, norm scales and statistics)
    at bias_lr_factor x the lr and no decay; heavy-ball momentum
    t = g + momentum t; the step -lr(step) t with lr from the schedule.
    Two parameter groups of ``torch.optim.SGD`` compute the same: the
    factor 2 moves from the gradient to the lr, exactly, and the update
    differs from optax's by the rounding of its last multiply-add (an ulp).
    ``step()`` takes the lr of its own count."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Callable,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 bias_lr_factor: float = 2.0):
        vals = list(params.values())
        super().__init__(
            [{"params": [v for v in vals if v.ndim > 1],
              "weight_decay": weight_decay, "lr_factor": 1.0},
             {"params": [v for v in vals if v.ndim <= 1],
              "weight_decay": 0.0, "lr_factor": bias_lr_factor}],
            lr=0.0, momentum=momentum)
        self.schedule = schedule
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = float(self.schedule(self.count))
        for g in self.param_groups:
            g["lr"] = g["lr_factor"] * lr
        super().step(closure)
        self.count += 1


def make_detection_optimizer(
    params: Dict[str, torch.Tensor],
    base_lr: float = 0.01,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    warmup_factor: float = 1.0 / 3.0,
    warmup_iters: int = 500,
    steps: Tuple[int, ...] = (120000, 160000),
    gamma: float = 0.1,
    bias_lr_factor: float = 2.0,
) -> DetectionSGD:
    """SGD with momentum under WarmupMultiStepLR over ``params``; defaults
    are the X-101 1x recipe (lr 0.01, wd 1e-4, steps 120k/160k), which
    assumes a pretrained backbone: random-init training wants ~10x lower
    lr."""
    return DetectionSGD(params, warmup_multistep_schedule(
        base_lr, warmup_factor, warmup_iters, steps, gamma), momentum,
        weight_decay, bias_lr_factor)


def detection_batch(batch, device) -> Tuple[torch.Tensor, DetectionTargets]:
    """A batch as ``CocoDetectionDataset.batch`` or ``synthetic_batches``
    give it ({"image": (B, H, W, 3), "targets": {boxes, labels, masks,
    valid}}, numpy or tensors) -> the images (B, 3, H, W) float32 and the
    stacked targets on ``device``."""
    t = batch["targets"]
    image = torch.as_tensor(batch["image"], dtype=torch.float32,
                            device=device).permute(0, 3, 1, 2).contiguous()
    return image, DetectionTargets(
        boxes=torch.as_tensor(t["boxes"], dtype=torch.float32, device=device),
        labels=torch.as_tensor(t["labels"], dtype=torch.int64, device=device),
        masks=torch.as_tensor(t["masks"], dtype=torch.float32, device=device),
        valid=torch.as_tensor(t["valid"], dtype=torch.bool, device=device))


def detection_loss(model: MaskRCNN, batch, key: torch.Tensor,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The mean over the batch's images of ``total_loss``, image b drawn
    from ``split(key, B)[b]`` (train.py:166-183). On a ``mesh``, the mean
    over this dp rank's rows of the global batch, each with its row of
    the global split."""
    dev = next(model.parameters()).device
    keys = prng.split(key.to(dev), batch["image"].shape[0])
    if mesh is not None:
        batch, keys = shard_batch((batch, keys), mesh)
    images, tg = detection_batch(batch, dev)
    losses = [total_loss(model, images[b:b + 1],
                         DetectionTargets(*(x[b] for x in tg)), keys[b])
              for b in range(images.shape[0])]
    return torch.stack(losses).mean()


def make_detection_train_step(
        model: MaskRCNN, lr: float = 1e-4,
        opt: Optional[torch.optim.Optimizer] = None,
        mesh: Optional[Mesh] = None,
        params: Optional[Dict[str, torch.Tensor]] = None):
    """(batch, key) -> loss: one optimizer step of ``detection_loss`` over
    ``model``'s trainable state, in place. ``opt`` overrides the default
    Adam (pass ``make_detection_optimizer(params)`` for the reference's
    SGD solver); it must hold ``params``: ``trainable_state(model)``, or on
    a ``mesh`` this rank's shards of it (``shard_params``; made here when
    not given). On a mesh the batch and key are the global ones and the
    loss is the dp mean."""
    whole = trainable_state(model)
    if params is None:
        params = whole if mesh is None else sharded_leaves(whole, mesh)
    opt = opt if opt is not None else make_optimizer(params, lr)

    def step(batch, key) -> torch.Tensor:
        loss = detection_loss(model, batch, key, mesh)
        compute_grads(loss, whole)
        if mesh is None:
            opt.step()
            return loss.detach()
        mesh_update(opt, whole, params, mesh)
        return dp_mean(loss.detach(), mesh)

    return step


def run_detection_training(
    params: Dict[str, torch.Tensor],
    batches,
    device,
    cfg,
    *,
    num_iters: int,
    base_lr: float = 0.01,
    warmup_iters: int = 500,
    lr_steps: Tuple[int, ...] = (120000, 160000),
    checkpoint_period: int = 2500,
    log_period: int = 20,
    output_dir: Optional[str] = None,
    seed: int = 0,
    start_iter: int = 0,
    log_fn: Callable[[str], None] = print,
    mesh: Optional[Mesh] = None,
) -> Dict[str, torch.Tensor]:
    """The reference training loop (engine/trainer.py do_train): the batches
    through the detector's step under the SGD solver, a log line every
    ``log_period`` iterations and at the end (the loss, the median of the
    last 20, the lr, s/it and the ETA), and checkpoints every
    ``checkpoint_period`` and at the end as ``model_<iter>.npz`` /
    ``model_final.npz`` in the JAX package's layout
    (``save_torch_state_dict``), so that either package reads them.

    ``params``: the detector's state dict in torch layout (as
    ``init_maskrcnn_params`` or ``convert.maskrcnn_state_dict_from_numpy``
    give it); ``device``: where to train (None: the card). A sequence of
    batches is cycled; an iterator is read as it comes. Returns the final
    state dict (detached).

    On a ``mesh`` (``device`` is then the mesh's) the batches are the
    global ones; only rank 0 logs, with the global loss, and writes the
    checkpoints, from the tensors ``gather_params`` keeps whole."""
    if mesh is not None:
        device = mesh.device
    model = MaskRCNN(cfg, device=resolve_device(device))
    model.load_state_dict(params, strict=True)
    state = trainable_state(model)
    if mesh is not None:
        state = sharded_leaves(state, mesh)
    opt = make_detection_optimizer(state, base_lr=base_lr,
                                   warmup_iters=warmup_iters, steps=lr_steps)
    step = make_detection_train_step(model, opt=opt, mesh=mesh, params=state)
    lead = mesh is None or mesh.rank == 0
    sched = warmup_multistep_schedule(base_lr, warmup_iters=warmup_iters,
                                      steps=lr_steps)

    if hasattr(batches, "__getitem__"):
        it = itertools.islice(itertools.cycle(batches), num_iters - start_iter)
    else:
        it = itertools.islice(batches, num_iters - start_iter)

    key = prng.PRNGKey(seed)
    window = deque(maxlen=20)
    t0 = time.perf_counter()
    for i, batch in enumerate(it, start=start_iter):
        key, k = prng.split(key)
        loss = step(batch, k)
        window.append(float(loss))
        if lead and ((i + 1) % log_period == 0 or i + 1 == num_iters):
            done = i + 1 - start_iter
            rate = (time.perf_counter() - t0) / max(done, 1)
            eta_s = rate * (num_iters - (i + 1))
            log_fn(f"iter {i + 1}/{num_iters}  loss {float(loss):.4f} "
                   f"(median {float(np.median(window)):.4f})  "
                   f"lr {float(sched(i)):.6f}  "
                   f"{rate:.2f} s/it  eta {eta_s / 60:.1f} min")
        if lead and output_dir and (i + 1) % checkpoint_period == 0:
            save_torch_state_dict(
                os.path.join(output_dir, f"model_{i + 1:07d}"),
                model.state_dict())
    if lead and output_dir:
        save_torch_state_dict(os.path.join(output_dir, "model_final"),
                              model.state_dict())
    return {k: v.detach() for k, v in model.state_dict().items()}
