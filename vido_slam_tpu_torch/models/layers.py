"""NCHW building blocks of the port's networks with the semantics of
``vido_slam_tpu/models/layers.py``. What needs a rule of its own is here.

The networks run in their parameters' dtype, float32 or bfloat16 (the
perception options ``compute_dtype``, ``mask_dtype``, ``flow_dtype``): as
in the JAX package (layers.py:40-43), an activation that reaches a
convolution or a linear layer in another dtype is cast to its weights'
dtype there (``Conv2d``, ``ConvTranspose2d``, ``Linear``,
``deconv_grouped``), and GroupNorm takes its statistics in float32."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


NET_DTYPES = (torch.float32, torch.bfloat16)


def net_dtype(dtype, what: str):
    """``dtype`` checked as a network's compute dtype: None (float32),
    float32 or bfloat16; anything else raises."""
    if dtype is None or dtype in NET_DTYPES:
        return dtype
    raise TypeError(f"{what}: the networks run in float32 or bfloat16, not "
                    f"{dtype}")


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose input follows its weights' dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose input follows its weights' dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class Linear(nn.Linear):
    """``nn.Linear`` whose input follows its weights' dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


def relu(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's relu, ``jnp.maximum(x, 0)`` (layers.py:187-188):
    the value of ``F.relu``, but a gradient of one half at exactly 0, where
    both frameworks split a tie of ``maximum`` (``F.relu``'s is 0). An
    all-zero pooled ROI meets that tie in the box head, so the trainers'
    gradients follow JAX's only with this relu."""
    return torch.maximum(x, x.new_zeros(()))


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


class BatchNorm2d(nn.Module):
    """``torch.nn.BatchNorm2d`` in eval mode with the JAX package's
    rounding (layers.py:138-147): ``x * inv + (beta - mean * inv)`` with
    ``inv = gamma * rsqrt(var + eps)``. Its buffers are exactly the four
    checkpoint keys (``nn.BatchNorm2d`` adds ``num_batches_tracked``, which
    a strict load of the JAX dict would miss)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


class FrozenBatchNorm2d(BatchNorm2d):
    """maskrcnn_benchmark's FrozenBatchNorm2d (layers/batch_norm.py): fixed
    statistics, scale = weight * rsqrt(running_var) with **no** epsilon
    (backbone.py:50-59: 1e-5 would break checkpoint parity on channels of
    small variance). Its buffers carry the checkpoint's four keys."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=0.0)


class GroupNorm(nn.Module):
    """``torch.nn.GroupNorm(num_groups, C, eps, affine=True)``, the
    counterpart of the JAX package's ``layers.group_norm``
    (layers.py:150-170): per sample and group of C / G consecutive
    channels, normalised over (C / G, H, W). maskrcnn_benchmark's GN
    checkpoints use 32 groups and eps 1e-5. Its state is ``weight`` and
    ``bias`` as buffers, like the other norms here: no running
    statistics."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return F.group_norm(x, self.num_groups, self.weight, self.bias,
                                self.eps)
        # statistics and normalisation in float32, the affine in x's dtype
        xn = F.group_norm(x.float(), self.num_groups, eps=self.eps)
        return xn.to(x.dtype) * self.weight.view(1, -1, 1, 1) \
            + self.bias.view(1, -1, 1, 1)


def max_pool(x: torch.Tensor, k: int = 3, stride: int = 2,
             padding: int = 1) -> torch.Tensor:
    """Max pooling whose padding never wins (the JAX package pads with
    -inf, layers.py:172-180), which is ``F.max_pool2d``'s rule."""
    return F.max_pool2d(x, k, stride, padding)


def deconv_grouped(x: torch.Tensor, w: torch.Tensor, stride: int = 2,
                   padding: int = 1) -> torch.Tensor:
    """``torch.nn.ConvTranspose2d(C, C, k, stride, padding, groups=C,
    bias=False)`` with its (C, 1, k, k) weight. The JAX package flips the
    kernel only because it writes the transpose as a dilated correlation."""
    return F.conv_transpose2d(x.to(w.dtype), w, stride=stride,
                              padding=padding, groups=x.shape[1])


def unfold_channels(x: torch.Tensor, k: int) -> torch.Tensor:
    """``F.unfold`` of a one-channel (N, 1, H, W) map, as (N, k*k, H, W):
    channel dy*k+dx holds x[y+dy-r, x+dx-r], zero padded, r = (k-1)//2."""
    if x.shape[1] != 1:
        raise ValueError(f"unfold_channels: one channel expected, got "
                         f"{x.shape[1]}")
    r = (k - 1) // 2
    H, W = x.shape[2], x.shape[3]
    xp = F.pad(x[:, 0], (r, r, r, r))
    return torch.stack([xp[:, dy:dy + H, dx:dx + W]
                        for dy in range(k) for dx in range(k)], 1)
