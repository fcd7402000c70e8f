"""NCHW building blocks of the port's networks with the semantics of
``vido_slam_tpu/models/layers.py``. Convolutions are ``torch.nn.Conv2d``;
what needs a rule of its own is here."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


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
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.eps)


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
    return F.conv_transpose2d(x, w, stride=stride, padding=padding,
                              groups=x.shape[1])


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
