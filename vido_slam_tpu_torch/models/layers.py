"""NCHW building blocks of the port's networks with the semantics of
``vido_slam_tpu/models/layers.py``. Convolutions are ``torch.nn.Conv2d``;
what needs a rule of its own is here."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


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
