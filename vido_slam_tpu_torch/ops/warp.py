"""Bilinear sampling, backward warping and resizing in NCHW — counterpart of
``vido_slam_tpu/ops/warp.py``.

The sample coordinates are float pixel coordinates, as in the JAX package,
rather than ``F.grid_sample``'s normalised grid: the four corners are
gathered and weighted exactly as ``grid_sample_nhwc`` weights them, which
keeps the two packages within float32 rounding of each other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """Sample img (N, C, H, W) at float pixel coordinates x, y (N, H', W'):
    bilinear, zeros outside the image (torch ``grid_sample`` with zeros
    padding). Returns (N, C, H', W')."""
    N, C, H, W = img.shape
    Hp, Wp = x.shape[1], x.shape[2]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).reshape(N, 1, Hp * Wp)
    fy = (y - y0).reshape(N, 1, Hp * Wp)
    x0i = x0.to(torch.int64).reshape(N, 1, Hp * Wp)
    y0i = y0.to(torch.int64).reshape(N, 1, Hp * Wp)
    flat = img.reshape(N, C, H * W)

    def corner(xi, yi):
        inb = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).to(img.dtype)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return torch.gather(flat, 2, idx.expand(N, C, Hp * Wp)) * inb

    v00 = corner(x0i, y0i)
    v01 = corner(x0i + 1, y0i)
    v10 = corner(x0i, y0i + 1)
    v11 = corner(x0i + 1, y0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return (top * (1 - fy) + bot * fy).reshape(N, C, Hp, Wp)


def backwarp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp x (N, C, H, W) backward by flow (N, 2, H, W) [fx, fy]: the
    reference's normalised-grid backwarp, which displaces by f * W/(W-1)
    and f * H/(H-1) pixels. The sample coordinates and the interpolation
    are float32 whatever x's dtype, and the result is in x's dtype, so a
    bf16 net stays bf16 through its warps (warp.py:76-81)."""
    N, _, H, W = flow.shape
    ii = torch.arange(W, dtype=torch.float32, device=flow.device)
    jj = torch.arange(H, dtype=torch.float32, device=flow.device)
    sx = ii[None, None, :] + flow[:, 0].float() * (W / (W - 1.0))
    sy = jj[None, :, None] + flow[:, 1].float() * (H / (H - 1.0))
    return grid_sample(x, sx, sy).to(x.dtype)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NCHW bilinear resize equal to ``jax.image.resize(method="bilinear")``:
    half-pixel centres, and an antialiasing (triangle) filter along a side
    that shrinks, which ``F.interpolate`` applies only with
    ``antialias=True``. A bf16 image is resized in float32 and rounded
    back once."""
    shrinks = height < x.shape[2] or width < x.shape[3]
    return F.interpolate(x.float(), size=(height, width), mode="bilinear",
                         align_corners=False, antialias=shrinks).to(x.dtype)
