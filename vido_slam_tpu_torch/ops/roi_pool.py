"""ROIPool (hard max pooling) in NCHW — counterpart of
``vido_slam_tpu/ops/roi_pool.py`` (maskrcnn_benchmark's ROIPool, the pooler
of non-FPN C4 configs).

Semantics, as the JAX package computes them: a ROI's corners are scaled by
``spatial_scale`` and rounded half to even (``jnp.round``; ``torch.round``
does the same, where the reference's CUDA ``round`` takes halves away from
zero); its extent is end - start + 1, at least 1; bin p of an axis maxes
over the integer pixels [start + floor(p ext / res), start + ceil((p + 1)
ext / res)), clamped to the map, with the floors and ceilings in exact
integer arithmetic; an empty bin gives 0.

The bins are intervals, so the bin max is separable: a masked max over the
rows, then over the columns. ROIs go ``CHUNK_BYTES`` of (n, res, C, H, W)
intermediate at a time (the JAX package maps them one by one). Plain
PyTorch on every device: max is exact, so the card and the CPU give the
same bits.
"""

from __future__ import annotations

import torch

CHUNK_BYTES = 1 << 28   # the masked row max's intermediate, at most


def _interval_mask(start: torch.Tensor, size: int, res: int,
                   extent: torch.Tensor) -> torch.Tensor:
    """(R, res, size) bool: pixel i lies in bin p of its ROI."""
    p = torch.arange(res, dtype=torch.int32, device=start.device)
    ext = extent.to(torch.int32)[:, None]
    s = start.to(torch.int32)[:, None]
    lo = torch.clamp(s + torch.div(p * ext, res, rounding_mode="floor"),
                     0, size)
    hi = torch.clamp(s - torch.div(-(p + 1) * ext, res, rounding_mode="floor"),
                     0, size)
    i = torch.arange(size, dtype=torch.int32, device=start.device)
    return (i >= lo[..., None]) & (i < hi[..., None])


def roi_pool(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
             resolution: int = 7) -> torch.Tensor:
    """(R, C, res, res) hard-max pooled features of one image's map feat
    (1, C, H, W) over rois (R, 4) xyxy in input-image coordinates."""
    if feat.ndim != 4 or feat.shape[0] != 1:
        raise ValueError(f"roi_pool: feat must be (1, C, H, W), got "
                         f"{tuple(feat.shape)}")
    if rois.ndim != 2 or rois.shape[1] != 4 or rois.device != feat.device:
        raise ValueError("roi_pool: rois must be (R, 4) on the map's device")
    _, C, H, W = feat.shape
    f = feat[0].float()
    r = resolution
    corners = torch.round(rois.float() * spatial_scale)
    x0, y0, x1, y1 = corners.unbind(1)
    rw = torch.clamp(x1 - x0 + 1, min=1.0)
    rh = torch.clamp(y1 - y0 + 1, min=1.0)
    my = _interval_mask(y0, H, r, rh)                  # (R, r, H)
    mx = _interval_mask(x0, W, r, rw)                  # (R, r, W)
    R = rois.shape[0]
    out = f.new_empty((R, C, r, r))
    step = max(1, CHUNK_BYTES // (4 * r * C * H * W))
    neg = f.new_full((), -float("inf"))
    for a in range(0, R, step):
        b = min(a + step, R)
        # rows: (n, r, 1, H, 1) over (C, H, W) -> (n, r, C, W)
        t = torch.where(my[a:b, :, None, :, None], f, neg).amax(3)
        # columns: (n, 1, 1, r', W) over (n, r, C, 1, W) -> (n, r, C, r')
        o = torch.where(mx[a:b, None, None], t[:, :, :, None, :],
                        neg).amax(4)
        out[a:b] = o.permute(0, 2, 1, 3)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
