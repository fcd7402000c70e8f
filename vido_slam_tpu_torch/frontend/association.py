"""Mask repair — Tracking::UpdateMask (Tracking.cc:3291-3529); counterpart of
``vido_slam_tpu/frontend/association.py``.

A semantic value with >= 100 px in the previous mask and none in the current
one is forward-warped through the previous flow and stamped where the
current mask is background."""

from __future__ import annotations

import torch

from vido_slam_tpu_torch.frontend.objects import MAX_SEM
from vido_slam_tpu_torch.utils.order import top_k

MIN_RECOVER_PX = 100  # Tracking.cc:3325
MAX_WARP_PX = 16384   # source-pixel budget of the recovery warp per frame


def update_mask(cur_mask: torch.Tensor, last_mask: torch.Tensor,
                last_flow: torch.Tensor) -> torch.Tensor:
    """Returns the repaired current mask (H, W) int32."""
    H, W = cur_mask.shape
    dev = cur_mask.device
    last_c = torch.clamp(last_mask, 0, MAX_SEM - 1).to(torch.int64)
    cur_c = torch.clamp(cur_mask, 0, MAX_SEM - 1).to(torch.int64)
    last_count = torch.bincount(last_c.reshape(-1), minlength=MAX_SEM)
    cur_count = torch.bincount(cur_c.reshape(-1), minlength=MAX_SEM)
    recover = (last_count >= MIN_RECOVER_PX) & (cur_count == 0)
    recover[0] = False
    # the warp is the rare path: one host check keeps it off the common one
    if not bool(recover.any()):
        return cur_mask

    vv, uu = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    tx = torch.round(uu + last_flow[..., 0]).to(torch.int64)
    ty = torch.round(vv + last_flow[..., 1]).to(torch.int64)
    src_val = torch.where(recover[last_c], last_c, torch.zeros_like(last_c))
    in_b = (tx >= 0) & (tx < W) & (ty >= 0) & (ty < H) & (src_val > 0)
    # (target position, label) packed into one integer: the top-k both
    # compacts the flagged pixels and carries the payload
    packed = torch.where(in_b, ((ty * W + tx) << 8) | src_val,
                         torch.zeros_like(src_val))
    vals, _ = top_k(packed.reshape(-1), min(MAX_WARP_PX, H * W))
    ok = vals > 0
    val_k = torch.where(ok, vals & 0xFF, torch.zeros_like(vals))
    pos = torch.where(ok, vals >> 8, torch.zeros_like(vals))
    # scatter-max: duplicates resolve to the largest label, on any device
    warped = torch.zeros(H * W, dtype=torch.int64, device=dev)
    warped.scatter_reduce_(0, pos, val_k, reduce="amax")
    warped = warped.reshape(H, W).to(cur_mask.dtype)
    return torch.where((cur_mask == 0) & (warped > 0), warped, cur_mask)
