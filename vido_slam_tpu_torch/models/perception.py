"""The flow branch of the perception graph — counterpart of the LiteFlowNet
part of ``vido_slam_tpu/models/perception.py::perception_forward``
(perception.py:75-76,89-95), the stand-in for the reference's
``FlowNetService``. Depth and Mask R-CNN are not ported yet."""

from __future__ import annotations

import torch

from vido_slam_tpu_torch.models.liteflownet import LiteFlowNet
from vido_slam_tpu_torch.ops.warp import resize_bilinear


def ceil32(v: int) -> int:
    return -(-v // 32) * 32


def perception_flow(net: LiteFlowNet, prev_bgr: torch.Tensor,
                    cur_bgr: torch.Tensor) -> torch.Tensor:
    """Flow (H, W, 2) from prev to cur, two (H, W, 3) float32 BGR frames in
    0..255 on the net's device: RGB in [0, 1], resized to the next
    multiples of 32, the net, and its half-size flow resized back to
    (H, W) and scaled by width / padded width and height / padded height."""
    height, width = prev_bgr.shape[0], prev_bgr.shape[1]
    ph, pw = ceil32(height), ceil32(width)

    def rgb(bgr):
        x = bgr.flip(-1).permute(2, 0, 1)[None] / 255.0
        return resize_bilinear(x, ph, pw)

    net_flow = net(rgb(prev_bgr), rgb(cur_bgr))
    flow = resize_bilinear(net_flow, height, width)[0]
    scale = torch.tensor([width / pw, height / ph], dtype=flow.dtype,
                         device=flow.device)
    return (flow * scale.view(2, 1, 1)).permute(1, 2, 0)
