"""The flow and mask branches of the perception graph — counterparts of
the LiteFlowNet and Mask R-CNN parts of
``vido_slam_tpu/models/perception.py::perception_forward``
(perception.py:75-76,89-109), the stand-ins for the reference's
``FlowNetService`` and ``MaskRcnnService``. Depth is not ported yet."""

from __future__ import annotations

import torch

from vido_slam_tpu_torch.models.liteflownet import LiteFlowNet
from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                       maskrcnn_inference,
                                                       paste_semantic_mask)
from vido_slam_tpu_torch.ops.warp import resize_bilinear
from vido_slam_tpu_torch.utils.device import resolve_device


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


def perception_mask(model: MaskRCNN, cur_bgr, device=None) -> torch.Tensor:
    """Semantic mask (H, W) uint8 of one (H, W, 3) BGR frame in 0..255 (a
    tensor or array), on ``device`` (the card unless the caller asks for
    the CPU), where ``model`` must lie: RGB kept at raw 0..255 values
    (predictor.py:283-286 of the reference), resized bilinearly to the
    model's input size, the detector, and the detections pasted back at
    (H, W) (perception.py:97-109)."""
    dev = resolve_device(device)
    if next(model.parameters()).device.type != dev.type:
        raise ValueError(f"perception_mask: the model is not on {dev}")
    cfg = model.cfg
    frame = torch.as_tensor(cur_bgr, dtype=torch.float32, device=dev)
    height, width = frame.shape[0], frame.shape[1]
    x = resize_bilinear(frame.flip(-1).permute(2, 0, 1)[None], cfg.input_h,
                        cfg.input_w).contiguous()
    det = maskrcnn_inference(model, x)
    return paste_semantic_mask(det, cfg.input_h, cfg.input_w, height, width,
                               cfg.mask_threshold)
