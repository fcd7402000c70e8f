"""The perception graph — counterpart of
``vido_slam_tpu/models/perception.py``: the three ROS GPU services of the
reference (MonoDepthService, FlowNetService, MaskRcnnService; SURVEY §3.2)
as three branches on one device, from raw BGR frames to the SLAM inputs.

Service-parity outputs:
  depth: min-max normalised inverse depth in [0, 65536] at the camera's
         size (run_mono_depth.py:137-146);
  flow:  (H, W, 2) float32 flow at the camera's size (run_flow_net.py:85-107);
  mask:  (H, W) uint8 semantic mask, the sum of instance mask times label
         index (run_mask_rcnn.py:83-127).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vido_slam_tpu_torch.geometry.camera import convert_depth
from vido_slam_tpu_torch.models.layers import net_dtype
from vido_slam_tpu_torch.models.liteflownet import LiteFlowNet
from vido_slam_tpu_torch.models.maskrcnn.model import (RESNET50_FPN,
                                                       MaskRCNN,
                                                       MaskRCNNConfig,
                                                       maskrcnn_inference,
                                                       paste_semantic_mask)
from vido_slam_tpu_torch.models.monodepth2 import (FEED_HEIGHT, FEED_WIDTH,
                                                   MonoDepth2,
                                                   disp_to_uint16_depth,
                                                   monodepth2_disp)
from vido_slam_tpu_torch.ops.warp import resize_bilinear
from vido_slam_tpu_torch.utils.device import resolve_device


def ceil32(v: int) -> int:
    return -(-v // 32) * 32


def _rgb01(bgr: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) BGR in 0..255 -> (1, 3, H, W) RGB in [0, 1]."""
    return bgr.flip(-1).permute(2, 0, 1)[None] / 255.0


def perception_depth(net: MonoDepth2, cur_bgr: torch.Tensor) -> torch.Tensor:
    """Depth (H, W) in [0, 65536] of one (H, W, 3) float32 BGR frame in
    0..255 on the net's device: RGB in [0, 1] resized to the net's
    640x192 feed, the disparity, and its min-max uint16 form at (H, W)
    (perception.py:78-85), the disparity taken to float32 first whatever
    the net's dtype."""
    height, width = cur_bgr.shape[0], cur_bgr.shape[1]
    x = resize_bilinear(_rgb01(cur_bgr), FEED_HEIGHT, FEED_WIDTH)
    disp = monodepth2_disp(net, x.contiguous()).float()
    return disp_to_uint16_depth(disp, height, width)[0]


def perception_flow(net: LiteFlowNet, prev_bgr: torch.Tensor,
                    cur_bgr: torch.Tensor) -> torch.Tensor:
    """Flow (H, W, 2) from prev to cur, two (H, W, 3) float32 BGR frames in
    0..255 on the net's device: RGB in [0, 1], resized to the next
    multiples of 32, the net, and its half-size flow resized back to
    (H, W) and scaled by width / padded width and height / padded height."""
    height, width = prev_bgr.shape[0], prev_bgr.shape[1]
    ph, pw = ceil32(height), ceil32(width)
    net_flow = net(resize_bilinear(_rgb01(prev_bgr), ph, pw),
                   resize_bilinear(_rgb01(cur_bgr), ph, pw))
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
    (H, W) (perception.py:97-109), every floating field taken to float32
    first whatever the detector's dtype."""
    dev = resolve_device(device)
    if next(model.parameters()).device.type != dev.type:
        raise ValueError(f"perception_mask: the model is not on {dev}")
    cfg = model.cfg
    frame = torch.as_tensor(cur_bgr, dtype=torch.float32, device=dev)
    height, width = frame.shape[0], frame.shape[1]
    x = resize_bilinear(frame.flip(-1).permute(2, 0, 1)[None], cfg.input_h,
                        cfg.input_w).contiguous()
    det = maskrcnn_inference(model, x)
    det = det._replace(**{k: v.float() for k, v in det._asdict().items()
                          if v.is_floating_point()})
    return paste_semantic_mask(det, cfg.input_h, cfg.input_w, height, width,
                               cfg.mask_threshold)


class PerceptionOutput(NamedTuple):
    depth_u16: torch.Tensor  # (H, W) float32 in [0, 65536] (service mono16)
    flow: torch.Tensor       # (H, W, 2)
    mask: torch.Tensor       # (H, W) uint8 semantic labels


def perception_forward(depth_net: MonoDepth2, flow_net: LiteFlowNet,
                       mask_model: MaskRCNN, prev_bgr: torch.Tensor,
                       cur_bgr: torch.Tensor) -> PerceptionOutput:
    """The three branches in the JAX package's order (perception.py:62-110)
    on two (H, W, 3) float32 BGR frames in 0..255 on the nets' device:
    depth of the current frame, flow from prev to cur, the current frame's
    semantic mask."""
    depth_u16 = perception_depth(depth_net, cur_bgr)
    flow = perception_flow(flow_net, prev_bgr, cur_bgr)
    mask = perception_mask(mask_model, cur_bgr, device=cur_bgr.device)
    return PerceptionOutput(depth_u16=depth_u16, flow=flow, mask=mask)


class PerceptionModel:
    """The three networks on one device (the card unless the caller asks
    for the CPU), each from ``seed`` unless its state dict is given (torch
    layout; the JAX dicts through ``convert.perception_model_from_numpy``,
    bundles on disk through ``from_pretrained``).

    ``use_pallas`` is accepted for the JAX signature: on the card the CUDA
    kernels run either way. The dtype options are the JAX package's
    (perception.py:126-175): ``compute_dtype`` casts the depth net and the
    detector, ``mask_dtype`` the detector only (after ``compute_dtype``),
    ``flow_dtype`` LiteFlowNet only; None keeps float32 (TF32 off), and
    ``torch.bfloat16`` is the other dtype the networks and kernels 3, 4
    and 5 take. A net cast to bf16 computes in bf16 where JAX does, with
    the same places pinned to float32 (the warp coordinates, LiteFlowNet's
    flow mean and output, GroupNorm statistics, the RPN and box decoding,
    the disparity and the detections before the paste). A deformable
    detector (``RESNEXT101_FPN_DCN``) in bf16 computes each deformable 3x3
    and the norm and relu after it in float32, as JAX promotes there, and
    the rest of the detector in bf16 (``ops/deform_conv.py``)."""

    def __init__(self, height: int, width: int,
                 mask_cfg: MaskRCNNConfig = RESNET50_FPN, seed: int = 0,
                 depth_state: Optional[dict] = None,
                 flow_state: Optional[dict] = None,
                 mask_state: Optional[dict] = None, use_pallas: bool = True,
                 compute_dtype=None, mask_dtype=None, flow_dtype=None,
                 device=None):
        compute_dtype, mask_dtype, flow_dtype = (
            net_dtype(d, f"PerceptionModel {name}") for d, name in (
                (compute_dtype, "compute_dtype"), (mask_dtype, "mask_dtype"),
                (flow_dtype, "flow_dtype")))
        self.height = height
        self.width = width
        self.mask_cfg = mask_cfg
        self.use_pallas = use_pallas
        self.device = resolve_device(device)
        self.depth_net = MonoDepth2(seed, device=self.device)
        self.flow_net = LiteFlowNet(seed, device=self.device)
        self.mask_model = MaskRCNN(mask_cfg, seed, device=self.device)
        for net, state in ((self.depth_net, depth_state),
                           (self.flow_net, flow_state),
                           (self.mask_model, mask_state)):
            if state is not None:
                net.load_state_dict(state, strict=True)
        for net, dtype in ((self.depth_net, compute_dtype),
                           (self.mask_model, mask_dtype or compute_dtype),
                           (self.flow_net, flow_dtype)):
            if dtype is not None:
                net.to(dtype)

    @classmethod
    def from_pretrained(cls, weights_dir: str, height: int, width: int,
                        mask_cfg: MaskRCNNConfig = RESNET50_FPN, **kw):
        """Build from a directory of ``depth``, ``flow`` and ``mask``
        bundles in the JAX package's layout (``tools/convert_weights.py``'s
        output as ``.npz``; ``utils/checkpoint.py``), loaded with
        ``strict=True``: a bundle whose keys or shapes do not fit its net
        raises, naming them. A missing bundle keeps that net's seeded
        init. ``kw`` goes to the constructor (``seed``, ``device``,
        ``use_pallas`` and the dtype options, which cast the loaded
        weights as they cast the seeded ones)."""
        import os

        from vido_slam_tpu_torch import convert
        from vido_slam_tpu_torch.utils.checkpoint import load_params

        def maybe(name):
            base = os.path.join(weights_dir, name)
            if os.path.exists(base + ".npz") or os.path.exists(base):
                return {k: v.numpy() for k, v in load_params(base).items()}
            return None

        dev = resolve_device(kw.pop("device", None))
        depth, flow, mask = maybe("depth"), maybe("flow"), maybe("mask")
        return cls(
            height, width, mask_cfg, device=dev,
            depth_state=None if depth is None else
            convert.monodepth2_state_dict_from_numpy(depth, dev),
            flow_state=None if flow is None else
            convert.liteflownet_state_dict_from_numpy(flow),
            mask_state=None if mask is None else
            convert.maskrcnn_state_dict_from_numpy(mask, dev), **kw)

    def _frame(self, bgr) -> torch.Tensor:
        return torch.as_tensor(bgr, dtype=torch.float32, device=self.device)

    def __call__(self, prev_bgr, cur_bgr) -> PerceptionOutput:
        """Two (H, W, 3) BGR frames in 0..255 (tensors or arrays)."""
        return perception_forward(self.depth_net, self.flow_net,
                                  self.mask_model, self._frame(prev_bgr),
                                  self._frame(cur_bgr))

    def make_slam_forward(self, depth_mode: str, depth_map_factor: float,
                          bf: float, scale: float = 1.0):
        """A function of (prev_bgr, cur_bgr) giving the SLAM inputs: metric
        depth (``convert_depth`` of the uint16 depth), the flow and the
        int32 mask (perception.py:229-246)."""
        def forward(prev_bgr, cur_bgr):
            out = self(prev_bgr, cur_bgr)
            depth = convert_depth(out.depth_u16, depth_mode,
                                  depth_map_factor, bf, scale=scale)
            return depth, out.flow, out.mask.to(torch.int32)
        return forward
