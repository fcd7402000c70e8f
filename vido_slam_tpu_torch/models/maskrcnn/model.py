"""Mask R-CNN inference in NCHW — counterpart of
``vido_slam_tpu/models/maskrcnn/model.py`` (maskrcnn_benchmark's
GeneralizedRCNN plus the ROS wrapper's post-processing,
run_mask_rcnn.py:75-127 and predictor.py:267-321 of the reference):

  image -> backbone + FPN -> RPN proposals -> box head -> detections
        -> mask head -> pasted masks -> semantic mask = sum(mask * label)

Every stage has a fixed shape: 1000 proposals, 100 detections, validity
masks throughout. ``MaskRCNN``'s ``state_dict()`` keys equal
maskrcnn_benchmark's names and the JAX parameter dict's, so either loads
with ``load_state_dict(strict=True)`` (the JAX dict through
``convert.maskrcnn_state_dict_from_numpy``), and a Detectron caffe2
checkpoint through ``MaskRCNN.load_c2``. Inference only, float32.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
import torch.nn as nn

from vido_slam_tpu_torch.models.maskrcnn.backbone import (
    Backbone, ResNetConfig, init_resnet_fpn_params)
from vido_slam_tpu_torch.models.maskrcnn.roi_heads import (
    NUM_CLASSES, BoxHead, MaskHead, box_head_forward, mask_head_forward,
    postprocess_detections)
from vido_slam_tpu_torch.models.maskrcnn.rpn import (
    ANCHOR_SIZES, ANCHOR_STRIDES, RPNHead, generate_cell_anchors,
    grid_anchors, level_candidates, nms_levels, rpn_head_concat,
    select_over_all_levels)
from vido_slam_tpu_torch.utils.device import resolve_device


class MaskRCNNConfig(NamedTuple):
    resnet: ResNetConfig = ResNetConfig()
    input_h: int = 1088
    input_w: int = 800
    confidence_threshold: float = 0.8   # run_mask_rcnn.py:42
    mask_threshold: float = 0.5
    # the RPN head over all levels in one pass (rpn_head_concat); the JAX
    # package reads this from VIDO_RPN_CONCAT at trace time
    rpn_concat: bool = False


RESNET50_FPN = MaskRCNNConfig()
# the reference ROS node's X-101-32x8d FPN
RESNEXT101_FPN = MaskRCNNConfig(resnet=ResNetConfig(
    stage_blocks=(3, 4, 23, 3), num_groups=32, width_per_group=8,
    stride_in_1x1=False))
# its deformable variant (STAGE_WITH_DCN): modulated deformable 3x3s in
# stages 3-5, as the DCN model-zoo checkpoints have them
RESNEXT101_FPN_DCN = MaskRCNNConfig(resnet=RESNEXT101_FPN.resnet._replace(
    stage_with_dcn=(False, True, True, True), with_modulated_dcn=True))


class MaskRCNNOutput(NamedTuple):
    boxes: torch.Tensor      # (D, 4) in input-image coordinates
    scores: torch.Tensor     # (D,)
    labels: torch.Tensor     # (D,)
    valid: torch.Tensor      # (D,) bool
    masks28: torch.Tensor    # (D, 28, 28) sigmoid masks


class MaskRCNN(nn.Module):
    """The detector of ``cfg`` with its parameters from
    ``init_maskrcnn_params`` of ``seed``, on ``device`` (the card unless the
    caller asks for the CPU). Load other parameters with
    ``load_state_dict``."""

    def __init__(self, cfg: MaskRCNNConfig = RESNET50_FPN, seed: int = 0,
                 device=None):
        super().__init__()
        self.cfg = cfg
        C = cfg.resnet.out_channels
        # built without storage (no default init, no draw from torch's
        # global generator), then given the seeded parameters
        with torch.device("meta"):
            self.backbone = Backbone(cfg.resnet)
            self.rpn = nn.Module()
            self.rpn.head = RPNHead(C, len(generate_cell_anchors(4, 32)))
            self.roi_heads = nn.Module()
            self.roi_heads.box = BoxHead(C)
            self.roi_heads.mask = MaskHead(C)
        self.load_state_dict(init_maskrcnn_params(
            torch.Generator().manual_seed(seed), cfg), assign=True)
        self.to(resolve_device(device))
        self._anchors: Dict[tuple, torch.Tensor] = {}

    def load_c2(self, path_or_blobs, conv_body: str):
        """Load a Detectron caffe2 checkpoint (a pickle's path, or its blob
        dict) through ``c2_loading``: translate the blob names for
        ``conv_body`` ("R-50-FPN", "R-101-FPN"; X-101-32x8d rides R-101),
        align them onto this model's keys and load the result strictly.
        A DCN model's deformable 3x3s take the ``conv2`` blobs; its offset
        convs have none. Returns (filled, unmatched) as the JAX loader
        gives them: model keys that kept this model's values (the offset
        convs), and blobs that fit no key."""
        from vido_slam_tpu_torch.models.maskrcnn import c2_loading

        blobs = (c2_loading.load_c2_pickle(path_or_blobs)
                 if isinstance(path_or_blobs, str) else path_or_blobs)
        state = c2_loading.translate_c2_blobs(
            blobs, conv_body, stage_with_dcn=self.cfg.resnet.stage_with_dcn)
        current = {k: v.detach().cpu() for k, v in self.state_dict().items()}
        aligned, filled, unmatched = c2_loading.align_c2_to_model(state,
                                                                  current)
        self.load_state_dict(aligned, strict=True)
        return filled, unmatched

    def anchors(self, level: int, height: int, width: int,
                device: torch.device) -> torch.Tensor:
        """(H*W*A, 4) float32 anchors of a pyramid level, made once per
        level, size and device."""
        key = (level, height, width, device)
        if key not in self._anchors:
            stride = ANCHOR_STRIDES[level]
            cell = generate_cell_anchors(stride, ANCHOR_SIZES[level])
            self._anchors[key] = torch.from_numpy(
                grid_anchors(height, width, stride, cell)).to(device)
        return self._anchors[key]

    def forward(self, image: torch.Tensor) -> MaskRCNNOutput:
        return maskrcnn_inference(self, image)


def rpn_proposals(model: MaskRCNN, feats: List[torch.Tensor]):
    """P2..P6 -> the 1000 proposals over all levels (boxes, scores,
    valid): each level's candidates, one NMS batched over the levels (each
    level's ``select_proposals_level``), the global top 1000."""
    H, W = model.cfg.input_h, model.cfg.input_w
    heads = (rpn_head_concat(model.rpn.head, feats) if model.cfg.rpn_concat
             else [model.rpn.head(f) for f in feats])
    per_level = []
    for li, (f, (logits, deltas)) in enumerate(zip(feats, heads)):
        anchors = model.anchors(li, f.shape[2], f.shape[3], f.device)
        per_level.append(level_candidates(logits, deltas, anchors, H, W))
    boxes, scores, valid = nms_levels(*(torch.stack(x)
                                        for x in zip(*per_level)))
    return select_over_all_levels(boxes.unbind(), scores.unbind(),
                                  valid.unbind())


@torch.no_grad()
def maskrcnn_inference(model: MaskRCNN,
                       image: torch.Tensor) -> MaskRCNNOutput:
    """image (1, 3, input_h, input_w) float32, preprocessed -> detections
    and masks (model.py:84-125)."""
    cfg = model.cfg
    if tuple(image.shape) != (1, 3, cfg.input_h, cfg.input_w):
        raise ValueError(f"maskrcnn_inference: image {tuple(image.shape)}, "
                         f"expected (1, 3, {cfg.input_h}, {cfg.input_w})")
    feats = model.backbone(image)                       # P2..P6
    proposals, _, pvalid = rpn_proposals(model, feats)
    p2_p5 = feats[:4]
    logits, deltas = box_head_forward(model.roi_heads.box, p2_p5, proposals)
    det = postprocess_detections(logits, deltas, proposals, pvalid,
                                 cfg.input_h, cfg.input_w)
    det = det._replace(valid=det.valid
                       & (det.scores > cfg.confidence_threshold))
    masks = mask_head_forward(model.roi_heads.mask, p2_p5, det)
    return MaskRCNNOutput(boxes=det.boxes, scores=det.scores,
                          labels=det.labels, valid=det.valid, masks28=masks)


PASTE_CHUNK = 10   # detections resampled together by the paste


def paste_semantic_mask(out: MaskRCNNOutput, in_h: int, in_w: int,
                        out_h: int, out_w: int,
                        mask_threshold: float = 0.5) -> torch.Tensor:
    """Semantic mask (out_h, out_w) uint8: the sum over valid detections of
    (pasted mask > threshold) * label, wrapping around at 256 as the
    reference's numpy += loop does (model.py:128-206). Boxes scale from the
    model input to the output size; each 28x28 mask is padded by 1 to
    30x30, its box expanded by 30/28 about the centre, resampled
    bilinearly over the box (separable, clamped to the padded mask) and
    thresholded; PASTE_CHUNK detections at a time."""
    dev = out.boxes.device
    sx, sy = out_w / in_w, out_h / in_h
    boxes = out.boxes * torch.tensor([sx, sy, sx, sy], dtype=torch.float32,
                                     device=dev)
    x0, y0, x1, y1 = boxes.unbind(-1)
    cx, cy = (x0 + x1) * 0.5, (y0 + y1) * 0.5
    hw = (x1 - x0) * 0.5 * (30.0 / 28.0)
    hh = (y1 - y0) * 0.5 * (30.0 / 28.0)
    ex0, ex1, ey0, ey1 = cx - hw, cx + hw, cy - hh, cy + hh
    masks = torch.nn.functional.pad(out.masks28, (1, 1, 1, 1))  # (D, 30, 30)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    ks = torch.arange(30, dtype=torch.float32, device=dev)
    acc = torch.zeros((out_h, out_w), dtype=torch.int32, device=dev)
    for a in range(0, masks.shape[0], PASTE_CHUNK):
        sl = slice(a, a + PASTE_CHUNK)
        bx0, bx1, by0, by1 = ex0[sl], ex1[sl], ey0[sl], ey1[sl]
        w = torch.clamp(bx1 - bx0 + 1, min=1.0)
        h = torch.clamp(by1 - by0 + 1, min=1.0)
        u = torch.clamp((xs[None, :] - bx0[:, None] + 0.5) / w[:, None] * 30.0
                        - 0.5, 0.0, 29.0)
        v = torch.clamp((ys[None, :] - by0[:, None] + 0.5) / h[:, None] * 30.0
                        - 0.5, 0.0, 29.0)
        Rx = torch.clamp(1.0 - (u[:, :, None] - ks).abs(), min=0.0)
        Ry = torch.clamp(1.0 - (v[:, :, None] - ks).abs(), min=0.0)
        val = Ry @ masks[sl] @ Rx.transpose(1, 2)              # (c, H, W)
        row_in = (ys[None, :] >= by0[:, None]) & (ys[None, :] <= by1[:, None])
        col_in = (xs[None, :] >= bx0[:, None]) & (xs[None, :] <= bx1[:, None])
        binary = (val > mask_threshold) & row_in[:, :, None] \
            & col_in[:, None, :] & out.valid[sl, None, None]
        acc += (binary.to(torch.int32)
                * out.labels[sl, None, None].to(torch.int32)).sum(0,
                                                                  dtype=torch.int32)
    return (acc % 256).to(torch.uint8)


def init_maskrcnn_params(generator: torch.Generator,
                         cfg: MaskRCNNConfig = RESNET50_FPN
                         ) -> Dict[str, torch.Tensor]:
    """Random parameters on the CPU with maskrcnn_benchmark's keys and torch
    layouts, drawn from ``generator`` as the JAX package's
    ``init_maskrcnn_params`` draws them (not its numbers): convs and fcs
    N(0, 1 / fan_in), zero biases."""
    p = init_resnet_fpn_params(generator, cfg.resnet)

    def add_conv(name, cin, cout, k):
        p[name + ".weight"] = torch.randn(
            (cout, cin, k, k), generator=generator) / (cin * k * k) ** 0.5
        p[name + ".bias"] = torch.zeros(cout)

    def add_fc(name, cin, cout):
        p[name + ".weight"] = torch.randn(
            (cout, cin), generator=generator) / cin ** 0.5
        p[name + ".bias"] = torch.zeros(cout)

    C = cfg.resnet.out_channels
    A = len(generate_cell_anchors(4, 32))
    add_conv("rpn.head.conv", C, C, 3)
    add_conv("rpn.head.cls_logits", C, A, 1)
    add_conv("rpn.head.bbox_pred", C, A * 4, 1)
    add_fc("roi_heads.box.feature_extractor.fc6", C * 7 * 7, 1024)
    add_fc("roi_heads.box.feature_extractor.fc7", 1024, 1024)
    add_fc("roi_heads.box.predictor.cls_score", 1024, NUM_CLASSES)
    add_fc("roi_heads.box.predictor.bbox_pred", 1024, NUM_CLASSES * 4)
    for i in range(1, 5):
        add_conv(f"roi_heads.mask.feature_extractor.mask_fcn{i}", C, C, 3)
    # ConvTranspose2d (cin, cout, 2, 2)
    p["roi_heads.mask.predictor.conv5_mask.weight"] = torch.randn(
        (C, C, 2, 2), generator=generator) / (C * 4) ** 0.5
    p["roi_heads.mask.predictor.conv5_mask.bias"] = torch.zeros(C)
    add_conv("roi_heads.mask.predictor.mask_fcn_logits", C, NUM_CLASSES, 1)
    return p
