"""FBNet mobile detectors in NCHW, inference — counterpart of
``vido_slam_tpu/models/maskrcnn/fbnet.py`` (maskrcnn_benchmark's
backbone/fbnet*.py).

The five registered architectures of ``MODEL_ARCH`` ("default",
"xirb16d_dsmask", "mobilenet_v2", "cham_v1a", "cham_v2"), each made of
MobileNetV2-style inverted-residual blocks (IRF: a 1x1 expansion conv, BN,
ReLU; a depthwise k x k at the block's stride, BN, ReLU; a 1x1 projection
and BN; the input added back when the stride is 1 and the widths agree).
BN is the eval ``BatchNorm2d`` with eps 1e-5. The detector is a
single-scale Faster R-CNN on the stride-16 trunk: an RPN over the trunk
(through the arch's RPN stage, if it has one) with 15 anchors a cell, the
600 best proposals, NMS 0.7 to 200, ROIAlign 6x6 on the trunk, the bbox
IRF stage and a global average pool as the box head, softmax over 81
classes, NMS 0.5 to 100 detections. As in the JAX package (and the
reference's bbox-only FBNet configs), the mask stages are not built.

The pooler is the JAX package's single-level ROIAlign; here it is
``roi_align_multilevel`` with one level and every ROI at level 0, so kernel
5 runs it on the card. Every top-k and NMS goes through the stable order
helpers (ties toward the lower index, as ``lax.top_k``).

Parameter names equal the JAX package's (``backbone.first.conv.weight``,
``backbone.stage0.0.pw.bn.running_var``, ``rpn.head.conv.bias``,
``bbox.cls_score.weight``, ...): ``FBNet.state_dict()`` takes the JAX dict
through ``convert.maskrcnn_state_dict_from_numpy``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vido_slam_tpu_torch.models.layers import BatchNorm2d, Conv2d, Linear
from vido_slam_tpu_torch.models.maskrcnn.rpn import (generate_cell_anchors,
                                                     grid_anchors)
from vido_slam_tpu_torch.ops.nms import clip_boxes, decode_boxes, nms
from vido_slam_tpu_torch.ops.roi_align import roi_align_multilevel
from vido_slam_tpu_torch.utils.device import resolve_device
from vido_slam_tpu_torch.utils.order import argmax, top_k

Stage = Tuple[Tuple[int, int, int, int], ...]   # ((t, c, n, s), ...)


class FBNetArch(NamedTuple):
    first: Tuple[int, int]          # (channels, stride)
    backbone: Tuple[Stage, ...]     # backbone stages
    rpn: Optional[Stage]            # RPN feature stage (None: the trunk)
    bbox: Stage                     # bbox-head stage
    # depthwise kernel size per backbone block in block order; None: all 3
    backbone_k: Optional[Tuple[int, ...]] = None


# fbnet_modeldef.py's MODEL_ARCH and MODEL_ARCH_CHAM, as the JAX package
# transcribes them (the stages the detector uses)
MODEL_ARCH: Dict[str, FBNetArch] = {
    "default": FBNetArch(
        first=(32, 2),
        backbone=(((1, 16, 1, 1),), ((6, 24, 2, 2),), ((6, 32, 3, 2),),
                  ((6, 64, 4, 2), (6, 96, 3, 1))),
        rpn=((6, 96, 3, 1),),
        bbox=((4, 160, 1, 2), (6, 160, 2, 1), (6, 240, 1, 1)),
    ),
    "xirb16d_dsmask": FBNetArch(
        first=(16, 2),
        backbone=(((1, 16, 1, 1),), ((6, 32, 2, 2),), ((6, 48, 3, 2),),
                  ((6, 96, 4, 2), (6, 128, 3, 1))),
        rpn=((6, 128, 3, 1),),
        bbox=((4, 128, 1, 2), (6, 128, 2, 1), (6, 160, 1, 1)),
    ),
    "mobilenet_v2": FBNetArch(
        first=(32, 2),
        backbone=(((1, 16, 1, 1),), ((6, 24, 2, 2),), ((6, 32, 3, 2),),
                  ((6, 64, 4, 2), (6, 96, 3, 1))),
        rpn=None,
        bbox=((6, 160, 3, 1), (6, 320, 1, 1)),
    ),
    "cham_v1a": FBNetArch(
        first=(32, 2),
        backbone=(((1, 24, 1, 1),), ((4, 48, 2, 2),), ((7, 64, 5, 2),),
                  ((12, 56, 7, 2), (8, 88, 5, 1))),
        rpn=((8, 88, 3, 1),),
        bbox=((7, 152, 4, 2), (10, 104, 1, 1)),
        backbone_k=(3,) + (7,) * 2 + (3,) * 5 + (5,) * 7 + (3,) * 5,
    ),
    "cham_v2": FBNetArch(
        first=(32, 2),
        backbone=(((1, 24, 1, 1),), ((8, 32, 4, 2),), ((5, 48, 6, 2),),
                  ((9, 56, 3, 2), (6, 56, 6, 1))),
        rpn=((6, 56, 1, 1),),
        bbox=((2, 160, 6, 2), (6, 112, 1, 1)),
        backbone_k=(3,) + (5,) * 4 + (7,) * 6 + (5,) * 3 + (3,) * 6,
    ),
}

TRUNK_STRIDE = 16
NUM_CLASSES = 81
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
NUM_ANCHORS = len(ANCHOR_SIZES) * len(ASPECT_RATIOS)
PRE_NMS_TOP_N = 600
POST_NMS_TOP_N = 200
DETECTIONS = 100
POOL = 6


def _expand(stage: Stage):
    """[t, c, n, s] specs -> per-block (t, c, stride)."""
    return [(t, c, s if j == 0 else 1) for (t, c, n, s) in stage
            for j in range(n)]


def trunk_channels(arch: FBNetArch) -> int:
    return arch.backbone[-1][-1][1]


class CBR(nn.Module):
    """conv (no bias, padding k // 2) + BN (eps 1e-5) + optional ReLU
    (``_cbr``)."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__()
        self.act = act
        self.conv = Conv2d(cin, cout, k, stride, k // 2, groups=groups,
                           bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class IRFBlock(nn.Module):
    """IRFBlock (fbnet_builder.py:445-560): pw, dw (k x k, stride), pwl;
    residual iff stride 1 and cin == cout."""

    def __init__(self, cin: int, cout: int, expansion: int, stride: int,
                 k: int = 3):
        super().__init__()
        mid = cin * expansion
        self.residual = stride == 1 and cin == cout
        self.pw = CBR(cin, mid)
        self.dw = CBR(mid, mid, k, stride, groups=mid)
        self.pwl = CBR(mid, cout, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwl(self.dw(self.pw(x)))
        return y + x if self.residual else y


def _stage(cin: int, stage: Stage, ks=None) -> Tuple[nn.Sequential, int]:
    blocks = []
    for i, (t, c, stride) in enumerate(_expand(stage)):
        blocks.append(IRFBlock(cin, c, t, stride, 3 if ks is None else ks[i]))
        cin = c
    return nn.Sequential(*blocks), cin


class FBNet(nn.Module):
    """The FBNet detector of ``arch`` with ``init_fbnet_params`` of
    ``seed``, on ``device`` (the card unless the caller asks for the CPU).
    Load other parameters with ``load_state_dict``."""

    def __init__(self, arch: str = "default", seed: int = 0, device=None):
        super().__init__()
        self.arch = arch
        a = MODEL_ARCH[arch]
        with torch.device("meta"):
            self.backbone = nn.Module()
            self.backbone.first = CBR(3, a.first[0], 3, a.first[1])
            cin, off = a.first[0], 0
            for si, stage in enumerate(a.backbone):
                n = len(_expand(stage))
                ks = None if a.backbone_k is None \
                    else a.backbone_k[off:off + n]
                seq, cin = _stage(cin, stage, ks)
                self.backbone.add_module(f"stage{si}", seq)
                off += n
            ct = trunk_channels(a)
            self.rpn = nn.Module()
            cr = ct
            if a.rpn is not None:
                self.rpn.stage, cr = _stage(ct, a.rpn)
            self.rpn.head = nn.Module()
            self.rpn.head.conv = Conv2d(cr, cr, 3, 1, 1)
            self.rpn.head.cls_logits = Conv2d(cr, NUM_ANCHORS, 1)
            self.rpn.head.bbox_pred = Conv2d(cr, NUM_ANCHORS * 4, 1)
            self.bbox = nn.Module()
            self.bbox.stage, cfin = _stage(ct, a.bbox)
            self.bbox.cls_score = Linear(cfin, NUM_CLASSES)
            self.bbox.bbox_pred = Linear(cfin, NUM_CLASSES * 4)
        self.load_state_dict(init_fbnet_params(
            torch.Generator().manual_seed(seed), arch), assign=True)
        self.to(resolve_device(device))
        self._anchors: Dict[tuple, torch.Tensor] = {}

    def anchors(self, height: int, width: int,
                device: torch.device) -> torch.Tensor:
        """(H*W*15, 4) anchors of the stride-16 trunk, made once per size
        and device: the five sizes' cells concatenated, location-major."""
        key = (height, width, device)
        if key not in self._anchors:
            cells = np.concatenate([
                generate_cell_anchors(TRUNK_STRIDE, s, ASPECT_RATIOS)
                for s in ANCHOR_SIZES])
            self._anchors[key] = torch.from_numpy(grid_anchors(
                height, width, TRUNK_STRIDE, cells)).to(device)
        return self._anchors[key]


def fbnet_trunk(model: FBNet, image: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) -> (N, C_trunk, H/16, W/16)."""
    x = model.backbone.first(image)
    for si in range(len(MODEL_ARCH[model.arch].backbone)):
        x = getattr(model.backbone, f"stage{si}")(x)
    return x


class FBNetDetections(NamedTuple):
    boxes: torch.Tensor    # (100, 4)
    scores: torch.Tensor   # (100,)
    labels: torch.Tensor   # (100,) int64, 1..80
    valid: torch.Tensor    # (100,) bool


@torch.no_grad()
def fbnet_inference(model: FBNet, image: torch.Tensor, input_h: int,
                    input_w: int) -> FBNetDetections:
    """image (1, 3, input_h, input_w) float32 -> 100 detections
    (fbnet.py:175-236 of the JAX package)."""
    if tuple(image.shape) != (1, 3, input_h, input_w):
        raise ValueError(f"fbnet_inference: image {tuple(image.shape)}, "
                         f"expected (1, 3, {input_h}, {input_w})")
    trunk = fbnet_trunk(model, image)
    # the RPN over the single stride-16 level
    rpn = model.rpn
    feat = rpn.stage(trunk) if hasattr(rpn, "stage") else trunk
    feat = F.relu(rpn.head.conv(feat))
    logits = rpn.head.cls_logits(feat)[0].permute(1, 2, 0).reshape(-1)
    deltas = rpn.head.bbox_pred(feat)[0].permute(1, 2, 0).reshape(-1, 4)
    anchors = model.anchors(trunk.shape[2], trunk.shape[3], trunk.device)
    scores = torch.sigmoid(logits)
    k = min(PRE_NMS_TOP_N, scores.shape[0])
    top, idx = top_k(scores, k)
    props = clip_boxes(decode_boxes(deltas[idx], anchors[idx]), input_h,
                       input_w)
    keep_idx, keep_ok = nms(props, top, torch.ones_like(top, dtype=torch.bool),
                            0.7, POST_NMS_TOP_N)
    rois = props[keep_idx].contiguous()
    # the box head: ROIAlign 6x6 on the trunk, the bbox stage, the pool
    levels = torch.zeros(rois.shape[0], dtype=torch.int32,
                         device=rois.device)
    x = roi_align_multilevel([trunk.contiguous()], rois, levels,
                             (1.0 / TRUNK_STRIDE,), POOL, 2)
    x = model.bbox.stage(x).mean((2, 3))
    cls = model.bbox.cls_score(x)
    reg = model.bbox.bbox_pred(x).reshape(-1, NUM_CLASSES, 4)
    probs = torch.softmax(cls, -1)
    best = argmax(probs[:, 1:]) + 1
    score = torch.take_along_dim(probs, best[:, None], dim=1)[:, 0]
    d_best = torch.take_along_dim(reg, best[:, None, None].expand(-1, 1, 4),
                                  dim=1)[:, 0]
    boxes = clip_boxes(decode_boxes(d_best, rois, (10.0, 10.0, 5.0, 5.0)),
                       input_h, input_w)
    ok = keep_ok & (score > 0.05)
    fidx, fok = nms(boxes, torch.where(ok, score, torch.zeros_like(score)),
                    ok, 0.5, DETECTIONS)
    return FBNetDetections(boxes=boxes[fidx], scores=score[fidx],
                           labels=best[fidx], valid=fok)


def init_fbnet_params(generator: torch.Generator,
                      arch: str = "default") -> Dict[str, torch.Tensor]:
    """Random parameters on the CPU with the JAX package's keys and torch
    layouts, drawn from ``generator`` as its ``init_fbnet_params`` draws
    them (not its numbers): convs N(0, 2 / fan_in), BN at unit weight and
    variance and zero bias and mean, the RPN head N(0, 0.01^2), the box
    predictor N(0, 0.01^2) and N(0, 0.001^2), zero biases."""
    a = MODEL_ARCH[arch]
    p: Dict[str, torch.Tensor] = {}

    def randn(*shape):
        return torch.randn(shape, generator=generator)

    def add_cbr(prefix, cin, cout, k=1, groups=1):
        fan = k * k * cin // groups
        p[f"{prefix}.conv.weight"] = randn(cout, cin // groups, k, k) \
            * (2.0 / fan) ** 0.5
        p[f"{prefix}.bn.weight"] = torch.ones(cout)
        p[f"{prefix}.bn.bias"] = torch.zeros(cout)
        p[f"{prefix}.bn.running_mean"] = torch.zeros(cout)
        p[f"{prefix}.bn.running_var"] = torch.ones(cout)

    def add_stage(prefix, cin, stage, ks=None):
        for i, (t, c, _) in enumerate(_expand(stage)):
            mid = cin * t
            add_cbr(f"{prefix}.{i}.pw", cin, mid)
            add_cbr(f"{prefix}.{i}.dw", mid, mid, 3 if ks is None else ks[i],
                    groups=mid)
            add_cbr(f"{prefix}.{i}.pwl", mid, c)
            cin = c
        return cin

    add_cbr("backbone.first", 3, a.first[0], k=3)
    cin, off = a.first[0], 0
    for si, stage in enumerate(a.backbone):
        n = len(_expand(stage))
        ks = None if a.backbone_k is None else a.backbone_k[off:off + n]
        cin = add_stage(f"backbone.stage{si}", cin, stage, ks)
        off += n
    ct = trunk_channels(a)
    cr = add_stage("rpn.stage", ct, a.rpn) if a.rpn is not None else ct
    p["rpn.head.conv.weight"] = randn(cr, cr, 3, 3) * 0.01
    p["rpn.head.conv.bias"] = torch.zeros(cr)
    p["rpn.head.cls_logits.weight"] = randn(NUM_ANCHORS, cr, 1, 1) * 0.01
    p["rpn.head.cls_logits.bias"] = torch.zeros(NUM_ANCHORS)
    p["rpn.head.bbox_pred.weight"] = randn(NUM_ANCHORS * 4, cr, 1, 1) * 0.01
    p["rpn.head.bbox_pred.bias"] = torch.zeros(NUM_ANCHORS * 4)
    cfin = add_stage("bbox.stage", ct, a.bbox)
    p["bbox.cls_score.weight"] = randn(NUM_CLASSES, cfin) * 0.01
    p["bbox.cls_score.bias"] = torch.zeros(NUM_CLASSES)
    p["bbox.bbox_pred.weight"] = randn(NUM_CLASSES * 4, cfin) * 0.001
    p["bbox.bbox_pred.bias"] = torch.zeros(NUM_CLASSES * 4)
    return p
