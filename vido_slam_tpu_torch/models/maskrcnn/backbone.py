"""ResNet/ResNeXt + FPN backbone in NCHW — counterpart of
``vido_slam_tpu/models/maskrcnn/backbone.py`` (maskrcnn_benchmark's
modeling/backbone/{resnet.py,fpn.py}).

Bottlenecks follow the checkpoint configs: a grouped 3x3 for ResNeXt
(``num_groups`` x ``width_per_group``, ``nn.Conv2d(groups=...)``), the
stride on the 1x1 or the 3x3 by ``stride_in_1x1``, FrozenBatchNorm (no
epsilon) everywhere, or GroupNorm (32 groups, eps 1e-5) for the GN
checkpoints (``ResNetConfig(norm="gn")``, maskrcnn_benchmark's
BottleneckWithGN / StemWithGN). In the stages of ``stage_with_dcn`` the
3x3 is deformable (``DFConv2d``, maskrcnn_benchmark's layers/misc.py): a
plain 3x3 offset conv feeding ``ops/deform_conv.py``; with
``with_modulated_dcn`` (DCNv2) one 27-channel conv gives the 18 offsets
and the 9 mask logits, whose sigmoid modulates the taps. The FPN adds 1x1
laterals to the nearest-upsampled coarser map, 3x3 output convs, and P6
as every other pixel of P5 (LastLevelMaxPool with kernel 1, stride 2).

Module and buffer names equal maskrcnn_benchmark's state_dict keys
("backbone.body.stem.conv1.weight", "backbone.fpn.fpn_inner1.weight", ...)
under ``MaskRCNN``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vido_slam_tpu_torch.models.layers import (Conv2d, FrozenBatchNorm2d,
                                               GroupNorm, max_pool, relu)
from vido_slam_tpu_torch.ops.deform_conv import deform_conv2d


class ResNetConfig(NamedTuple):
    stage_blocks: tuple = (3, 4, 6, 3)   # R-50; R-101: (3, 4, 23, 3)
    num_groups: int = 1                  # X-101: 32
    width_per_group: int = 64            # X-101: 8
    stride_in_1x1: bool = True           # caffe2 R-50: True; X-101 cfg: False
    out_channels: int = 256              # FPN channels
    # deformable conv2 per stage (MODEL.RESNETS.STAGE_WITH_DCN)
    stage_with_dcn: tuple = (False, False, False, False)
    with_modulated_dcn: bool = False
    norm: str = "frozen_bn"              # or "gn" (GroupNorm checkpoints)


def _check_supported(cfg: ResNetConfig) -> None:
    if cfg.norm not in ("frozen_bn", "gn"):
        raise ValueError(f"ResNet norm {cfg.norm!r}: 'frozen_bn' or 'gn'")


def _norm(channels: int, norm: str) -> nn.Module:
    return GroupNorm(channels) if norm == "gn" else \
        FrozenBatchNorm2d(channels)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          groups: int = 1, bias: bool = False) -> Conv2d:
    return Conv2d(cin, cout, k, stride, padding, groups=groups, bias=bias)


class DeformConv(nn.Module):
    """The deformable 3x3 of ``DFConv2d``: its weight (cout, cin / groups,
    3, 3), no bias."""

    def __init__(self, cin: int, cout: int, stride: int, groups: int):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, 3, 3))

    def forward(self, x, offsets, mask=None):
        return deform_conv2d(x, offsets, self.weight, stride=self.stride,
                             padding=1, mask=mask, groups=self.groups)


class DFConv2d(nn.Module):
    """maskrcnn_benchmark's DFConv2d (layers/misc.py:114-190, the JAX
    package's ``_dcn_conv2``): ``offset``, a plain 3x3 conv with bias at the
    block's stride, gives 18 offsets, or with ``modulated`` 18 offsets and 9
    mask logits (sigmoided); ``conv`` is the deformable 3x3. State-dict
    names ``conv2.offset.{weight,bias}`` and ``conv2.conv.weight``."""

    def __init__(self, cin: int, cout: int, stride: int, groups: int,
                 modulated: bool):
        super().__init__()
        self.modulated = modulated
        self.offset = _conv(cin, 27 if modulated else 18, 3, stride, 1,
                            bias=True)
        self.conv = DeformConv(cin, cout, stride, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        om = self.offset(x)
        if self.modulated:
            return self.conv(x, om[:, :18], torch.sigmoid(om[:, 18:27]))
        return self.conv(x, om)


class Bottleneck(nn.Module):
    """BottleneckWithFixedBatchNorm or BottleneckWithGN (resnet.py): 1x1,
    grouped 3x3 (deformable with ``dcn``), 1x1, with a 1x1 + norm
    projection when the shape changes."""

    def __init__(self, cin: int, planes: int, cout: int, stride: int,
                 groups: int, stride_in_1x1: bool, norm: str = "frozen_bn",
                 dcn: bool = False, modulated_dcn: bool = False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = _conv(cin, planes, 1, s1)
        self.bn1 = _norm(planes, norm)
        self.conv2 = DFConv2d(planes, planes, s3, groups, modulated_dcn) \
            if dcn else _conv(planes, planes, 3, s3, 1, groups)
        self.bn2 = _norm(planes, norm)
        self.conv3 = _conv(planes, cout, 1)
        self.bn3 = _norm(cout, norm)
        self.downsample = nn.Sequential(_conv(cin, cout, 1, stride),
                                        _norm(cout, norm)) \
            if cin != cout or stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = relu(self.bn1(self.conv1(x)))
        out = relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return relu(out + identity)


class Stem(nn.Module):
    def __init__(self, norm: str = "frozen_bn"):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = _norm(64, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(relu(self.bn1(self.conv1(x))), 3, 2, 1)


class ResNet(nn.Module):
    """The body: stem and four stages; ``forward`` returns [C2, C3, C4, C5]
    (``resnet_stages`` of the JAX package)."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        _check_supported(cfg)
        self.stem = Stem(cfg.norm)
        width = cfg.num_groups * cfg.width_per_group
        cin = 64
        for si, nblocks in enumerate(cfg.stage_blocks):
            planes, cout = width * 2 ** si, 256 * 2 ** si
            stride = 1 if si == 0 else 2
            self.add_module(f"layer{si + 1}", nn.Sequential(*(
                Bottleneck(cin if b == 0 else cout, planes, cout,
                           stride if b == 0 else 1, cfg.num_groups,
                           cfg.stride_in_1x1, cfg.norm,
                           cfg.stage_with_dcn[si], cfg.with_modulated_dcn)
                for b in range(nblocks))))
            cin = cout

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        feats = []
        for si in range(4):
            x = getattr(self, f"layer{si + 1}")(x)
            feats.append(x)
        return feats


class FPN(nn.Module):
    """[C2..C5] -> [P2, P3, P4, P5, P6] (``fpn_forward``)."""

    def __init__(self, out_channels: int = 256):
        super().__init__()
        for i, c in enumerate((256, 512, 1024, 2048), start=1):
            self.add_module(f"fpn_inner{i}", _conv(c, out_channels, 1,
                                                   bias=True))
            self.add_module(f"fpn_layer{i}", _conv(out_channels, out_channels,
                                                   3, 1, 1, bias=True))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        last_inner = self.fpn_inner4(feats[3])
        results = [self.fpn_layer4(last_inner)]
        for i in (3, 2, 1):
            inner = getattr(self, f"fpn_inner{i}")(feats[i - 1])
            # the half-pixel nearest rule of jax.image.resize(method=
            # "nearest"); plain "nearest" agrees only at exact 2x ratios
            top_down = F.interpolate(last_inner, size=inner.shape[2:],
                                     mode="nearest-exact")
            last_inner = inner + top_down
            results.insert(0, getattr(self, f"fpn_layer{i}")(last_inner))
        return results + [results[-1][:, :, ::2, ::2]]


class Backbone(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.body = ResNet(cfg)
        self.fpn = FPN(cfg.out_channels)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.fpn(self.body(x))


def init_resnet_fpn_params(generator: torch.Generator,
                           cfg: ResNetConfig) -> Dict[str, torch.Tensor]:
    """Random backbone parameters on the CPU with the checkpoint's keys and
    torch layouts, drawn from ``generator`` as the JAX package's
    ``init_resnet_fpn_params`` draws them (not its numbers: another
    generator): convs N(0, 1 / fan_in), zero FPN biases, FrozenBN at unit
    weight and variance, zero bias and mean; GroupNorm at unit weight and
    zero bias, without running statistics; a DCN stage's offset conv at
    zero (its blocks start as plain convolutions), drawing nothing."""
    _check_supported(cfg)
    p: Dict[str, torch.Tensor] = {}

    def add_conv(name, cin, cout, k, bias=False, groups=1):
        fan = cin // groups * k * k
        p[name + ".weight"] = torch.randn(
            (cout, cin // groups, k, k), generator=generator) / fan ** 0.5
        if bias:
            p[name + ".bias"] = torch.zeros(cout)

    def add_bn(name, c):
        p[name + ".weight"] = torch.ones(c)
        p[name + ".bias"] = torch.zeros(c)
        if cfg.norm != "gn":
            p[name + ".running_mean"] = torch.zeros(c)
            p[name + ".running_var"] = torch.ones(c)

    pre = "backbone.body"
    add_conv(f"{pre}.stem.conv1", 3, 64, 7)
    add_bn(f"{pre}.stem.bn1", 64)
    cin = 64
    width = cfg.num_groups * cfg.width_per_group
    for si, nblocks in enumerate(cfg.stage_blocks):
        planes, cout = width * 2 ** si, 256 * 2 ** si
        for b in range(nblocks):
            q = f"{pre}.layer{si + 1}.{b}"
            add_conv(f"{q}.conv1", cin if b == 0 else cout, planes, 1)
            add_bn(f"{q}.bn1", planes)
            if cfg.stage_with_dcn[si]:
                oc = 27 if cfg.with_modulated_dcn else 18
                p[f"{q}.conv2.offset.weight"] = torch.zeros(oc, planes, 3, 3)
                p[f"{q}.conv2.offset.bias"] = torch.zeros(oc)
                add_conv(f"{q}.conv2.conv", planes, planes, 3,
                         groups=cfg.num_groups)
            else:
                add_conv(f"{q}.conv2", planes, planes, 3,
                         groups=cfg.num_groups)
            add_bn(f"{q}.bn2", planes)
            add_conv(f"{q}.conv3", planes, cout, 1)
            add_bn(f"{q}.bn3", cout)
            if b == 0:
                add_conv(f"{q}.downsample.0", cin, cout, 1)
                add_bn(f"{q}.downsample.1", cout)
        cin = cout
    for i, c in enumerate((256, 512, 1024, 2048), start=1):
        add_conv(f"backbone.fpn.fpn_inner{i}", c, cfg.out_channels, 1,
                 bias=True)
        add_conv(f"backbone.fpn.fpn_layer{i}", cfg.out_channels,
                 cfg.out_channels, 3, bias=True)
    return p
