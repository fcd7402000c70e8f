"""LiteFlowNet in NCHW — counterpart of ``vido_slam_tpu/models/liteflownet.py``
(the reference's optical-flow network, flow_net/src/layers.py:38-315).

``LiteFlowNet``'s ``state_dict()`` keys equal the reference checkpoint's
(``network-default.pytorch``) and the JAX parameter dict's, so either loads
with ``load_state_dict(strict=True)`` (the JAX dict through
``convert.liteflownet_state_dict_from_numpy``).

  - netFeatures: the 6-level encoder 3->32->32->64->96->128->192, stride 2
    between levels, LeakyReLU(0.1);
  - per level L in 6..2: Matching (the cost volume, kernel
    ``ops/correlation.py``, at stride 2 with a learned 49-group deconv
    below level 4, then 4 convs to a flow delta), Subpixel (feature-concat
    refinement) and Regularization (feature-driven distance weights over a
    k x k flow window, the fused tail kernel ``ops/regularize.py``);
  - the result is the flow at half the input size, times 20.

Inference only: the kernels have no backward, so ``forward`` runs without
autograd.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn

from vido_slam_tpu_torch.models.layers import (Conv2d, deconv_grouped,
                                               leaky_relu)
from vido_slam_tpu_torch.ops.correlation import correlation
from vido_slam_tpu_torch.ops.regularize import dist_weighted_flow
from vido_slam_tpu_torch.ops.warp import backwarp, resize_bilinear
from vido_slam_tpu_torch.utils.device import resolve_device

# per-level constants (index by level 2..6), flow_net/src/layers.py
FLT_BACKWARP = [0.0, 0.0, 10.0, 5.0, 2.5, 1.25, 0.625]
MAIN_KERNEL = [0, 0, 7, 5, 5, 3, 3]
MAIN_PAD = [0, 0, 3, 2, 2, 1, 1]
SUBPIX_CIN = [0, 0, 130, 130, 194, 258, 386]
REG_FEAT_CIN = [0, 0, 32, 64, 96, 128, 192]
REG_MAIN_CIN = [0, 0, 131, 131, 131, 131, 195]
REG_DIST_CH = [0, 0, 49, 25, 25, 9, 9]
MEAN_FIRST = (0.411618, 0.434631, 0.454253)
MEAN_SECOND = (0.410782, 0.433645, 0.452793)

# module list order: netMatching[i] has level LEVELS[i]
LEVELS = [2, 3, 4, 5, 6]


def _seq(*convs, last_act: bool = True) -> nn.Sequential:
    """Conv2d, LeakyReLU, Conv2d, ... as the reference's nn.Sequentials
    (convs at the even indices); without the last LeakyReLU when
    ``last_act`` is False."""
    mods = []
    for cin, cout, k, stride, pad in convs:
        mods += [Conv2d(cin, cout, k, stride, pad), nn.LeakyReLU(0.1)]
    return nn.Sequential(*(mods if last_act else mods[:-1]))


def _upsample(channels: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(channels, channels, 4, 2, 1, groups=channels,
                              bias=False)


class Features(nn.Module):
    def __init__(self):
        super().__init__()
        self.netOne = _seq((3, 32, 7, 1, 3))
        self.netTwo = _seq((32, 32, 3, 2, 1), (32, 32, 3, 1, 1),
                           (32, 32, 3, 1, 1))
        self.netThr = _seq((32, 64, 3, 2, 1), (64, 64, 3, 1, 1))
        self.netFou = _seq((64, 96, 3, 2, 1), (96, 96, 3, 1, 1))
        self.netFiv = _seq((96, 128, 3, 2, 1))
        self.netSix = _seq((128, 192, 3, 2, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for net in (self.netOne, self.netTwo, self.netThr, self.netFou,
                    self.netFiv, self.netSix):
            x = net(x)
            feats.append(x)
        return feats


def _main(cin: int, level: int) -> nn.Sequential:
    k, pd = MAIN_KERNEL[level], MAIN_PAD[level]
    return _seq((cin, 128, 3, 1, 1), (128, 64, 3, 1, 1), (64, 32, 3, 1, 1),
                (32, 2, k, 1, pd), last_act=False)


class Matching(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        self.level = level
        self.netFeat = _seq((32, 64, 1, 1, 0)) if level == 2 \
            else nn.Sequential()
        self.netUpflow = _upsample(2) if level != 6 else None
        self.netUpcorr = _upsample(49) if level < 4 else None
        self.netMain = _main(49, level)

    def forward(self, feat1, feat2, flow):
        feat1 = self.netFeat(feat1)
        feat2 = self.netFeat(feat2)
        if flow is not None:
            flow = deconv_grouped(flow, self.netUpflow.weight)
            feat2 = backwarp(feat2, flow * FLT_BACKWARP[self.level])
        if self.level >= 4:
            corr = leaky_relu(correlation(feat1, feat2, 1))
        else:
            corr = leaky_relu(correlation(feat1, feat2, 2))
            corr = deconv_grouped(corr, self.netUpcorr.weight)
        delta = self.netMain(corr)
        return delta if flow is None else flow + delta


class Subpixel(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        self.level = level
        self.netFeat = _seq((32, 64, 1, 1, 0)) if level == 2 \
            else nn.Sequential()
        self.netMain = _main(SUBPIX_CIN[level], level)

    def forward(self, feat1, feat2, flow):
        feat1 = self.netFeat(feat1)
        feat2 = self.netFeat(feat2)
        feat2 = backwarp(feat2, flow * FLT_BACKWARP[self.level])
        return flow + self.netMain(torch.cat([feat1, feat2, flow], 1))


class Regularization(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        self.level = level
        k, r = MAIN_KERNEL[level], MAIN_PAD[level]
        dch = REG_DIST_CH[level]
        self.netFeat = _seq((REG_FEAT_CIN[level], 128, 1, 1, 0)) \
            if level < 5 else nn.Sequential()
        self.netMain = _seq((REG_MAIN_CIN[level], 128, 3, 1, 1),
                            (128, 128, 3, 1, 1), (128, 64, 3, 1, 1),
                            (64, 64, 3, 1, 1), (64, 32, 3, 1, 1),
                            (32, 32, 3, 1, 1))
        if level >= 5:
            self.netDist = nn.Sequential(Conv2d(32, dch, k, 1, r))
        else:   # separable k x 1 then 1 x k
            self.netDist = nn.Sequential(
                Conv2d(32, dch, (k, 1), 1, (r, 0)),
                Conv2d(dch, dch, (1, k), 1, (0, r)))
        self.netScaleX = Conv2d(dch, 1, 1, 1, 0)
        self.netScaleY = Conv2d(dch, 1, 1, 1, 0)

    def forward(self, im1, im2, feat1, flow):
        diff = im1 - backwarp(im2, flow * FLT_BACKWARP[self.level])
        diff = torch.sqrt(torch.sum(diff * diff, dim=1, keepdim=True))
        # the image-wide mean in float32 whatever the net's dtype
        # (liteflownet.py:130-132)
        flow_mean = flow.float().mean(dim=(2, 3), keepdim=True) \
            .to(flow.dtype)
        x = torch.cat([diff, flow - flow_mean, self.netFeat(feat1)], 1)
        d = self.netDist(self.netMain(x))
        return dist_weighted_flow(
            d, flow, self.netScaleX.weight, self.netScaleX.bias,
            self.netScaleY.weight, self.netScaleY.bias,
            MAIN_KERNEL[self.level])


class LiteFlowNet(nn.Module):
    """The network with its parameters from ``init_liteflownet_params`` of
    ``seed``, on ``device`` (the card unless the caller asks for the CPU).
    Load other parameters with ``load_state_dict``. It computes in its
    parameters' dtype: ``.to(torch.bfloat16)`` runs the pyramid in bf16
    (kernels 3 and 4 in their bf16 builds), with the warp coordinates and
    the flow mean in float32 and the flow returned in float32."""

    def __init__(self, seed: int = 0, device=None):
        super().__init__()
        # built without storage (no default init, no draw from torch's
        # global generator), then given the seeded parameters
        with torch.device("meta"):
            self.netFeatures = Features()
            self.netMatching = nn.ModuleList(Matching(lv) for lv in LEVELS)
            self.netSubpixel = nn.ModuleList(Subpixel(lv) for lv in LEVELS)
            self.netRegularization = nn.ModuleList(
                Regularization(lv) for lv in LEVELS)
        self.load_state_dict(init_liteflownet_params(
            torch.Generator().manual_seed(seed)), assign=True)
        self.to(resolve_device(device))

    @torch.no_grad()
    def forward(self, first: torch.Tensor,
                second: torch.Tensor) -> torch.Tensor:
        """first, second: (N, 3, H, W) RGB in [0, 1], H and W multiples of
        32. Returns the flow (N, 2, H/2, W/2) times 20
        (flow_net/src/layers.py:313); the caller resizes and rescales it."""
        dt = self.netFeatures.netOne[0].weight.dtype
        mean1 = torch.tensor(MEAN_FIRST, dtype=dt, device=first.device)
        mean2 = torch.tensor(MEAN_SECOND, dtype=dt, device=first.device)
        # contiguous NCHW from here on, whatever the callers' strides: the
        # kernels take contiguous tensors only
        first = (first.to(dt) - mean1.view(1, 3, 1, 1)).contiguous()
        second = (second.to(dt) - mean2.view(1, 3, 1, 1)).contiguous()
        feats1 = self.netFeatures(first)
        feats2 = self.netFeatures(second)
        im1, im2 = [first], [second]
        for lvl in range(1, 6):
            h, w = feats1[lvl].shape[2], feats1[lvl].shape[3]
            im1.append(resize_bilinear(im1[-1], h, w))
            im2.append(resize_bilinear(im2[-1], h, w))
        flow = None
        for mi in (4, 3, 2, 1, 0):   # levels 6, 5, 4, 3, 2
            li = LEVELS[mi] - 1      # level L -> list index L-1
            f1, f2 = feats1[li], feats2[li]
            flow = self.netMatching[mi](f1, f2, flow)
            flow = self.netSubpixel[mi](f1, f2, flow)
            flow = self.netRegularization[mi](im1[li], im2[li], f1, flow)
        return flow.float() * 20.0


def liteflownet_forward(module: LiteFlowNet, first: torch.Tensor,
                        second: torch.Tensor) -> torch.Tensor:
    """``module(first, second)``, under the JAX function's name."""
    return module(first, second)


def flow_full_resolution(flow: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """Upsample the half-size network flow (N, 2, h, w) to (out_h, out_w)
    with the u/v rescale (run_flow_net.py:96-106)."""
    h, w = flow.shape[2], flow.shape[3]
    up = resize_bilinear(flow, out_h, out_w)
    scale = torch.tensor([out_w / w, out_h / h], dtype=flow.dtype,
                         device=flow.device)
    return up * scale.view(1, 2, 1, 1)


# ---------------------------------------------------------------------------
# parameter initialisation (the checkpoint's keys, torch layout)
# ---------------------------------------------------------------------------

def init_liteflownet_params(generator: torch.Generator
                            ) -> Dict[str, torch.Tensor]:
    """Random parameters on the CPU with the checkpoint's keys and shapes,
    drawn from ``generator``: conv weights N(0, 1/fan_in), zero biases, and
    the up-sampling deconvolutions at 0.25, as the JAX package's
    ``init_liteflownet_params`` (not its numbers: another generator)."""
    p: Dict[str, torch.Tensor] = {}

    def add_conv(name, cin, cout, k, bias=True):
        kh, kw = (k, k) if isinstance(k, int) else k
        p[name + ".weight"] = torch.randn(
            (cout, cin, kh, kw), generator=generator) / (cin * kh * kw) ** 0.5
        if bias:
            p[name + ".bias"] = torch.zeros(cout)

    add_conv("netFeatures.netOne.0", 3, 32, 7)
    add_conv("netFeatures.netTwo.0", 32, 32, 3)
    add_conv("netFeatures.netTwo.2", 32, 32, 3)
    add_conv("netFeatures.netTwo.4", 32, 32, 3)
    add_conv("netFeatures.netThr.0", 32, 64, 3)
    add_conv("netFeatures.netThr.2", 64, 64, 3)
    add_conv("netFeatures.netFou.0", 64, 96, 3)
    add_conv("netFeatures.netFou.2", 96, 96, 3)
    add_conv("netFeatures.netFiv.0", 96, 128, 3)
    add_conv("netFeatures.netSix.0", 128, 192, 3)
    for mi, level in enumerate(LEVELS):
        mk = MAIN_KERNEL[level]
        if level == 2:
            add_conv(f"netMatching.{mi}.netFeat.0", 32, 64, 1)
            add_conv(f"netSubpixel.{mi}.netFeat.0", 32, 64, 1)
        if level != 6:
            p[f"netMatching.{mi}.netUpflow.weight"] = torch.full(
                (2, 1, 4, 4), 0.25)
        if level < 4:
            p[f"netMatching.{mi}.netUpcorr.weight"] = torch.full(
                (49, 1, 4, 4), 0.25)
        for net, cin in (("netMatching", 49),
                         ("netSubpixel", SUBPIX_CIN[level])):
            add_conv(f"{net}.{mi}.netMain.0", cin, 128, 3)
            add_conv(f"{net}.{mi}.netMain.2", 128, 64, 3)
            add_conv(f"{net}.{mi}.netMain.4", 64, 32, 3)
            add_conv(f"{net}.{mi}.netMain.6", 32, 2, mk)
        reg = f"netRegularization.{mi}"
        if level < 5:
            add_conv(f"{reg}.netFeat.0", REG_FEAT_CIN[level], 128, 1)
        for i, (cin, cout) in enumerate(((REG_MAIN_CIN[level], 128),
                                         (128, 128), (128, 64), (64, 64),
                                         (64, 32), (32, 32))):
            add_conv(f"{reg}.netMain.{2 * i}", cin, cout, 3)
        dch = REG_DIST_CH[level]
        if level >= 5:
            add_conv(f"{reg}.netDist.0", 32, dch, mk)
        else:
            add_conv(f"{reg}.netDist.0", 32, dch, (mk, 1))
            add_conv(f"{reg}.netDist.1", dch, dch, (1, mk))
        add_conv(f"{reg}.netScaleX", dch, 1, 1)
        add_conv(f"{reg}.netScaleY", dch, 1, 1)
    return p
