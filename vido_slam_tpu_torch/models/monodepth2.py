"""MonoDepth2 in NCHW, inference only — counterpart of the depth half of
``vido_slam_tpu/models/monodepth2.py`` (the reference's depth network,
mono_depth2/src/networks/{resnet_encoder.py,depth_decoder.py}, layers.py).

  - encoder: the torchvision ResNet-18 trunk, its features after relu and
    after layer1..4 (resnet_encoder.py:84-98), on the input normalised as
    (x - 0.45) / 0.225;
  - decoder: reflection-padded 3x3 convs with ELU, nearest x2 upsampling,
    the skip concatenated after the upsampled map, sigmoid disparities at
    scales 0..3 (depth_decoder.py:18-66, layers.py:106-136, 196-199);
  - the service's output: the disparity resized to the camera's size and
    min-max normalised to [0, 65536] (run_mono_depth.py:137-146).

``MonoDepth2``'s ``state_dict()`` keys equal the reference checkpoints' and
the JAX parameter dict's: ``encoder.<torchvision key>`` for the encoder,
``decoder.<n>.conv.conv.*`` for the ten ConvBlocks and ``decoder.<10+s>.conv.*``
for the dispconvs, so either loads with ``load_state_dict(strict=True)``
(the JAX dict through ``convert.monodepth2_state_dict_from_numpy``). The
pose networks serve only training and are not ported.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from vido_slam_tpu_torch.models.layers import BatchNorm2d, Conv2d, max_pool
from vido_slam_tpu_torch.ops.warp import resize_bilinear
from vido_slam_tpu_torch.utils.device import resolve_device

NUM_CH_ENC = [64, 64, 128, 256, 512]
NUM_CH_DEC = [16, 32, 64, 128, 256]
FEED_HEIGHT, FEED_WIDTH = 192, 640


class BasicBlock(nn.Module):
    """torchvision's BasicBlock: conv3x3-bn-relu-conv3x3-bn plus the
    (projected, where the width or stride changes) input, then relu."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = None
        if cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, bias=False), BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet18Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        for li in range(1, 5):
            cin, cout = NUM_CH_ENC[li - 1], NUM_CH_ENC[li]
            stride = 1 if li == 1 else 2
            setattr(self, f"layer{li}", nn.Sequential(
                BasicBlock(cin, cout, stride), BasicBlock(cout, cout, 1)))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (N, 3, H, W) RGB in [0, 1] -> the five features, in the
        parameters' dtype (the input cast to it first, as the JAX package
        casts the net's input)."""
        x = x.to(self.conv1.weight.dtype)
        x = F.relu(self.bn1(self.conv1((x - 0.45) / 0.225)))
        feats = [x]
        x = max_pool(x, 3, 2, 1)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        return feats


class Conv3x3(nn.Module):
    """A 3x3 conv over a reflection-padded input (layers.py:124-136 of the
    reference); its weights sit under ``conv``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    """Conv3x3 then ELU (layers.py:106-121 of the reference)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3x3(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsampling: output pixel i reads input i // 2, which is
    ``jax.image.resize(method="nearest")`` at an exact doubling."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class DepthDecoder(nn.ModuleList):
    """The decoder's ModuleList (depth_decoder.py:31-48): indices 0..9 are
    the ("upconv", i, j) ConvBlocks for i = 4..0, j = 0, 1; 10..13 the
    dispconvs of scales 0..3."""

    def __init__(self):
        blocks = []
        for i in range(4, -1, -1):
            cin = NUM_CH_ENC[-1] if i == 4 else NUM_CH_DEC[i + 1]
            blocks.append(ConvBlock(cin, NUM_CH_DEC[i]))
            cin1 = NUM_CH_DEC[i] + (NUM_CH_ENC[i - 1] if i > 0 else 0)
            blocks.append(ConvBlock(cin1, NUM_CH_DEC[i]))
        super().__init__(blocks + [Conv3x3(NUM_CH_DEC[s], 1)
                                   for s in range(4)])

    def forward(self, feats: List[torch.Tensor]) -> Dict[int, torch.Tensor]:
        """{scale: sigmoid disparity (N, 1, h, w)} for scales 0..3."""
        outputs: Dict[int, torch.Tensor] = {}
        x = feats[-1]
        for i in range(4, -1, -1):
            n0 = (4 - i) * 2
            x = upsample2(self[n0](x))
            if i > 0:
                x = torch.cat([x, feats[i - 1]], 1)
            x = self[n0 + 1](x)
            if i <= 3:
                outputs[i] = torch.sigmoid(self[10 + i](x))
        return outputs


class MonoDepth2(nn.Module):
    """The depth network with its parameters from
    ``init_monodepth2_params`` of ``seed``, on ``device`` (the card unless
    the caller asks for the CPU). Load other parameters with
    ``load_state_dict``."""

    def __init__(self, seed: int = 0, device=None):
        super().__init__()
        # built without storage, then given the seeded parameters
        with torch.device("meta"):
            self.encoder = ResNet18Encoder()
            self.decoder = DepthDecoder()
        self.load_state_dict(init_monodepth2_params(
            torch.Generator().manual_seed(seed)), assign=True)
        self.to(resolve_device(device))

    @torch.no_grad()
    def forward(self, image: torch.Tensor) -> Dict[int, torch.Tensor]:
        """image (N, 3, H, W) RGB in [0, 1] -> the decoder's outputs."""
        return self.decoder(self.encoder(image))


def monodepth2_disp(net: MonoDepth2, image: torch.Tensor) -> torch.Tensor:
    """image (N, 3, 192, 640) RGB in [0, 1] -> disparity (N, 1, 192, 640)."""
    return net(image)[0]


def disp_to_uint16_depth(disp: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """disp (N, 1, h, w) resized to (out_h, out_w) and min-max normalised
    per image to [0, 65536] (run_mono_depth.py:137-146, cv2.NORM_MINMAX
    with beta 65536), in the JAX order of operations. Returns (N, out_h,
    out_w)."""
    up = resize_bilinear(disp, out_h, out_w)[:, 0]
    lo = torch.amin(up, dim=(1, 2), keepdim=True)
    hi = torch.amax(up, dim=(1, 2), keepdim=True)
    return (up - lo) / torch.clamp(hi - lo, min=1e-12) * 65536.0


def disp_to_depth(disp: torch.Tensor, min_depth: float = 0.1,
                  max_depth: float = 100.0):
    """(scaled disparity, depth) (layers.py:16-25 of the reference)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled = min_disp + (max_disp - min_disp) * disp
    return scaled, 1.0 / scaled


# ---------------------------------------------------------------------------
# parameter initialisation (the checkpoint's keys, torch layout)
# ---------------------------------------------------------------------------

def init_monodepth2_params(generator: torch.Generator
                           ) -> Dict[str, torch.Tensor]:
    """Random parameters on the CPU with the checkpoint's keys and shapes,
    drawn from ``generator``: conv weights N(0, 1/fan_in), zero decoder
    biases, batch norms at the identity, as the JAX package's
    ``init_monodepth2_params`` (not its numbers: another generator)."""
    p: Dict[str, torch.Tensor] = {}

    def add_conv(name, cin, cout, k, bias=False):
        p[name + ".weight"] = torch.randn(
            (cout, cin, k, k), generator=generator) / (cin * k * k) ** 0.5
        if bias:
            p[name + ".bias"] = torch.zeros(cout)

    def add_bn(name, c):
        p[name + ".weight"] = torch.ones(c)
        p[name + ".bias"] = torch.zeros(c)
        p[name + ".running_mean"] = torch.zeros(c)
        p[name + ".running_var"] = torch.ones(c)

    add_conv("encoder.conv1", 3, 64, 7)
    add_bn("encoder.bn1", 64)
    for li in range(1, 5):
        cin, cout = NUM_CH_ENC[li - 1], NUM_CH_ENC[li]
        for blk in range(2):
            pre = f"encoder.layer{li}.{blk}"
            add_conv(f"{pre}.conv1", cin if blk == 0 else cout, cout, 3)
            add_bn(f"{pre}.bn1", cout)
            add_conv(f"{pre}.conv2", cout, cout, 3)
            add_bn(f"{pre}.bn2", cout)
            if blk == 0 and cin != cout:
                add_conv(f"{pre}.downsample.0", cin, cout, 1)
                add_bn(f"{pre}.downsample.1", cout)
    for i in range(4, -1, -1):
        n0 = (4 - i) * 2
        cin = NUM_CH_ENC[-1] if i == 4 else NUM_CH_DEC[i + 1]
        add_conv(f"decoder.{n0}.conv.conv", cin, NUM_CH_DEC[i], 3, bias=True)
        cin1 = NUM_CH_DEC[i] + (NUM_CH_ENC[i - 1] if i > 0 else 0)
        add_conv(f"decoder.{n0 + 1}.conv.conv", cin1, NUM_CH_DEC[i], 3,
                 bias=True)
    for s in range(4):
        add_conv(f"decoder.{10 + s}.conv", NUM_CH_DEC[s], 1, 3, bias=True)
    return p
