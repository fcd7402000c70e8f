"""Deformable convolution (DCN v1 and the modulated v2) in NCHW — counterpart
of ``vido_slam_tpu/ops/deform_conv.py`` (maskrcnn_benchmark's DCN layers,
used by the ResNet stages of ``STAGE_WITH_DCN``).

The JAX formulation, which builds no im2col buffer: for each kernel tap,
one bilinear sample of the whole image at the tap's displaced positions
(``ops/warp.py::grid_sample``: zeros outside, per-corner masks), scaled by
the tap's modulation mask if any, then a contraction of the sampled
channels with the tap's weights, accumulated over the taps in row-major
order. Plain PyTorch on every device: the JAX package computes it in XLA
outside any Pallas kernel, and it is differentiable (the offsets get their
gradient through the bilinear weights).

Layouts: ``x`` (N, Cin, H, W); ``offsets`` (N, 2 K, Ho, Wo) with the
channels interleaved (dy, dx) per tap, taps row-major (ki, kj), K = kh kw;
``mask`` (N, K, Ho, Wo); ``w`` (Cout, Cin / groups, kh, kw) as
``nn.Conv2d`` holds it. Output channel o of a grouped call belongs to group
o // (Cout / groups), as in ``nn.Conv2d`` and the JAX split
``g * (Cout / groups) + d``. With zero offsets the op is the plain
convolution.
"""

from __future__ import annotations

import torch

from vido_slam_tpu_torch.ops.warp import grid_sample
from vido_slam_tpu_torch.utils.device import resolve_device


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor = None, *, stride: int = 1,
                  padding: int = 1, dilation: int = 1,
                  mask: torch.Tensor = None, groups: int = 1) -> torch.Tensor:
    """(N, Cout, Ho, Wo) deformable convolution of x, float32 whether x
    (and the offsets, weights and mask) are float32 or bf16, as the JAX
    function promotes: the sample coordinates are float32, so the bilinear
    samples of bf16 texels are float32, and each tap's contraction runs on
    them against the tap's weights widened to float32 (the JAX einsum's
    ``Precision.HIGHEST``; the port's entry points turn TF32 off)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"deform_conv2d: float32 or bfloat16, got {x.dtype}")
    N, Cin, H, W = x.shape
    Cout, cin_g, kh, kw = w.shape
    if Cin % groups or Cout % groups or cin_g * groups != Cin:
        raise ValueError(f"deform_conv2d: weights {tuple(w.shape)} do not fit "
                         f"{Cin} input channels in {groups} groups")
    Ho = (H + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    K = kh * kw
    if offsets.shape != (N, 2 * K, Ho, Wo):
        raise ValueError(f"deform_conv2d: offsets {tuple(offsets.shape)}, "
                         f"expected {(N, 2 * K, Ho, Wo)}")
    if mask is not None and mask.shape != (N, K, Ho, Wo):
        raise ValueError(f"deform_conv2d: mask {tuple(mask.shape)}, "
                         f"expected {(N, K, Ho, Wo)}")
    oy = torch.arange(Ho, dtype=torch.float32, device=x.device) * stride \
        - padding
    ox = torch.arange(Wo, dtype=torch.float32, device=x.device) * stride \
        - padding
    base_y = oy[:, None].expand(Ho, Wo)
    base_x = ox[None, :].expand(Ho, Wo)
    out = x.new_zeros((N, Cout, Ho, Wo), dtype=torch.float32)
    for ki in range(kh):
        for kj in range(kw):
            k = ki * kw + kj
            sy = base_y[None] + ki * dilation + offsets[:, 2 * k]
            sx = base_x[None] + kj * dilation + offsets[:, 2 * k + 1]
            v = grid_sample(x, sx, sy)                    # (N, Cin, Ho, Wo)
            if mask is not None:
                v = v * mask[:, k:k + 1]
            wk = w[:, :, ki, kj].float()                  # (Cout, Cin/g)
            if groups == 1:
                out = out + torch.einsum("nchw,dc->ndhw", v, wk)
            else:
                vg = v.reshape(N, groups, cin_g, Ho, Wo)
                wg = wk.reshape(groups, Cout // groups, cin_g)
                out = out + torch.einsum("ngchw,gdc->ngdhw", vg, wg) \
                    .reshape(N, Cout, Ho, Wo)
    if b is not None:
        out = out + b.view(1, -1, 1, 1)
    return out


def init_dcn_offsets(shape, device=None) -> torch.Tensor:
    """Zero offsets (the offset conv starts at zero, so training starts from
    the plain convolution). ``shape`` is the offsets' NCHW shape; on
    ``device``, the card unless the caller asks for the CPU."""
    return torch.zeros(shape, dtype=torch.float32,
                       device=resolve_device(device))
