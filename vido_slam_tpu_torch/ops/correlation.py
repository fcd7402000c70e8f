"""LiteFlowNet's cost volume: the CUDA kernel ``csrc/correlation.cu``
(counterpart of the Pallas ``correlation_pallas``,
``vido_slam_tpu/ops/correlation.py``) and its plain PyTorch version.

For f1, f2 (N, C, H, W) and a stride s, channel (p+3)*7+(o+3) of the
(N, 49, ceil(H/s), ceil(W/s)) output at (i, j) is
``mean_c f1[c, i*s, j*s] * f2[c, (i+p)*s, (j+o)*s]``, zero where f2 is read
outside the image. Every offset is a multiple of s, so only the stride
phase (rows and columns at multiples of s) of either input is read.

``correlation`` runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vido_slam_tpu_torch.utils import cuda_build
from vido_slam_tpu_torch.utils.device import kernel_device

RADIUS = 3   # displacements -3..3 in each direction: 49 taps
TAPS = (2 * RADIUS + 1) ** 2


def _out_hw(H: int, W: int, stride: int):
    return -(-H // stride), -(-W // stride)


def operations(f1: torch.Tensor, stride: int) -> int:
    """float32 operations of a call: a multiply-add (2) per channel, tap
    and output, and the 1/C scale per tap and output."""
    N, C, H, W = f1.shape
    Ho, Wo = _out_hw(H, W, stride)
    return N * Ho * Wo * TAPS * (2 * C + 1)


def nbytes(f1: torch.Tensor, stride: int) -> int:
    """Bytes a call must move: the stride phase of f1 and f2 read once, the
    cost volume written once."""
    N, C, H, W = f1.shape
    Ho, Wo = _out_hw(H, W, stride)
    return 4 * N * Ho * Wo * (2 * C + TAPS)


def correlation_ref(f1: torch.Tensor, f2: torch.Tensor,
                    stride: int = 1) -> torch.Tensor:
    """Plain version: 49 shifted products of the stride phases, each
    averaged over the channels."""
    f1s = f1[:, :, ::stride, ::stride]
    f2s = f2[:, :, ::stride, ::stride]
    Ho, Wo = f1s.shape[2], f1s.shape[3]
    r = RADIUS
    f2p = F.pad(f2s, (r, r, r, r))
    taps = [(f1s * f2p[:, :, r + p:r + p + Ho, r + o:r + o + Wo]).mean(1)
            for p in range(-r, r + 1) for o in range(-r, r + 1)]
    return torch.stack(taps, 1)


_launch_fn = None


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
    """Cost volume (N, 49, ceil(H/s), ceil(W/s)) of f1, f2 (N, C, H, W),
    contiguous float32 on one device."""
    global _launch_fn
    dev = kernel_device("correlation", (f1, f2))
    if f1.ndim != 4 or f1.shape != f2.shape:
        raise ValueError(f"correlation: f1 {tuple(f1.shape)} and f2 "
                         f"{tuple(f2.shape)} must be one (N, C, H, W) shape")
    if int(stride) != stride or stride < 1:
        raise ValueError(f"correlation: stride {stride} must be a positive "
                         f"integer")
    if dev.type == "cpu":
        return correlation_ref(f1, f2, stride)
    N, C, H, W = f1.shape
    Ho, Wo = _out_hw(H, W, stride)
    out = torch.empty((N, TAPS, Ho, Wo), dtype=torch.float32, device=dev)
    if _launch_fn is None:
        fn = cuda_build.load("correlation").correlation_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _launch_fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), N, C,
                        H, W, int(stride), stream)
    if rc != 0:
        raise RuntimeError(f"correlation kernel launch failed: CUDA error {rc}")
    correlation.launches += 1
    return out


# kernel launches since the last reset (the wrapper adds one per launch)
correlation.launches = 0
