"""LiteFlowNet's cost volume: the CUDA kernel ``csrc/correlation.cu``
(counterpart of the Pallas ``correlation_pallas``,
``vido_slam_tpu/ops/correlation.py``) and its plain PyTorch version.

For f1, f2 (N, C, H, W) and a stride s, channel (p+3)*7+(o+3) of the
(N, 49, ceil(H/s), ceil(W/s)) output at (i, j) is
``mean_c f1[c, i*s, j*s] * f2[c, (i+p)*s, (j+o)*s]``, zero where f2 is read
outside the image. Every offset is a multiple of s, so only the stride
phase (rows and columns at multiples of s) of either input is read.

In bfloat16 (LiteFlowNet with ``flow_dtype=torch.bfloat16``) the inputs and
the output are bf16 and the arithmetic float32: a bf16 x bf16 product is
exact in float32, the channel sum runs in float32, and the mean is rounded
to bf16 once. That is what the JAX package's ``correlation`` and
``correlation_pallas`` return on the CPU for bf16 inputs: the Pallas body
casts each bf16 product to float32 (correlation.py:120-125), and XLA
keeps the product unrounded (measured: rounding it in bf16 changes 45 of 96
outputs of a 64-channel tap, keeping it none).

``correlation`` runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel (its float32 or its bf16 build) or
raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from vido_slam_tpu_torch.utils import cuda_build
from vido_slam_tpu_torch.utils.device import FLOAT_DTYPES, kernel_device

RADIUS = 3   # displacements -3..3 in each direction: 49 taps
TAPS = (2 * RADIUS + 1) ** 2

# The kernel's launch plan (csrc/correlation.cu): tiles of TILE_W x tile_h
# outputs, 2 outputs a thread along x, the channel sum split over a cluster
# of `split` CTAs.
SM_COUNT = 132       # H100 SXM
TILE_W = 32
HALO_W = TILE_W + 2 * RADIUS  # f2 columns staged for a tile row
CHUNK = 4            # channels a cp.async stage
STAGES = 3           # stages in the ring
MAX_SPLIT = 8        # portable cluster size
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
MIN_CTAS = 128       # a tile height of 8 must reach this many CTAs
TARGET_CTAS = 2 * SM_COUNT


class CorrelationPlan(NamedTuple):
    tile_h: int             # output rows of a tile (8, or 4 at small levels)
    split: int              # CTAs of a cluster, each summing C / split
    grid: Tuple[int, int]   # (split * tiles, N); TILE_W * tile_h / 2 threads
    smem_bytes: int         # dynamic shared memory a CTA


def smem_bytes(tile_h: int) -> int:
    """A CTA's shared memory: STAGES stages of CHUNK channels of the haloed
    f2 tile and the f1 tile, or the 49 x tile_h x TILE_W partial sums that
    reuse them, whichever is larger."""
    stage = CHUNK * ((tile_h + 2 * RADIUS) * HALO_W + tile_h * TILE_W)
    return 4 * max(STAGES * stage, TAPS * tile_h * TILE_W)


def launch_plan(N: int, C: int, H: int, W: int,
                stride: int) -> CorrelationPlan:
    """Tile height 8 where a split of MAX_SPLIT gives it MIN_CTAS CTAs,
    else 4; then the smallest power-of-two split that reaches TARGET_CTAS,
    at most MAX_SPLIT and at least CHUNK channels a rank."""
    Ho, Wo = _out_hw(H, W, stride)
    tiles_x = -(-Wo // TILE_W)

    def tiles(tile_h):
        return tiles_x * -(-Ho // tile_h)

    tile_h = 8 if N * tiles(8) * MAX_SPLIT >= MIN_CTAS else 4
    split = 1
    while (split < MAX_SPLIT and N * tiles(tile_h) * split < TARGET_CTAS
           and C >= 2 * split * CHUNK):
        split *= 2
    return CorrelationPlan(tile_h=tile_h, split=split,
                           grid=(split * tiles(tile_h), N),
                           smem_bytes=smem_bytes(tile_h))


def _out_hw(H: int, W: int, stride: int):
    return -(-H // stride), -(-W // stride)


def operations(f1: torch.Tensor, stride: int) -> int:
    """float32 operations of a call (bf16 inputs too: their arithmetic is
    float32): a multiply-add (2) per channel, tap and output, and the 1/C
    scale per tap and output."""
    N, C, H, W = f1.shape
    Ho, Wo = _out_hw(H, W, stride)
    return N * Ho * Wo * TAPS * (2 * C + 1)


def nbytes(f1: torch.Tensor, stride: int) -> int:
    """Bytes a call must move: the stride phase of f1 and f2 read once, the
    cost volume written once, at the inputs' element size."""
    N, C, H, W = f1.shape
    Ho, Wo = _out_hw(H, W, stride)
    return f1.element_size() * N * Ho * Wo * (2 * C + TAPS)


def correlation_ref(f1: torch.Tensor, f2: torch.Tensor,
                    stride: int = 1) -> torch.Tensor:
    """Plain version: 49 shifted products of the stride phases, each
    averaged over the channels, in float32 (bf16 inputs converted, the
    output rounded back to their dtype)."""
    f1s = f1[:, :, ::stride, ::stride].float()
    f2s = f2[:, :, ::stride, ::stride].float()
    Ho, Wo = f1s.shape[2], f1s.shape[3]
    r = RADIUS
    f2p = F.pad(f2s, (r, r, r, r))
    taps = [(f1s * f2p[:, :, r + p:r + p + Ho, r + o:r + o + Wo]).mean(1)
            for p in range(-r, r + 1) for o in range(-r, r + 1)]
    return torch.stack(taps, 1).to(f1.dtype)


_launch_fn = None


def _launch(f1: torch.Tensor, f2: torch.Tensor, stride: int,
            plan: CorrelationPlan, out: torch.Tensor) -> int:
    """Launches the kernel on the current stream with `plan` into `out`;
    returns the launcher's CUDA error (cudaErrorInvalidValue for a plan it
    cannot run), 0 on success."""
    global _launch_fn
    if _launch_fn is None:
        fn = cuda_build.load("correlation").correlation_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P] + [I] * 10 + [P]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    N, C, H, W = f1.shape
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        return _launch_fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), N, C,
                          H, W, int(stride), plan.tile_h, plan.split,
                          plan.grid[0], plan.smem_bytes,
                          int(f1.dtype == torch.bfloat16), stream)


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
    """Cost volume (N, 49, ceil(H/s), ceil(W/s)) of f1, f2 (N, C, H, W),
    contiguous float32 or bfloat16 (both one dtype, the output's) on one
    device."""
    dev = kernel_device("correlation", (f1, f2), FLOAT_DTYPES)
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
    out = torch.empty((N, TAPS, Ho, Wo), dtype=f1.dtype, device=dev)
    rc = _launch(f1, f2, stride, launch_plan(N, C, H, W, int(stride)), out)
    if rc != 0:
        raise RuntimeError(f"correlation kernel launch failed: CUDA error {rc}")
    correlation.launches += 1
    return out


# kernel launches since the last reset (the wrapper adds one per launch)
correlation.launches = 0
