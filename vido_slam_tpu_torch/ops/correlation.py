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
from vido_slam_tpu_torch.utils.device import (FLOAT_DTYPES, kernel_device,
                                              refuse_grad)

RADIUS = 3   # displacements -3..3 in each direction: 49 taps
TAPS = (2 * RADIUS + 1) ** 2

# The kernel's launch plan (csrc/correlation.cu): tiles of TILE_W x tile_h
# outputs, 2 outputs a thread along x, the channel sum split over a cluster
# of `split` CTAs; the float32 build stages CHUNK channels at a time through
# a ring of STAGES buffers, by 4-byte copies.
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
    chunk: int = CHUNK      # channels a stage of the ring
    taps: int = 1           # thread groups, each over its share of tap rows


def smem_bytes(tile_h: int) -> int:
    """A CTA's shared memory: STAGES stages of CHUNK channels of the haloed
    f2 tile and the f1 tile, or the 49 x tile_h x TILE_W partial sums that
    reuse them, whichever is larger."""
    stage = CHUNK * _chan_floats(tile_h)
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


def _chan_floats(tile_h: int) -> int:
    """Floats of one channel's staged tiles: the haloed f2 tile and the f1
    tile."""
    return (tile_h + 2 * RADIUS) * HALO_W + tile_h * TILE_W


# The bf16 build stages its rows raw, as the 16-byte pieces (8 values) that
# cover each row from its first element's offset in its first piece (0-7):
# any W, stride and storage offset. Its ring holds STAGES stages of
# `chunk` channels, each widened a chunk ahead into one of two float tiles
# (tools/sweep_kernel_plans.py correlation: the largest chunk whose grid
# stays resident the fastest; 3, 4 and 6 stages timed alike).
PIECE = 8              # bf16 values a 16-byte piece
BF16_CHUNKS = (8, 4, 2, 1)
# groups of TILE_W * tile_h / 2 threads, each summing its share of the 7
# tap rows of every output: 4 at tiles of 4 rows, 2 at tiles of 8 where the
# grid stays resident with 256 threads a CTA, else 1
# (tools/sweep_kernel_plans.py correlation)
TAP_GROUPS = (1, 2, 4)
MAX_BF16_CHUNK = 16    # csrc/correlation.cu: kMaxChunk


def row_pieces(n: int, stride: int) -> int:
    """16-byte pieces of a staged row of n stride-phase values: they span
    (n - 1) stride + 1 elements of the image row, from any of the 8
    offsets in the first piece."""
    return ((n - 1) * stride + 2 * PIECE - 1) // PIECE


def chan_pieces(tile_h: int, stride: int) -> int:
    """Pieces of one channel: the tile_h + 6 haloed f2 rows of HALO_W
    values, then the tile_h f1 rows of TILE_W."""
    return ((tile_h + 2 * RADIUS) * row_pieces(HALO_W, stride)
            + tile_h * row_pieces(TILE_W, stride))


def smem_bytes_bf16(tile_h: int, stride: int, chunk: int) -> int:
    """A CTA's shared memory in the bf16 build: two float tiles of `chunk`
    channels, STAGES raw buffers of `chunk` channels' pieces and a 16-byte
    description of each piece of a channel, or the partial sums that reuse
    them, whichever is larger."""
    ring = (4 * 2 * chunk * _chan_floats(tile_h)
            + 16 * (STAGES * chunk + 1) * chan_pieces(tile_h, stride))
    return max(ring, 4 * TAPS * tile_h * TILE_W)


def launch_plan_bf16(N: int, C: int, H: int, W: int,
                     stride: int) -> CorrelationPlan:
    """The bf16 build's plan: the float32 plan's tile height and split (so
    that every rank sums the channels it summed before, in the same order:
    the tap groups share out the sums, not the channels), the tap groups
    of the rule above TAP_GROUPS, and a ring of STAGES stages of the most
    channels (of BF16_CHUNKS, no more than twice a rank's share needs)
    with which every CTA of the grid is resident at once (by shared
    memory), else of one."""
    plan = launch_plan(N, C, H, W, stride)
    ctas = plan.grid[0] * plan.grid[1]
    share = -(-C // plan.split)
    for chunk in BF16_CHUNKS:
        if chunk > 1 and chunk // 2 >= share:
            continue
        smem = smem_bytes_bf16(plan.tile_h, stride, chunk)
        if smem <= SMEM_LIMIT and ctas <= SM_COUNT * (SMEM_LIMIT // smem):
            break
    taps = 4 if plan.tile_h == 4 else 2 if ctas <= 2 * SM_COUNT else 1
    return plan._replace(chunk=chunk, taps=taps, smem_bytes=smem)


def plan_for(f1: torch.Tensor, stride: int) -> CorrelationPlan:
    """The plan the wrapper launches for f1's dtype and shape."""
    fn = launch_plan_bf16 if f1.dtype == torch.bfloat16 else launch_plan
    return fn(*f1.shape, int(stride))


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
        fn.argtypes = [P, P, P] + [I] * 12 + [P]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    N, C, H, W = f1.shape
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        return _launch_fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), N, C,
                          H, W, int(stride), plan.tile_h, plan.split,
                          plan.grid[0], plan.chunk, plan.taps,
                          plan.smem_bytes, int(f1.dtype == torch.bfloat16),
                          stream)


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
    """Cost volume (N, 49, ceil(H/s), ceil(W/s)) of f1, f2 (N, C, H, W),
    contiguous float32 or bfloat16 (both one dtype, the output's) on one
    device."""
    dev = kernel_device("correlation", (f1, f2), FLOAT_DTYPES)
    refuse_grad("correlation", (f1, f2))
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
    rc = _launch(f1, f2, stride, plan_for(f1, stride), out)
    if rc != 0:
        raise RuntimeError(f"correlation kernel launch failed: CUDA error {rc}")
    correlation.launches += 1
    return out


# kernel launches since the last reset (the wrapper adds one per launch)
correlation.launches = 0
