"""FPN ROIAlign: the CUDA kernel ``csrc/roi_align.cu`` (counterpart of the
Pallas ``roi_align_fused_pallas``, ``vido_slam_tpu/ops/roi_align.py``) and
its plain PyTorch version.

Detectron-1 semantics (maskrcnn_benchmark's ROIAlign, as the JAX package
computes it): a ROI (x1, y1, x2, y2) in image coordinates is scaled by its
level's ``spatial_scale``, no half-pixel shift; bin (ph, pw) of an r x r
grid averages ``sampling_ratio``^2 bilinear samples at
``y = y1 + (ph + (iy + 0.5) / s) * max(y2 - y1, 1) / r`` (x alike). A
sample outside [-1, size - 1] contributes 0; an in-range coordinate is
clamped to [0, size - 1] first. The multilevel form pools ROI i only from
level ``levels[i]`` of the pyramid.

Features are NCHW, one image: each level (1, C, H_l, W_l). Outputs are
(R, C, r, r), so the box head flattens them in torch order directly.

In bfloat16 (the detector with ``mask_dtype`` or ``compute_dtype``
``torch.bfloat16``) the features and the output are bf16 and the ROIs stay
float32, as in the JAX package, whose bf16 path rounds three times
(roi_align.py:166-168, 236, 246): the weights Ry, Rx to bf16, the
y-contraction t = Ry F (summed in float32) to bf16, and the output (t Rx^T
summed in float32) to bf16. The plain version and the kernel's bf16 build
both do.

``roi_align_multilevel`` runs the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel (its float32 or its bf16
build) or raises. It is differentiable with respect to the features: on
CUDA its backward launches the backward kernel ``csrc/roi_align_backward.cu``
(float32; the JAX package differentiates its XLA ROIAlign instead), whose
plain version is the autograd of ``roi_align_multilevel_ref``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from vido_slam_tpu_torch.utils import cuda_build
from vido_slam_tpu_torch.utils.device import FLOAT_DTYPES, kernel_device

MAX_LEVELS = 4      # csrc/roi_align.cu: kMaxLevels
MAX_SAMPLES = 64    # resolution x sampling_ratio per axis: kMaxSamples
MAX_RATIO = 4       # sampling ratios 1..4: kMaxRatio
CHUNK = 128         # ROIs per product in the plain version

# The kernel's launch plan: a block pools one ROI over a group of channels,
# staging each channel's sample grid in shared memory, a chunk of channels
# at a time through two buffers.
SM_COUNT = 132             # H100 SXM
MIN_THREADS = 64           # warps 0 and 1 set up the two axes
MAX_THREADS = 256
THREADS = 256
# blocks of THREADS an SM holds at most (2048 threads; their shared memory
# fits it 7-8 times)
BLOCKS_PER_SM = 8
BLOCK_OUTPUTS = 2048       # the bins a block computes, at most: 8 a thread
BUFFER_FLOATS = 3072       # a buffer: 12 KB, or one channel's largest grid
SMEM_LIMIT = 232448        # bytes of shared memory a block may use on sm_90
SMEM_RESERVE = 4096        # room for the static shared memory


# the bf16 build's plan: a block of BF16_THREADS pools one ROI over a group
# of channels whose bins number about BF16_OUTPUTS
BF16_THREADS = 256
BF16_OUTPUTS = 1024


class RoiAlignPlan(NamedTuple):
    group: int       # channels a block
    threads: int     # threads a block
    smem_bytes: int  # dynamic shared memory a block: two buffers


def grid_lines(resolution: int, sampling_ratio: int, size: int) -> int:
    """Texel lines (rows or columns) a ROI's sample grid stages on an axis
    whose largest level has ``size`` of them: two a sample, or the level's
    whole extent if that is fewer."""
    return min(2 * resolution * sampling_ratio, size)


def smem_bytes(resolution: int, sampling_ratio: int,
               level_sizes: Sequence[tuple]) -> int:
    """Dynamic shared memory of a block: two buffers of BUFFER_FLOATS, or
    of one channel's largest sample grid and its r x r bins if that is
    more."""
    rows = grid_lines(resolution, sampling_ratio,
                      max(h for h, _ in level_sizes))
    cols = grid_lines(resolution, sampling_ratio,
                      max(w for _, w in level_sizes))
    return 8 * max(BUFFER_FLOATS, rows * cols + resolution * resolution)


def launch_plan(R: int, C: int, resolution: int, sampling_ratio: int,
                level_sizes: Sequence[tuple]) -> RoiAlignPlan:
    """THREADS a block and the largest power-of-two channel group, at most
    C, whose bins stay within BLOCK_OUTPUTS and that still gives the R ROIs
    two waves of blocks on the SMs (at least one channel). A block sets up
    its ROI's sample grid once for all its channels but takes its chunks in
    turn, so a group of 32 channels at 7 x 7 bins (the box head) or 8 at
    14 x 14 (the mask head) balances the two. ``level_sizes``: the
    pyramid's (height, width) pairs."""
    wave = SM_COUNT * BLOCKS_PER_SM
    group = 1
    while (2 * group <= C
           and 2 * group * resolution * resolution <= BLOCK_OUTPUTS
           and R * -(-C // (2 * group)) >= 2 * wave):
        group *= 2
    return RoiAlignPlan(group, THREADS,
                        smem_bytes(resolution, sampling_ratio, level_sizes))


def launch_plan_bf16(C: int, resolution: int) -> RoiAlignPlan:
    """The bf16 build's plan: BF16_THREADS a block, a group of channels of
    at most BF16_OUTPUTS bins (at least one channel); no dynamic shared
    memory."""
    group = max(1, min(C, BF16_OUTPUTS // (resolution * resolution)))
    return RoiAlignPlan(group, BF16_THREADS, 0)


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once, on every device. PyTorch multiplies a CUDA
    tensor by the reciprocal of a Python-number divisor instead, which is
    one ulp off for b = 7 or 14; near row 270 of P2 one ulp of a sample's
    position is 3e-5 px, enough to part the plain version from the kernel
    by 2e-5 of the features' magnitude."""
    return a / torch.full_like(a, b)


def _hat_weights(lo: torch.Tensor, hi: torch.Tensor, size: int, r: int,
                 s: int, offset: int = 0) -> torch.Tensor:
    """(R, r, size) weights of one axis: the bin's s samples' bilinear
    weights (hat functions), zero for a sample outside [-1, size - 1],
    averaged. ``lo``/``hi`` are the ROI's scaled start and end (R,); the
    arithmetic is roi_align.py:54-70's, operation for operation, with the
    kernel's correctly rounded divisions. ``offset``: the level's first row
    in the JAX package's row-stacked pyramid, added to the clamped sample
    position and to the texel index before the hat is taken, as
    roi_align.py:154-168 does (it moves the float32 rounding of the
    weights); 0 gives the per-level weights of the float32 build."""
    bin_ = true_div(torch.clamp(hi - lo, min=1.0), r)
    ph = torch.arange(r, dtype=torch.float32, device=lo.device)
    frac = true_div(torch.arange(s, dtype=torch.float32, device=lo.device)
                    + 0.5, s)
    pos = lo[:, None, None] + (ph[None, :, None] + frac[None, None, :]) \
        * bin_[:, None, None]                                  # (R, r, s)
    inside = (pos >= -1.0) & (pos <= size - 1.0)
    p = torch.clamp(pos, 0.0, size - 1.0) + float(offset)
    ks = torch.arange(offset, offset + size, dtype=torch.float32,
                      device=lo.device)
    w = torch.clamp(1.0 - (p[..., None] - ks).abs(), min=0.0) \
        * inside[..., None]
    return w.sum(2) / s


def _level_weights(rois: torch.Tensor, spatial_scale: float, H: int, W: int,
                   r: int, s: int, row_offset: int = 0):
    """(Ry (R, r, H), Rx (R, r, W)) of ROIs pooled from an H x W level
    (``_hat_weights``' ``offset`` for the rows)."""
    x1, y1, x2, y2 = (rois[:, k] * spatial_scale for k in range(4))
    return (_hat_weights(y1, y2, H, r, s, row_offset),
            _hat_weights(x1, x2, W, r, s))


def roi_align(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              resolution: int = 7, sampling_ratio: int = 2,
              row_offset: int = 0) -> torch.Tensor:
    """Plain single-level ROIAlign: feat (1, C, H, W), rois (R, 4) ->
    (R, C, r, r). The separable form out = Ry F Rx^T of roi_align.py:40-94,
    ``CHUNK`` ROIs a product, in float32; for bf16 features Ry, Rx (with
    the level's ``row_offset``), t = Ry F and the output rounded to
    bf16."""
    _, C, H, W = feat.shape
    r, R = resolution, rois.shape[0]
    bf16 = feat.dtype == torch.bfloat16
    Ry, Rx = _level_weights(rois.float(), spatial_scale, H, W, r,
                            sampling_ratio, row_offset if bf16 else 0)

    def rounded(x):
        return x.to(torch.bfloat16).float() if bf16 else x
    Ry, Rx = rounded(Ry), rounded(Rx)
    Fy = feat[0].float().permute(1, 0, 2).reshape(H, C * W)
    out = feat.new_empty((R, C, r, r))
    for a in range(0, R, CHUNK):
        b = min(a + CHUNK, R)
        t = rounded(Ry[a:b].reshape(-1, H) @ Fy).reshape(b - a, r, C, W)
        out[a:b] = torch.einsum("bpcw,bqw->bcpq", t, Rx[a:b])
    return out


def roi_align_multilevel_ref(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                             levels: torch.Tensor,
                             spatial_scales: Sequence[float],
                             resolution: int = 7,
                             sampling_ratio: int = 2) -> torch.Tensor:
    """Plain version of the multilevel pooler (roi_align.py:111-196): the
    ROIs of each level through ``roi_align`` on that level, put back in
    order (bf16: with the level's first row in the stacked pyramid). Levels
    outside [0, L) clamp, as JAX's gathers do. Reads the level partition
    back to the host."""
    C = feats[0].shape[1]
    r = resolution
    lv = levels.clamp(0, len(feats) - 1)
    out = feats[0].new_zeros((rois.shape[0], C, r, r))
    row = 0
    for level, (f, scale) in enumerate(zip(feats, spatial_scales)):
        idx = torch.nonzero(lv == level)[:, 0]
        if idx.numel():
            out[idx] = roi_align(f, rois[idx], scale, r, sampling_ratio, row)
        row += f.shape[2]
    return out


def banded_weights(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                   levels: torch.Tensor, spatial_scales: Sequence[float],
                   resolution: int = 7, sampling_ratio: int = 2):
    """The plain version's per-level weights in the banded layout of the
    Pallas kernel's arguments, as numpy: ``fcat`` (Htot, Wmax, C), the
    levels stacked along rows in JAX's HWC layout and zero-padded to the
    widest; ``Ry`` (R, r, Htot), each ROI's weights in its level's row band;
    ``Rx`` (R, r, Wmax). ``roi_align_fused_pallas(fcat, Ry, Rx, r)`` then
    computes the function of ``roi_align_multilevel_ref`` (permuted to
    (R, r, r, C))."""
    Hs = [f.shape[2] for f in feats]
    Ws = [f.shape[3] for f in feats]
    Wmax = max(Ws)
    offs = np.concatenate([[0], np.cumsum(Hs)])
    fcat = np.concatenate([np.pad(f[0].permute(1, 2, 0).cpu().numpy(),
                                  ((0, 0), (0, Wmax - w), (0, 0)))
                           for f, w in zip(feats, Ws)])
    r = resolution
    R = rois.shape[0]
    Ry = np.zeros((R, r, int(offs[-1])), np.float32)
    Rx = np.zeros((R, r, Wmax), np.float32)
    lv = levels.clamp(0, len(feats) - 1).cpu().numpy()
    for level, scale in enumerate(spatial_scales):
        idx = np.nonzero(lv == level)[0]
        ry, rx = _level_weights(rois[torch.from_numpy(idx)].cpu(), scale,
                                Hs[level], Ws[level], r, sampling_ratio)
        Ry[idx, :, offs[level]:offs[level + 1]] = ry.numpy()
        Rx[idx, :, :Ws[level]] = rx.numpy()
    return fcat, Ry, Rx


def operations(rois: torch.Tensor, channels: int, resolution: int,
               sampling_ratio: int = 2) -> int:
    """float32 operations of a call of the float32 build, against its
    arithmetic: per output and sample a multiply and a multiply-add for
    each of the two rows (6) and two multiply-adds into the sum (4); per
    ROI and sample position of either axis the position and weights
    (12)."""
    R = rois.shape[0]
    r, s = resolution, sampling_ratio
    return R * channels * r * r * s * s * 10 + R * 2 * r * s * 12


def _bin_lines(feats, rois, levels, spatial_scales, resolution,
               sampling_ratio):
    """Per ROI the number of texel rows (R, r) and columns (R, r) that
    each bin's samples weight, at the ROI's level."""
    lv = levels.clamp(0, len(feats) - 1)
    R, r = rois.shape[0], resolution
    ny = torch.zeros((R, r), dtype=torch.int64, device=rois.device)
    nx = torch.zeros_like(ny)
    for level, (f, scale) in enumerate(zip(feats, spatial_scales)):
        idx = torch.nonzero(lv == level)[:, 0]
        if idx.numel():
            ry, rx = _level_weights(rois[idx].float(), scale, f.shape[2],
                                    f.shape[3], r, sampling_ratio)
            ny[idx] = (ry > 0).sum(2)
            nx[idx] = (rx > 0).sum(2)
    return ny, nx


def operations_bf16(feats, rois, levels, spatial_scales, resolution=7,
                    sampling_ratio=2) -> int:
    """float32 operations of a call of the bf16 build on these ROIs: per
    output and weighted column a multiply-add per weighted row (2 each)
    and one into the output (2)."""
    ny, nx = _bin_lines(feats, rois, levels, spatial_scales, resolution,
                        sampling_ratio)
    C = feats[0].shape[1]
    per_roi = (nx.sum(1) * (2 * ny.sum(1) + 2 * resolution)).sum()
    return int(C * per_roi)


def nbytes(feats: Sequence[torch.Tensor], rois: torch.Tensor,
           levels: torch.Tensor, spatial_scales: Sequence[float],
           resolution: int = 7, sampling_ratio: int = 2) -> int:
    """Bytes a call must move: the ROIs and levels read, the (R, C, r, r)
    output written, and every feature texel that a sample of these ROIs
    weights above zero read once (C channels at the features' element
    size): the union over ROIs of their sampled rows x columns, per
    level."""
    C = feats[0].shape[1]
    R = rois.shape[0]
    lv = levels.clamp(0, len(feats) - 1)
    texels = 0
    for level, (f, scale) in enumerate(zip(feats, spatial_scales)):
        idx = torch.nonzero(lv == level)[:, 0]
        if idx.numel():
            ry, rx = _level_weights(rois[idx], scale, f.shape[2], f.shape[3],
                                    resolution, sampling_ratio)
            rows = (ry > 0).any(1).to(torch.float32)       # (n, H)
            cols = (rx > 0).any(1).to(torch.float32)       # (n, W)
            texels += int(((rows.T @ cols) > 0).sum())
    size = feats[0].element_size()
    return size * (R * C * resolution * resolution + texels * C) + 20 * R


def backward_nbytes(level_shapes: Sequence[tuple], R: int, C: int,
                   resolution: int) -> int:
    """Bytes the backward must move: grad_out (R, C, r, r) and the ROIs and
    levels read once, each level's whole float32 gradient (C, H_l, W_l)
    written once."""
    texels = sum(h * w for h, w in level_shapes)
    return 4 * (R * C * resolution * resolution + C * texels) + 20 * R


def backward_operations(R: int, C: int, resolution: int,
                        sampling_ratio: int = 2) -> int:
    """float32 operations of the backward: per output element and sample
    the four corner products and their adds (8), plus the row weight's
    product (1)."""
    return R * C * resolution * resolution * sampling_ratio ** 2 * 9


_launch_fn = None
_launch_bf16_fn = None


def level_sizes(feats: Sequence[torch.Tensor]) -> list:
    """The (height, width) of each level of (1, C, H, W) features."""
    return [(f.shape[2], f.shape[3]) for f in feats]


def _launch(feats, rois, levels, spatial_scales, resolution, sampling_ratio,
            plan: RoiAlignPlan, out: torch.Tensor) -> int:
    """Launches the kernel on the current stream with `plan`, writing into
    `out`; ``levels`` int32 and contiguous. Returns the launcher's CUDA
    error (cudaErrorInvalidValue for a plan it cannot run), 0 on
    success."""
    global _launch_fn, _launch_bf16_fn
    bf16 = out.dtype == torch.bfloat16
    if (_launch_bf16_fn if bf16 else _launch_fn) is None:
        lib = cuda_build.load("roi_align")
        P, I = ctypes.c_void_p, ctypes.c_int
        head = [ctypes.POINTER(P), ctypes.POINTER(I), ctypes.POINTER(I),
                ctypes.POINTER(ctypes.c_float), I, P, P, P]
        if bf16:
            _launch_bf16_fn = lib.roi_align_bf16_launch
            _launch_bf16_fn.argtypes = head + [I] * 6 + [P]
            _launch_bf16_fn.restype = ctypes.c_int
        else:
            _launch_fn = lib.roi_align_launch
            _launch_fn.argtypes = head + [I] * 7 + [P]
            _launch_fn.restype = ctypes.c_int
    L = len(feats)
    R, C = rois.shape[0], feats[0].shape[1]
    ptrs = (ctypes.c_void_p * L)(*(f.data_ptr() for f in feats))
    hs = (ctypes.c_int * L)(*(f.shape[2] for f in feats))
    ws = (ctypes.c_int * L)(*(f.shape[3] for f in feats))
    scales = (ctypes.c_float * L)(*(float(x) for x in spatial_scales))
    dev = out.device
    args = (ptrs, hs, ws, scales, L, rois.data_ptr(), levels.data_ptr(),
            out.data_ptr(), R, C, resolution, sampling_ratio, plan.group,
            plan.threads)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bf16:
            return _launch_bf16_fn(*args, stream)
        return _launch_fn(*args, plan.smem_bytes, stream)


def _check_args(feats, rois, levels, spatial_scales, resolution,
                sampling_ratio) -> torch.device:
    """The one device of a call's tensors, after checking the arguments as
    both the kernel and its plain version take them."""
    dev = kernel_device("roi_align_multilevel", feats, FLOAT_DTYPES)
    if rois.device != dev:
        raise ValueError("roi_align_multilevel: all tensors must be on the "
                         "CPU or all on one CUDA device")
    if not rois.is_contiguous():
        raise ValueError("roi_align_multilevel: inputs must be contiguous")
    if rois.dtype != torch.float32:
        raise TypeError(f"roi_align_multilevel: rois must be float32, got "
                        f"{rois.dtype}")
    L = len(feats)
    if not 1 <= L <= MAX_LEVELS or len(spatial_scales) != L:
        raise ValueError(f"roi_align_multilevel: 1 to {MAX_LEVELS} levels "
                         f"with one scale each, got {L} and "
                         f"{len(spatial_scales)}")
    C = feats[0].shape[1]
    for f in feats:
        if f.ndim != 4 or f.shape[0] != 1 or f.shape[1] != C:
            raise ValueError(f"roi_align_multilevel: levels must be "
                             f"(1, {C}, H, W), got {tuple(f.shape)}")
    R = rois.shape[0]
    if rois.shape != (R, 4) or levels.shape != (R,) or R > 65535:
        raise ValueError(f"roi_align_multilevel: rois {tuple(rois.shape)} "
                         f"and levels {tuple(levels.shape)} must be (R, 4) "
                         f"and (R,) with R <= 65535")
    if levels.device != dev or levels.is_floating_point():
        raise ValueError("roi_align_multilevel: levels must be an integer "
                         "tensor on the features' device")
    if resolution < 1 or sampling_ratio < 1 \
            or resolution * sampling_ratio > MAX_SAMPLES:
        raise ValueError(f"roi_align_multilevel: resolution x sampling_ratio "
                         f"must be in [1, {MAX_SAMPLES}]")
    if dev.type == "cuda" and sampling_ratio > MAX_RATIO:
        raise ValueError(f"roi_align_multilevel: the kernel takes sampling "
                         f"ratios 1 to {MAX_RATIO}, got {sampling_ratio}")
    if rois.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("roi_align_multilevel: no gradient flows to the "
                           "ROIs (the detector pools detached proposals); "
                           "pass rois.detach()")
    return dev


def _forward(feats, rois, levels, spatial_scales, resolution,
             sampling_ratio) -> torch.Tensor:
    """One launch of kernel 5 (its float32 or bf16 build) on CUDA tensors;
    ``levels`` int32 and contiguous."""
    R, C = rois.shape[0], feats[0].shape[1]
    out = torch.empty((R, C, resolution, resolution), dtype=feats[0].dtype,
                      device=rois.device)
    if R == 0:
        return out
    plan = launch_plan_bf16(C, resolution) \
        if out.dtype == torch.bfloat16 else \
        launch_plan(R, C, resolution, sampling_ratio, level_sizes(feats))
    rc = _launch(feats, rois, levels, spatial_scales, resolution,
                 sampling_ratio, plan, out)
    if rc != 0:
        raise RuntimeError(f"roi_align kernel launch failed: CUDA error {rc}")
    roi_align_multilevel.launches += 1
    return out


_backward_fn = None


def _launch_backward(grads, rois, levels, spatial_scales, resolution,
                     sampling_ratio, grad_out) -> int:
    """Launches the backward kernel (``csrc/roi_align_backward.cu``) on the
    current stream, adding into the zeroed level gradients ``grads``
    ((1, C, H_l, W_l) float32). Returns the launcher's CUDA error, 0 on
    success."""
    global _backward_fn
    if _backward_fn is None:
        lib = cuda_build.load("roi_align_backward")
        P, I = ctypes.c_void_p, ctypes.c_int
        fn = lib.roi_align_backward_launch
        fn.argtypes = [ctypes.POINTER(P), ctypes.POINTER(I),
                       ctypes.POINTER(I), ctypes.POINTER(ctypes.c_float), I,
                       P, P, P, I, I, I, I, P]
        fn.restype = ctypes.c_int
        _backward_fn = fn
    L = len(grads)
    R, C = rois.shape[0], grads[0].shape[1]
    dev = grad_out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return _backward_fn(
            (ctypes.c_void_p * L)(*(g.data_ptr() for g in grads)),
            (ctypes.c_int * L)(*(g.shape[2] for g in grads)),
            (ctypes.c_int * L)(*(g.shape[3] for g in grads)),
            (ctypes.c_float * L)(*(float(x) for x in spatial_scales)), L,
            rois.data_ptr(), levels.data_ptr(), grad_out.data_ptr(), R, C,
            resolution, sampling_ratio, stream)


def roi_align_multilevel_backward(grad_out: torch.Tensor,
                                  level_shapes: Sequence[tuple],
                                  rois: torch.Tensor, levels: torch.Tensor,
                                  spatial_scales: Sequence[float],
                                  resolution: int = 7,
                                  sampling_ratio: int = 2) -> list:
    """The gradient of the float32 ``roi_align_multilevel`` with respect to
    each level: grad_out (R, C, r, r) -> one (1, C, H_l, W_l) tensor a
    level of ``level_shapes`` ((H_l, W_l) pairs). One launch of the
    backward kernel on CUDA tensors (``levels`` int32 and contiguous). The
    CPU never reaches it: there ``roi_align_multilevel`` is the plain
    version, which has its own autograd."""
    if grad_out.device.type != "cuda":
        raise ValueError("roi_align_multilevel_backward: the backward kernel "
                         "takes CUDA tensors; on the CPU differentiate "
                         "roi_align_multilevel's plain version")
    C = grad_out.shape[1]
    grads = [torch.zeros((1, C, h, w), device=grad_out.device)
             for h, w in level_shapes]
    if rois.shape[0] == 0:
        return grads
    rc = _launch_backward(grads, rois, levels, spatial_scales, resolution,
                          sampling_ratio, grad_out.contiguous())
    if rc != 0:
        raise RuntimeError(f"roi_align backward kernel launch failed: CUDA "
                           f"error {rc}")
    roi_align_multilevel_backward.launches += 1
    return grads


class _RoiAlignFunction(torch.autograd.Function):
    """Kernel 5 with the backward kernel as its gradient (CUDA tensors
    only); the ROIs and levels take no gradient."""

    @staticmethod
    def forward(ctx, rois, levels, spatial_scales, resolution,
                sampling_ratio, *feats):
        ctx.save_for_backward(rois, levels)
        ctx.meta = ([(f.shape[2], f.shape[3]) for f in feats],
                    spatial_scales, resolution, sampling_ratio,
                    feats[0].dtype)
        return _forward(feats, rois, levels, spatial_scales, resolution,
                        sampling_ratio)

    @staticmethod
    def backward(ctx, grad_out):
        rois, levels = ctx.saved_tensors
        shapes, scales, r, s, dtype = ctx.meta
        if dtype != torch.float32:
            raise NotImplementedError(
                "roi_align_multilevel: the bf16 build has no backward; "
                "train in float32, as the JAX package does")
        grads = roi_align_multilevel_backward(grad_out, shapes, rois, levels,
                                              scales, r, s)
        return (None, None, None, None, None, *grads)


def roi_align_multilevel(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         levels: torch.Tensor, spatial_scales: Sequence[float],
                         resolution: int = 7,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """(R, C, r, r) ROIAlign of rois (R, 4) float32, each from level
    ``levels[i]`` (an integer tensor (R,)) of the pyramid ``feats``, up to
    four contiguous (1, C, H_l, W_l) levels on one device, all float32 or
    all bfloat16 (the output's dtype; the ROIs stay float32, as in the JAX
    package). The kernel takes sampling ratios 1 to MAX_RATIO.

    Differentiable with respect to the features: on the CPU through the
    plain version's own autograd, on CUDA through the backward kernel
    (float32 only; the bf16 build raises on a backward). The ROIs take no
    gradient: a call with ``rois.requires_grad`` raises."""
    dev = _check_args(feats, rois, levels, spatial_scales, resolution,
                      sampling_ratio)
    if dev.type == "cpu":
        return roi_align_multilevel_ref(feats, rois, levels, spatial_scales,
                                        resolution, sampling_ratio)
    return _RoiAlignFunction.apply(
        rois, levels.to(torch.int32).contiguous(), tuple(spatial_scales),
        resolution, sampling_ratio, *feats)


# kernel launches since the last reset (each wrapper adds one per launch)
roi_align_multilevel.launches = 0
roi_align_multilevel_backward.launches = 0
