"""The tail of LiteFlowNet's regularization: the CUDA kernel
``csrc/regularize.cu`` (counterpart of the Pallas
``dist_weighted_flow_pallas``, ``vido_slam_tpu/ops/regularize.py``) and its
plain PyTorch version.

From the netDist output dc (N, K, H, W), K = k*k, and the flow (N, 2, H, W)
= [u, v]:

    e_k = exp(-dc_k^2 - max_k(-dc_k^2))
    sx  = (sum_k wx_k e_k u[y+dy-r, x+dx-r] + bx) / sum_k e_k,  k = dy*k+dx

and sy the same with wy, v and by: the exp-normalised, distance-weighted
k x k filter of the flow (zero padded, r = (k-1)//2), i.e. the 1x1
netScaleX/netScaleY convolutions of the unfolded flow.

In bfloat16 (LiteFlowNet with ``flow_dtype=torch.bfloat16``) every input
and the result are bf16 and all arithmetic is float32, as the JAX
package's ``dist_weighted_flow`` and its Pallas kernel compute it
(regularize.py:37-62, 188): the inputs are converted, and (sx, sy) rounded
to bf16 once.

``dist_weighted_flow`` runs the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel (its float32 or its bf16 build) or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from vido_slam_tpu_torch.models.layers import unfold_channels
from vido_slam_tpu_torch.utils import cuda_build
from vido_slam_tpu_torch.utils.device import (FLOAT_DTYPES, kernel_device,
                                              refuse_grad)

WINDOWS = (3, 5, 7)   # the kernel's window sides, LiteFlowNet's

# float32 operations per pixel and tap: the square and the max (2), the
# subtraction and exp (2), the sum (1), and for each of x and y the product
# with the weight and the multiply-add of the flow (3 each) ...
FLOPS_TAP = 11
# ... and per pixel the reciprocal, two bias additions and two scalings
FLOPS_PIXEL = 5


def copy_width(flow: torch.Tensor) -> int:
    """Bytes a flow copy of the float32 build takes: 16 where every 4-float
    chunk of a row is 16-byte aligned (W % 4 == 0 and the flow's first
    element 16-byte aligned; a contiguous view may start at a storage
    offset), else 4. The bf16 build loads its flow by plain loads: 2."""
    if flow.dtype == torch.bfloat16:
        return 2
    return 16 if flow.shape[-1] % 4 == 0 and flow.data_ptr() % 16 == 0 \
        else 4


def operations(dc: torch.Tensor) -> int:
    N, K, H, W = dc.shape
    return N * H * W * (FLOPS_TAP * K + FLOPS_PIXEL)


def nbytes(dc: torch.Tensor) -> int:
    """Bytes a call must move: dc, the flow, the weights and biases read
    once, the (N, 2, H, W) result written once, at dc's element size."""
    N, K, H, W = dc.shape
    return dc.element_size() * (N * H * W * (K + 2 + 2) + 2 * K + 2)


def dist_weighted_flow_ref(dc, flow, wx, bx, wy, by, k: int) -> torch.Tensor:
    """Plain version: returns (N, 2, H, W) = [sx, sy], computed in float32
    (bf16 inputs converted, the result rounded back to their dtype)."""
    dt = dc.dtype
    dc, flow, wx, bx, wy, by = (t.float() for t in (dc, flow, wx, bx, wy, by))
    d1 = -(dc * dc)
    e = torch.exp(d1 - d1.max(dim=1, keepdim=True).values)
    inv = 1.0 / e.sum(1)
    ufx = unfold_channels(flow[:, 0:1], k)
    ufy = unfold_channels(flow[:, 1:2], k)
    wx, wy = wx.reshape(-1), wy.reshape(-1)
    accx = torch.zeros_like(inv)
    accy = torch.zeros_like(inv)
    for ch in range(k * k):
        accx = accx + wx[ch] * e[:, ch] * ufx[:, ch]
        accy = accy + wy[ch] * e[:, ch] * ufy[:, ch]
    sx = (accx + bx.reshape(())) * inv
    sy = (accy + by.reshape(())) * inv
    return torch.stack([sx, sy], 1).to(dt)


_launch_fn = None


def _launch(dc, flow, wx, bx, wy, by, k: int, vec: int,
            out: torch.Tensor) -> int:
    """Launches the kernel on the current stream with flow copies of `vec`
    bytes into `out`; returns the launcher's CUDA error
    (cudaErrorInvalidValue for arguments it cannot run), 0 on success."""
    global _launch_fn
    if _launch_fn is None:
        fn = cuda_build.load("regularize").dist_weighted_flow_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 5 + [P]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    N, _, H, W = dc.shape
    with torch.cuda.device(dc.device):
        stream = torch.cuda.current_stream(dc.device).cuda_stream
        return _launch_fn(dc.data_ptr(), flow.data_ptr(), wx.data_ptr(),
                          bx.data_ptr(), wy.data_ptr(), by.data_ptr(),
                          out.data_ptr(), N, H, W, int(k), vec, stream)


def dist_weighted_flow(dc, flow, wx, bx, wy, by, k: int) -> torch.Tensor:
    """[sx, sy] (N, 2, H, W) of dc (N, K, H, W), flow (N, 2, H, W), wx and
    wy of K elements, bx and by of one (the netScaleX/Y weights and biases
    as they are), all contiguous float32 or all bfloat16 (the output's
    dtype) on one device."""
    dev = kernel_device("dist_weighted_flow", (dc, flow, wx, bx, wy, by),
                        FLOAT_DTYPES)
    refuse_grad("dist_weighted_flow", (dc, flow, wx, bx, wy, by))
    if k not in WINDOWS:
        raise ValueError(f"dist_weighted_flow: window {k} not in {WINDOWS}")
    if dc.ndim != 4 or dc.shape[1] != k * k:
        raise ValueError(f"dist_weighted_flow: dc {tuple(dc.shape)} must be "
                         f"(N, {k * k}, H, W)")
    N, K, H, W = dc.shape
    if tuple(flow.shape) != (N, 2, H, W):
        raise ValueError(f"dist_weighted_flow: flow {tuple(flow.shape)} must "
                         f"be {(N, 2, H, W)}")
    if wx.numel() != K or wy.numel() != K or bx.numel() != 1 \
            or by.numel() != 1:
        raise ValueError("dist_weighted_flow: wx, wy need K elements and "
                         "bx, by one")
    if dev.type == "cpu":
        return dist_weighted_flow_ref(dc, flow, wx, bx, wy, by, k)
    out = torch.empty((N, 2, H, W), dtype=dc.dtype, device=dev)
    rc = _launch(dc, flow, wx, bx, wy, by, k, copy_width(flow), out)
    if rc != 0:
        raise RuntimeError(f"regularize kernel launch failed: CUDA error {rc}")
    dist_weighted_flow.launches += 1
    return out


# kernel launches since the last reset (the wrapper adds one per launch)
dist_weighted_flow.launches = 0
