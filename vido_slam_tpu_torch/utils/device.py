"""Device choice for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Asking for ``cuda`` without a card raises.

    Also turns TF32 off for matmuls and cuDNN: RANSAC counts inliers
    against a 0.4 px threshold from one float32 matmul, and TF32 would
    change those counts (the JAX code runs at ``Precision.HIGHEST``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def kernel_device(what: str, tensors) -> torch.device:
    """The one device of a kernel wrapper's inputs, which must all be
    contiguous float32 tensors on the CPU or all on one CUDA device.
    Raises ``ValueError`` for mixed devices or a non-contiguous tensor and
    ``TypeError`` for another dtype."""
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: all tensors must be on the CPU or all on "
                         f"one CUDA device")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev
