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
