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


# the dtypes of the kernels that have a bfloat16 build (kernels 3, 4, 5)
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def kernel_device(what: str, tensors,
                  dtypes=(torch.float32,)) -> torch.device:
    """The one device of a kernel wrapper's inputs, which must all be
    contiguous tensors of one dtype among ``dtypes`` (float32 unless the
    kernel has other builds), on the CPU or all on one CUDA device.
    Raises ``ValueError`` for mixed devices or a non-contiguous tensor and
    ``TypeError`` for another dtype or a mix of dtypes: nothing is cast
    quietly."""
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: all tensors must be on the CPU or all on "
                         f"one CUDA device")
    for t in tensors:
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: expected "
                            f"{' or '.join(str(d) for d in dtypes)}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"{what}: all inputs must have one dtype, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev
