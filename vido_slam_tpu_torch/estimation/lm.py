"""Robust-kernel weight shared by the solvers — from
``vido_slam_tpu/estimation/lm.py``. The generic ``lm_solve`` engine is not
ported: the per-frame pose solves run in ``lm_kernel`` and the window BA
has its own Schur solver."""

from __future__ import annotations

import torch


def huber_weight(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    """g2o RobustKernelHuber weight rho'(chi2): 1 for chi2 <= delta^2,
    else delta / sqrt(chi2)."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta * delta, torch.ones_like(chi2),
                       delta / torch.sqrt(safe))
