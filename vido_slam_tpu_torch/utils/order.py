"""Order helpers with a fixed tie rule: among equal values the lower index
comes first, as ``jax.lax.top_k`` and ``jnp.argsort`` give it.
``torch.topk`` promises no order among ties, so every site whose result
depends on order goes through these."""

from __future__ import annotations

import torch


def _sortable(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32) if x.dtype == torch.bool else x


def argsort(x: torch.Tensor, dim: int = -1,
            descending: bool = False) -> torch.Tensor:
    """Stable argsort (ties keep index order)."""
    return torch.sort(_sortable(x), dim=dim, descending=descending,
                      stable=True).indices


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last dim, ties
    broken toward the lower index."""
    vals, idx = torch.sort(_sortable(x), dim=-1, descending=True, stable=True)
    return vals[..., :k].to(x.dtype), idx[..., :k]


def argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the largest entry along the last dim, the first one among
    equal maxima (``jnp.argmax``'s rule)."""
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == x.amax(-1, keepdim=True), idx,
                       x.shape[-1]).amin(-1)
