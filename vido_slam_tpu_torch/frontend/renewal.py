"""Slot-persistent feature renewal — Tracking::RenewFrameInfo
(Tracking.cc:2959-3289); counterpart of ``vido_slam_tpu/frontend/renewal.py``.

A surviving track keeps its slot (slot index == track identity), the r-th
invalid slot takes the r-th valid fresh candidate, and an occupancy image
drops fresh picks that land on a kept point's pixel."""

from __future__ import annotations

from typing import Tuple

import torch

from vido_slam_tpu_torch.frontend.features import FeatureSet, _round_idx
from vido_slam_tpu_torch.utils.order import argsort


def dedup_against(fresh: FeatureSet, keep_uv: torch.Tensor,
                  keep_valid: torch.Tensor, height: int,
                  width: int) -> FeatureSet:
    H, W = height, width
    r = _round_idx(keep_uv[:, 1], H - 1)
    c = _round_idx(keep_uv[:, 0], W - 1)
    occ = torch.zeros(H * W, dtype=torch.int32, device=keep_uv.device)
    occ.scatter_reduce_(0, r * W + c, keep_valid.to(torch.int32),
                        reduce="amax")
    fr = _round_idx(fresh.uv[:, 1], H - 1)
    fc = _round_idx(fresh.uv[:, 0], W - 1)
    clash = occ[fr * W + fc] > 0
    return fresh._replace(valid=fresh.valid & ~clash)


def fill_invalid_slots(kept: FeatureSet,
                       fresh: FeatureSet) -> Tuple[FeatureSet, torch.Tensor]:
    """Returns (renewed set, is_new (N,) bool)."""
    order = argsort(~fresh.valid)
    f_uv = fresh.uv[order]
    f_depth = fresh.depth[order]
    f_flow = fresh.flow[order]
    f_sem = fresh.sem[order]
    num_fresh = torch.sum(fresh.valid)
    invalid = ~kept.valid
    rank = torch.cumsum(invalid.to(torch.int64), 0) - 1
    cand = torch.clamp(rank, 0, f_uv.shape[0] - 1)
    take = invalid & (rank < num_fresh)
    uv = torch.where(take[:, None], f_uv[cand], kept.uv)
    depth = torch.where(take, f_depth[cand], kept.depth)
    flow = torch.where(take[:, None], f_flow[cand], kept.flow)
    sem = torch.where(take, f_sem[cand], kept.sem)
    return (FeatureSet(uv=uv, depth=depth, flow=flow, sem=sem,
                       valid=kept.valid | take), take)


def renew_features(tracked: FeatureSet, tracked_inlier: torch.Tensor,
                   fresh: FeatureSet, *, height: int,
                   width: int) -> Tuple[FeatureSet, torch.Tensor]:
    """Keep inlier tracks in place, refill the rest from fresh samples."""
    kept = tracked._replace(valid=tracked.valid & tracked_inlier)
    fresh_d = dedup_against(fresh, kept.uv, kept.valid, height, width)
    return fill_invalid_slots(kept, fresh_d)
