"""Feature sampling and image gathers into fixed-size slot arrays —
counterpart of ``vido_slam_tpu/frontend/features.py``.

Background keypoints: grid-stratified sampling, random or by FAST score,
gated by mask == 0, valid depth below ThDepthBG and an in-bounds flow
target (Frame.cc:888-958, 20x20 grid). Object points: every ``step``-th
pixel with mask != 0 and valid depth below ThDepthOBJ, in raster order
(Frame.cc:184-211). Every selection goes through the stable order
helpers, so ties pick the lower index as ``lax.top_k`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vido_slam_tpu_torch.utils import prng
from vido_slam_tpu_torch.utils.order import argsort, top_k


class FeatureSet(NamedTuple):
    """Fixed-size feature slots; ``valid`` gates everything downstream."""

    uv: torch.Tensor      # (N, 2) float32 pixel coords (u=x, v=y)
    depth: torch.Tensor   # (N,) float32 metric depth
    flow: torch.Tensor    # (N, 2) float32 optical flow at the feature
    sem: torch.Tensor     # (N,) int32 semantic label (0 = background)
    valid: torch.Tensor   # (N,) bool


def _round_idx(x: torch.Tensor, hi: int) -> torch.Tensor:
    # round half to even, as jnp.round
    return torch.clamp(torch.round(x).to(torch.int64), 0, hi)


def gather_nearest(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel gather at float (u, v); coordinates clamp to the
    border."""
    H, W = img.shape[0], img.shape[1]
    c = _round_idx(uv[:, 0], W - 1)
    r = _round_idx(uv[:, 1], H - 1)
    return img[r, c]


def _bilinear_taps(H: int, W: int, uv: torch.Tensor):
    u = torch.clamp(uv[:, 0], 0.0, W - 1.0)
    v = torch.clamp(uv[:, 1], 0.0, H - 1.0)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    u1 = torch.clamp(u0 + 1, max=W - 1)
    v1 = torch.clamp(v0 + 1, max=H - 1)
    return u0, v0, u1, v1, u - u0, v - v0


def gather_depth_bilinear(depth: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear depth gather that falls back to the nearest pixel when a tap
    is invalid (<= 0) or the taps straddle a > 5x depth ratio (an occlusion
    boundary, where blending would invent a surface)."""
    H, W = depth.shape
    u0, v0, u1, v1, fu, fv = _bilinear_taps(H, W, uv)
    d00 = depth[v0, u0]
    d01 = depth[v0, u1]
    d10 = depth[v1, u0]
    d11 = depth[v1, u1]
    all_valid = (d00 > 0) & (d01 > 0) & (d10 > 0) & (d11 > 0)
    dmin = torch.minimum(torch.minimum(d00, d01), torch.minimum(d10, d11))
    dmax = torch.maximum(torch.maximum(d00, d01), torch.maximum(d10, d11))
    smooth = all_valid & (dmax <= 5.0 * dmin)
    bil = (d00 * (1 - fu) * (1 - fv) + d01 * fu * (1 - fv)
           + d10 * (1 - fu) * fv + d11 * fu * fv)
    return torch.where(smooth, bil, gather_nearest(depth, uv))


def gather_bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear gather; img (H, W) or (H, W, C)."""
    H, W = img.shape[0], img.shape[1]
    u0, v0, u1, v1, fu, fv = _bilinear_taps(H, W, uv)
    if img.ndim == 3:
        fu, fv = fu[:, None], fv[:, None]
    top = img[v0, u0] * (1 - fu) + img[v0, u1] * fu
    bot = img[v1, u0] * (1 - fu) + img[v1, u1] * fu
    return top * (1 - fv) + bot * fv


def sample_background_features(key: torch.Tensor, mask: torch.Tensor,
                               depth: torch.Tensor, flow: torch.Tensor,
                               score_map: Optional[torch.Tensor] = None, *,
                               n: int = 3000, th_depth: float = 80.0,
                               grid: int = 20) -> FeatureSet:
    """Grid-stratified background selection: each eligible pixel is ranked
    inside its grid cell, and a global top-n of -rank fills one point per
    cell, then two, and so on. Without ``score_map`` the rank is by uniform
    noise (UseSampleFeature=1); with a FAST score map (``ops/fast.py``,
    UseSampleFeature=0) only corners are eligible and the strongest win,
    the same noise at 1e-3 breaking ties."""
    H, W = depth.shape
    dev = depth.device
    vv, uu = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    target_u = uu.to(torch.float32) + flow[..., 0]
    target_v = vv.to(torch.float32) + flow[..., 1]
    eligible = ((mask == 0) & (depth > 0.0) & (depth < th_depth)
                & (target_u >= 0) & (target_u < W)
                & (target_v >= 0) & (target_v < H))
    noise = prng.uniform(key, (H, W))
    if score_map is not None:
        eligible = eligible & (score_map > 0)
        prio_in_cell = score_map + noise * 1e-3
    else:
        prio_in_cell = noise
    prio = torch.where(eligible, prio_in_cell,
                       torch.full_like(noise, float("-inf")))

    ch = -(-H // grid)
    cw = -(-W // grid)
    prio_p = torch.nn.functional.pad(
        prio, (0, cw * grid - W, 0, ch * grid - H), value=float("-inf"))
    cells = prio_p.reshape(grid, ch, grid, cw).permute(0, 2, 1, 3).reshape(
        grid * grid, ch * cw)
    order = argsort(-cells, dim=1)
    ranks = argsort(order, dim=1).to(torch.float32)
    # as in the JAX code: with any -inf cell the divisor is inf and the
    # tie term vanishes for every finite entry
    tie = cells / torch.clamp(torch.abs(cells).max(), min=1.0)
    global_prio = torch.where(torch.isfinite(cells), -ranks + tie,
                              torch.full_like(cells, float("-inf")))
    flat = global_prio.reshape(-1)
    _, sel = top_k(flat, n)
    valid = torch.isfinite(flat[sel])
    cell_idx = sel // (ch * cw)
    within = sel % (ch * cw)
    r = torch.clamp((cell_idx // grid) * ch + within // cw, 0, H - 1)
    c = torch.clamp((cell_idx % grid) * cw + within % cw, 0, W - 1)
    uv = torch.stack([c.to(torch.float32), r.to(torch.float32)], dim=-1)
    return FeatureSet(uv=uv, depth=depth[r, c], flow=flow[r, c],
                      sem=torch.zeros(n, dtype=torch.int32, device=dev),
                      valid=valid)


def sample_object_points(mask: torch.Tensor, depth: torch.Tensor,
                         flow: torch.Tensor, *, n: int = 4000, step: int = 4,
                         th_depth: float = 60.0) -> FeatureSet:
    """Every ``step``-th object pixel (mask != 0, valid depth) in raster
    order, up to ``n`` slots."""
    ms = mask[::step, ::step]
    ds = depth[::step, ::step]
    fs = flow[::step, ::step]
    h, w = ds.shape
    dev = depth.device
    eligible = (ms != 0) & (ds > 0.0) & (ds < th_depth)
    lin = torch.arange(h * w, device=dev).reshape(h, w).to(torch.float32)
    prio = torch.where(eligible, -lin,
                       torch.full_like(lin, float("-inf"))).reshape(-1)
    if prio.shape[0] < n:
        prio = torch.nn.functional.pad(prio, (0, n - prio.shape[0]),
                                       value=float("-inf"))
    _, idx = top_k(prio, n)
    valid = torch.isfinite(prio[idx])
    idx = torch.clamp(idx, max=h * w - 1)
    r = idx // w
    c = idx % w
    uv = torch.stack([(c * step).to(torch.float32),
                      (r * step).to(torch.float32)], dim=-1)
    return FeatureSet(uv=uv, depth=ds[r, c], flow=fs[r, c],
                      sem=ms[r, c].to(torch.int32), valid=valid)


def propagate_features(feats: FeatureSet, new_depth: torch.Tensor,
                       new_mask: torch.Tensor, new_flow: torch.Tensor, *,
                       th_depth: float = 80.0) -> FeatureSet:
    """Advance slots by their stored flow and re-read depth, label and flow
    at the new positions (Tracking.cc:369-430)."""
    H, W = new_depth.shape
    uv_new = feats.uv + feats.flow
    in_b = ((uv_new[:, 0] >= 0) & (uv_new[:, 0] <= W - 1)
            & (uv_new[:, 1] >= 0) & (uv_new[:, 1] <= H - 1))
    d = gather_depth_bilinear(new_depth, uv_new)
    s = gather_nearest(new_mask, uv_new).to(torch.int32)
    f = gather_bilinear(new_flow, uv_new)
    valid = feats.valid & in_b & (d > 0.0) & (d < th_depth)
    return FeatureSet(uv=uv_new, depth=d, flow=f, sem=s, valid=valid)
