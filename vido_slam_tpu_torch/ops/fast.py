"""FAST-9/16 corners as whole-image tensor ops — counterpart of
``vido_slam_tpu/ops/fast.py`` (the reference's ORBextractor corner stage,
ORBextractor.cc ComputeKeyPointsOctTree; the system uses only the FAST
corners, kaist_config.yaml:78).

A pixel is a corner when at least 9 contiguous pixels of its radius-3
Bresenham circle are all brighter than centre + t or all darker than
centre - t. The 16 circle neighbours are 16 shifted copies of the image
(edges replicated), stacked; the arc test ANDs 9 rotations of that stack
and ORs over the 16 starting points. The score is the sum of
|neighbour - centre| over the qualifying neighbours, added in circle order
as the JAX function adds them, so the two score maps are equal bit for
bit: every step is a comparison, an absolute difference or that sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vido_slam_tpu_torch.utils.order import argsort, top_k

# radius-3 Bresenham circle, clockwise from 12 o'clock (OpenCV order)
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC = 9
BORDER = 3


def circle_taps(g: torch.Tensor) -> torch.Tensor:
    """(16, H, W): tap k holds g[y + dy_k, x + dx_k], edge-replicated."""
    H, W = g.shape
    dev = g.device
    dx = torch.tensor([c[0] for c in CIRCLE], device=dev)
    dy = torch.tensor([c[1] for c in CIRCLE], device=dev)
    rows = torch.clamp(torch.arange(H, device=dev)[None] + dy[:, None], 0,
                       H - 1)
    cols = torch.clamp(torch.arange(W, device=dev)[None] + dx[:, None], 0,
                       W - 1)
    return g[rows[:, :, None], cols[:, None, :]]


def _arc_any(flags: torch.Tensor) -> torch.Tensor:
    """(H, W): some run of ARC contiguous taps (cyclically) all set."""
    run = flags
    for k in range(1, ARC):
        run = run & torch.roll(flags, -k, dims=0)
    return run.any(0)


def fast_score_map(gray: torch.Tensor, threshold: int = 20) -> torch.Tensor:
    """(H, W) grayscale -> (H, W) float32 corner score (0: not a corner),
    non-max suppressed (a pixel keeps its score where it is >= the 3x3
    maximum), with a 3-pixel border zeroed (the circle would leave the
    image)."""
    g = gray.to(torch.float32)
    t = float(threshold)
    taps = circle_taps(g)
    bright = taps > g + t
    dark = taps < g - t
    is_corner = _arc_any(bright) | _arc_any(dark)

    diffs = torch.where(bright | dark, torch.abs(taps - g),
                        torch.zeros_like(taps))
    score = torch.zeros_like(g)
    for k in range(len(CIRCLE)):   # in circle order, as the JAX sum
        score = score + diffs[k]
    score = torch.where(is_corner, score, torch.zeros_like(score))

    m = F.max_pool2d(score[None, None], 3, 1, 1)[0, 0]
    score = torch.where(score >= m, score, torch.zeros_like(score))

    H, W = g.shape
    border = torch.ones_like(score, dtype=torch.bool)
    border[BORDER:H - BORDER, BORDER:W - BORDER] = False
    return torch.where(border, torch.zeros_like(score), score)


def detect_fast_features(gray: torch.Tensor, *, n: int = 2000,
                         threshold: int = 20, min_threshold: int = 7,
                         grid: int = 20):
    """The top-n FAST corners spread over a grid x grid cell layout (the
    reference's quadtree DistributeOctTree as rank-within-cell selection):
    corners at ``threshold`` rank first, those found only at
    ``min_threshold`` fill in (ORBextractor.cc's retry in sparse cells).
    Returns (uv (n, 2) float32, score (n,), valid (n,))."""
    H, W = gray.shape
    s_hi = fast_score_map(gray, threshold=threshold)
    s_lo = fast_score_map(gray, threshold=min_threshold)
    ninf = torch.full_like(s_hi, float("-inf"))
    prio = torch.where(s_hi > 0, s_hi + 1e6,
                       torch.where(s_lo > 0, s_lo, ninf))

    ch = -(-H // grid)
    cw = -(-W // grid)
    prio_p = F.pad(prio, (0, cw * grid - W, 0, ch * grid - H),
                   value=float("-inf"))
    cells = prio_p.reshape(grid, ch, grid, cw).permute(0, 2, 1, 3).reshape(
        grid * grid, ch * cw)
    order = argsort(-cells, dim=1)
    ranks = argsort(order, dim=1).to(torch.float32)
    # rank first, the raw score as the tie-break
    gp = torch.where(torch.isfinite(cells), -ranks * 1e8 + cells,
                     torch.full_like(cells, float("-inf"))).reshape(-1)
    _, sel = top_k(gp, n)
    valid = torch.isfinite(gp[sel])
    cell_idx = sel // (ch * cw)
    within = sel % (ch * cw)
    r = torch.clamp((cell_idx // grid) * ch + within // cw, 0, H - 1)
    c = torch.clamp((cell_idx % grid) * cw + within % cw, 0, W - 1)
    uv = torch.stack([c.to(torch.float32), r.to(torch.float32)], -1)
    score = prio.reshape(-1)[torch.clamp(r * W + c, 0, H * W - 1)]
    return uv, torch.where(valid, score, torch.zeros_like(score)), valid
