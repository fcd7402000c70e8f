"""ORB feature extraction as whole-image tensor ops — counterpart of
``vido_slam_tpu/ops/orb.py`` (the reference's ORBextractor,
vido_slam/src/ORBextractor.cc). The SLAM system uses only the FAST corners
(matching is by optical flow); the extractor is API parity for its users.

- pyramid: 8 levels at 1.2x, each resized from the full image as
  ``jax.image.resize(..., "linear")`` does it, antialiased when it shrinks:
  the separable triangle-weight matrices of ``jax.image.scale_and_translate``
  applied with two matmuls (``resize_linear``);
- corners: ``ops/fast.py``'s grid-spread FAST per level, with ORB-SLAM2's
  geometric per-level budget, the 19-pixel border dropped;
- orientation: the intensity centroid (IC_Angle) of the radius-15 circular
  patch at every pixel, one two-channel 31x31 convolution, gathered at the
  corners;
- descriptors: steered BRIEF over the learned 256-pair table
  ``bit_pattern_31_`` (ORBextractor.cc:140-438; ``orb_pattern.npy``, a copy
  of the JAX package's), rotated by each corner's angle, rounded half to
  even and sampled in one gather;
- matching: brute-force Hamming distances through a 256-entry popcount
  table, with the ratio test and the cross-check; ties go to the lower
  index (``utils/order.py``), as ``jnp.argmin`` gives them.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vido_slam_tpu_torch.ops.fast import detect_fast_features
from vido_slam_tpu_torch.utils.device import resolve_device
from vido_slam_tpu_torch.utils.order import argsort

N_LEVELS = 8          # ORBextractor.h nlevels
SCALE_FACTOR = 1.2    # scaleFactor
HALF_PATCH = 15       # HALF_PATCH_SIZE (orientation radius)
PATCH_SIZE = 31
EDGE = 19             # EDGE_THRESHOLD border
NO_MATCH = 10_000     # the distance of a pair with an invalid side


class OrbFeatures(NamedTuple):
    uv: torch.Tensor          # (n, 2) level-0 pixel coords (u, v)
    response: torch.Tensor    # (n,) FAST score
    angle: torch.Tensor       # (n,) radians, intensity-centroid orientation
    octave: torch.Tensor      # (n,) int32 pyramid level
    size: torch.Tensor        # (n,) patch diameter in level-0 pixels
    descriptor: torch.Tensor  # (n, 32) uint8 steered BRIEF
    valid: torch.Tensor       # (n,) bool


def level_sizes(h: int, w: int, n_levels: int = N_LEVELS,
                scale: float = SCALE_FACTOR):
    """(h, w) of each pyramid level (ComputePyramid's shapes)."""
    out = []
    for lv in range(n_levels):
        s = 1.0 / (scale ** lv)
        out.append((max(int(round(h * s)), 32), max(int(round(w * s)), 32)))
    return out


def features_per_level(n: int, n_levels: int = N_LEVELS,
                       scale: float = SCALE_FACTOR):
    """ORB-SLAM2's geometric budget (ORBextractor.cc:62-76): level l gets
    n * (1 - 1/s) / (1 - (1/s)^L) * (1/s)^l, the rest to the coarsest."""
    inv = 1.0 / scale
    per = n * (1 - inv) / (1 - inv ** n_levels)
    counts = [max(int(round(per * inv ** lv)), 8)
              for lv in range(n_levels - 1)]
    counts.append(max(n - sum(counts), 8))
    return counts


def _brief_pattern() -> np.ndarray:
    """(256, 2, 2) int32 point pairs [(x0, y0), (x1, y1)] per bit, all
    within +/-13 of the centre."""
    pat = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "orb_pattern.npy"))
    if pat.shape != (256, 2, 2) or pat.dtype != np.int32:
        raise ValueError(f"orb_pattern.npy: {pat.shape} {pat.dtype}")
    return pat


_PATTERN = _brief_pattern()
# bits set in each byte value
POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                        dtype=torch.int32)


def _moment_kernel() -> torch.Tensor:
    """(2, 1, 31, 31) convolution weight: channel 0 the x moment m10,
    channel 1 the y moment m01 over the radius-15 circular patch."""
    ys, xs = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    circ = (xs * xs + ys * ys) <= HALF_PATCH * HALF_PATCH
    k = np.stack([xs * circ, ys * circ]).astype(np.float32)
    return torch.from_numpy(k[:, None])


_MOMENTS = _moment_kernel()


def resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(out, in) float32 weights of ``jax.image.resize``'s "linear" method
    along one axis (``compute_weight_mat`` there) on ``device`` (the
    image's; no default, so that they never land on the CPU unasked): the
    triangle kernel at the half-pixel sample positions, widened by in / out
    when the axis shrinks (its antialiasing), normalised per output, and
    zero for an output whose sample lies outside the input."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = torch.tensor(max(inv_scale, 1.0), **f32)
    sample = (torch.arange(out_size, **f32) + 0.5) \
        * torch.tensor(inv_scale, **f32) - 0.5
    x = torch.abs(sample[None, :] - torch.arange(in_size, **f32)[:, None]) \
        / kernel_scale
    w = torch.clamp(1 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T


def resize_linear(gray: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(gray, (h, w), "linear")`` of a (H, W) image: the
    rows' and the columns' weight matrices (``resize_weights``), applied
    as two products. Equal to JAX's within float32 rounding, not to the
    bit: XLA fuses and reorders the weights' arithmetic and sums."""
    H, W = gray.shape
    wy = resize_weights(H, h, gray.device)
    wx = resize_weights(W, w, gray.device)
    return torch.matmul(torch.matmul(wy, gray), wx.T)


def orientation_map(gray: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H, W) angle in radians at every pixel: atan2(m01, m10) of
    the centred circular patch (zero padded at the border)."""
    m = F.conv2d(gray.to(torch.float32)[None, None],
                 _MOMENTS.to(gray.device), padding=HALF_PATCH)[0]
    return torch.atan2(m[1], m[0])


def _gather(img: torch.Tensor, r: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    H, W = img.shape
    return img[torch.clamp(r, 0, H - 1), torch.clamp(c, 0, W - 1)]


def steered_brief(gray: torch.Tensor, uv: torch.Tensor,
                  angle: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 descriptors: the 256 point pairs rotated by each
    keypoint's angle (computeOrbDescriptor's steering), rounded half to
    even, sampled, compared, and packed least significant bit first."""
    pat = torch.from_numpy(_PATTERN).to(device=gray.device,
                                        dtype=torch.float32)
    ca, sa = torch.cos(angle), torch.sin(angle)
    px, py = pat[..., 0], pat[..., 1]                       # (256, 2)
    rx = ca[:, None, None] * px - sa[:, None, None] * py    # (N, 256, 2)
    ry = sa[:, None, None] * px + ca[:, None, None] * py
    c = torch.round(uv[:, 0][:, None, None] + rx).to(torch.int64)
    r = torch.round(uv[:, 1][:, None, None] + ry).to(torch.int64)
    vals = _gather(gray.to(torch.float32), r, c)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int32)    # (N, 256)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=gray.device)
    return (bits.reshape(-1, 32, 8) * weights).sum(-1).to(torch.uint8)


def orb_extract(gray, *, n: int = 2000, n_levels: int = N_LEVELS,
                scale_factor: float = SCALE_FACTOR, threshold: int = 20,
                min_threshold: int = 7, device=None) -> OrbFeatures:
    """The ORB pipeline over a (H, W) grayscale image (a tensor or an
    array), on ``device`` (the card unless the caller asks for the CPU)."""
    gray = torch.as_tensor(gray, dtype=torch.float32,
                           device=resolve_device(device))
    H, W = gray.shape
    sizes = level_sizes(H, W, n_levels, scale_factor)
    budgets = features_per_level(n, n_levels, scale_factor)
    fields = [[] for _ in OrbFeatures._fields]
    for lv, ((lh, lw), n_lv) in enumerate(zip(sizes, budgets)):
        g = gray if lv == 0 else resize_linear(gray, lh, lw)
        uv, score, ok = detect_fast_features(
            g, n=n_lv, threshold=threshold, min_threshold=min_threshold)
        # the descriptors need the whole patch: drop the border
        ok = ok & (uv[:, 0] >= EDGE) & (uv[:, 0] < lw - EDGE) \
            & (uv[:, 1] >= EDGE) & (uv[:, 1] < lh - EDGE)
        a = _gather(orientation_map(g), uv[:, 1].to(torch.int64),
                    uv[:, 0].to(torch.int64))
        s = scale_factor ** lv
        level = (uv * s, torch.where(ok, score, torch.zeros_like(score)), a,
                 torch.full((n_lv,), lv, dtype=torch.int32,
                            device=gray.device),
                 torch.full((n_lv,), PATCH_SIZE * s, dtype=torch.float32,
                            device=gray.device),
                 steered_brief(g, uv, a), ok)
        for acc, v in zip(fields, level):
            acc.append(v)
    return OrbFeatures(*(torch.cat(acc) for acc in fields))


def hamming_distances(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N1, N2) int32 Hamming distances of two sets of uint8 descriptors."""
    x = torch.bitwise_xor(d1[:, None, :], d2[None, :, :])
    return POPCOUNT.to(x.device)[x.to(torch.int64)].sum(-1,
                                                        dtype=torch.int32)


def match_descriptors(d1: torch.Tensor, v1: torch.Tensor, d2: torch.Tensor,
                      v2: torch.Tensor, max_distance: int = 64,
                      ratio: float = 0.8, cross_check: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force Hamming matcher: for each row of d1 the nearest row of
    d2 (the first among equals), kept when within ``max_distance``, below
    ``ratio`` times the second nearest and, with ``cross_check``, nearest
    both ways. Returns (idx (N1,) int32 into d2, ok (N1,) bool)."""
    dist = hamming_distances(d1, d2)
    dist = torch.where(v1[:, None] & v2[None, :], dist,
                       torch.full_like(dist, NO_MATCH))
    idx = argsort(dist, dim=1)[:, 0]
    rows = torch.arange(d1.shape[0], device=dist.device)
    best = dist[rows, idx]
    second = dist.clone()
    second[rows, idx] = NO_MATCH
    second = second.min(dim=1).values
    ok = (best <= max_distance) & (best.to(torch.float32)
                                   < ratio * second.to(torch.float32))
    if cross_check:
        back = argsort(dist, dim=0)[0]
        ok = ok & (back[idx] == rows)
    return idx.to(torch.int32), ok
