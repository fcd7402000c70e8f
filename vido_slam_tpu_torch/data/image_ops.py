"""Host image operations of the data pipelines without PIL or matplotlib,
which the card's machine lacks, each bit-equal to the call it replaces:

  - ``resize_lanczos_u8``: ``PIL.Image.resize((w, h), Image.LANCZOS)`` of
    8-bit RGB, PIL's ``libImaging/Resample.c`` step for step (fixed-point
    weights, a horizontal pass into an 8-bit image, then a vertical pass);
  - ``rgb_to_hsv`` / ``hsv_to_rgb``: matplotlib 3.10's ``matplotlib.colors``
    functions, the same numpy code (float32 in, float32 arithmetic).

The JAX package calls them through PIL and matplotlib at
``data/mono_dataset.py:59-69`` and ``:86-91``.
"""

from __future__ import annotations

import math

import numpy as np

LANCZOS_SUPPORT = 3.0
PRECISION_BITS = 32 - 8 - 2   # Resample.c: 22 bits of weight precision


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    """Resample.c's ``lanczos_filter``: the sinc truncated at +-3."""
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _coefficients(in_size: int, out_size: int):
    """Resample.c's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for
    the box (0, in_size): each output pixel's first source pixel and its
    (out_size, ksize) int64 fixed-point weights, zero past its window."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        # C's (int) truncates toward zero
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        first[xx] = xmin
        weights[xx, :xmax] = k
    scaled = weights * (1 << PRECISION_BITS)
    fixed = np.where(weights < 0, np.trunc(-0.5 + scaled),
                     np.trunc(0.5 + scaled)).astype(np.int64)
    return first, fixed


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of Resample.c along ``axis`` (1: horizontal, 0:
    vertical): the accumulator starts at one half, each output is
    ``clip8(acc >> 22)``. Every partial sum stays below 255 x 1.3 x 2^22 in
    magnitude, so int32 holds it, as it does in C."""
    first, fixed = _coefficients(img.shape[axis], out_size)
    n = img.shape[axis]
    src = img.astype(np.int32)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int32)
    for x in range(fixed.shape[1]):
        idx = np.minimum(first + x, n - 1)
        acc += np.take(src, idx, axis=axis) \
            * fixed[:, x].astype(np.int32).reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_lanczos_u8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize((w, h), Image.LANCZOS))``
    for an (H, W, 3) uint8 image: (h, w, 3) uint8, bit-equal to PIL. A pass
    whose size does not change is skipped, as PIL skips it."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_lanczos_u8 takes (H, W, C) uint8, got "
                         f"{img.dtype} {img.shape}")
    out = img
    if w != img.shape[1]:
        out = _pass(out, w, 1)
    if h != img.shape[0]:
        out = _pass(out, h, 0)
    return np.ascontiguousarray(out)


def _float_array(arr):
    """matplotlib's input cast: ints promoted to float32, at least 2-D."""
    arr = np.asarray(arr)
    if arr.shape[-1] != 3:
        raise ValueError("Last dimension of input array must be 3; "
                         f"shape {arr.shape} was found.")
    return np.atleast_2d(
        arr.astype(np.promote_types(arr.dtype, np.float32), copy=False))


def rgb_to_hsv(arr) -> np.ndarray:
    """``matplotlib.colors.rgb_to_hsv``: (..., 3) RGB in [0, 1] -> HSV in
    [0, 1]."""
    in_shape = np.shape(arr)
    arr = _float_array(arr)
    out = np.zeros_like(arr)
    arr_max = arr.max(-1)
    if np.any(arr_max > 1):
        raise ValueError("Input array must be in the range [0, 1]. "
                         f"Found a maximum value of {arr_max.max()}")
    if arr.min() < 0:
        raise ValueError("Input array must be in the range [0, 1]. "
                         f"Found a minimum value of {arr.min()}")
    ipos = arr_max > 0
    delta = np.ptp(arr, -1)
    s = np.zeros_like(delta)
    s[ipos] = delta[ipos] / arr_max[ipos]
    ipos = delta > 0
    # red is max
    idx = (arr[..., 0] == arr_max) & ipos
    out[idx, 0] = (arr[idx, 1] - arr[idx, 2]) / delta[idx]
    # green is max
    idx = (arr[..., 1] == arr_max) & ipos
    out[idx, 0] = 2. + (arr[idx, 2] - arr[idx, 0]) / delta[idx]
    # blue is max
    idx = (arr[..., 2] == arr_max) & ipos
    out[idx, 0] = 4. + (arr[idx, 0] - arr[idx, 1]) / delta[idx]
    out[..., 0] = (out[..., 0] / 6.0) % 1.0
    out[..., 1] = s
    out[..., 2] = arr_max
    return out.reshape(in_shape)


def hsv_to_rgb(hsv) -> np.ndarray:
    """``matplotlib.colors.hsv_to_rgb``: (..., 3) HSV in [0, 1] -> RGB."""
    in_shape = np.shape(hsv)
    hsv = _float_array(hsv)
    h = hsv[..., 0]
    s = hsv[..., 1]
    v = hsv[..., 2]
    r = np.empty_like(h)
    g = np.empty_like(h)
    b = np.empty_like(h)
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # the six hue sectors: (r, g, b) from (v, t, p), (q, v, p), ...
    for sector, (rs, gs, bs) in enumerate(((v, t, p), (q, v, p), (p, v, t),
                                           (p, q, v), (t, p, v), (v, p, q))):
        idx = (i % 6 == 0) if sector == 0 else (i == sector)
        r[idx] = rs[idx]
        g[idx] = gs[idx]
        b[idx] = bs[idx]
    idx = s == 0
    r[idx] = v[idx]
    g[idx] = v[idx]
    b[idx] = v[idx]
    return np.stack([r, g, b], axis=-1).reshape(in_shape)
