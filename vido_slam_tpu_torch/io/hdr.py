"""Radiance HDR (RGBE) decoding without cv2 — what ``cv2.imread`` gives for
``.hdr`` files (OpenCV's ``grfmt_hdr.cpp`` on Bruce Walter's ``rgbe.cpp``),
bit for bit, for ``io/datasets.py``. PIL opens no HDR file.

The header is read as ``RGBE_ReadHeader`` reads it, line by line as
``fgets`` returns them (at most 127 bytes a line): lines up to the exact
line ``FORMAT=32-bit_rle_rgbe``, none of them empty, then any lines up to
an empty one, then ``-Y <height> +X <width>`` (the only orientation read;
any other, or another FORMAT, fails). The pixels: rows of new-style run-length encoding
(``2 2`` and the width, then each of the four channels as runs ``128 + n,
v`` and literals ``n, v...``) where the width is 8 to 32767, else flat
RGBE quadruples; a row that does not start so ends the encoding and the
rest is read flat. ``rgbe2float``: (R, G, B) x 2^(E - 136), 0 where E is 0,
stored B, G, R.

cv2's reads: ``IMREAD_ANYDEPTH`` gives the float gray of cvtColor's float
path (``gray_float``), ``IMREAD_COLOR`` the floats x 255 saturated to 8
bits (round half to even), and ``IMREAD_GRAYSCALE`` cvtColor's 8-bit gray
of that colour image (``gray_u8``: other weights than the readers' own
``bmp.to_gray``). A file cv2 fails on gives None.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from vido_slam_tpu_torch.io.limits import check_cv2_size
from vido_slam_tpu_torch.io.pxm import saturate_u8

SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
FORMAT_LINE = b"FORMAT=32-bit_rle_rgbe\n"


class CorruptHdr(ValueError):
    """The bytes are no Radiance file cv2 decodes."""


def fma32(x: np.ndarray, c: float, z: np.ndarray) -> np.ndarray:
    """float32 fused multiply-add ``x * c + z`` rounded once: the product
    of two float32 values is exact in float64; the sum's rounding error
    (TwoSum) breaks the ties that rounding float64 to float32 would
    otherwise take twice."""
    p = x.astype(np.float64) * np.float64(np.float32(c))
    z = z.astype(np.float64)
    s = p + z
    bp = s - p
    err = (p - (s - bp)) + (z - bp)
    f = s.astype(np.float32)
    # where s is a float32 midpoint and the exact sum lies off it, move s
    # by one float64 ulp toward the exact sum before rounding
    lo = np.nextafter(f, np.float32(-np.inf)).astype(np.float64)
    hi = np.nextafter(f, np.float32(np.inf)).astype(np.float64)
    f64 = f.astype(np.float64)
    tie = (err != 0) & ((s == (f64 + lo) / 2) | (s == (f64 + hi) / 2))
    if tie.any():
        nudged = np.nextafter(s, np.where(err > 0, np.inf, -np.inf))
        f = np.where(tie, nudged.astype(np.float32), f)
    return f.astype(np.float32)


def gray_float(bgr: np.ndarray) -> np.ndarray:
    """cvtColor(BGR2GRAY) of float32 (H, W, 3) BGR as cv2 5.0 on x86-64
    computes it, row by row: fma(R, 0.299, fma(B, 0.114, G x 0.587)) in
    float32, but for lanes 0 and 2 of the 4-wide step that follows the
    8-wide loop where 4 to 7 pixels of a row remain, which sum
    fma(R, 0.299, fma(G, 0.587, B x 0.114))."""
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    c = np.float32
    out = fma32(r, 0.299, fma32(b, 0.114, g * c(0.587)))
    W = bgr.shape[1]
    i = W - W % 8
    if W - i >= 4:
        cols = [i, i + 2]
        out[:, cols] = fma32(r[:, cols], 0.299,
                             fma32(g[:, cols], 0.587, b[:, cols] * c(0.114)))
    return out


def gray_u8(bgr: np.ndarray) -> np.ndarray:
    """cvtColor(BGR2GRAY) of uint8 (..., 3) BGR in cv2 5.0: 15-bit fixed
    point (3735, 19235, 9798 / 32768), rounded."""
    v = bgr.astype(np.int64)
    return ((v[..., 0] * 3735 + v[..., 1] * 19235 + v[..., 2] * 9798
             + (1 << 14)) >> 15).astype(np.uint8)


def _lines(data: bytes, pos: int):
    """``fgets`` over ``data`` from ``pos``: (line, next pos)."""
    end = data.find(b"\n", pos, pos + 127)
    stop = min(pos + 127, len(data)) if end < 0 else end + 1
    if stop <= pos:
        raise CorruptHdr("RGBE read error")
    return data[pos:stop], stop


def _header(data: bytes):
    line, pos = _lines(data, 0)
    while True:
        if line[:1] in (b"\x00", b"\n"):
            raise CorruptHdr("no FORMAT specifier found")
        if line == FORMAT_LINE:
            break
        line, pos = _lines(data, pos)
    while line != b"\n":             # the other lines up to a blank one
        line, pos = _lines(data, pos)
    line, pos = _lines(data, pos)
    m = re.match(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)", line)
    if not m:
        raise CorruptHdr("missing image size specifier")
    H, W = int(m.group(1)), int(m.group(2))
    if not (0 < W < 1 << 31 and 0 < H < 1 << 31):     # sscanf's "%d"
        raise CorruptHdr("image size")
    return W, H, pos


def read_rgbe(data: bytes) -> np.ndarray:
    """The file's (H, W, 4) RGBE bytes (raises CorruptHdr)."""
    W, H, pos = _header(data)
    n = W * H
    out = np.empty((n, 4), np.uint8)
    done = 0
    if 8 <= W <= 0x7FFF:
        view = memoryview(data)
        for _ in range(H):
            head = data[pos:pos + 4]
            if len(head) < 4:
                raise CorruptHdr("RGBE read error")
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                break                            # not encoded: flat
            if head[2] << 8 | head[3] != W:
                raise CorruptHdr("wrong scanline width")
            pos += 4
            row = bytearray(4 * W)
            k = 0
            for ch in range(4):
                end = (ch + 1) * W
                while k < end:
                    if pos + 2 > len(data):
                        raise CorruptHdr("RGBE read error")
                    count, v = data[pos], data[pos + 1]
                    pos += 2
                    if count > 128:
                        count -= 128
                        if count > end - k:
                            raise CorruptHdr("bad scanline data")
                        row[k:k + count] = bytes([v]) * count
                        k += count
                    else:
                        if count == 0 or count > end - k:
                            raise CorruptHdr("bad scanline data")
                        row[k] = v
                        rest = count - 1
                        if pos + rest > len(data):
                            raise CorruptHdr("RGBE read error")
                        row[k + 1:k + count] = view[pos:pos + rest]
                        pos += rest
                        k += count
            out[done:done + W] = np.frombuffer(bytes(row), np.uint8).reshape(
                4, W).T
            done += W
    rest = n - done
    flat = data[pos:pos + 4 * rest]
    if len(flat) < 4 * rest:
        raise CorruptHdr("RGBE read error")
    out[done:] = np.frombuffer(flat, np.uint8).reshape(rest, 4)
    return out.reshape(H, W, 4)


def rgbe_to_bgr(rgbe: np.ndarray) -> np.ndarray:
    """``rgbe2float``: float32 (H, W, 3) B, G, R."""
    e = rgbe[..., 3].astype(np.int64)
    f = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., 2::-1].astype(np.float32) * f[..., None]


def read_cv2(data: bytes, flags: int) -> Optional[np.ndarray]:
    """``cv2.imread`` of Radiance bytes under ``flags`` (1 colour, 0 gray,
    2 any depth); None where cv2 fails."""
    try:
        check_cv2_size(*_header(data)[:2])
        bgr = rgbe_to_bgr(read_rgbe(data))
    except CorruptHdr:
        return None
    if flags == 2:
        return gray_float(bgr)
    with np.errstate(over="ignore"):
        color = saturate_u8(bgr * np.float32(255))
    return color if flags == 1 else gray_u8(color)
