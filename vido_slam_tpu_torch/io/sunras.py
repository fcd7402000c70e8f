"""Sun raster decoding without cv2 or PIL — what ``cv2.imread`` (OpenCV's
``grfmt_sunras.cpp``) and PIL's ``Image.open(p).convert("RGB")``
(``SunImagePlugin``) give for ``.ras`` files, bit for bit, each by its own
rules, for ``io/datasets.py``.

The file: a big-endian 32-byte header (magic, width, height, depth,
length, type, map type, map length), an RMT_EQUAL_RGB colour map of R, G
and B planes, then rows padded to 16 bits; type 1 (standard) stores
24-bit pixels B, G, R and 32-bit ones X, B, G, R, type 3 R, G, B and
X, R, G, B, type 2 byte-encodes the rows (``0x80 n v``: n + 1 copies of v;
``0x80 0x00``: one 0x80).

cv2 reads types 0 and 1 only, depths 1, 8, 24 and 32, a colour map only
below 24 bits and only with a map length of at most 3 << depth: an index
past the map is black, a 1-bit file without a map is 0 black and 1
white; a gray read weighs the map's entries (``bmp.to_gray``) and is 0
everywhere where there is no map (cv2 never fills its gray table then),
and of 24- and 32-bit pixels it is the same fixed-point gray of B, G, R.
``IMREAD_ANYDEPTH`` reads as gray. PIL reads types 0-5 but 2 as raw rows
of 16-bit stride, type 2 by its run decoder over unpadded rows (runs
carry on into the next row), depths 1 (1 black, no map), 4, 8 (gray, or
a palette of the map's entries, missing ones black), 24 and 32 (the
fourth byte read as B, G, R, X in type 1, R, G, B, X in type 3; a map
beside 1, 24 or 32 bits fails). PIL tries its GIMP brush plugin first,
which takes a file of width 1 and length 1 or 4 (``pil_open`` names
it). A file cv2 fails on gives None from ``read_cv2``; one PIL's Sun
plugin fails on raises ``CorruptSunRaster`` from ``read_pil``.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from vido_slam_tpu_torch.io.bmp import to_gray
from vido_slam_tpu_torch.io.limits import check_cv2_size, check_pil_size

SIGNATURE = b"\x59\xa6\x6a\x95"


class CorruptSunRaster(ValueError):
    """The bytes are no Sun raster file the reader decodes."""


def _header(data: bytes):
    if len(data) < 32 or data[:4] != SIGNATURE:
        raise CorruptSunRaster("Sun raster header")
    return struct.unpack(">7i", data[4:32])


def _rows(data: bytes, offset: int, H: int, stride: int) -> np.ndarray:
    need = H * stride
    raw = data[offset:offset + need]
    if len(raw) < need:
        raise CorruptSunRaster("Sun raster data ends early")
    return np.frombuffer(raw, np.uint8).reshape(H, stride)


def read_cv2(data: bytes, flags: int) -> Optional[np.ndarray]:
    """``cv2.imread`` of Sun raster bytes: (H, W, 3) BGR for
    ``IMREAD_COLOR`` (1), else (H, W) gray; None where cv2 fails."""
    try:
        return _read_cv2(data, flags == 1)
    except CorruptSunRaster:
        return None


def _read_cv2(data: bytes, color: bool) -> np.ndarray:
    W, H, depth, _, kind, maptype, maplen = _header(data)
    pal_size = 3 << depth if 0 < depth <= 8 else 0
    ok = (W > 0 and H > 0 and depth in (1, 8, 24, 32) and kind in (0, 1)
          and (maptype == 0 and maplen == 0
               or maptype == 1 and 0 < maplen <= pal_size and depth <= 8))
    if not ok:
        raise CorruptSunRaster("Sun raster layout cv2 does not read")
    check_cv2_size(W, H)
    palette = np.zeros((256, 3), np.uint8)          # BGR
    gray_pal = np.zeros(256, np.uint8)
    if maplen:
        if 32 + maplen > len(data):
            raise CorruptSunRaster("Sun raster map ends early")
        n = maplen // 3
        planes = np.frombuffer(data[32:32 + 3 * n], np.uint8).reshape(3, n)
        palette[:n] = planes[::-1].T
        gray_pal = to_gray(palette)
    elif depth == 1:
        palette[1] = 255
    elif depth == 8:
        palette[:] = np.arange(256, dtype=np.uint8)[:, None]
    stride = ((W * depth + 7) // 8 + 1) & -2
    rows = _rows(data, 32 + maplen, H, stride)
    if depth <= 8:
        idx = (np.unpackbits(rows, axis=1)[:, :W] if depth == 1
               else rows[:, :W])
        return np.ascontiguousarray(palette[idx] if color else gray_pal[idx])
    n = depth // 8
    bgr = rows[:, :n * W].reshape(H, W, n)[..., n - 3:]
    return np.ascontiguousarray(bgr if color else to_gray(bgr))


def _rle_pil(data: bytes, offset: int, H: int, rowbytes: int) -> bytes:
    """PIL's SunRleDecode over rows of ``rowbytes`` (no padding): a run
    past a row's end carries on into the next rows."""
    out = bytearray()
    need = H * rowbytes
    pos = offset
    while len(out) < need:
        if pos >= len(data):
            raise CorruptSunRaster("Sun raster data ends early (PIL: image "
                                   "file is truncated)")
        b = data[pos]
        if b == 0x80:
            if pos + 1 >= len(data):
                raise CorruptSunRaster("Sun raster data ends early")
            n = data[pos + 1]
            if n == 0:
                out.append(0x80)
                pos += 2
            else:
                if pos + 2 >= len(data):
                    raise CorruptSunRaster("Sun raster data ends early")
                out += bytes([data[pos + 2]]) * (n + 1)
                pos += 3
        else:
            out.append(b)
            pos += 1
    return bytes(out[:need])


def read_pil(data: bytes) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of Sun raster bytes:
    (H, W, 3) RGB; CorruptSunRaster where PIL raises."""
    W, H, depth, length, kind, maptype, maplen = _header(data)
    if depth not in (1, 4, 8, 24, 32):
        raise CorruptSunRaster("Sun raster depth PIL does not read")
    palette = None
    if maplen:
        if maplen > 1024 or maptype != 1:
            raise CorruptSunRaster("Sun raster map PIL does not read")
        if depth not in (4, 8):
            raise CorruptSunRaster("PIL: unrecognized image mode")
        cmap = data[32:32 + maplen]
        n = len(cmap) // 3
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(cmap[:3 * n], np.uint8).reshape(3, n).T
        palette[:min(n, 256)] = entries[:256]
    if kind not in (0, 1, 2, 3, 4, 5):
        raise CorruptSunRaster("Sun raster type PIL does not read")
    if W <= 0 or H <= 0:
        raise CorruptSunRaster("Sun raster size")
    check_pil_size(W, H)
    offset = 32 + maplen
    rowbytes = (W * depth + 7) // 8
    if kind == 2:
        flat = _rle_pil(data, offset, H, rowbytes)
        rows = np.frombuffer(flat, np.uint8).reshape(H, rowbytes)
    else:
        stride = ((W * depth + 15) // 16) * 2
        if offset + (H - 1) * stride + rowbytes > len(data):
            raise CorruptSunRaster("Sun raster data ends early (PIL: image "
                                   "file is truncated)")
        raw = data[offset:offset + H * stride]
        raw += bytes(H * stride - len(raw))
        rows = np.frombuffer(raw, np.uint8).reshape(H, stride)
    if depth == 1:
        g = np.where(np.unpackbits(rows, axis=1)[:, :W], 0, 255).astype(
            np.uint8)
    elif depth == 4:
        nib = np.stack([rows >> 4, rows & 15], -1).reshape(H, -1)[:, :W]
        g = nib if palette is not None else (nib * 17).astype(np.uint8)
    elif depth == 8:
        g = rows[:, :W]
    else:
        n = depth // 8
        px = rows[:, :n * W].reshape(H, W, n)
        order = [0, 1, 2] if kind == 3 else [2, 1, 0]
        return np.ascontiguousarray(px[..., order])
    if palette is not None:
        return np.ascontiguousarray(palette[g])
    return np.ascontiguousarray(np.repeat(g[..., None], 3, -1))
