"""Windows icon decoding without PIL: ``Image.open(p).convert("RGB")`` of
an ICO file (Pillow 12.1's ``IcoImagePlugin``), bit for bit. cv2 reads no
ICO (``imread`` gives None).

The directory (``00 00 01 00``, an entry count, 16 bytes an entry: width
and height with 0 for 256, colour count, planes, bits a pixel, data size
and offset) names the images; PIL opens the one first when the entries
are sorted by colour depth (the bits a pixel, else log2 of the colour
count rounded up, else 256) and then, stably, by area, largest first.
That entry's data is a PNG (its own signature; ``png.read_pil`` from the
entry's offset to the end of the file) or a BMP without its file header
(``bmp.read_pil_dib(icon=True)``: the colour bitmap at half the height
its header declares). PIL also reads the entry's AND mask as alpha, which
``convert("RGB")`` drops, but it fails where the mask is short (for a
32-bit entry the alpha of the colour bitmap instead; "not enough image
data", "buffer is not large enough") or starts before the file (a
negative seek), so the port checks the same bytes. A size in the
directory that differs from the image's is PIL's warning, not an error:
the image is read at its own size.
"""

from __future__ import annotations

import math
import struct
from typing import NamedTuple

import numpy as np

from vido_slam_tpu_torch.io import bmp, png


class CorruptIco(OSError):
    """Bytes PIL fails on."""


class Entry(NamedTuple):
    width: int
    height: int
    bpp: int
    size: int
    offset: int
    depth: int


def entries(data: bytes):
    """``IcoFile``'s directory in PIL's order (the entry it opens first)."""
    n = struct.unpack_from("<H", data, 4)[0]
    out = []
    for i in range(n):
        s = data[6 + 16 * i:6 + 16 * (i + 1)]
        width, height, colors = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) \
            or 256
        out.append(Entry(width, height, bpp, size, offset, depth))
    out.sort(key=lambda e: e.depth)
    out.sort(key=lambda e: e.width * e.height, reverse=True)
    return out


def _mask_bytes(data: bytes, entry: Entry, dib_offset: int, W: int, H: int
                ) -> None:
    """The bytes ``IcoFile.frame`` reads for the alpha mask, checked as
    its ``Image.frombuffer`` checks them."""
    if entry.bpp == 32:
        alpha = data[dib_offset:dib_offset + 4 * W * H][3::4]
        if len(alpha) < W * H:
            raise CorruptIco("buffer is not large enough")
        return
    w = W + (32 - W % 32) % 32
    total = int(w * H / 8)
    start = entry.offset + entry.size - total
    if start < 0:
        raise CorruptIco("Invalid argument (a seek before the file)")
    got = len(data[start:start + total])
    if got < (H - 1) * (w // 8) + (W + 7) // 8:
        raise CorruptIco("not enough image data")


def read_pil(data: bytes) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of ICO bytes: (H, W, 3)
    uint8 RGB of the entry PIL opens. Raises where PIL raises."""
    entry = entries(data)[0]
    at = data[entry.offset:]
    if at[:8] == png.SIGNATURE:
        return png.read_pil(at)
    img, offset = bmp.read_pil_dib(data, entry.offset, icon=True)
    H, W = img.shape[:2]
    _mask_bytes(data, entry, offset, W, H)
    return img
