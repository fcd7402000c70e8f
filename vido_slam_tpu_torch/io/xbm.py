"""X11 bitmap decoding without PIL: ``Image.open(p).convert("RGB")`` of an
XBM file (Pillow 12.1's ``XbmImagePlugin`` and ``XbmDecode.c``), bit for
bit. cv2 reads no XBM (``imread`` gives None).

The header is PIL's regular expression over the first 512 bytes
(``pil_open.xbm_header``: the ``_width`` and ``_height`` defines, an
optional hotspot pair, anything up to ``_bits[]``). From there the
decoder skips to each ``x`` and takes the two characters after it as a
hex byte (a character that is no hex digit counts 0), then skips on from
the third: ``(width + 7) // 8`` bytes a row, least significant bit
first, a set bit white (PIL's mode ``1``, unlike X11's convention).
Bytes that end before the last row raise ("image file is truncated").
The scan is host C++ (``csrc/pil_decode.cpp`` ``xbm_decode``) with the
Python version beside it (``hex_plain``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from vido_slam_tpu_torch.io import pil_open
from vido_slam_tpu_torch.io.limits import check_pil_size
from vido_slam_tpu_torch.utils import host_build


class CorruptXbm(OSError):
    """Bytes PIL fails on ("image file is truncated")."""


def _hex(c: int) -> int:
    if 48 <= c <= 57:
        return c - 48
    if 97 <= c <= 102:
        return c - 87
    if 65 <= c <= 70:
        return c - 55
    return 0


def hex_plain(data: bytes, pos: int, count: int) -> bytes:
    """``XbmDecode.c``: ``count`` bytes, each from the two characters after
    an ``x`` at or after ``pos``. Raises CorruptXbm."""
    out = bytearray()
    n = len(data)
    while len(out) < count:
        pos = data.find(b"x", pos)
        if pos < 0 or n - pos < 3:
            raise CorruptXbm("image file is truncated")
        out.append(_hex(data[pos + 1]) << 4 | _hex(data[pos + 2]))
        pos += 3
    return bytes(out)


def hex_bytes(data: bytes, pos: int, count: int, plain: bool = False
              ) -> bytes:
    """``hex_plain`` by the host C++ scan (or by ``hex_plain``)."""
    if plain:
        return hex_plain(data, pos, count)
    out = np.zeros(count, np.uint8)
    src = np.frombuffer(data, np.uint8)
    fn = host_build.load("pil_decode").xbm_decode
    fn.restype = ctypes.c_int
    rc = fn(ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(data)),
            ctypes.c_int64(pos), ctypes.c_int64(count),
            ctypes.c_void_p(out.ctypes.data))
    if rc != 0:
        raise CorruptXbm("image file is truncated")
    return out.tobytes()


def read_pil(data: bytes, plain: bool = False) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of XBM bytes: (H, W, 3)
    uint8, white where a bit is set."""
    W, H, pos = pil_open.xbm_header(data)
    check_pil_size(W, H)
    row = (W + 7) // 8
    raw = np.frombuffer(hex_bytes(data, pos, row * H, plain), np.uint8)
    bits = np.unpackbits(raw.reshape(H, row), axis=1,
                         bitorder="little")[:, :W]
    return np.ascontiguousarray(np.repeat(
        np.where(bits, 255, 0).astype(np.uint8)[..., None], 3, -1))
