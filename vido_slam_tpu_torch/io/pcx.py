"""PCX decoding without PIL: ``Image.open(p).convert("RGB")`` of a
Paintbrush file (Pillow 12.1's ``PcxImagePlugin`` and ``PcxDecode.c``),
bit for bit. cv2 reads no PCX (``imread`` gives None).

The modes PIL opens (``pil_open._pcx`` holds its header tests): 1 bit in
one plane (black and white), 1 bit in 2 or 4 planes (indices into the
header's 16-entry palette, the planes of a row one after another), and,
for version 5, 8 bits in one plane (gray, or a palette of 256 entries in
the last 769 bytes behind a 0x0C marker unless that palette is the gray
ramp) or in three (R, G and B planes a row). A row's stride is
``(width * bits + 7) // 8``, made even where the header's bytes per line
differ from it.

PIL's run-length loop fills one row's planes at a time: a byte of the
form 11xxxxxx repeats the next byte xxxxxx times (a run may not leave
the row: "buffer overrun"), any other byte is itself. Where the planes
are padded (their stride is more than the width), PIL moves them
together before unpacking (``_compact``: for three 8-bit planes with the
plane count and stride taken by integer division of the row's bytes by
the width, which for rows of 3 or fewer pixels are other counts than the
real ones). The data runs to the end of the file, palette included. The
loop is host C++ (``csrc/pil_decode.cpp`` ``pcx_rle_decode``) with the
Python version beside it (``rle_plain``).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from vido_slam_tpu_torch.io.limits import check_pil_size
from vido_slam_tpu_torch.utils import host_build


class CorruptPcx(OSError):
    """Bytes PIL fails on."""


def _compact(row: bytearray, width: int, planes: int) -> bytearray:
    """PcxDecode.c's move of padded planes before the row is unpacked:
    for 2 and 4 one-bit planes, plane i from ``i * (size // planes)`` to
    ``i * ((width + 7) // 8)``; for the others, with ``bands = size //
    width`` and ``stride = size // bands``, plane i from ``i * stride`` to
    ``i * width``, where the stride is the longer."""
    size = len(row)
    if planes in (2, 4):
        xsize, bands, stride = (width + 7) // 8, planes, size // planes
    else:
        xsize, bands = width, size // width
        stride = size // bands if bands else 0
    if stride > xsize:
        for i in range(1, bands):
            row[i * xsize:(i + 1) * xsize] = row[i * stride:i * stride + xsize]
    return row


def rle_plain(data: bytes, pos: int, size: int, width: int, planes: int,
              rows: int) -> bytes:
    """``PcxDecode.c``: ``rows`` rows of ``size`` bytes (each compacted by
    ``_compact`` for a ``width``-pixel row of ``planes`` one-bit planes, or
    of other planes) from the bytes at ``pos``.
    Raises CorruptPcx."""
    out = bytearray()
    row = bytearray(size)
    x, n, overrun = 0, len(data), False
    for _ in range(rows):
        while x < size:
            if pos >= n:
                raise CorruptPcx("image file is truncated")
            b = data[pos]
            if b & 0xC0 == 0xC0:
                if pos + 1 >= n:
                    raise CorruptPcx("image file is truncated")
                count = b & 0x3F
                if x + count > size:
                    overrun = True
                    count = size - x
                row[x:x + count] = bytes([data[pos + 1]]) * count
                x += count
                pos += 2
            else:
                row[x] = b
                x += 1
                pos += 1
        out += _compact(row, width, planes)
        x = 0
    if overrun:
        raise CorruptPcx("buffer overrun when reading image file")
    return bytes(out)


def rle(data: bytes, pos: int, size: int, width: int, planes: int,
        rows: int, plain: bool = False) -> bytes:
    """``rle_plain`` by the host C++ loop (or by ``rle_plain``)."""
    if plain:
        return rle_plain(data, pos, size, width, planes, rows)
    out = np.zeros(size * rows, np.uint8)
    src = np.frombuffer(data, np.uint8)
    fn = host_build.load("pil_decode").pcx_rle_decode
    fn.restype = ctypes.c_int
    rc = fn(ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(data)),
            ctypes.c_int64(pos), ctypes.c_int64(size), ctypes.c_int64(width),
            int(planes), ctypes.c_int64(rows),
            ctypes.c_void_p(out.ctypes.data))
    if rc == -1:
        raise CorruptPcx("image file is truncated")
    if rc == -2:
        raise CorruptPcx("buffer overrun when reading image file")
    return out.tobytes()


def read_pil(data: bytes, plain: bool = False) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of PCX bytes: (H, W, 3)
    uint8 RGB. Raises where PIL raises (its header tests are
    ``pil_open._pcx``'s)."""
    x0, y0, x1, y1 = struct.unpack_from("<4H", data, 4)
    W, H = x1 + 1 - x0, y1 + 1 - y0
    version, bits, planes = data[1], data[3], data[65]
    provided = struct.unpack_from("<H", data, 66)[0]
    palette = None
    if bits == 1 and planes in (2, 4):
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(data[16:64], np.uint8).reshape(16, 3)
    elif bits == 8 and planes == 1:
        tail = data[-769:]
        if tail[0] == 12 and tail[1:] != bytes(np.arange(256, dtype=np.uint8)
                                               .repeat(3)):
            palette = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
    check_pil_size(W, H)
    stride = (W * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    size = planes * stride
    flat = rle(data, 128, size, W, planes if bits == 1 else 0, H, plain)
    rows = np.frombuffer(flat, np.uint8).reshape(H, size)
    if bits == 1 and planes == 1:
        bw = np.unpackbits(rows, axis=1)[:, :W]
        return np.ascontiguousarray(np.repeat(
            np.where(bw, 255, 0).astype(np.uint8)[..., None], 3, -1))
    if bits == 1:
        # P;{planes}L: bit x of plane p (planes (W + 7) // 8 bytes apart)
        # is bit p of the index
        s = (W + 7) // 8
        idx = np.zeros((H, W), np.uint8)
        for p in range(planes):
            plane = np.unpackbits(rows[:, p * s:(p + 1) * s], axis=1)[:, :W]
            idx |= plane << p
        return np.ascontiguousarray(palette[idx])
    if planes == 3:
        return np.ascontiguousarray(np.stack(
            [rows[:, c * W:(c + 1) * W] for c in range(3)], -1))
    px = rows[:, :W]
    if palette is not None:
        return np.ascontiguousarray(palette[px])
    return np.ascontiguousarray(np.repeat(px[..., None], 3, -1))
