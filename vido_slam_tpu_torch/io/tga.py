"""Targa decoding without PIL: ``Image.open(p).convert("RGB")`` of a TGA
file (Pillow 12.1's ``TgaImagePlugin`` and ``TgaRleDecode.c``), bit for
bit. cv2 reads no Targa (``imread`` gives None).

The header (``pil_open.tga_header``) picks the mode by image type and
depth: colour-mapped (types 1 and 9, 8-bit indices into a map of 16- or
24-bit entries, the map's first ``start`` entries black), true colour (2
and 10: 16-bit 5-5-5 scaled by v * 255 // 31, 24-bit BGR, 32-bit BGRA)
and gray (3 and 11: 1-bit, 8-bit, 16-bit gray and alpha; a gray file with
a map is read through it); types 9-11 are run-length coded. Alpha is
dropped. Rows run bottom-up unless bit 0x20 of the descriptor is set; bit
0x10 mirrors the columns.

PIL's run-length decoder works on a row's bytes: a literal packet may
run on into the next rows (and past the image's end, where the rest is
left unread), a run may not leave its row ("buffer overrun"); a packet
must be whole in the file before it is taken ("image file is
truncated"). A 1-bit file has no run-length form PIL decodes (its
packets carry no bytes). The combinations PIL has no raw mode for
(indices that are not 8 bits, a map of 32-bit entries, a map with true
colour or 1-bit gray, indices without a map, true colour of 8 bits, gray
of 24 or 32) raise, as PIL does when it loads them; so does a map of
more than 256 entries. The packet loop is host C++
(``csrc/pil_decode.cpp`` ``tga_rle_decode``) with the Python version
beside it (``rle_plain``).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from vido_slam_tpu_torch.io import pil_open
from vido_slam_tpu_torch.io.limits import check_pil_size
from vido_slam_tpu_torch.utils import host_build


class CorruptTga(OSError):
    """Bytes PIL fails on: "image file is truncated", "buffer overrun",
    "cannot load this image" and the palette and raw mode errors."""


def scale5(v: np.ndarray) -> np.ndarray:
    """Pillow's 5-bit to 8-bit widening (Unpack.c): v * 255 // 31."""
    return (v.astype(np.int64) * 255 // 31).astype(np.uint8)


def bgr15(words: np.ndarray) -> np.ndarray:
    """(..., 3) RGB of little-endian 1-5-5-5 words (``BGRA;15Z``)."""
    w = words.astype(np.int64)
    return np.stack([scale5((w >> 10) & 31), scale5((w >> 5) & 31),
                     scale5(w & 31)], -1)


def rle_plain(data: bytes, pos: int, pixel: int, row: int, rows: int
              ) -> bytes:
    """``TgaRleDecode.c``: ``rows`` rows of ``row`` bytes from the packets
    at ``pos``, ``pixel`` bytes a pixel. Raises CorruptTga."""
    out = bytearray()
    x, n = 0, len(data)
    total = row * rows
    while len(out) < total:
        if pos >= n:
            raise CorruptTga("image file is truncated")
        head = data[pos]
        count = pixel * ((head & 0x7F) + 1)
        if head & 0x80:
            if n - pos < 1 + pixel:
                raise CorruptTga("image file is truncated")
            if x + count > row:
                raise CorruptTga("buffer overrun when reading image file")
            out += data[pos + 1:pos + 1 + pixel] * (count // max(pixel, 1))
            pos += 1 + pixel
            x = (x + count) % row
            continue
        if n - pos < 1 + count:
            raise CorruptTga("image file is truncated")
        take = data[pos + 1:pos + 1 + count][:total - len(out)]
        out += take
        x = (x + len(take)) % row
        pos += 1 + count
    return bytes(out)


def rle(data: bytes, pos: int, pixel: int, row: int, rows: int,
        plain: bool = False) -> bytes:
    """``rle_plain`` by the host C++ loop (or by ``rle_plain``)."""
    if plain:
        return rle_plain(data, pos, pixel, row, rows)
    out = np.zeros(row * rows, np.uint8)
    src = np.frombuffer(data, np.uint8)
    fn = host_build.load("pil_decode").tga_rle_decode
    fn.restype = ctypes.c_int
    rc = fn(ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(data)),
            ctypes.c_int64(pos), pixel, ctypes.c_int64(row),
            ctypes.c_int64(rows), ctypes.c_void_p(out.ctypes.data))
    if rc == -1:
        raise CorruptTga("image file is truncated")
    if rc == -2:
        raise CorruptTga("buffer overrun when reading image file")
    return out.tobytes()


def read_pil(data: bytes, plain: bool = False) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of TGA bytes: (H, W, 3)
    uint8 RGB. Raises where PIL raises."""
    id_len, cmt, kind, W, H, depth, flags = pil_open.tga_header(data)
    check_pil_size(W, H)
    pos = 18 + id_len
    palette = None
    if cmt:
        start, size, mapdepth = struct.unpack_from("<HHB", data, 3)
        nb = mapdepth // 8
        entries = data[pos:pos + nb * size]
        pos += nb * size
        if start + len(entries) // nb > 256:
            raise CorruptTga("invalid palette size")
        raw = bytes(nb * start) + entries
        n = len(raw) // nb
        palette = np.zeros((256, 3), np.uint8)
        if nb == 2:
            palette[:n] = bgr15(np.frombuffer(raw[:2 * n], "<u2"))
        else:
            palette[:n] = np.frombuffer(raw[:nb * n], np.uint8).reshape(
                n, nb)[:, 2::-1]
    base = kind & 7
    if palette is not None and (mapdepth == 32 or base == 2 or depth == 1):
        # PIL has no raw mode for a BGRA map, and no palette for true
        # colour or 1-bit pixels
        raise CorruptTga("unrecognized raw mode or image mode")
    if base == 1:
        if depth != 8:
            raise CorruptTga("cannot load this image")
        if not cmt:
            raise CorruptTga("unknown raw mode for given image mode")
    elif (base, depth) not in ((2, 16), (2, 24), (2, 32), (3, 1), (3, 8),
                               (3, 16)):
        raise CorruptTga("cannot load this image")
    row = (W * depth + 7) // 8
    if kind & 8:
        if depth == 1:
            raise CorruptTga("image file is truncated")
        flat = rle(data, pos, depth // 8, row, H, plain)
    else:
        flat = data[pos:pos + row * H]
        if len(flat) < row * H:
            raise CorruptTga("image file is truncated")
    rows = np.frombuffer(flat, np.uint8).reshape(H, row)
    if base == 2:
        if depth == 16:
            img = bgr15(rows.copy().view("<u2"))
        else:
            img = rows.reshape(H, W, depth // 8)[..., 2::-1]
    elif depth == 1:
        img = np.where(np.unpackbits(rows, axis=1)[:, :W, None], 255,
                       0).astype(np.uint8).repeat(3, -1)
    else:
        # gray (or indices): the first byte of each pixel, through the
        # map where there is one
        gray = rows.reshape(H, W, depth // 8)[..., 0]
        img = palette[gray] if palette is not None else np.repeat(
            gray[..., None], 3, -1)
    if not flags & 0x20:
        img = img[::-1]
    if flags & 0x10:
        img = img[:, ::-1]
    return np.ascontiguousarray(img)
