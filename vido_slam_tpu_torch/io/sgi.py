"""SGI image decoding without PIL: ``Image.open(p).convert("RGB")`` of an
SGI file (Pillow 12.1's ``SgiImagePlugin`` and ``SgiRleDecode.c``), bit
for bit. cv2 reads no SGI (``imread`` gives None).

The 512-byte header (magic 474) gives the compression (0 verbatim, 1
run-length), bytes a channel (1 or 2, big-endian), the dimension and the
channel count; PIL opens gray (1 channel), RGB (3) and RGBA (4)
(``pil_open.SGI_MODES``). Rows run bottom-up, each channel a plane. A
2-byte channel keeps its high byte; alpha is dropped. A verbatim file
whose compression byte is neither 0 nor 1 has no tile, which PIL cannot
load.

A run-length file holds a table of row starts and one of row lengths
(big-endian, a row a channel, channel-major), then the rows' packets: a
count byte (or, at 2 bytes a channel, the low byte of a count word) of n
= count & 0x7F, n literal samples after it where count & 0x80, else one
sample repeated n times; n = 0 ends the row. Where PIL parts from the
format: a row's table length counts its packets, not its bytes (the last
packet it allows must be the end, or PIL stops decoding and keeps what
it has, without an error); a row whose packets end before its width
keeps the previous row's samples past them (the row buffer is not
cleared); a length of 2^31 or more is negative, no packet; a row start
before the tables' end is read from the header; a packet past the row's
width, or a literal reaching the last byte of the file, is an overrun.
The packet loop is host C++ (``csrc/pil_decode.cpp`` ``sgi_rle_decode``)
with the Python version beside it (``rle_plain``).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from vido_slam_tpu_torch.io.limits import check_pil_size
from vido_slam_tpu_torch.utils import host_build

HEADER = 512


class CorruptSgi(OSError):
    """Bytes PIL fails on."""


def _expand(buf: bytearray, dest: int, src: bytes, s: int, n: int, z: int,
            width: int, bpc: int) -> int:
    """``expandrow``/``expandrow2``: a row's packets from ``src[s]`` into
    every ``z``-th sample of ``buf`` from ``dest``; 0 at the row's end, 1
    where PIL stops decoding, -1 on an overrun."""
    end = len(src) - 1
    x = 0
    for k in range(n, 0, -1):
        if s + bpc - 1 > end:
            return -1
        pixel = src[s + bpc - 1]
        s += bpc
        if k == 1 and pixel != 0:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > width:
            return -1
        x += count
        if pixel & 0x80:
            if s + bpc * count > end:
                return -1
            for _ in range(count):
                buf[dest:dest + bpc] = src[s:s + bpc]
                s += bpc
                dest += z * bpc
        else:
            if s + bpc > end if bpc == 2 else s > end:
                return -1
            v = src[s:s + bpc]
            for _ in range(count):
                buf[dest:dest + bpc] = v
                dest += z * bpc
            s += bpc
    return 0


def rle_plain(data: bytes, width: int, height: int, z: int, bpc: int
              ) -> bytes:
    """``SgiRleDecode.c``: (height, width * z * bpc) interleaved samples,
    rows in file order (bottom first). Raises CorruptSgi."""
    need = HEADER + 8 * height * z
    if len(data) < need:
        raise CorruptSgi("image file is truncated")
    starts = struct.unpack_from(f">{height * z}I", data, HEADER)
    lengths = struct.unpack_from(f">{height * z}I", data,
                                 HEADER + 4 * height * z)
    src = data[HEADER:]
    row = bytearray(width * z * bpc)
    out = bytearray(len(row) * height)
    for y in range(height):
        for c in range(z):
            off, n = starts[y + c * height], lengths[y + c * height]
            if off < HEADER:
                raise CorruptSgi("buffer overrun when reading image file")
            n = n - (1 << 32) if n >= 1 << 31 else n    # a C int
            status = _expand(row, c * bpc, src, off - HEADER, n, z, width,
                             bpc)
            if status == -1:
                raise CorruptSgi("buffer overrun when reading image file")
            if status == 1:
                return bytes(out)
        out[y * len(row):(y + 1) * len(row)] = row
    return bytes(out)


def rle(data: bytes, width: int, height: int, z: int, bpc: int,
        plain: bool = False) -> bytes:
    """``rle_plain`` by the host C++ loop (or by ``rle_plain``)."""
    if plain:
        return rle_plain(data, width, height, z, bpc)
    out = np.zeros(width * z * bpc * height, np.uint8)
    src = np.frombuffer(data, np.uint8)
    fn = host_build.load("pil_decode").sgi_rle_decode
    fn.restype = ctypes.c_int
    rc = fn(ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(data)),
            ctypes.c_int64(width), ctypes.c_int64(height), z, bpc,
            ctypes.c_void_p(out.ctypes.data))
    if rc == -1:
        raise CorruptSgi("image file is truncated")
    if rc == -2:
        raise CorruptSgi("buffer overrun when reading image file")
    return out.tobytes()


def read_pil(data: bytes, plain: bool = False) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of SGI bytes: (H, W, 3)
    uint8 RGB. Raises where PIL raises (its header tests are
    ``pil_open._sgi``'s)."""
    compression, bpc = data[2], data[3]
    W, H, z = struct.unpack_from(">HHH", data, 6)
    check_pil_size(W, H)
    if compression == 1:
        flat = rle(data, W, H, z, bpc, plain)
        px = np.frombuffer(flat, np.uint8).reshape(H, W, z, bpc)[..., 0]
    elif compression == 0:
        page = W * H * bpc
        if bpc == 2:
            # SGI16Decoder reads each band's page whole, short or not
            planes = [data[HEADER + 2 * k * W * H:HEADER + 2 * (k + 1) * W * H]
                      for k in range(z)]
            if any(len(p) < page for p in planes):
                raise CorruptSgi("not enough image data")
        else:
            planes = [data[HEADER + k * page:HEADER + (k + 1) * page]
                      for k in range(z)]
            if any(len(p) < page for p in planes):
                raise CorruptSgi("image file is truncated")
        px = np.stack([np.frombuffer(p, np.uint8).reshape(H, W, bpc)[..., 0]
                       for p in planes], -1)
    else:
        raise CorruptSgi("cannot load this image")
    px = px[::-1, :, :3]
    if px.shape[-1] == 1:
        px = np.repeat(px, 3, -1)
    return np.ascontiguousarray(px)
