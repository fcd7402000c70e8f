"""QOI decoding without PIL: ``Image.open(p).convert("RGB")`` of a Quite OK
Image (Pillow 12.1's ``QoiImagePlugin``, whose decoder is Python), bit
for bit. cv2 reads no QOI (``imread`` gives None).

The 14-byte header: ``qoif``, big-endian width and height, the channel
count (3 is RGB, any other value RGBA) and the colour space (unread).
The ops, each on the previous pixel (0, 0, 0, 255 at the start) and a
64-entry table keyed by (r * 3 + g * 5 + b * 7 + a * 11) % 64: RGB
(0xFE, the previous alpha kept), RGBA (0xFF), INDEX (00xxxxxx; an entry
never written is 0, 0, 0, 0), DIFF (01rrggbb, each -2..1), LUMA
(10gggggg then rrrrbbbb: green -32..31, red and blue -8..7 more than
green) and RUN (11xxxxxx, 1-62 repeats, which PIL also takes at 63 and 64:
it tests for RGB and RGBA first). Every op but RUN writes its pixel to the
table. Where PIL's decoder parts from the format: it decodes until it has
the image's samples, so a run may end past the last pixel (the rest is
dropped) and the 8-byte end marker is never read; running out of bytes
raises (IndexError, or ValueError for a short RGB or RGBA op). The op loop
is host C++ (``csrc/pil_decode.cpp`` ``qoi_decode``) with the Python
version beside it (``decode_plain``).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from vido_slam_tpu_torch.io.limits import check_pil_size
from vido_slam_tpu_torch.utils import host_build


class CorruptQoi(ValueError):
    """Bytes PIL's decoder fails on."""


def decode_plain(data: bytes, W: int, H: int, bands: int) -> bytes:
    """``QoiDecoder.decode``: the first W * H * bands samples (RGB or RGBA)
    of the ops from byte 14. Raises CorruptQoi."""
    seen = {}
    prev = (0, 0, 0, 255)
    out = bytearray()
    need = W * H * bands
    pos, n = 14, len(data)
    while len(out) < need:
        if pos >= n:
            raise CorruptQoi("the data ends before the image (IndexError)")
        b = data[pos]
        pos += 1
        if b == 0xFE:
            if pos + 3 > n:
                raise CorruptQoi("a cut RGB op")
            value = tuple(data[pos:pos + 3]) + prev[3:]
            pos += 3
        elif b == 0xFF:
            if pos + 4 > n:
                raise CorruptQoi("a cut RGBA op")
            value = tuple(data[pos:pos + 4])
            pos += 4
        elif b >> 6 == 0:
            value = seen.get(b & 0x3F, (0, 0, 0, 0))
        elif b >> 6 == 1:
            value = ((prev[0] + ((b >> 4) & 3) - 2) % 256,
                     (prev[1] + ((b >> 2) & 3) - 2) % 256,
                     (prev[2] + (b & 3) - 2) % 256, prev[3])
        elif b >> 6 == 2:
            if pos >= n:
                raise CorruptQoi("a cut LUMA op (IndexError)")
            second = data[pos]
            pos += 1
            dg = (b & 0x3F) - 32
            value = ((prev[0] + dg + (second >> 4) - 8) % 256,
                     (prev[1] + dg) % 256,
                     (prev[2] + dg + (second & 15) - 8) % 256, prev[3])
        else:
            out += bytes(prev[:bands]) * ((b & 0x3F) + 1)
            continue
        prev = value
        r, g, bl, a = value
        seen[(r * 3 + g * 5 + bl * 7 + a * 11) % 64] = value
        out += bytes(value[:bands])
    return bytes(out[:need])


def decode(data: bytes, W: int, H: int, bands: int, plain: bool = False
           ) -> bytes:
    """``decode_plain`` by the host C++ loop (or by ``decode_plain``)."""
    if plain:
        return decode_plain(data, W, H, bands)
    out = np.zeros(W * H * bands, np.uint8)
    src = np.frombuffer(data, np.uint8)
    fn = host_build.load("pil_decode").qoi_decode
    fn.restype = ctypes.c_int
    rc = fn(ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(data)),
            ctypes.c_int64(W * H), bands, ctypes.c_void_p(out.ctypes.data))
    if rc != 0:
        raise CorruptQoi("the data ends before the image")
    return out.tobytes()


def read_pil(data: bytes, plain: bool = False) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of QOI bytes: (H, W, 3)
    uint8 RGB. Raises where PIL raises (its header tests are
    ``pil_open._qoi``'s)."""
    W, H = struct.unpack_from(">II", data, 4)
    check_pil_size(W, H)
    bands = 3 if data[12] == 3 else 4
    px = np.frombuffer(decode(data, W, H, bands, plain), np.uint8)
    return np.ascontiguousarray(px.reshape(H, W, bands)[..., :3])
