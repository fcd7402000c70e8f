"""Windows Paint (MSP) decoding without PIL: ``Image.open(p).convert("RGB")``
of an MSP file (Pillow 12.1's ``MspImagePlugin``), bit for bit. cv2 reads
no MSP (``imread`` gives None).

The 32-byte header (``DanM`` or ``LinS``, sixteen little-endian words
whose XOR is 0, the width and height at words 2 and 3) is
``pil_open._msp``'s. Both versions are 1-bit, rows of ``(width + 7) //
8`` bytes, a set bit white. Version 1 (``DanM``) holds the rows raw from
byte 32. Version 2 (``LinS``) holds a row map (a word a row: the row's
byte count) and then PIL's Python decoder's run-length rows: a count byte
0 then (n, v) is v n times, any other count n is n literal bytes; a row
of count 0 is white. PIL joins the decoded rows into one stream whatever
their lengths (a row decoded short or long shifts the rows after it) and
raises where the stream is shorter than the image ("not enough image
data"), where the map or a row is cut, and where a run lacks its two
bytes. The row loop is host C++ (``csrc/pil_decode.cpp``
``msp_rle_decode``) with the Python version beside it (``rle_plain``).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from vido_slam_tpu_torch.io.limits import check_pil_size
from vido_slam_tpu_torch.utils import host_build


class CorruptMsp(OSError):
    """Bytes PIL fails on."""


def rle_plain(data: bytes, W: int, H: int) -> bytes:
    """``MspDecoder.decode``: the decoded rows of a version 2 file, joined
    (at least the image's bytes; raises CorruptMsp)."""
    if len(data) < 32 + 2 * H:
        raise CorruptMsp("Truncated MSP file in row map")
    rowmap = struct.unpack_from(f"<{H}H", data, 32)
    blank = b"\xff" * ((W + 7) // 8)
    out = bytearray()
    pos = 32 + 2 * H
    for y, length in enumerate(rowmap):
        if length == 0:
            out += blank
            continue
        row = data[pos:pos + length]
        pos += length
        if len(row) != length:
            raise CorruptMsp(f"Truncated MSP file, expected {length} bytes "
                             f"on row {y}")
        i = 0
        while i < length:
            kind = row[i]
            i += 1
            if kind == 0:
                if i + 2 > length:
                    raise CorruptMsp(f"Corrupted MSP file in row {y}")
                out += row[i + 1:i + 2] * row[i]
                i += 2
            else:
                out += row[i:i + kind]
                i += kind
    if len(out) < ((W + 7) // 8) * H:
        raise CorruptMsp("not enough image data")
    return bytes(out)


def rle(data: bytes, W: int, H: int, plain: bool = False) -> bytes:
    """``rle_plain``'s first ``(W + 7) // 8 * H`` bytes by the host C++
    loop (or by ``rle_plain``)."""
    need = ((W + 7) // 8) * H
    if plain:
        return rle_plain(data, W, H)[:need]
    out = np.zeros(need, np.uint8)
    src = np.frombuffer(data, np.uint8)
    fn = host_build.load("pil_decode").msp_rle_decode
    fn.restype = ctypes.c_int
    rc = fn(ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(data)),
            ctypes.c_int64(W), ctypes.c_int64(H),
            ctypes.c_void_p(out.ctypes.data))
    if rc != 0:
        raise CorruptMsp({-1: "Truncated MSP file in row map",
                          -2: "Truncated MSP file",
                          -3: "Corrupted MSP file",
                          -4: "not enough image data"}.get(rc, "MSP"))
    return out.tobytes()


def read_pil(data: bytes, plain: bool = False) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of MSP bytes: (H, W, 3)
    uint8, white where a bit is set."""
    W, H = struct.unpack_from("<HH", data, 4)
    check_pil_size(W, H)
    row = (W + 7) // 8
    if data[:4] == b"DanM":
        raw = data[32:32 + row * H]
        if len(raw) < row * H:
            raise CorruptMsp("image file is truncated")
    else:
        raw = rle(data, W, H, plain)
    bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(H, row),
                         axis=1)[:, :W]
    return np.ascontiguousarray(np.repeat(
        np.where(bits, 255, 0).astype(np.uint8)[..., None], 3, -1))
