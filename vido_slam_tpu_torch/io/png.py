"""PNG decoding without cv2 — what the offline demo needs of cv2's PNG
reader (libpng), for the port's dataset readers (``io/datasets.py``).

Every mode of the PNG standard: colour types 0 (gray), 2 (RGB), 3
(palette), 4 (gray + alpha) and 6 (RGBA) at their bit depths, with or
without Adam7 interlace, filter method 0 with its five row filters;
``zlib`` inflates the IDAT stream and every chunk's CRC is checked. The
samples come out as libpng's expansions give them to cv2: 16-bit samples
big-endian in the file, gray of 1, 2 or 4 bits scaled to 8 (x 255, 85,
17), palette indices replaced by their PLTE colours (indices past the
palette give black, libpng's zero-filled palette), interlaced passes put
in place. Bytes that are no decodable PNG (a bad signature, a short
stream, a bad CRC, an invalid IHDR, a palette image without a valid PLTE,
data that does not inflate or falls short of the image, a bad row
filter) raise ``CorruptPng``, where libpng fails and ``cv2.imread``
returns None. Surplus image data, which libpng decodes with a warning,
raises a plain ``ValueError``: nothing is guessed. Ancillary chunks (gAMA,
sBIT, tRNS, text) are skipped; they change no sample value that the
readers return (cv2 applies no gamma, and drops alpha, tRNS's included,
where the readers do).

The row unfilter is a host C++ function (``csrc/png_unfilter.cpp``, built
at first use, bound by ctypes): Avg and Paeth are sequential along a row,
and a Python loop would take seconds on a 1280x560 frame.
``unfilter_plain`` is its plain version, for the tests.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import NamedTuple

import numpy as np

from vido_slam_tpu_torch.utils import host_build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
# colour type -> the bit depths the PNG standard allows for it
VALID_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
                4: (8, 16), 6: (8, 16)}


class CorruptPng(ValueError):
    """The bytes are no decodable PNG (libpng fails on them too)."""


# Adam7: (x0, y0, dx, dy) of the seven passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PngImage(NamedTuple):
    pixels: np.ndarray   # (H, W, C) uint8 or uint16, the file's channel
    #                      order (RGB for a palette image)
    color_type: int
    bit_depth: int       # 8 or 16: the samples' depth after expansion


def _chunks(data: bytes):
    """(type, payload) of each chunk up to IEND, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise CorruptPng("not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise CorruptPng("PNG ends before IEND")
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if pos + 12 + n > len(data):
            raise CorruptPng(f"PNG chunk {kind!r} is truncated")
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise CorruptPng(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def _check_size(size: int, height: int, rowbytes: int) -> None:
    """Too little image data is corrupt; libpng decodes surplus data with
    a warning, which this reader refuses."""
    need = height * (rowbytes + 1)
    if size != need:
        kind = CorruptPng if size < need else ValueError
        raise kind(f"PNG image data holds {size} bytes, not {need}")


def unfilter(filtered: np.ndarray, height: int, rowbytes: int,
             bpp: int) -> np.ndarray:
    """Reconstruct ``height`` rows of ``rowbytes`` bytes from the inflated
    stream (each row led by its filter-type byte), ``bpp`` bytes a pixel,
    with the host C++ unfilter. Returns (height, rowbytes) uint8."""
    src = np.ascontiguousarray(filtered, np.uint8).reshape(-1)
    _check_size(src.size, height, rowbytes)
    out = np.empty((height, rowbytes), np.uint8)
    lib = host_build.load("png_unfilter")
    fn = lib.png_unfilter
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64]
    rc = fn(src.ctypes.data, out.ctypes.data, height, rowbytes, bpp)
    if rc != 0:
        raise CorruptPng(f"PNG row {-rc - 1} has filter type "
                         f"{src[(-rc - 1) * (rowbytes + 1)]}, not 0-4")
    return out


def unfilter_plain(filtered: np.ndarray, height: int, rowbytes: int,
                   bpp: int) -> np.ndarray:
    """The plain version of ``unfilter``: numpy for None, Sub (a cumulative
    sum of each of the ``bpp`` interleaved byte lanes) and Up, a Python
    loop along the row for Avg and Paeth."""
    src = np.asarray(filtered, np.uint8).reshape(-1)
    _check_size(src.size, height, rowbytes)
    rows = src.reshape(height, rowbytes + 1)
    out = np.zeros((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = np.zeros(rowbytes, np.uint8)
            for lane in range(min(bpp, rowbytes)):
                cur[lane::bpp] = np.cumsum(line[lane::bpp], dtype=np.uint64) \
                    .astype(np.uint8)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = bytearray(rowbytes)
            up = prev.tolist()
            for i, x in enumerate(line.tolist()):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                cur[i] = (x + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise CorruptPng(f"PNG row {y} has filter type {kind}, "
                             f"not 0-4")
        out[y] = cur
        prev = out[y]
    return out


def _samples(rows: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """Unpack (h, rowbytes) unfiltered rows into (h, width, channels)
    samples: big-endian 16-bit words, bytes, or 1-4-bit fields packed from
    the high bits of each byte."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, width, channels)
    if depth == 8:
        return rows.reshape(h, width, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    fields = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return fields.reshape(h, -1)[:, :width, None]


def decode_png(data: bytes, *, plain: bool = False) -> PngImage:
    """Decode a PNG held in memory; ``plain`` takes the plain unfilter."""
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if header is None:
            if kind != b"IHDR" or len(body) != 13:
                raise CorruptPng("PNG does not start with a valid IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE" and not idat:
            palette = body
    width, height, depth, ctype, comp, filt, interlace = header
    if depth not in VALID_DEPTHS.get(ctype, ()) or width == 0 \
            or height == 0 or comp != 0 or filt != 0 or interlace > 1:
        raise CorruptPng(f"PNG IHDR is invalid: {header}")
    if ctype == 3 and (palette is None or len(palette) % 3
                       or not 3 <= len(palette) <= 768):
        raise CorruptPng("PNG palette image without a valid PLTE")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise CorruptPng(f"PNG image data does not inflate: {e}") from None
    channels = 1 if ctype == 3 else CHANNELS[ctype]
    bits = channels * depth
    bpp = max(1, bits // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(height - y0) // dy), -(-(width - x0) // dx))
             for x0, y0, dx, dy in passes]
    need = sum(h * (-(-w * bits // 8) + 1) for h, w in sizes if h and w)
    if raw.size != need:
        kind = CorruptPng if raw.size < need else ValueError
        raise kind(f"PNG image data holds {raw.size} bytes, not {need}")
    fn = unfilter_plain if plain else unfilter
    out = np.empty((height, width, channels),
                   np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (h, w) in zip(passes, sizes):
        if not (h and w):
            continue
        rowbytes = -(-w * bits // 8)
        size = h * (rowbytes + 1)
        rows = fn(raw[pos:pos + size], h, rowbytes, bpp)
        pos += size
        out[y0::dy, x0::dx] = _samples(rows, w, depth, channels)
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette) // 3] = np.frombuffer(palette, np.uint8) \
            .reshape(-1, 3)
        out = table[out[..., 0]]
    elif depth < 8:
        out = out * np.uint8(255 // ((1 << depth) - 1))
    return PngImage(out, ctype, 16 if depth == 16 else 8)


def read_png(path: str, *, plain: bool = False) -> PngImage:
    """Decode a PNG file."""
    with open(path, "rb") as f:
        return decode_png(f.read(), plain=plain)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit gray (H, W) or RGB (H, W, 3) uint8 image as PNG bytes:
    every row filter type None, the stream deflated at ``level``. What
    PIL's ``Image.save`` of the same array decodes to, without PIL."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape[:2]
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           img.reshape(H, -1)], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0 if img.ndim == 2 else 2, 0, 0,
                       0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write ``encode_png(img)`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
