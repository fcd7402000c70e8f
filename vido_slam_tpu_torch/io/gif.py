"""GIF reading without cv2 or PIL: the first image of a GIF as
``cv2.imread`` (OpenCV 5.0's own decoder, ``grfmt_gif.cpp``) and as PIL's
``Image.open(p).convert("RGB")`` (``GifImagePlugin``, ``GifDecode.c``)
give it, each by its own rules, bit for bit.

The LZW data runs in host C++ (``csrc/gif_decode.cpp``, built at first
use and bound by ctypes); ``plain=True`` runs its Python version
(``lzw_decode_plain``), bit-equal to it.

cv2 (``read_cv2``): the header must name a screen of nonzero size and a
background index inside the global colour table; every block of the file
up to the trailer must parse (``readHeader`` counts the frames: a cut
file, a missing trailer or a stray byte between blocks give None); the
first image's Graphic Control Extension must be 4 bytes long with a
disposal method of at most 3; the image must lie inside the screen, its
minimum code size be 2-11 and its LZW data give at least its pixel count
(``csrc/gif_decode.cpp`` has the rules). The screen starts as the global
table's background colour (black without a global table); each pixel
takes its index's colour from the local table written over the global
one (``cv2_palette``), else a default table (index i gray i, but 1
white), an index past both failing; a transparent index leaves the
screen's colour. IMREAD_COLOR
gives the BGR, IMREAD_GRAYSCALE and IMREAD_ANYDEPTH cvtColor's 8-bit
gray of it.

PIL (``read_pil``): stray bytes between blocks are skipped; the first
image found is read; the image grows to hold a frame that reaches past
the screen; it starts as the transparent index (0 without one) and takes
the frame's indices, decoded until the frame is full (an end code or the
end of the file before that raises, as PIL does); the colours come from
the local table, else the global one, an index past the table black, and
a table that is the gray ramp (or none) gives each index its own gray.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional

import numpy as np

from vido_slam_tpu_torch.io import hdr
from vido_slam_tpu_torch.io.limits import check_cv2_size, check_pil_size
from vido_slam_tpu_torch.utils import host_build

SIGNATURES = (b"GIF87a", b"GIF89a")

# cv2's table where a GIF has none: index i is gray i, but index 1 white
# (as cv2 5.0 decodes such a file)
CV2_DEFAULT_TABLE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
CV2_DEFAULT_TABLE[1] = 255


class CorruptGif(ValueError):
    """Bytes cv2 gives None for."""


class TruncatedGif(OSError):
    """PIL's "image file is truncated" (or "broken data stream")."""


class Image(NamedTuple):
    left: int
    top: int
    width: int
    height: int
    interlace: bool
    table: Optional[np.ndarray]     # the local colour table ((n, 3) RGB)
    min_code_size: int
    data: int                       # offset of the LZW sub-blocks
    transparency: Optional[int]
    disposal: int
    gce_size: int                   # the last GCE's block size (-1: none)


def _table(data: bytes, pos: int, flags: int, strict: bool):
    """The colour table a flags byte announces at pos: ((n, 3) array or
    None, the offset after it)."""
    if not flags & 0x80:
        return None, pos
    n = 1 << ((flags & 7) + 1)
    raw = data[pos:pos + 3 * n]
    if strict and len(raw) < 3 * n:
        raise CorruptGif("GIF colour table is cut")
    raw = raw[:len(raw) // 3 * 3]
    return np.frombuffer(raw, np.uint8).reshape(-1, 3), pos + 3 * n


def _skip_blocks(data: bytes, pos: int) -> int:
    """Past data sub-blocks and their terminator; CorruptGif where the
    file ends first."""
    while True:
        if pos >= len(data):
            raise CorruptGif("GIF ends inside its sub-blocks")
        size = data[pos]
        pos += 1
        if size == 0:
            return pos
        if pos + size > len(data):
            raise CorruptGif("GIF ends inside its sub-blocks")
        pos += size


def _descriptor(data: bytes, pos: int, gce, strict: bool) -> Image:
    """The image descriptor after its 0x2C, its local table and minimum
    code size."""
    if len(data) < pos + 9:
        raise CorruptGif("GIF ends inside an image descriptor")
    left, top, w, h = struct.unpack("<4H", data[pos:pos + 8])
    flags = data[pos + 8]
    table, pos = _table(data, pos + 9, flags, strict)
    if pos >= len(data):
        raise CorruptGif("GIF ends before its LZW data")
    return Image(left, top, w, h, bool(flags & 0x40), table, data[pos],
                 pos + 1, *gce)


def parse_cv2(data: bytes):
    """GifDecoder::readHeader and the first image of readData: (screen
    width, height, the global table or None, the background index, the
    first Image). CorruptGif where cv2 gives None."""
    if len(data) < 13:
        raise CorruptGif("GIF header is cut")
    W, H = struct.unpack("<2H", data[6:10])
    if W == 0 or H == 0:
        raise CorruptGif("GIF screen is empty")
    flags, bg = data[10], data[11]
    table, pos = _table(data, 13, flags, True)
    if table is not None and bg >= len(table):
        raise CorruptGif("GIF background index is past the global table")
    first, gce, frames = None, (None, 0, -1), 0
    while True:          # getFrameCount_: every block up to the trailer
        if pos >= len(data):
            raise CorruptGif("GIF has no trailer")
        kind = data[pos]
        pos += 1
        if kind == 0x3B:
            break
        if kind == 0x21:
            if pos >= len(data):
                raise CorruptGif("GIF ends inside an extension")
            label = data[pos]
            if label == 0xFF and data[pos + 1:pos + 13] not in (
                    b"\x0bNETSCAPE2.0", b"\x0bXMP DataXMP"):
                raise CorruptGif("GIF application extension is unknown to "
                                 "cv2")
            if label == 0xF9 and frames == 0:
                if pos + 6 > len(data):
                    raise CorruptGif("GIF ends inside an extension")
                size, f = data[pos + 1], data[pos + 2]
                gce = (data[pos + 5] if f & 1 else None, (f >> 2) & 7, size)
            pos = _skip_blocks(data, pos + 1)
        elif kind == 0x2C:
            img = _descriptor(data, pos, gce, True)
            pos = _skip_blocks(data, img.data)
            if frames == 0:
                first = img
            frames += 1
        else:
            raise CorruptGif(f"GIF block {kind:#04x} is unknown to cv2")
    if first is None:
        raise CorruptGif("GIF has no image")
    check_cv2_size(W, H)          # imread's, between readHeader and readData
    if first.gce_size not in (-1, 4) or first.disposal > 3:
        raise CorruptGif("GIF graphic control extension is invalid")
    if first.width == 0 or first.height == 0 or \
            first.left + first.width > W or first.top + first.height > H:
        raise CorruptGif("GIF image lies outside its screen")
    if not 2 <= first.min_code_size <= 11:
        raise CorruptGif("GIF LZW minimum code size is invalid")
    return W, H, table, bg, first


def lzw_decode_plain(data: bytes, pos: int, min_code_size: int, pil: bool,
                     npix: int):
    """Plain version of ``gif_lzw_decode``: (the first npix indices
    decoded, the return code)."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    strings = [bytes([i & 0xFF]) for i in range(min(clear, 4096))]
    strings += [b""] * (4096 - len(strings))
    nxt, width, prev = clear + 2, min_code_size + 1, -1
    acc = nacc = count = 0
    out = bytearray()
    n = len(data)
    if pos >= n:
        return out, -3 if pil else 0
    block = 0
    if not pil:
        block, pos = data[pos], pos + 1
    while True:
        if pil:
            while nacc < width:
                while block == 0:
                    if pos >= n:
                        return out, -3
                    block, pos = data[pos], pos + 1
                    if pos + block > n:
                        return out, -3
                acc |= data[pos] << nacc
                pos, nacc, block = pos + 1, nacc + 8, block - 1
        else:
            if block == 0:
                return out, count
            if count > npix:
                return out, -2
            if nacc < width:
                if pos >= n:
                    return out, count
                acc |= data[pos] << nacc
                pos, nacc, block = pos + 1, nacc + 8, block - 1
        while nacc >= width:
            c = acc & ((1 << width) - 1)
            acc >>= width
            nacc -= width
            if c in (clear, end):
                nxt, width, prev = clear + 2, min_code_size + 1, -1
                if c == clear:
                    continue
                if pil:
                    return out, -4
                break
            if (prev < 0 and c > clear) or (prev >= 0 and c > nxt):
                if pil or count < npix:
                    return out, -1
                continue            # cv2, the image full: changes nothing
            if prev < 0:
                s = strings[c]
            elif c == nxt:
                s = strings[prev] + strings[prev][:1]
            else:
                s = strings[c]
            if pil:
                out += s[:npix - len(out)]
                if len(out) == npix:
                    return out, npix
            else:
                if count < npix < count + len(s):
                    return out, -2
                out += s[:max(0, npix - count)]
                count += len(s)
            if prev >= 0 and nxt < 4096:
                strings[nxt] = strings[prev] + s[:1]
                nxt += 1
                if nxt == 1 << width and width < 12:
                    width += 1
            prev = c
        if not pil and block == 0:
            if pos >= n:
                return out, count
            block, pos = data[pos], pos + 1


def lzw_decode(data: bytes, img: Image, pil: bool, plain: bool = False):
    """The image's indices in file order (npix of them where the decode
    succeeds) and the decoder's return code."""
    npix = img.width * img.height
    if plain:
        out, rc = lzw_decode_plain(data, img.data, img.min_code_size, pil,
                                   npix)
        return np.frombuffer(bytes(out if rc >= 0 else b""), np.uint8), rc
    out = np.zeros(max(npix, 1), np.uint8)
    src = np.frombuffer(data, np.uint8)
    fn = host_build.load("gif_decode").gif_lzw_decode
    fn.restype = ctypes.c_int64
    rc = fn(ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(data)),
            ctypes.c_int64(img.data), img.min_code_size, int(pil),
            ctypes.c_void_p(out.ctypes.data), ctypes.c_int64(npix))
    return out[:min(rc, npix) if rc >= 0 else 0], int(rc)


def rows(indices: np.ndarray, img: Image) -> np.ndarray:
    """(h, w) indices in image order from the file's row order (the four
    interlaced passes where the image is interlaced)."""
    h, w = img.height, img.width
    px = indices.reshape(h, w)
    if not img.interlace:
        return px
    order = (list(range(0, h, 8)) + list(range(4, h, 8))
             + list(range(2, h, 4)) + list(range(1, h, 2)))
    out = np.empty_like(px)
    out[order] = px
    return out


def cv2_palette(table: Optional[np.ndarray],
                local: Optional[np.ndarray]) -> np.ndarray:
    """The colours cv2 looks an image's indices up in: the local table
    written over the start of the global one (the global entries past it
    stay), as long as the longer of the two; cv2's default table where the
    file has neither."""
    if table is None and local is None:
        return CV2_DEFAULT_TABLE
    n = max(0 if table is None else len(table),
            0 if local is None else len(local))
    pal = np.zeros((n, 3), np.uint8)
    if table is not None:
        pal[:len(table)] = table
    if local is not None:
        pal[:len(local)] = local
    return pal


def read_cv2(data: bytes, flags: int, plain: bool = False
             ) -> Optional[np.ndarray]:
    """``cv2.imread`` of a GIF with IMREAD_COLOR (flags 1: (H, W, 3) BGR),
    IMREAD_GRAYSCALE or IMREAD_ANYDEPTH ((H, W) uint8); None where cv2
    gives None."""
    try:
        W, H, table, bg, img = parse_cv2(data)
    except CorruptGif:
        return None
    indices, rc = lzw_decode(data, img, False, plain)
    if rc < img.width * img.height:
        return None
    px = rows(indices, img)
    pal = cv2_palette(table, img.table)
    if int(px.max()) >= len(pal):
        return None                          # code2pixel's assertion
    # the screen as indices into the table and, past it, the background
    # colour; the colours (and cv2's gray of them) looked up once each
    colors = np.concatenate([pal, table[bg:bg + 1] if table is not None
                             else np.zeros((1, 3), np.uint8)])[:, ::-1]
    screen = np.full((H, W), len(pal), np.uint16)
    region = screen[img.top:img.top + img.height,
                    img.left:img.left + img.width]
    if img.transparency is None:
        region[:] = px
    else:
        keep = px != img.transparency
        region[keep] = px[keep]
    if flags == 1:
        return np.ascontiguousarray(colors)[screen]
    return hdr.gray_u8(colors)[screen]


def _ramp(table: Optional[np.ndarray]) -> bool:
    """GifImagePlugin._is_palette_needed's negation: the table is the gray
    ramp (entry i is i, i, i), or there is none."""
    if table is None:
        return True
    return bool((table == np.arange(len(table))[:, None]).all())


def parse_pil(data: bytes):
    """GifImagePlugin._open and _seek(0): (the image's size, the table its
    pixels use or None for gray, the first Image). Raises where PIL
    does."""
    if len(data) < 13:
        raise TruncatedGif("GIF header is cut")
    W, H = struct.unpack("<2H", data[6:10])
    flags = data[10]
    table, pos = _table(data, 13, flags, False)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise TruncatedGif("image not found in GIF frame")
        kind = data[pos]
        pos += 1
        if kind == 0x21:
            if pos >= len(data):
                raise TruncatedGif("GIF ends inside an extension")
            label = data[pos]
            size = data[pos + 1] if pos + 1 < len(data) else 0
            block = data[pos + 2:pos + 2 + size]
            if label == 0xF9 and size:
                if len(block) < 3 or block[0] & 1 and len(block) < 4:
                    raise TruncatedGif("GIF graphic control extension is "
                                       "short")
                if block[0] & 1:
                    transparency = block[3]
            pos = pos + 2 + size if size else pos + 2
            while pos < len(data) and data[pos]:    # the other sub-blocks
                pos += 1 + data[pos]
            pos += 1
        elif kind == 0x2C:
            img = _descriptor(data, pos, (transparency, 0, -1), False)
            break
    if img.min_code_size > 12:
        raise ValueError("bad number of bits")
    frame = img.table if img.table is not None else table
    size = (max(W, img.left + img.width), max(H, img.top + img.height))
    return size, None if _ramp(frame) else frame, img


def read_pil(data: bytes, plain: bool = False) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of a GIF's first frame:
    (H, W, 3) uint8 RGB. Raises where PIL raises."""
    (W, H), table, img = parse_pil(data)
    check_pil_size(W, H)
    npix = img.width * img.height
    px = np.full((H, W), img.transparency or 0, np.uint8)
    if npix:
        indices, rc = lzw_decode(data, img, True, plain)
        if rc == -1:
            raise TruncatedGif("broken data stream when reading image file")
        if rc != npix:
            raise TruncatedGif("image file is truncated")
        px[img.top:img.top + img.height,
           img.left:img.left + img.width] = rows(indices, img)
    else:
        raise TruncatedGif("image file is truncated")
    if table is None:
        return np.repeat(px[..., None], 3, axis=-1)
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(table)] = table
    return pal[px]
