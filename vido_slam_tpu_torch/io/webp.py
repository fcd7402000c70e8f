"""WebP reading without cv2 or PIL, as ``cv2.imread`` (OpenCV 5.0 over
libwebp) and PIL's ``Image.open(p).convert("RGB")`` (``WebPImagePlugin``
over libwebp's ``WebPAnimDecoder``) give it, bit for bit: lossless WebP
(VP8L) here, lossy WebP's VP8 frame in ``io/vp8.py`` and its ALPH chunk
here.

The container: a RIFF ``WEBP`` file of a ``VP8L`` or ``VP8 `` chunk, or
an extended one (``VP8X``, metadata chunks, an ``ALPH`` chunk before a
``VP8 `` one, then the image); the first frame of an animation
(``ANIM``/``ANMF``) at its offset on the canvas. cv2 reads a still file
by WebPDecode (the last ALPH chunk before the image, whatever the VP8X
flags say; the decoder is given the rest of the file), an animation and
every PIL read by the demuxer (the padded chunk; a still image's ALPH
chunk dropped without the VP8X alpha flag).

The VP8L bitstream (libwebp 1.x ``vp8l_dec.c``): the 5-byte header,
then the transforms in their stored order — predictor (the 14 modes, 14
and 15 read as mode 0), cross-colour, subtract-green, colour indexing with
pixel bundling —, then the ARGB image: prefix codes (simple and normal,
the code-length code), the meta prefix codes of an entropy image, LZ77
backward references with the 120-entry distance map, and the colour
cache; each subimage (entropy image, transform data) by the same rules
without meta codes. libwebp fails on an incomplete or over-subscribed
code, a code of one used length other than 1 symbol, a reference before
the image or past its end, and bits read past the end of the data; so
does the port (``CorruptWebp``: cv2 gives None, PIL raises).

The ALPH chunk (``alpha_dec.c``): its header byte (compression 0 or 1,
filter 0-3, pre-processing 0 or 1, reserved bits 0: anything else fails
the read, cv2's colour read too), the raw plane or a VP8L stream of the
frame's size without the 5-byte header whose green channel is the plane,
then the horizontal, vertical or gradient unfilter. Alpha leaves the RGB
reads as they are; only its failures show.

The entropy-coded decoding and the ALPH chunk run in host C++
(``csrc/webp_decode.cpp``, built at first use, bound by ctypes);
``plain=True`` runs the Python versions here, bit-equal to it. The
inverse transforms are numpy.

cv2 decodes to BGR (alpha dropped) and takes cvtColor's 8-bit gray of it
for IMREAD_GRAYSCALE and IMREAD_ANYDEPTH; PIL's RGB drops alpha too.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional

import numpy as np

from vido_slam_tpu_torch.io import hdr, vp8
from vido_slam_tpu_torch.io.limits import check_cv2_size, check_pil_size
from vido_slam_tpu_torch.utils import host_build

# vp8l_dec.c: the order the code-length code's lengths are stored in
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                     13, 14, 15)

# kCodeToPlane: the 120 distance codes' (y << 4 | 8 - x) offsets
CODE_TO_PLANE = bytes((
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70))

# vp8l_dec.c: the alphabets of a prefix code group (green + lengths,
# red, blue, alpha, distance)
ALPHABETS = (256 + 24, 256, 256, 256, 40)


class CorruptWebp(ValueError):
    """Bytes libwebp fails on (cv2 gives None; PIL raises)."""


class _Bits:
    """libwebp's VP8LBitReader: bits LSB first, zeros past the data; it
    reaches its end once more bits were read than the data holds (at least
    64: the first 8 bytes are its window)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.avail = max(64, 8 * len(data))

    def read(self, n: int) -> int:
        p = self.pos >> 3
        v = (int.from_bytes(self.data[p:p + 5], "little") >> (self.pos & 7)) \
            & ((1 << n) - 1)
        self.pos += n
        return v

    @property
    def eos(self) -> bool:
        return self.pos > self.avail


def _build(lengths) -> Optional[dict]:
    """huffman_utils.c BuildHuffmanTable's checks and the canonical codes:
    {(length, code): symbol}, {0: symbol} for a code of one symbol; None
    for lengths libwebp rejects (all zero, over-subscribed, incomplete)."""
    count = [0] * 16
    for n in lengths:
        count[n] += 1
    used = len(lengths) - count[0]
    if used == 0:
        return None
    if used == 1:
        return {0: next(s for s, n in enumerate(lengths) if n)}
    left = 1
    for n in range(1, 16):
        left = 2 * left - count[n]
        if left < 0:
            return None
    if left != 0:
        return None
    codes, code = {}, 0
    for n in range(1, 16):
        for s, ln in enumerate(lengths):
            if ln == n:
                codes[(n, code)] = s
                code += 1
        code <<= 1
    return codes


def _symbol(br: _Bits, table: dict) -> int:
    if 0 in table:
        return table[0]
    code = 0
    for n in range(1, 16):
        code = code << 1 | br.read(1)
        if (n, code) in table:
            return table[(n, code)]
    raise CorruptWebp("VP8L prefix code is invalid")   # not reached


def _read_code(br: _Bits, alphabet: int) -> dict:
    """vp8l_dec.c ReadHuffmanCode: a simple code (one or two symbols of
    one or eight bits; symbols past the alphabet are dropped) or a normal
    one (the code-length code, then the lengths, runs of 16-18)."""
    lengths = [0] * alphabet
    if br.read(1):
        num = br.read(1) + 1
        s0 = br.read(8 if br.read(1) else 1)
        if s0 < alphabet:
            lengths[s0] = 1
        if num == 2:
            s1 = br.read(8)
            if s1 < alphabet:
                lengths[s1] = 1
    else:
        cl = [0] * 19
        for i in range(br.read(4) + 4):
            cl[CODE_LENGTH_ORDER[i]] = br.read(3)
        cl_table = _build(cl)
        if cl_table is None:
            raise CorruptWebp("VP8L code-length code is invalid")
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > alphabet:
                raise CorruptWebp("VP8L code lengths run past the alphabet")
        else:
            max_symbol = alphabet
        symbol, prev = 0, 8
        while symbol < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            n = _symbol(br, cl_table)
            if n < 16:
                lengths[symbol] = n
                symbol += 1
                if n:
                    prev = n
            else:
                extra, offset = ((2, 3), (3, 3), (7, 11))[n - 16]
                repeat = br.read(extra) + offset
                if symbol + repeat > alphabet:
                    raise CorruptWebp("VP8L code lengths run past the "
                                      "alphabet")
                lengths[symbol:symbol + repeat] = \
                    [prev if n == 16 else 0] * repeat
                symbol += repeat
    if br.eos:
        raise CorruptWebp("VP8L data ends inside a prefix code")
    table = _build(lengths)
    if table is None:
        raise CorruptWebp("VP8L prefix code is invalid")
    return table


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _copy_value(symbol: int, br: _Bits) -> int:
    """GetCopyDistance (and GetCopyLength): a prefix symbol and its extra
    bits."""
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _plane_distance(xsize: int, code: int) -> int:
    if code > 120:
        return code - 120
    dist_code = CODE_TO_PLANE[code - 1]
    dist = (dist_code >> 4) * xsize + 8 - (dist_code & 0xF)
    return dist if dist >= 1 else 1


def _image_stream(br: _Bits, xsize: int, ysize: int, level0: bool,
                  transforms: list, alpha: bool = False):
    """DecodeImageStream: (ARGB pixels as a flat list, the width they were
    coded at). ``alpha``: an ALPH chunk's stream, which libwebp decodes by
    DecodeAlphaData where its one transform is colour indexing, with no
    colour cache and one-symbol red, blue and alpha codes."""
    if level0:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise CorruptWebp("VP8L transform repeated")
            seen.add(kind)
            if kind in (0, 1):
                bits = br.read(3) + 2
                sub, _ = _image_stream(br, _subsample(xsize, bits),
                                       _subsample(ysize, bits), False, [])
                transforms.append((kind, xsize, bits, sub))
            elif kind == 3:
                colors = br.read(8) + 1
                bits = 0 if colors > 16 else 1 if colors > 4 else \
                    2 if colors > 2 else 3
                sub, _ = _image_stream(br, colors, 1, False, [])
                transforms.append((kind, xsize, bits, sub))
                xsize = _subsample(xsize, bits)
            else:
                transforms.append((kind, xsize, 0, None))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise CorruptWebp("VP8L colour cache size is invalid")
    meta, meta_bits, groups = None, 0, 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw = _subsample(xsize, meta_bits)
        sub, _ = _image_stream(br, mw, _subsample(ysize, meta_bits), False,
                               [])
        meta = [(p >> 8) & 0xFFFF for p in sub]
        groups = max(meta) + 1
    codes = []
    for _ in range(groups):
        codes.append([_read_code(br, a + (1 << cache_bits
                                          if i == 0 and cache_bits else 0))
                      for i, a in enumerate(ALPHABETS)])
    lenient = alpha and len(transforms) == 1 and transforms[0][0] == 3 \
        and not cache_bits and all(0 in table for group in codes
                                   for table in group[1:4])
    pixels = _image_data(br, xsize, ysize, codes, meta, meta_bits,
                         cache_bits, lenient)
    return pixels, xsize


def _image_data(br, width, height, codes, meta, meta_bits, cache_bits,
                lenient=False):
    """DecodeImageData: literals, backward references and colour cache
    hits, each pixel's codes those of its entropy-image tile. ``lenient``:
    DecodeAlphaData, which fails on reading past the end only where pixels
    are left (the pixels it then reads are libwebp's garbage, which no
    reader returns: here they are read as zeros)."""
    total = width * height
    out = [0] * total
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    mw = _subsample(width, meta_bits) if meta is not None else 0
    i = cached = 0
    while i < total:
        y, x = divmod(i, width)
        group = codes[meta[(y >> meta_bits) * mw + (x >> meta_bits)]] \
            if meta is not None else codes[0]
        code = _symbol(br, group[0])
        if br.eos and not lenient:
            break
        if code < 256:
            red = _symbol(br, group[1])
            blue = _symbol(br, group[2])
            alpha = _symbol(br, group[3])
            if br.eos and not lenient:
                break
            out[i] = alpha << 24 | red << 16 | code << 8 | blue
            i += 1
        elif code < 280:
            length = _copy_value(code - 256, br)
            dist = _plane_distance(width, _copy_value(_symbol(br, group[4]),
                                                      br))
            if br.eos and not lenient:
                break
            if i < dist or total - i < length:
                raise CorruptWebp("VP8L backward reference leaves the image")
            for k in range(i, i + length):
                out[k] = out[k - dist]
            i += length
        else:
            while cached < i:
                cache[(out[cached] * 0x1E35A7BD & 0xFFFFFFFF) >> shift] = \
                    out[cached]
                cached += 1
            out[i] = cache[code - 280]
            i += 1
        if cache is not None:
            while cached < i:
                cache[(out[cached] * 0x1E35A7BD & 0xFFFFFFFF) >> shift] = \
                    out[cached]
                cached += 1
        if lenient and br.eos:
            break
    if br.eos and (not lenient or i < total):
        raise CorruptWebp("VP8L data ends before the image")
    return out


# ---------------------------------------------------------------------------
# the inverse transforms (lossless.c)
# ---------------------------------------------------------------------------

def _average2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(p):
    return [(p >> s) & 0xFF for s in (24, 16, 8, 0)]


def _pack(ch):
    return (ch[0] << 24) | (ch[1] << 16) | (ch[2] << 8) | ch[3]


def _select(t, left, tl):
    """Select(a = top, b = left, c = top-left)."""
    d = sum(abs(b - c) - abs(a - c) for a, b, c in
            zip(_channels(t), _channels(left), _channels(tl)))
    return t if d <= 0 else left


def _clip(v):
    return 0 if v < 0 else 255 if v > 255 else v


def _predict(mode, left, top, tr, tl):
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _average2(_average2(left, tr), top)
    if mode == 6:
        return _average2(left, tl)
    if mode == 7:
        return _average2(left, top)
    if mode == 8:
        return _average2(tl, top)
    if mode == 9:
        return _average2(top, tr)
    if mode == 10:
        return _average2(_average2(left, tl), _average2(top, tr))
    if mode == 11:
        return _select(top, left, tl)
    if mode == 12:
        return _pack([_clip(a + b - c) for a, b, c in zip(
            _channels(left), _channels(top), _channels(tl))])
    if mode == 13:
        ave = _channels(_average2(left, top))
        return _pack([_clip(a + int((a - c) / 2)) for a, c in zip(
            ave, _channels(tl))])
    return 0xFF000000                  # mode 0, and 14-15 as libwebp


def _add(a, b):
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | \
        (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _inverse_predictor(px, width, height, bits, sub):
    tiles = _subsample(width, bits)
    out = list(px)
    for y in range(height):
        for x in range(width):
            i = y * width + x
            if y == 0:
                pred = 0xFF000000 if x == 0 else out[i - 1]
            elif x == 0:
                pred = out[i - width]
            else:
                mode = (sub[(y >> bits) * tiles + (x >> bits)] >> 8) & 0xF
                pred = _predict(mode, out[i - 1], out[i - width],
                                out[i - width + 1], out[i - width - 1])
            out[i] = _add(px[i], pred)
    return out


def _delta(pred: int, color: int) -> int:
    def s8(v):
        return v - 256 if v > 127 else v
    return (s8(pred) * s8(color)) >> 5


def _inverse_cross_color(px, width, height, bits, sub):
    tiles = _subsample(width, bits)
    out = []
    for i, p in enumerate(px):
        y, x = divmod(i, width)
        m = sub[(y >> bits) * tiles + (x >> bits)]
        g2r, g2b, r2b = m & 0xFF, (m >> 8) & 0xFF, (m >> 16) & 0xFF
        green = (p >> 8) & 0xFF
        red = ((p >> 16) + _delta(g2r, green)) & 0xFF
        blue = ((p & 0xFF) + _delta(g2b, green) + _delta(r2b, red)) & 0xFF
        out.append((p & 0xFF00FF00) | red << 16 | blue)
    return out


def _inverse_subtract_green(px):
    out = []
    for p in px:
        g = (p >> 8) & 0xFF
        out.append((p & 0xFF00FF00) | (((p >> 16) + g) & 0xFF) << 16
                   | ((p + g) & 0xFF))
    return out


def _inverse_color_indexing(px, width, height, bits, sub, packed_width):
    table = [0] * (1 << (8 >> bits) if bits else 256)
    prev = 0
    for k, p in enumerate(sub):          # the map is coded as deltas
        prev = _add(prev, p) if k else p
        table[k] = prev
    per = 1 << bits
    nbits = 8 >> bits
    out = []
    for y in range(height):
        for x in range(width):
            g = (px[y * packed_width + (x >> bits)] >> 8) & 0xFF
            index = (g >> (nbits * (x & (per - 1)))) & ((1 << nbits) - 1) \
                if bits else g
            out.append(table[index])
    return out


def vp8l_plain(payload: bytes, size: Optional[tuple] = None):
    """Plain version of ``webp_vp8l_decode``: (width, height, whether the
    header says alpha is used, (H, W) uint32 ARGB). With ``size`` (width,
    height), an ALPH chunk's stream, which has no header."""
    br = _Bits(payload)
    if size is None:
        width, height, alpha = vp8l_header(payload)
        br.pos = 40
    else:
        (width, height), alpha = size, 1
    transforms = []
    px, xsize = _image_stream(br, width, height, True, transforms,
                              size is not None)
    for kind, w, bits, sub in reversed(transforms):
        if kind == 0:
            px = _inverse_predictor(px, w, height, bits, sub)
        elif kind == 1:
            px = _inverse_cross_color(px, w, height, bits, sub)
        elif kind == 2:
            px = _inverse_subtract_green(px)
        else:
            px = _inverse_color_indexing(px, w, height, bits, sub,
                                         _subsample(w, bits))
    return width, height, alpha, np.array(px, np.uint32).reshape(height,
                                                                  width)


def vp8l_header(payload: bytes):
    """VP8LGetInfo: (width, height, alpha used); CorruptWebp where the
    signature, the version or the length is wrong."""
    if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
        raise CorruptWebp("VP8L header is invalid")
    bits = int.from_bytes(payload[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, \
        (bits >> 28) & 1


# ---------------------------------------------------------------------------
# the container (libwebp's demux.c, as WebPAnimDecoder parses it for both
# readers) and the readers
# ---------------------------------------------------------------------------

class Frame(NamedTuple):
    canvas: tuple           # (width, height)
    offset: tuple           # (x, y) of the frame on the canvas
    kind: bytes             # b"VP8L" or b"VP8 "
    payload: bytes          # the image chunk's payload with its padding
                            # byte (libwebp's decoder gets it too)
    alpha: Optional[bytes]  # a lossy frame's ALPH payload, if it has one


MAX_CHUNK = (1 << 32) - 1 - 10     # MAX_CHUNK_PAYLOAD


def vp8_info(data: bytes, chunk_size: int):
    """VP8GetInfo: a lossy frame's (width, height), CorruptWebp where
    libwebp rejects its header."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        raise CorruptWebp("VP8 frame header is invalid")
    bits = data[0] | data[1] << 8 | data[2] << 16
    w = (data[7] << 8 | data[6]) & 0x3FFF
    h = (data[9] << 8 | data[8]) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or \
            bits >> 5 >= chunk_size or w == 0 or h == 0:
        raise CorruptWebp("VP8 frame header is invalid")
    return w, h


class _Mem:
    """demux.c's MemBuffer over the RIFF data: a position and its end."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end

    def left(self) -> int:
        return self.end - self.pos

    def header(self):
        """A chunk header: (fourcc, payload size, padded size); CorruptWebp
        where the chunk runs past the RIFF data."""
        if self.left() < 8:
            raise CorruptWebp("WebP chunk header is cut")
        tag = self.data[self.pos:self.pos + 4]
        size = struct.unpack("<I", self.data[self.pos + 4:self.pos + 8])[0]
        padded = size + (size & 1)
        if size > MAX_CHUNK or self.pos + 8 + padded > self.end:
            raise CorruptWebp("WebP chunk runs past the RIFF data")
        return tag, size, padded


def _store_frame(mem: _Mem, min_size: int = 0):
    """demux.c StoreFrame: an ALPH chunk and a VP8 or VP8L chunk (at most
    one of each) from mem's position, stopping at any other chunk. Returns
    (kind, payload with its padding, width, height, the ALPH payload or
    None, whether the ALPH chunk came after the image); kind is None where
    the frame has no image chunk."""
    if mem.left() < 8 or mem.left() < min_size:
        raise CorruptWebp("WebP frame is cut")
    alpha = None
    image = (None, None, 0, 0)
    after = False
    while True:
        start = mem.pos
        tag, size, padded = mem.header()
        if tag == b"ALPH" and alpha is None:
            alpha = mem.data[start + 8:start + 8 + size]
            after = image[0] is not None
        elif tag in (b"VP8L", b"VP8 ") and image[0] is None:
            if tag == b"VP8L" and alpha is not None:
                raise CorruptWebp("WebP VP8L frame after an ALPH chunk")
            payload = mem.data[start + 8:start + 8 + padded]
            if tag == b"VP8L":
                w, h, _ = vp8l_header(payload)
            else:
                w, h = vp8_info(payload, size)
            image = (tag, payload, w, h)
        else:
            break
        mem.pos = start + 8 + padded
        if mem.pos == mem.end:
            break
        if mem.left() < 8:
            raise CorruptWebp("WebP chunk header is cut")
    return image + (alpha, after)


def _frame(image: tuple, keep_alpha: bool, x: int = 0, y: int = 0):
    """A stored frame as (kind, payload, width, height, ALPH payload or
    None, x, y): its alpha dropped unless ``keep_alpha``; IsValidExtended
    Format fails on a kept ALPH chunk after the image."""
    kind, payload, w, h, alpha, after = image
    if not keep_alpha:
        alpha = None
    elif alpha is not None and after:
        raise CorruptWebp("WebP ALPH chunk after its image")
    return kind, payload, w, h, alpha, x, y


def parse(data: bytes) -> Frame:
    """The first frame of a WebP file as WebPDemux (demux.c: ReadHeader,
    ParseSingleImage, ParseVP8X and its chunk walk, the validity checks)
    finds it for WebPAnimDecoder; ParseSingleImage drops the ALPH chunk of
    a still image whose VP8X header lacks the alpha flag (or that has no
    VP8X). CorruptWebp where it fails."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise CorruptWebp("not a RIFF WebP file")
    riff = struct.unpack("<I", data[4:8])[0]
    if riff < 8 or riff > MAX_CHUNK or riff + 8 > len(data):
        raise CorruptWebp("WebP RIFF size is invalid or the file is cut")
    mem = _Mem(data, 12, riff + 8)
    if mem.left() < 8:
        raise CorruptWebp("WebP has no chunk")
    first = data[12:16]
    frames = []        # (kind, payload, width, height, alpha, x, y)
    if first in (b"VP8 ", b"VP8L", b"ALPH"):
        image = _store_frame(mem)
        if image[0] is None:
            raise CorruptWebp("WebP has no image")
        frames.append(_frame(image, False))
        canvas, animated = (image[2], image[3]), False
    elif first == b"VP8X":
        tag, size, padded = mem.header()
        if size < 10:
            raise CorruptWebp("WebP VP8X chunk is too short")
        p = mem.pos + 8
        flags = data[p]
        canvas = (1 + int.from_bytes(data[p + 4:p + 7], "little"),
                  1 + int.from_bytes(data[p + 7:p + 10], "little"))
        if canvas[0] * canvas[1] >= 1 << 32:
            raise CorruptWebp("WebP canvas is too large")
        mem.pos += 8 + padded
        animated = bool(flags & 0x02)
        anim = 0
        stored = False
        if mem.left() < 8:
            raise CorruptWebp("WebP has no chunk after VP8X")
        while True:
            start = mem.pos
            tag, size, padded = mem.header()
            if tag == b"VP8X":
                raise CorruptWebp("WebP has two VP8X chunks")
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim or animated or stored:
                    raise CorruptWebp("WebP image chunk outside its ANMF")
                stored = True
                image = _frame(_store_frame(mem), bool(flags & 0x10))
                if image[0] is not None:
                    frames.append(image)
            elif tag == b"ANIM":
                if padded < 6:
                    raise CorruptWebp("WebP ANIM chunk is too short")
                anim += 1
                mem.pos = start + 8 + padded
            elif tag == b"ANMF":
                if not anim:
                    raise CorruptWebp("WebP ANMF before ANIM")
                if padded < 16:
                    raise CorruptWebp("WebP ANMF chunk is too short")
                p = start + 8
                x = 2 * int.from_bytes(data[p:p + 3], "little")
                y = 2 * int.from_bytes(data[p + 3:p + 6], "little")
                w = 1 + int.from_bytes(data[p + 6:p + 9], "little")
                h = 1 + int.from_bytes(data[p + 9:p + 12], "little")
                if w * h >= 1 << 32:
                    raise CorruptWebp("WebP frame is too large")
                mem.pos = p + 16
                image = _store_frame(mem, padded - 16)
                if mem.pos - (p + 16) > padded - 16:
                    raise CorruptWebp("WebP frame runs past its ANMF")
                if animated and image[0] is not None:
                    frames.append(_frame(image, True, x, y))
                elif animated and image[4] is not None:
                    raise CorruptWebp("WebP frame has no image")
            else:
                mem.pos = start + 8 + padded
            if mem.pos == mem.end:
                break
            if mem.left() < 8:
                raise CorruptWebp("WebP chunk header is cut")
        if flags & ~0x3E or not frames or (not animated and len(frames) > 1):
            raise CorruptWebp("WebP extended header is invalid")
    else:
        raise CorruptWebp("WebP has no image chunk")
    for kind, _, w, h, _, x, y in frames:
        if (animated and (x + w > canvas[0] or y + h > canvas[1])) or \
                (not animated and (x, y, w, h) != (0, 0) + canvas):
            raise CorruptWebp("WebP frame does not fit its canvas")
    kind, payload, w, h, alpha, x, y = frames[0]
    return Frame(canvas, (x, y), kind, payload, alpha)


def parse_still(data: bytes):
    """A still file as cv2 reads it: WebPGetFeatures on its first 32 bytes
    (the VP8X canvas, then cv2's size limits), then WebPDecode's parse of
    the whole file (webp_dec.c ParseHeadersInternal: ParseRIFF, ParseVP8X,
    ParseOptionalChunks, ParseVP8Header). Returns (canvas (width, height),
    the image payload's offset, its kind, the payload of the last ALPH
    chunk before it or None); the decoder is given the file from that
    offset to its end. CorruptWebp where libwebp fails."""
    if data[8:12] != b"WEBP":
        raise CorruptWebp("not a WebP file")
    riff = struct.unpack("<I", data[4:8])[0]
    if riff < 12 or riff > MAX_CHUNK:
        raise CorruptWebp("WebP RIFF size is invalid")
    pos, left = 12, len(data) - 12
    canvas = alpha = None
    if data[pos:pos + 4] == b"VP8X":
        if struct.unpack("<I", data[pos + 4:pos + 8])[0] != 10 or left < 18:
            raise CorruptWebp("WebP VP8X chunk is invalid")
        canvas = (1 + int.from_bytes(data[pos + 12:pos + 15], "little"),
                  1 + int.from_bytes(data[pos + 15:pos + 18], "little"))
        if canvas[0] * canvas[1] >= 1 << 32:
            raise CorruptWebp("WebP canvas is too large")
        check_cv2_size(*canvas)
        pos, left = pos + 18, left - 18
    if riff > len(data) - 8:
        raise CorruptWebp("WebP file is cut")
    if canvas is not None:
        if left < 4:
            raise CorruptWebp("WebP ends after its VP8X chunk")
        total = 4 + 8 + 10
        while True:                # ParseOptionalChunks
            if left < 8:
                raise CorruptWebp("WebP chunk header is cut")
            size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            if size > MAX_CHUNK:
                raise CorruptWebp("WebP chunk size is invalid")
            disk = (8 + size + 1) & ~1
            total += disk
            if total > riff:
                raise CorruptWebp("WebP chunk runs past the RIFF data")
            if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if left < disk:
                raise CorruptWebp("WebP chunk is cut")
            if data[pos:pos + 4] == b"ALPH":
                alpha = data[pos + 8:pos + 8 + size]
            pos, left = pos + disk, left - disk
    if left < 8:
        raise CorruptWebp("WebP image chunk header is cut")
    tag = data[pos:pos + 4]
    if tag not in (b"VP8 ", b"VP8L"):
        raise CorruptWebp("WebP has no image chunk")
    size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
    if size > riff - 12 or size > left - 8:
        raise CorruptWebp("WebP image chunk size is invalid")
    payload = data[pos + 8:]
    if tag == b"VP8 ":
        width, height = vp8_info(payload, size)
    else:
        width, height, _ = vp8l_header(payload)
    if canvas is not None and canvas != (width, height):
        raise CorruptWebp("WebP canvas differs from its image")
    return (width, height), pos + 8, tag, alpha


def _animated(data: bytes) -> bool:
    """The VP8X header's animation flag (the file cv2 reads through
    WebPAnimDecoder, as PIL reads every file)."""
    return len(data) >= 30 and data[12:16] == b"VP8X" and \
        bool(data[20] & 0x02)


def _lib():
    fn = host_build.load("webp_decode").webp_vp8l_decode
    fn.restype = ctypes.c_int
    return fn


def decode_vp8l(payload: bytes, plain: bool = False) -> np.ndarray:
    """A VP8L bitstream's (H, W) uint32 ARGB (``webp_vp8l_decode``, or
    ``vp8l_plain``); CorruptWebp where libwebp fails."""
    width, height, _ = vp8l_header(payload)
    if plain:
        return vp8l_plain(payload)[3]
    out = np.zeros((height, width), np.uint32)
    src = np.frombuffer(payload, np.uint8)
    rc = _lib()(ctypes.c_void_p(src.ctypes.data),
                ctypes.c_int64(len(payload)),
                ctypes.c_void_p(out.ctypes.data), width, height)
    if rc != 0:
        raise CorruptWebp(f"VP8L bitstream is invalid ({rc})")
    return out


def _unfilter(kind: int, plane: np.ndarray) -> np.ndarray:
    """The ALPH unfilters (horizontal 1, vertical 2, gradient 3) row by
    row; the first row by the horizontal one from 0, the first pixel of
    the others from the pixel above."""
    if kind == 0:
        return plane
    out = plane.astype(np.int64)
    H, W = out.shape
    for y in range(H):
        row = out[y]
        if kind == 1 or y == 0:
            row[0] = (row[0] + (out[y - 1, 0] if kind == 1 and y else 0)) \
                & 0xFF
            row[:] = np.cumsum(row) & 0xFF
        elif kind == 2:
            row[:] = (row + out[y - 1]) & 0xFF
        else:
            prev = out[y - 1]
            left, top_left = int(prev[0]), int(prev[0])
            for x in range(W):
                top = int(prev[x])
                left = (int(row[x]) + min(max(left + top - top_left, 0),
                                          255)) & 0xFF
                top_left = top
                row[x] = left
    return out.astype(np.uint8)


def alph_plain(data: bytes, width: int, height: int) -> np.ndarray:
    """Plain version of ``webp_alph_decode``: an ALPH chunk's (H, W)
    alpha plane; CorruptWebp where libwebp fails."""
    if len(data) <= 1:
        raise CorruptWebp("ALPH chunk is empty")
    method, kind = data[0] & 3, (data[0] >> 2) & 3
    if method > 1 or (data[0] >> 4) & 3 > 1 or data[0] >> 6:
        raise CorruptWebp("ALPH header is invalid")
    if method == 0:
        if len(data) - 1 < width * height:
            raise CorruptWebp("ALPH data is short")
        plane = np.frombuffer(data, np.uint8, width * height, 1).reshape(
            height, width)
    else:
        argb = vp8l_plain(data[1:], (width, height))[3]
        plane = ((argb >> 8) & 0xFF).astype(np.uint8)
    return _unfilter(kind, plane)


def decode_alph(data: bytes, width: int, height: int,
                plain: bool = False) -> np.ndarray:
    """An ALPH chunk's (H, W) alpha plane (``webp_alph_decode``, or
    ``alph_plain``); CorruptWebp where libwebp fails."""
    if plain:
        return alph_plain(data, width, height)
    fn = host_build.load("webp_decode").webp_alph_decode
    fn.restype = ctypes.c_int
    out = np.empty((height, width), np.uint8)
    src = np.frombuffer(data, np.uint8)
    rc = fn(ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(data)),
            ctypes.c_void_p(out.ctypes.data), width, height)
    if rc != 0:
        raise CorruptWebp(f"ALPH data is invalid ({rc})")
    return out


def _image(kind: bytes, payload: bytes, alpha: Optional[bytes],
           plain: bool) -> np.ndarray:
    """A frame's (H, W, 4) B, G, R, A bytes: VP8L, or VP8 (``vp8.decode``)
    with its ALPH plane; CorruptWebp where libwebp fails on either."""
    if kind == b"VP8L":
        argb = decode_vp8l(payload, plain)
        return argb.view(np.uint8).reshape(argb.shape + (4,))
    bgra = vp8.decode(payload, plain)
    if bgra is None:
        raise CorruptWebp("VP8 bitstream is invalid")
    if alpha is not None:
        bgra[..., 3] = decode_alph(alpha, bgra.shape[1], bgra.shape[0],
                                   plain)
    return bgra


def _canvas(data: bytes, plain: bool, cv2_limits: bool) -> np.ndarray:
    """The first frame on its canvas as (H, W, 4) B, G, R, A bytes (the
    canvas transparent black outside the frame). ``cv2_limits``: cv2's
    reading (a still file by ``parse_still``) and size limits
    (``limits.check_cv2_size``), else PIL's (``parse``) and its
    decompression bomb limit (``limits.check_pil_size``)."""
    if cv2_limits and not _animated(data):
        _, start, kind, alpha = parse_still(data)
        return _image(kind, data[start:], alpha, plain)
    frame = parse(data)
    cw, ch = frame.canvas
    if cv2_limits:
        check_cv2_size(cw, ch)
    else:
        check_pil_size(cw, ch)
    image = _image(frame.kind, frame.payload, frame.alpha, plain)
    canvas = np.zeros((ch, cw, 4), np.uint8)
    x, y = frame.offset
    canvas[y:y + image.shape[0], x:x + image.shape[1]] = image
    return canvas


def read_cv2(data: bytes, flags: int, plain: bool = False
             ) -> Optional[np.ndarray]:
    """``cv2.imread`` of a WebP: IMREAD_COLOR (flags 1) (H, W, 3) BGR,
    IMREAD_GRAYSCALE and IMREAD_ANYDEPTH cvtColor's gray of it; None where
    libwebp fails, and for a file of fewer than 32 bytes (cv2's WebP
    signature check reads 32)."""
    if len(data) < 32:
        return None
    try:
        bgra = _canvas(data, plain, True)
    except CorruptWebp:
        return None
    bgr = np.ascontiguousarray(bgra[..., :3])
    return bgr if flags == 1 else hdr.gray_u8(bgr)


def read_pil(data: bytes, plain: bool = False) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of a WebP."""
    return np.ascontiguousarray(_canvas(data, plain, False)[..., 2::-1])
