"""TIFF decoding without cv2 or PIL — what ``cv2.imread`` (OpenCV's
``grfmt_tiff.cpp`` on libtiff 4.7) and PIL's ``Image.open(p).convert("RGB")``
(``TiffImagePlugin``) give for the first page of a TIFF file, bit for bit,
each by its own rules, for ``io/datasets.py``.

Read: classic TIFF and BigTIFF in either byte order; strips (a short last
one too) and tiles (overhanging the edge); planar configurations 1 and 2;
no compression, LZW (the 5.0 form and the old one), Deflate (8, 32946,
the standard library's ``zlib``), PackBits, JPEG (7: each strip or tile
an abbreviated stream after the JPEGTables tag, decoded by ``io/jpeg.py``
as libtiff hands it to libjpeg), CCITT fax (2, 3, 4, 32771:
``io/tiff_fax.py``) and, for PIL only, LZMA (34925, the standard
library's ``lzma``); fill order 2 (every byte of the coded data
bit-reversed first); the horizontal (2) and floating-point (3)
predictors where libtiff applies them (LZW and Deflate); photometric 0
and 1 (1-, 2-, 4-, 8-, 16- and 32-bit samples, signed and unsigned, 16-,
32- and 64-bit floats, a second sample as alpha), 2 (8- and 16-bit RGB,
extra samples), 3 (1-, 2-, 4- and 8-bit palettes), 5 (CMYK of 8 and 16
bits) and 6 (YCbCr: JPEG-coded, or subsampled data units converted by
libtiff's tables). LZW, PackBits, the predictors and the fax codes run in
host C++ (``csrc/tiff_decode.cpp``, ``csrc/fax_decode.cpp``, built at
first use); ``plain=True`` runs their plain Python versions, bit-equal to
them. A file whose mode is not read here (Zstandard, LogLuv, CIELab,
old-style JPEG, other sample sizes, the layouts whose cv2 or PIL read
garbles its pixels) raises ValueError naming ROADMAP.md queue 1 item 26e,
but where cv2 gives None: cv2's libtiff is built without some codecs
(``CV2_UNCONFIGURED``), and ``read_cv2`` gives None for them as cv2 does.

cv2 (``read_cv2``): an 8-bit read goes through libtiff's RGBA interface
(16-bit gray samples shifted right by 8, 16-bit colour ones scaled by
``(v * 255 + 32767) // 65535``, signed samples taken as unsigned,
min-is-white inverted, a 16-bit colour map shifted right by 8 unless
every entry is below 256, unassociated alpha premultiplied as ``(v * a +
127) // 255``, other extra samples dropped, CMYK as ``(255 - k) * (255 -
c) // 255``, YCbCr by ``TIFFYCbCrtoRGB``), a gray one weighing its B, G,
R (``bmp.to_gray``). ``IMREAD_ANYDEPTH`` of a 16-bit file keeps the
samples (min-is-white not inverted; colour weighed into 16-bit gray), of
an 8- or 16-bit signed file labels the same values signed, of a float
file (32 or 64 bits) or a 32-bit integer one with one sample the samples;
such files give None under the 8-bit reads and with more samples, and
so do 16-bit floats, 2- and 4-bit gray and 2-bit palettes. Orientations
2-4 flip the image, 5-8 give None (cv2 5.0 fails its own check after
transposing).

PIL (``read_pil``): the mode of ``TiffImagePlugin.OPEN_INFO`` for the
file's byte order, photometric, sample format, fill order, bits and extra
samples (``I;16``/``I;16B``, ``I`` and ``I;32`` clipped at 255, ``F``
clipped and truncated, ``1``, ``L`` and its 2- and 4-bit forms
replicated, ``RGBa`` un-premultiplied, a palette's 16-bit entries' high
bytes, ``CMYK`` by ``Convert.c``'s cmyk2rgb), then its EXIF orientation
applied (2-4; 5-8 raise ValueError, item 26e). A file cv2 fails on gives
None from ``read_cv2``; one PIL fails on raises ``CorruptTiff``.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from vido_slam_tpu_torch.io import jpeg, tiff_fax
from vido_slam_tpu_torch.io.bmp import to_gray
from vido_slam_tpu_torch.io.limits import (ImageTooLarge, check_cv2_size,
                                            check_pil_size)
from vido_slam_tpu_torch.io.jpeg import orient
from vido_slam_tpu_torch.utils import host_build

SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
ITEM = "ROADMAP.md queue 1 item 26e"

# the tags TIFFReadDirectory fails on where it cannot read them (the others
# it leaves out with a warning)
FATAL_TAGS = (256, 257, 258, 273, 277, 279, 324, 325, 339)
# the field types read, by their struct codes (others are left out):
# bytes, the integers, and the rationals (two codes a value)
TYPE_CODES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B",
              8: "h", 9: "i", 10: "ii", 13: "I", 16: "Q", 17: "q", 18: "Q"}
RATIONAL = (5, 10)
# the codecs libtiff names that cv2's libtiff is built without: cv2 fails
# ("... compression support is not configured") and gives None (probed:
# old-style JPEG, PixarLog, JBIG, LERC, LZMA, Zstandard, WebP)
CV2_UNCONFIGURED = frozenset({6, 32909, 34661, 34887, 34925, 50000, 50001})
# the codecs read here (LZMA for PIL's reads only)
DECODED = frozenset({1, 2, 3, 4, 5, 7, 8, 32771, 32773, 32946, 34925})
FAX = frozenset({2, 3, 4, 32771})
# the sample dtypes read, by (bits, sample format)
DTYPES = {(8, 1): np.uint8, (8, 2): np.int8, (16, 1): np.uint16,
          (16, 2): np.int16, (16, 3): np.float16, (32, 1): np.uint32,
          (32, 2): np.int32, (32, 3): np.float32, (64, 3): np.float64}
# YCbCr's defaults: TIFF 6.0's luma and libtiff's ReferenceBlackWhite
LUMA = (0.299, 0.587, 0.114)
REF_BLACK_WHITE = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)


class CorruptTiff(ValueError):
    """The bytes are no TIFF the reader decodes."""


class Page(NamedTuple):
    """The first IFD's fields this reader uses."""
    big_endian: bool
    width: int
    height: int
    bits: tuple
    compression: int
    photometric: Optional[int]
    spp: int
    planar: int
    predictor: int
    sample_format: tuple
    extra: tuple
    orientation: int
    fill_order: int
    colormap: Optional[np.ndarray]
    tiled: bool
    chunk_w: int
    chunk_h: int
    offsets: tuple
    counts: tuple
    jpeg_tables: bytes = b""
    subsampling: tuple = (2, 2)
    luma: tuple = LUMA
    ref_bw: tuple = REF_BLACK_WHITE
    t4_options: int = 0
    inkset: int = 1


def _unsupported(what: str) -> ValueError:
    return ValueError(f"TIFF {what} is not supported ({ITEM})")


def read_page(data: bytes, pil: bool = False) -> Page:
    """The first IFD (raises CorruptTiff where libtiff's TIFFOpen fails).
    A tag whose value lies past the end of the file is left out, as
    libtiff leaves it out, but for the sizes, sample layout and chunk
    tables (``FATAL_TAGS``), where libtiff fails; with ``pil``, as PIL's
    directory reader stops there, it and every later entry are left out,
    and so are the entries the file ends inside."""
    if data[:4] not in SIGNATURES:
        raise CorruptTiff("not a TIFF file")
    be = data[:2] == b"MM"
    o = ">" if be else "<"
    big = data[2:4] in (b"\x00+", b"+\x00")
    try:
        if big:
            size, zero, ifd = struct.unpack_from(o + "HHQ", data, 4)
            if size != 8 or zero != 0:
                raise CorruptTiff("BigTIFF header")
            n = struct.unpack_from(o + "Q", data, ifd)[0]
            entry, pos = 20, ifd + 8
        else:
            ifd = struct.unpack_from(o + "I", data, 4)[0]
            n = struct.unpack_from(o + "H", data, ifd)[0]
            entry, pos = 12, ifd + 2
    except struct.error:
        raise CorruptTiff("TIFF header ends early") from None
    if ifd < 8 or n == 0:
        raise CorruptTiff("TIFF directory")
    if pos + n * entry > len(data):
        if not pil:
            raise CorruptTiff("TIFF directory ends early")
        n = (len(data) - pos) // entry
    inline = 8 if big else 4
    tags = {}
    for i in range(n):
        p = pos + i * entry
        tag, typ = struct.unpack_from(o + "HH", data, p)
        count = struct.unpack_from(o + ("Q" if big else "I"), data,
                                   p + 4)[0]
        if typ not in TYPE_CODES:
            continue
        nbytes = struct.calcsize(o + TYPE_CODES[typ]) * count
        vp = p + (12 if big else 8)
        if nbytes > inline:
            vp = struct.unpack_from(o + ("Q" if big else "I"), data, vp)[0]
        if vp + nbytes > len(data) or count > 1 << 24:
            if pil:
                break
            if tag in FATAL_TAGS:
                raise CorruptTiff(f"TIFF tag {tag} reaches past the file")
            continue               # libtiff ignores the tag, with a warning
        v = struct.unpack_from(o + TYPE_CODES[typ] * count, data, vp)
        if typ in RATIONAL:
            # libtiff: (float)((double)num / (double)den), 0 for den 0
            v = tuple(float(np.float32(n / d)) if d else 0.0
                      for n, d in zip(v[::2], v[1::2]))
        tags[tag] = v

    def one(tag, default=None):
        v = tags.get(tag)
        return default if not v else v[0]
    W, H = one(256), one(257)
    if not W or not H:
        raise CorruptTiff("TIFF image size")
    spp = one(277, 1)
    bits = tags.get(258, (1,))
    if len(bits) < spp:
        bits = bits[:1] * spp
    if len(set(bits[:spp])) > 1 or len(set(tags.get(339, (1,))[:spp])) > 1:
        # "Cannot handle different values per sample"
        raise CorruptTiff("TIFF samples of mixed sizes or formats")
    tiled = 322 in tags or 324 in tags
    if tiled:
        cw, ch = one(322), one(323)
        offsets, counts = tags.get(324), tags.get(325)
        if not cw or not ch or cw % 16 or ch % 16:
            raise CorruptTiff("TIFF tile size")
    else:
        cw, ch = W, min(one(278, H) or H, H)
        offsets, counts = tags.get(273), tags.get(279)
    if pil and offsets and not counts and one(259, 1) == 1:
        counts = [len(data)] * len(offsets)   # PIL's raw reader needs none
    if not offsets or not counts:
        raise CorruptTiff("TIFF has no strips or tiles")
    planar = one(284, 1)
    per_plane = -(-H // ch) * (-(-W // cw) if tiled else 1)
    need = per_plane * (spp if planar == 2 else 1)
    if len(offsets) < need or len(counts) < need:
        raise CorruptTiff("TIFF strip or tile count")
    cmap = tags.get(320)
    photometric = one(262)
    if photometric == 3 and cmap is None and bits[0] >= 8 and not pil:
        # TIFFReadDirectory: a palette image without its colour map
        photometric = 2 if spp == 3 else 1
    sub = tags.get(530, (2, 2))
    ref_bw = tags.get(532)
    if ref_bw is None or len(ref_bw) != 6:
        # TIFFDefaultRefBlackWhite, for YCbCr of these bits
        top = float((1 << bits[0]) - 1) if bits[0] < 32 else 0.0
        half = float(1 << (bits[0] - 1)) if bits[0] < 32 else 0.0
        ref_bw = (0.0, top, half, top, half, top)
    return Page(be, W, H, tuple(bits[:spp]), one(259, 1), photometric, spp,
                planar, one(317, 1), tuple(tags.get(339, (1,))),
                tuple(tags.get(338, ())), one(274, 1), one(266, 1),
                None if cmap is None else np.array(cmap, np.int64),
                tiled, cw, ch, tuple(offsets), tuple(counts),
                bytes(tags.get(347, ())),
                tuple(sub) if len(sub) == 2 else (2, 2),
                tuple(tags[529]) if len(tags.get(529, ())) == 3 else LUMA,
                tuple(ref_bw), one(292, 0), one(332, 1))


# ---------------------------------------------------------------------------
# the codecs: C++ and the plain versions
# ---------------------------------------------------------------------------

def _lib():
    lib = host_build.load("tiff_decode")
    for name in ("tiff_lzw_decode", "tiff_packbits_decode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64]
    lib.tiff_undo_predictor.restype = None
    return lib


def _decode_c(name: str, src: bytes, need: int) -> bytes:
    out = np.empty(need, np.uint8)
    got = getattr(_lib(), name)(src, len(src), out.ctypes.data, need)
    if got != need:
        raise CorruptTiff("TIFF strip or tile is corrupt or short")
    return out.tobytes()


def lzw_decode(src: bytes, need: int, plain: bool = False) -> bytes:
    """libtiff's LZWDecode (or LZWDecodeCompat where the data starts with
    an old-style Clear) of one strip or tile into ``need`` bytes."""
    if not plain:
        return _decode_c("tiff_lzw_decode", src, need)
    old_style = len(src) >= 2 and src[0] == 0 and src[1] & 1
    bits = np.unpackbits(np.frombuffer(src, np.uint8),
                         bitorder="little" if old_style else "big")
    prev = [-1] * 5120
    length = [1] * 256 + [0] * (5120 - 256)
    first = list(range(256)) + [0] * (5120 - 256)
    value = list(range(256)) + [0] * (5120 - 256)
    pos, nbits = 0, 9
    free, maxcode = 258, (511 if old_style else 510)
    weights = {}

    def code():
        nonlocal pos
        if len(bits) - pos < nbits:
            raise CorruptTiff("TIFF LZW data ends early")
        w = weights.get(nbits)
        if w is None:
            w = weights[nbits] = (1 << np.arange(nbits)) if old_style \
                else (1 << np.arange(nbits - 1, -1, -1))
        c = int(bits[pos:pos + nbits] @ w)
        pos += nbits
        return c
    out = bytearray()
    old = None
    while len(out) < need:
        c = code()
        if c == 257:
            break
        if c == 256:
            while c == 256:
                for i in range(258, 5120):
                    length[i] = 0
                nbits, free = 9, 258
                maxcode = 511 if old_style else 510
                c = code()
            if c == 257:
                break
            if c > 256:
                raise CorruptTiff("TIFF LZW table is corrupt")
            out.append(c)
            old = c
            continue
        if old is None or free >= 5120:
            raise CorruptTiff("TIFF LZW table is corrupt")
        prev[free], first[free] = old, first[old]
        length[free] = length[old] + 1
        value[free] = first[c] if c < free else first[old]
        free += 1
        if free > maxcode:
            nbits = min(nbits + 1, 12)
            maxcode = (1 << nbits) - (1 if old_style else 2)
        old = c
        if c >= 256:
            if length[c] == 0:
                raise CorruptTiff("TIFF LZW table is corrupt")
            s = []
            while c >= 0:
                s.append(value[c])
                c = prev[c]
            out += bytes(reversed(s))
        else:
            out.append(c)
    if len(out) < need:
        raise CorruptTiff("TIFF LZW data ends early")
    return bytes(out[:need])


def packbits_decode(src: bytes, need: int, plain: bool = False) -> bytes:
    """libtiff's PackBitsDecode of one strip or tile into ``need`` bytes."""
    if not plain:
        return _decode_c("tiff_packbits_decode", src, need)
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < need:
        c = src[i] - 256 if src[i] >= 128 else src[i]
        i += 1
        if c == -128:
            continue
        if c < 0:
            run = min(1 - c, need - len(out))
            if i >= n:
                break
            out += bytes([src[i]]) * run
            i += 1
        else:
            k = min(c + 1, need - len(out))
            if n - i < k:
                break
            out += src[i:i + k]
            i += k
    if len(out) < need:
        raise CorruptTiff("TIFF PackBits data ends early")
    return bytes(out)


def undo_predictor(buf: bytes, rows: int, cols: int, spp: int, nbytes: int,
                   predictor: int, big_endian: bool,
                   plain: bool = False) -> bytes:
    """tif_predict.c's horAcc (2) or fpAcc (3) over ``rows`` rows of
    ``cols`` pixels of ``spp`` samples of ``nbytes`` bytes; the result in
    the file's byte order."""
    arr = np.frombuffer(buf, np.uint8)[:rows * cols * spp * nbytes].copy()
    if not plain:
        _lib().tiff_undo_predictor(
            ctypes.c_void_p(arr.ctypes.data), ctypes.c_int64(rows),
            ctypes.c_int64(cols), ctypes.c_int64(spp),
            ctypes.c_int64(nbytes), ctypes.c_int(predictor),
            ctypes.c_int(int(big_endian)))
        return arr.tobytes()
    if predictor == 2:
        dt = np.dtype({1: "u1", 2: "u2", 4: "u4"}[nbytes]).newbyteorder(
            ">" if big_endian else "<")
        v = arr.view(dt).reshape(rows, cols, spp)
        acc = np.cumsum(v.astype(np.uint64), axis=1) & ((1 << 8 * nbytes) - 1)
        return acc.astype(dt).tobytes()
    planes = arr.reshape(rows, cols * spp * nbytes).astype(np.uint64)
    planes = (np.cumsum(planes.reshape(rows, -1, spp), axis=1) & 255).reshape(
        rows, nbytes, cols * spp).astype(np.uint8)
    vals = planes.transpose(0, 2, 1)                 # MSB first
    if not big_endian:
        vals = vals[..., ::-1]
    return np.ascontiguousarray(vals).tobytes()


# ---------------------------------------------------------------------------
# samples
# ---------------------------------------------------------------------------

def _check_mode(pg: Page) -> None:
    """Raises ValueError for a mode this reader lacks."""
    comp = pg.compression
    if comp == 6:
        raise _unsupported("old-style JPEG compression")
    if comp not in DECODED:
        raise _unsupported(f"compression {comp}")
    ph = pg.photometric
    if ph in (32844, 32845):
        raise _unsupported("LogLuv")
    if ph in (8, 9, 10):
        raise _unsupported("CIELab")
    if ph not in (None, 0, 1, 2, 3, 5, 6):
        raise _unsupported(f"photometric {ph}")
    b, fmt = pg.bits[0], pg.sample_format[0]
    if b in (1, 2, 4):
        if fmt != 1 or pg.spp != 1 or ph not in (None, 0, 1, 3):
            raise _unsupported(f"{b}-bit samples of this kind")
    elif (b, fmt) not in DTYPES:
        raise _unsupported(f"{b}-bit samples of format {fmt}")
    if comp in FAX and (b != 1 or pg.planar == 2):
        raise CorruptTiff("CCITT data of more than one bit")
    if comp == 7 and (b != 8 or ph == 3):
        raise CorruptTiff("JPEG data of these samples")
    if ph == 3 and (b > 8 or pg.spp != 1):
        raise _unsupported(f"{b}-bit palette samples")
    if ph == 2 and pg.spp < 3:
        raise _unsupported(f"RGB of {pg.spp} samples")
    if ph in (None, 0, 1) and pg.spp > 2:
        raise _unsupported(f"gray of {pg.spp} samples")
    if ph == 5 and (pg.spp < 4 or b not in (8, 16)):
        raise _unsupported(f"CMYK of {pg.spp} {b}-bit samples")
    if ph == 6 and (pg.spp != 3 or b != 8):
        raise _unsupported(f"YCbCr of {pg.spp} {b}-bit samples")
    if ph == 6 and pg.planar == 2:
        raise _unsupported("separate YCbCr planes")
    if ph == 3 and pg.colormap is None:
        raise CorruptTiff("TIFF palette without a colour map")


def _lzma_decode(raw: bytes, need: int) -> bytes:
    """tif_lzma.c's LZMADecode: the .xz stream lzma_stream_decoder reads,
    into ``need`` bytes."""
    import lzma

    try:
        buf = lzma.LZMADecompressor().decompress(raw, need)
    except lzma.LZMAError:
        raise CorruptTiff("TIFF LZMA data is corrupt") from None
    if len(buf) < need:
        raise CorruptTiff("TIFF LZMA data ends early")
    return buf


def _jpeg_tables(tables: bytes) -> bytes:
    """The JPEGTables' segments as JPEGSetupDecode's tables-only
    jpeg_read_header reads them: from the SOI to the first EOI, a field cut
    short read on through libtiff's source, which then gives fake EOIs (FF
    D9, again and again). Returns the bytes between the SOI and that EOI;
    CorruptTiff where the field starts with no SOI."""
    if tables[:2] != b"\xff\xd8":
        raise CorruptTiff("TIFF JPEGTables is no JPEG stream")
    n = len(tables)

    def byte(i: int) -> int:
        return tables[i] if i < n else 0xFF if (i - n) % 2 == 0 else 0xD9
    pos = 2
    while True:                              # next_marker, then its segment
        while byte(pos) != 0xFF:
            pos += 1
        start = pos
        while byte(pos) == 0xFF:
            pos += 1
        code = byte(pos)
        pos += 1
        if code == 0xD9:
            break
        if code != 0 and not 0xD0 <= code <= 0xD8 and code != 0x01:
            pos += byte(pos) << 8 | byte(pos + 1)
    return bytes(byte(i) for i in range(2, start))


def _jpeg_chunk(pg: Page, raw: bytes, rows: int, cols: int, per: int,
                last_strip: bool, plain: bool) -> np.ndarray:
    """tif_jpeg.c's JPEGPreDecode and JPEGDecode of one strip or tile: the
    JPEGTables' segments, then the chunk's stream, decoded to (rows, cols,
    per) uint8 (YCbCr converted to RGB by libjpeg, as the JPEGCOLORMODE_RGB
    that cv2's RGBA reader and PIL set asks; other colour spaces as
    coded). Raises CorruptTiff where libtiff fails the chunk."""
    tables = pg.jpeg_tables
    if tables:
        tables = _jpeg_tables(tables)
    if raw[:2] != b"\xff\xd8":
        raise CorruptTiff("TIFF JPEG chunk is no JPEG stream")
    try:
        co = jpeg.read_coefficients(b"\xff\xd8" + tables + raw[2:],
                                    plain=plain)
    except (jpeg.CorruptJpeg, jpeg.UnsupportedJpeg, ImageTooLarge):
        # libjpeg fails the stream, or libjpeg or JPEGPreDecode its frame's
        # component count (other than 1, 3 or 4) or size
        raise CorruptTiff("TIFF JPEG chunk is corrupt") from None
    frame = co.frame
    fw, fh = frame.width, frame.height
    if fw < cols or fh < rows:
        raise _unsupported("JPEG chunks smaller than their strip or tile")
    if fw > cols or fh > rows and not (fw == cols and last_strip):
        raise CorruptTiff("TIFF JPEG chunk exceeds its strip or tile")
    comps = frame.comps
    ycc = pg.photometric == 6 and pg.planar == 1
    hs, vs = pg.subsampling if ycc else (1, 1)
    if len(comps) != per or frame.precision != 8 or comps[0].h > hs \
            or comps[0].v > vs or any(c.h != 1 or c.v != 1
                                      for c in comps[1:]):
        raise CorruptTiff("TIFF JPEG chunk of other components")
    img = jpeg.render(co._replace(space="ycc" if ycc else "raw"),
                      plain=plain)
    if ycc:
        img = img[..., ::-1]
    return img.reshape(fh, fw, per)[:rows, :cols]


def _fax_chunk(pg: Page, raw: bytes, rows: int, cols: int,
               plain: bool) -> bytes:
    """One CCITT strip or tile into rows of packed bits (black runs 1)."""
    mode = pg.compression
    if mode == 3 and pg.t4_options & 1:
        mode = 103
    got, buf = tiff_fax.decode(raw, rows, cols, mode, plain)
    if got < 0 and mode == 32771:
        raise _unsupported("word-aligned CCITT runs that libtiff's "
                           "alignment by address fails on")
    if got < 0 and mode in (3, 103):
        raise _unsupported("T.4 data that ends before its rows, which "
                           "libtiff decodes on by rules not ported")
    if got < 0:
        raise CorruptTiff("TIFF CCITT data is corrupt or ends early")
    if got < rows:
        raise _unsupported("T.6 data that ends before its rows, which "
                           "libtiff leaves unwritten")
    return buf


def _ycbcr_units(buf: bytes, rows: int, cols: int, sub: tuple,
                 stride: Optional[int] = None) -> np.ndarray:
    """Subsampled YCbCr data units (hs x vs Y samples, then Cb and Cr)
    spread over (rows, cols, 3) Y, Cb, Cr samples; ``stride``: the bytes
    from a row of units to the next, where the reader steps otherwise."""
    hs, vs = sub
    ux, uy = -(-cols // hs), -(-rows // vs)
    size = hs * vs + 2
    stride = stride or ux * size
    flat = np.frombuffer(buf, np.uint8)
    units = np.stack([flat[r * stride:r * stride + ux * size]
                      for r in range(uy)]).reshape(uy, ux, size)
    y = units[..., :hs * vs].reshape(uy, ux, vs, hs).transpose(0, 2, 1, 3)
    y = y.reshape(uy * vs, ux * hs)
    c = np.repeat(np.repeat(units[..., hs * vs:], vs, 0), hs, 1)
    return np.concatenate([y[..., None], c], -1)[:rows, :cols]


def _chunk_bytes(pg: Page, rows: int, cols: int, per: int) -> tuple:
    """(the bytes of a chunk's decoded samples (TIFFVStripSize), the bytes
    libtiff's RGBA reader decodes of it): of a strip of subsampled YCbCr,
    its rows rounded up to the units times TIFFScanlineSize, a unit row's
    bytes over the vertical subsampling rounded down (4x4 units of an odd
    count a row lose bytes at the strip's end)."""
    if pg.photometric == 6 and pg.compression != 7:
        hs, vs = pg.subsampling
        unit_row = -(-cols // hs) * (hs * vs + 2)
        need = -(-rows // vs) * unit_row
        if pg.tiled:
            return need, need
        return need, min(need, -(-rows // vs) * vs * (unit_row // vs))
    n = rows * ((cols * per * pg.bits[0] + 7) // 8)
    return n, n


def _decode_chunk(pg: Page, raw: bytes, need: int, rows: int, cols: int,
                  per: int, last_strip: bool, plain: bool) -> tuple:
    """(the decoded bytes, or None, the (rows, cols, per) samples of a
    JPEG chunk, or None) of one strip or tile; CorruptTiff where libtiff
    fails it."""
    comp = pg.compression
    if pg.fill_order == 2:
        raw = raw.translate(tiff_fax.REVERSED)     # TIFFReverseBits
    if comp == 1:
        if len(raw) < need:
            raise CorruptTiff("TIFF strip or tile ends early")
        return raw[:need], None
    if comp == 5:
        return lzw_decode(raw, need, plain), None
    if comp == 32773:
        return packbits_decode(raw, need, plain), None
    if comp == 34925:
        return _lzma_decode(raw, need), None
    if comp == 7:
        return None, _jpeg_chunk(pg, raw, rows, cols, per, last_strip, plain)
    if comp in FAX:
        return _fax_chunk(pg, raw, rows, cols, plain), None
    try:
        buf = zlib.decompressobj().decompress(raw, need)
    except zlib.error:
        raise CorruptTiff("TIFF Deflate data is corrupt") from None
    if len(buf) < need:
        raise CorruptTiff("TIFF Deflate data ends early")
    return buf, None


def samples(data: bytes, plain: bool = False, pil: bool = False,
            lenient: bool = False) -> tuple:
    """(Page, the (H, W, spp) samples), decompressed and predicted back:
    the values of 1-, 2- and 4-bit samples as uint8, wider ones in their
    dtype (``DTYPES``), JPEG-coded YCbCr as R, G, B and subsampled YCbCr
    as Y, Cb, Cr; ``pil``: the directory as PIL reads it; ``lenient``: as
    libtiff's RGBA reader, which fails only where a chunk's data is
    missing and keeps what it decoded of a chunk it fails to decode, read
    by cv2's 8-bit reads (such a file raises ValueError here)."""
    pg = read_page(data, pil)
    _check_mode(pg)
    b, comp = pg.bits[0], pg.compression
    W, H, spp = pg.width, pg.height, pg.spp
    nbytes = max(b // 8, 1)
    planes = spp if pg.planar == 2 else 1
    per = spp // planes
    dt = np.dtype(DTYPES.get((b, pg.sample_format[0]), np.uint8))
    if pg.photometric == 6 and comp != 7:
        if pg.subsampling not in ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2),
                                  (4, 4), (1, 2)):
            raise CorruptTiff("TIFF YCbCr subsampling")
    out = np.zeros((H, W, spp), dt)
    order = ">" if pg.big_endian else "<"
    cw, ch = pg.chunk_w, pg.chunk_h
    across = -(-W // cw)
    down = -(-H // ch)
    k = 0
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across if pg.tiled else 1):
                rows = ch if pg.tiled else min(ch, H - ty * ch)
                cols = cw
                need, read = _chunk_bytes(pg, rows, cols, per)
                full, need = need, read
                off, cnt = pg.offsets[k], pg.counts[k]
                if pil and comp == 1:
                    cnt = len(data) - off     # PIL reads past a strip's end
                k += 1
                raw = data[off:off + cnt]
                try:
                    buf, px = _decode_chunk(pg, raw, need, rows, cols, per,
                                            not pg.tiled and ty == down - 1,
                                            plain)
                except CorruptTiff:
                    if lenient and comp != 7 and off + cnt <= len(data):
                        # libtiff's RGBA reader (stop_on_error 0) keeps a
                        # chunk whose data it read but failed to decode, as
                        # far as it went, the rest zero (JPEG's failures
                        # come in JPEGPreDecode, before that: None)
                        raise _unsupported(
                            "a strip or tile libtiff fails to decode, "
                            "which cv2 keeps as far as it went") from None
                    raise
                if px is None and pg.photometric == 6:
                    # the RGBA reader's strip buffer, zeroed past what
                    # it decodes
                    units = np.zeros(full, np.uint8)
                    units[:need] = np.frombuffer(buf, np.uint8)
                    vis = min(cols, W - tx * cw)
                    if pg.tiled and pg.subsampling == (4, 4) and vis < cols:
                        # putcontig8bitYCbCr44tile skips the columns past
                        # the image edge by 4x2 units' bytes
                        stride = -(-vis // 4) * 18 + (cols - vis) // 4 * 10
                        px = _ycbcr_units(units[:full].tobytes(), rows, vis,
                                          (4, 4), stride)
                        px = np.pad(px, [(0, 0), (0, cols - vis), (0, 0)])
                    else:
                        px = _ycbcr_units(units[:full].tobytes(), rows, cols,
                                          pg.subsampling)
                elif px is None:
                    if pg.predictor in (2, 3) and comp in (5, 8, 32946,
                                                           34925):
                        if pg.predictor == 3 and dt.kind != "f" or \
                                pg.predictor == 2 and b < 8:
                            raise CorruptTiff("TIFF predictor for these "
                                              "samples")
                        if pg.predictor == 2 and b == 64:
                            raise _unsupported("predictor 2 on 64-bit "
                                               "samples")
                        buf = undo_predictor(buf, rows, cols, per, nbytes,
                                             pg.predictor, pg.big_endian,
                                             plain)
                    if b < 8:
                        rowbytes = (cols * per * b + 7) // 8
                        bits = np.unpackbits(np.frombuffer(
                            buf, np.uint8).reshape(rows, rowbytes), axis=1)
                        v = bits[:, :cols * per * b].reshape(rows, cols * per,
                                                             b)
                        px = (v @ (1 << np.arange(b - 1, -1, -1))).astype(
                            np.uint8).reshape(rows, cols, per)
                    else:
                        px = np.frombuffer(buf, dt.newbyteorder(
                            order)).reshape(rows, cols, per).astype(dt)
                y0, x0 = ty * ch, tx * cw
                hh, ww = min(rows, H - y0), min(cols, W - x0)
                out[y0:y0 + hh, x0:x0 + ww,
                    plane * per:(plane + 1) * per] = px[:hh, :ww]
    return pg, out


def _orient(img: np.ndarray, orientation: int) -> Optional[np.ndarray]:
    """cv2's EXIF orientation of the image (``jpeg.orient``); 5-8 give
    None unless the image is square (cv2 5.0 fails its own check where
    transposing reallocates the image)."""
    if 5 <= orientation <= 8 and img.shape[0] != img.shape[1]:
        return None
    return orient(img, orientation)


# ---------------------------------------------------------------------------
# cv2
# ---------------------------------------------------------------------------

def read_cv2(data: bytes, flags: int, plain: bool = False
             ) -> Optional[np.ndarray]:
    """``cv2.imread`` of TIFF bytes under ``flags`` (1 colour, 0 gray, 2
    any depth); None where cv2 fails (a codec its libtiff lacks too);
    ValueError for a mode not read here."""
    try:
        pg = read_page(data)
        if pg.height >= 1 << 31:
            return None         # cv2 5.0 fails the header (probed)
        check_cv2_size(pg.width, pg.height)
        if pg.compression in CV2_UNCONFIGURED:
            return None
        if _cv2_refuses(pg, flags):
            return None
        pg, px = samples(data, plain, lenient=_rgba(pg, flags))
    except CorruptTiff:
        return None
    return _cv2(pg, px, flags)


def _cv2_refuses(pg: Page, flags: int) -> bool:
    """The sample layouts cv2 gives None for (probed): more than four
    samples, 16-bit floats, 2- and 4-bit gray, 2-bit palettes, and
    32- and 64-bit samples but for one sample under IMREAD_ANYDEPTH;
    YCbCr and CMYK that libtiff's RGBA reader has no routine for."""
    b, fmt, ph = pg.bits[0], pg.sample_format[0], pg.photometric
    if pg.spp > 4 or (b, fmt) == (16, 3):
        return True
    if b not in (1, 2, 4, 8, 10, 12, 14, 16, 32, 64):
        return True     # "Invalid bitsperpixel value read from TIFF header"
    if b in (10, 12, 14) and flags != 2:
        return True
    if ph == 3 and b == 16:
        return True
    if _rgba(pg, flags) and (
            ph not in (None, 0, 1, 2, 3, 5, 6, 8, 9, 10, 32844, 32845)
            or ph in (32844, 32845) and pg.compression not in (34676,
                                                               34677)):
        return True     # TIFFRGBAImageOK refuses the photometric
    if 5 <= pg.orientation <= 8 and pg.width != pg.height:
        return True     # cv2 5.0 fails its own check after transposing
    if b in (2, 4) and (ph != 3 or b == 2):
        return True
    if b in (32, 64) and (flags != 2 or pg.spp != 1):
        return True
    if ph == 5 and (b != 8 or pg.inkset != 1):
        return True
    if ph == 6 and pg.compression != 7 and pg.subsampling in ((1, 4),
                                                             (2, 4)):
        return True
    tile_bytes = pg.chunk_h * ((pg.chunk_w * pg.spp * b + 7) // 8)
    if pg.tiled and pg.fill_order == 2 and pg.compression == 1 and \
            _rgba(pg, flags) \
            and not (b == 16 and pg.spp == 2) and tile_bytes % 1024:
        # uncompressed tiles of fill order 2: cv2 fails but on tiles of a
        # multiple of 1024 bytes (probed)
        return True
    return False


def ycbcr_to_rgb(ycc: np.ndarray, luma: tuple = LUMA,
                 ref_bw: tuple = REF_BLACK_WHITE) -> np.ndarray:
    """tif_color.c's TIFFYCbCrToRGBInit tables (built in float, as libtiff
    builds them) and TIFFYCbCrtoRGB of (..., 3) uint8 Y, Cb, Cr: uint8 R,
    G, B. Raises CorruptTiff for the coefficients libtiff refuses."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    if np.isnan(lr) or lg == 0 or np.isnan(lb) or not all(
            f32(-0x7FFFFFFF + 128) < f32(v) < f32(0x7FFFFFFF)
            for v in ref_bw):
        raise CorruptTiff("TIFF YCbCr coefficients")

    def fix(v):
        v = f32(min(max(v, f32(0)), f32(2))) if not np.isnan(v) else f32(0)
        return int(float(v * f32(65536)) + 0.5)
    with np.errstate(all="ignore"):
        f1 = f32(2) - f32(2) * lr
        f2 = f32(lr * f1) / lg
        f3 = f32(2) - f32(2) * lb
        f4 = f32(lb * f3) / lg
    d1, d2, d3, d4 = fix(f1), -fix(f2), fix(f3), -fix(f4)
    rb = [f32(v) for v in ref_bw]
    x = np.arange(-128, 128)

    def code2v(c, black, white, top):
        den = f32(white - black)
        den = den if den != 0 else f32(1)
        with np.errstate(all="ignore"):
            v = (c - int(black)).astype(f32) * f32(top) / den
        v = np.where(~(v >= -4096), f32(-4096), np.minimum(v, f32(4096)))
        return np.trunc(v).astype(np.int64)
    cr = code2v(x, rb[4] - f32(128), rb[5] - f32(128), 127)
    cb = code2v(x, rb[2] - f32(128), rb[3] - f32(128), 127)
    y_tab = code2v(x + 128, rb[0], rb[1], 255)
    half = 1 << 15
    v = ycc.astype(np.int64)
    y, cbi, cri = y_tab[v[..., 0]], v[..., 1], v[..., 2]
    r = y + ((d1 * cr + half) >> 16)[cri]
    g = y + ((d4 * cb + half)[cbi] + (d2 * cr)[cri] >> 16)
    b = y + ((d3 * cb + half) >> 16)[cbi]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def cmyk_to_rgb_libtiff(cmyk: np.ndarray) -> np.ndarray:
    """tif_getimage.c's putRGBcontig8bitCMYKtile: ``(255 - k) * (255 - c)
    // 255`` of (..., 4+) uint8 C, M, Y, K."""
    v = cmyk.astype(np.int64)
    k = 255 - v[..., 3:4]
    return (k * (255 - v[..., :3]) // 255).astype(np.uint8)


def _rgba8(pg: Page, px: np.ndarray) -> np.ndarray:
    """libtiff's TIFFReadRGBA pixels, (H, W, 3) uint8 R, G, B (signed
    samples taken as unsigned)."""
    b, ph = pg.bits[0], pg.photometric
    if px.dtype.kind == "i":
        px = px.view(px.dtype.str.replace("i", "u"))
    if ph == 3:
        cmap = pg.colormap.reshape(3, -1)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        pal = np.zeros((256, 3), np.uint8)
        pal[:min(cmap.shape[1], 256)] = cmap[:, :256].T
        return pal[px[..., 0]]
    if ph in (None, 0, 1):
        g = px[..., 0]
        if b == 1:
            g = (g * 255).astype(np.uint8)
        elif b == 16:
            g = (g >> 8).astype(np.uint8)
        if ph == 0:
            g = 255 - g
        return np.repeat(g[..., None], 3, -1)
    if ph == 5:
        return cmyk_to_rgb_libtiff(px)
    if ph == 6 and pg.compression != 7:
        return ycbcr_to_rgb(px, pg.luma, pg.ref_bw)
    rgb = px[..., :3].astype(np.int64)
    if b == 16:
        rgb = (rgb * 255 + 32767) // 65535
    if pg.spp >= 4 and pg.extra[:1] == (2,):
        a = px[..., 3].astype(np.int64)
        if b == 16:
            a = (a * 255 + 32767) // 65535
        rgb = (rgb * a[..., None] + 127) // 255
    return rgb.astype(np.uint8)


def _rgba(pg: Page, flags: int) -> bool:
    """Whether cv2 reads the file through libtiff's RGBA interface: the
    8-bit reads, and under IMREAD_ANYDEPTH samples under 16 bits and
    16-bit gray with alpha."""
    b = pg.bits[0]
    return b < 32 and (flags != 2 or b != 16 or pg.spp == 2)


def _cv2_unsupported(pg: Page, flags: int) -> None:
    """Raises ValueError for layouts whose cv2 read garbles its pixels
    (libtiff's RGBA tile readers skew gray tiles and flip tiles one by one;
    cv2's raw reader takes separate planes for interleaved samples)."""
    rgba = _rgba(pg, flags)
    gray = pg.photometric in (None, 0, 1)
    if rgba and pg.tiled and pg.orientation in (2, 3, 5, 6, 7, 8):
        raise _unsupported("tiles flipped by their orientation, as cv2 "
                           "reads them")
    if rgba and pg.tiled and gray and (pg.bits[0] == 16 or pg.spp == 2):
        raise _unsupported("16-bit or gray-and-alpha tiles, as cv2 reads "
                           "them")
    if pg.planar == 2 and pg.spp > 1 and (gray or not rgba):
        raise _unsupported("separate planes, as cv2 reads them")


def _cv2(pg: Page, px: np.ndarray, flags: int) -> Optional[np.ndarray]:
    b = pg.bits[0]
    _cv2_unsupported(pg, flags)
    if b in (32, 64):
        return _orient(px[..., 0], pg.orientation)
    signed = px.dtype.kind == "i"
    if flags == 2 and b == 16 and pg.spp != 2:
        u = px.view(np.uint16) if signed else px
        g = u[..., 0] if pg.spp == 1 else to_gray(u[..., 2::-1])
        return _orient(g.view(px.dtype), pg.orientation)
    rgb = _rgba8(pg, px)
    if flags == 1:
        return _orient(rgb[..., ::-1], pg.orientation)
    g = to_gray(rgb[..., ::-1])
    if flags == 2 and signed:
        g = g.view(np.int8)       # cv2 labels the 8-bit read signed
    return _orient(g, pg.orientation)


# ---------------------------------------------------------------------------
# PIL
# ---------------------------------------------------------------------------

# TiffImagePlugin.OPEN_INFO: (mode, rawmode) by (photometric, sample
# formats, fill order, bits, extra samples), for both byte orders and for
# one; PIL_MODES keys them by (big-endian, ...) too. A key it lacks fails
# ("unknown pixel mode").
_PIL_BOTH = {
    (0, (1,), 1, (1,), ()): ("1", "1;I"),
    (0, (1,), 2, (1,), ()): ("1", "1;IR"),
    (1, (1,), 1, (1,), ()): ("1", "1"),
    (1, (1,), 2, (1,), ()): ("1", "1;R"),
    (0, (1,), 1, (2,), ()): ("L", "L;2I"),
    (0, (1,), 2, (2,), ()): ("L", "L;2IR"),
    (1, (1,), 1, (2,), ()): ("L", "L;2"),
    (1, (1,), 2, (2,), ()): ("L", "L;2R"),
    (0, (1,), 1, (4,), ()): ("L", "L;4I"),
    (0, (1,), 2, (4,), ()): ("L", "L;4IR"),
    (1, (1,), 1, (4,), ()): ("L", "L;4"),
    (1, (1,), 2, (4,), ()): ("L", "L;4R"),
    (0, (1,), 1, (8,), ()): ("L", "L;I"),
    (0, (1,), 2, (8,), ()): ("L", "L;IR"),
    (1, (1,), 1, (8,), ()): ("L", "L"),
    (1, (2,), 1, (8,), ()): ("L", "L"),
    (1, (1,), 2, (8,), ()): ("L", "L;R"),
    (1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    (2, (1,), 1, (8,) * 3, ()): ("RGB", "RGB"),
    (2, (1,), 2, (8,) * 3, ()): ("RGB", "RGB;R"),
    (2, (1,), 1, (8,) * 4, ()): ("RGBA", "RGBA"),
    (2, (1,), 1, (8,) * 4, (0,)): ("RGB", "RGBX"),
    (2, (1,), 1, (8,) * 5, (0, 0)): ("RGB", "RGBXX"),
    (2, (1,), 1, (8,) * 6, (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), 1, (8,) * 4, (1,)): ("RGBA", "RGBa"),
    (2, (1,), 1, (8,) * 5, (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), 1, (8,) * 6, (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, (1,), 1, (8,) * 4, (2,)): ("RGBA", "RGBA"),
    (2, (1,), 1, (8,) * 5, (2, 0)): ("RGBA", "RGBAX"),
    (2, (1,), 1, (8,) * 6, (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, (1,), 1, (8,) * 4, (999,)): ("RGBA", "RGBA"),
    (3, (1,), 1, (1,), ()): ("P", "P;1"),
    (3, (1,), 2, (1,), ()): ("P", "P;1R"),
    (3, (1,), 1, (2,), ()): ("P", "P;2"),
    (3, (1,), 2, (2,), ()): ("P", "P;2R"),
    (3, (1,), 1, (4,), ()): ("P", "P;4"),
    (3, (1,), 2, (4,), ()): ("P", "P;4R"),
    (3, (1,), 1, (8,), ()): ("P", "P"),
    (3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
    (3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
    (3, (1,), 2, (8,), ()): ("P", "P;R"),
    (5, (1,), 1, (8,) * 4, ()): ("CMYK", "CMYK"),
    (5, (1,), 1, (8,) * 5, (0,)): ("CMYK", "CMYKX"),
    (5, (1,), 1, (8,) * 6, (0, 0)): ("CMYK", "CMYKXX"),
    (6, (1,), 1, (8,), ()): ("L", "L"),
    (6, (1,), 1, (8,) * 3, ()): ("RGB", "RGBX"),
    (8, (1,), 1, (8,) * 3, ()): ("LAB", "LAB"),
}
_PIL_II = {
    (1, (1,), 1, (12,), ()): ("I;16", "I;12"),
    (0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    (1, (2,), 1, (16,), ()): ("I", "I;16S"),
    (0, (3,), 1, (32,), ()): ("F", "F;32F"),
    (1, (1,), 1, (32,), ()): ("I", "I;32N"),
    (1, (2,), 1, (32,), ()): ("I", "I;32S"),
    (1, (3,), 1, (32,), ()): ("F", "F;32F"),
    (2, (1,), 1, (16,) * 3, ()): ("RGB", "RGB;16L"),
    (2, (1,), 1, (16,) * 4, ()): ("RGBA", "RGBA;16L"),
    (2, (1,), 1, (16,) * 4, (0,)): ("RGB", "RGBX;16L"),
    (2, (1,), 1, (16,) * 4, (1,)): ("RGBA", "RGBa;16L"),
    (2, (1,), 1, (16,) * 4, (2,)): ("RGBA", "RGBA;16L"),
    (5, (1,), 1, (16,) * 4, ()): ("CMYK", "CMYK;16L"),
}
_PIL_MM = {
    (1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
    (1, (2,), 1, (16,), ()): ("I", "I;16BS"),
    (0, (3,), 1, (32,), ()): ("F", "F;32BF"),
    (1, (2,), 1, (32,), ()): ("I", "I;32BS"),
    (1, (3,), 1, (32,), ()): ("F", "F;32BF"),
    (2, (1,), 1, (16,) * 3, ()): ("RGB", "RGB;16B"),
    (2, (1,), 1, (16,) * 4, ()): ("RGBA", "RGBA;16B"),
    (2, (1,), 1, (16,) * 4, (0,)): ("RGB", "RGBX;16B"),
    (2, (1,), 1, (16,) * 4, (1,)): ("RGBA", "RGBa;16B"),
    (2, (1,), 1, (16,) * 4, (2,)): ("RGBA", "RGBA;16B"),
    (5, (1,), 1, (16,) * 4, ()): ("CMYK", "CMYK;16B"),
}
PIL_MODES = {(be,) + key: v for be, one in ((False, _PIL_II), (True, _PIL_MM))
             for key, v in {**_PIL_BOTH, **one}.items()}
# the rawmodes PIL's unpacker lacks: an uncompressed file of them fails
PIL_NO_UNPACKER = {"L;IR", "P;1R", "P;2R", "P;4R"}
# the codecs PIL names (TiffImagePlugin.COMPRESSION_INFO); others fail
PIL_CODECS = frozenset({1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946,
                        34676, 34677, 34925, 50000, 50001})


def _pil_mode(pg: Page) -> tuple:
    """(mode, rawmode) as TiffImagePlugin._setup picks them; CorruptTiff
    where it fails ("unknown pixel mode")."""
    ph = 0 if pg.photometric is None else pg.photometric
    fmt = pg.sample_format
    if len(fmt) > 1 and set(fmt) == {1}:
        fmt = (1,)
    key = (pg.big_endian, ph, tuple(fmt), pg.fill_order, pg.bits, pg.extra)
    if key not in PIL_MODES:
        raise CorruptTiff("PIL: unknown pixel mode")
    return PIL_MODES[key]


def read_pil(data: bytes) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of TIFF bytes: (H, W,
    3) uint8; CorruptTiff where PIL raises, ValueError for a mode not read
    here."""
    if data[:4] == b"MM\x00+":
        raise CorruptTiff("PIL: cannot identify a big-endian BigTIFF")
    pg = read_page(data, pil=True)
    check_pil_size(pg.width, pg.height)
    comp = pg.compression
    if comp not in PIL_CODECS or comp == 50001:
        raise CorruptTiff(f"PIL: compression {comp}")
    if comp in (6, 50000, 32809, 34676, 34677):
        raise _unsupported(f"compression {comp}, as PIL reads it")
    mode, rawmode = _pil_mode(pg)
    ph = 0 if pg.photometric is None else pg.photometric
    if comp == 1:
        if rawmode in PIL_NO_UNPACKER:
            raise CorruptTiff("PIL: unknown raw mode")
        if ph == 6:
            raise _unsupported("uncompressed YCbCr, which PIL unpacks as "
                               "RGBX (it fails or garbles the pixels)")
        pg, px = samples(data, pil=True)
    else:
        # PIL hands compressed files to libtiff, which reads the directory
        # again by its own rules
        px = samples(data)[1]
    b, extra = pg.bits[0], pg.extra
    if pg.orientation in (5, 6, 7, 8):
        raise _unsupported("orientation 5-8 as PIL reads it")
    if pg.planar == 2 and pg.spp > 1 and not (
            b == 8 and ph == 2 and (pg.spp == 3 or extra == (2,))
            or ph == 5 and pg.spp == 4):
        raise _unsupported("separate planes other than 8-bit RGB, RGBA and "
                           "CMYK, as PIL reads them")
    if pg.planar == 2 and comp == 1 and (
            ph == 0 or b == 16 or b == 32 and pg.big_endian):
        # PIL unpacks an uncompressed plane by its rawmode's first letter
        raise _unsupported("a separate plane that PIL unpacks by another "
                           "mode")
    if mode in ("1", "L"):
        g = px[..., 0].view(np.uint8) * np.uint8(255 // ((1 << b) - 1))
        rgb = np.repeat((255 - g if ph == 0 else g)[..., None], 3, -1)
    elif mode in ("I;16", "I;16B"):
        g = np.minimum(px[..., 0], 255).astype(np.uint8)
        rgb = np.repeat(g[..., None], 3, -1)
    elif mode == "I":
        v = px[..., 0]
        if comp != 1 and rawmode in ("I;16BS", "I;32BS"):
            # libtiff hands PIL native samples, which its big-endian
            # rawmode swaps again
            v = v.byteswap()
        if rawmode == "I;32N":
            v = v.view(np.int32)
        g = np.clip(v.astype(np.int64), 0, 255).astype(np.uint8)
        rgb = np.repeat(g[..., None], 3, -1)
    elif mode == "F":
        g = px[..., 0]
        if comp != 1 and rawmode == "F;32BF":
            # libtiff hands PIL native floats, which its rawmode swaps again
            g = g.byteswap()
        with np.errstate(invalid="ignore"):
            g = np.trunc(np.where(np.isnan(g), 0, np.clip(g, 0, 255)))
        rgb = np.repeat(g.astype(np.uint8)[..., None], 3, -1)
    elif mode == "LA":
        rgb = np.repeat(px[..., :1], 3, -1)
    elif mode == "CMYK":
        v = px[..., :4]
        if b == 16:
            v = v >> 8
        rgb = jpeg.cmyk_to_bgr_pil(255 - v.astype(np.uint8))[..., ::-1]
    elif ph == 6:
        rgb = px if comp == 7 else ycbcr_to_rgb(px, pg.luma, pg.ref_bw)
    elif mode in ("RGB", "RGBA"):
        v = px[..., :3]
        if b == 16:
            v = v >> 8
        v = v.astype(np.int64)
        if rawmode.startswith("RGBa"):         # un-premultiplied
            a = px[..., 3].astype(np.int64)
            if b == 16:
                a = a >> 8
            safe = np.maximum(a, 1)[..., None]
            un = np.minimum(255, v * 255 // safe)
            v = np.where(a[..., None] == 0, 0,
                         np.where(a[..., None] == 255, v, un))
        rgb = v.astype(np.uint8)
    elif mode == "P":
        if pg.colormap is None:
            raise CorruptTiff("PIL: a palette image without its colour map")
        cmap = pg.colormap.reshape(3, -1)
        pal = np.zeros((256, 3), np.uint8)
        n = min(cmap.shape[1], 256)
        pal[:n] = (cmap[:, :n].T // 256).astype(np.uint8)
        rgb = pal[px[..., 0]]
    else:
        raise _unsupported(f"PIL mode {mode}")
    return orient(np.ascontiguousarray(rgb), pg.orientation)
