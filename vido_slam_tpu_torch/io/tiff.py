"""TIFF decoding without cv2 or PIL — what ``cv2.imread`` (OpenCV's
``grfmt_tiff.cpp`` on libtiff 4.7) and PIL's ``Image.open(p).convert("RGB")``
(``TiffImagePlugin``) give for the first page of a TIFF file, bit for bit,
each by its own rules, for ``io/datasets.py``.

Read: classic TIFF and BigTIFF in either byte order; strips (a short last
one too) and tiles (overhanging the edge); planar configurations 1 and 2;
no compression, LZW (the 5.0 form and the old one), Deflate (8, 32946,
the standard library's ``zlib``) and PackBits, the horizontal (2) and
floating-point (3) predictors where libtiff applies them (LZW and
Deflate); photometric 0 and 1 (1-, 8- and 16-bit samples, 32-bit floats,
a second sample as alpha), 2 (8- and 16-bit RGB, extra samples), 3 (an
8-bit palette). LZW, PackBits and the predictors run in host C++
(``csrc/tiff_decode.cpp``, built at first use); ``plain=True`` runs their
plain Python versions, bit-equal to it. A file whose mode is not read
here (JPEG-in-TIFF, CCITT, YCbCr, CMYK, LogLuv, other sample sizes or
formats, fill order 2) raises ValueError naming ROADMAP.md queue 1 item
26c.

cv2 (``read_cv2``): an 8-bit read goes through libtiff's RGBA interface
(16-bit gray samples shifted right by 8, 16-bit colour ones scaled by
``(v * 255 + 32767) // 65535``, min-is-white inverted, a 16-bit colour
map shifted right by 8 unless every entry is below 256, unassociated
alpha premultiplied as ``(v * a + 127) // 255``, other extra samples
dropped), a gray one weighing its B, G, R (``bmp.to_gray``).
``IMREAD_ANYDEPTH`` of a 16-bit file keeps the samples (min-is-white not
inverted; colour weighed into 16-bit gray), of a float file with one
sample the floats; float files give None under the 8-bit reads and with
more samples. Orientations 2-4 flip the image, 5-8 give None (cv2 5.0
fails its own check after transposing).

PIL (``read_pil``): the mode of ``TiffImagePlugin.OPEN_INFO`` for the
file's byte order, photometric, sample format, bits and extra samples
(``I;16``/``I;16B`` and ``I`` clipped at 255, ``F`` clipped and
truncated, ``1`` and ``L`` replicated, ``RGBa`` un-premultiplied, a
palette's 16-bit entries' high bytes), then its EXIF orientation applied
(2-4; 5-8 raise ValueError, item 26c). A file cv2 fails on gives None
from ``read_cv2``; one PIL fails on raises ``CorruptTiff``.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from vido_slam_tpu_torch.io.bmp import to_gray
from vido_slam_tpu_torch.io.limits import check_cv2_size, check_pil_size
from vido_slam_tpu_torch.io.jpeg import orient
from vido_slam_tpu_torch.utils import host_build

SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
ITEM = "ROADMAP.md queue 1 item 26c"

# the tags TIFFReadDirectory fails on where it cannot read them (the others
# it leaves out with a warning)
FATAL_TAGS = (256, 257, 258, 273, 277, 279, 324, 325, 339)
# the integer field types, by their struct codes (others are left out)
TYPE_CODES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I",
              16: "Q", 17: "q", 18: "Q"}


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
        nbytes = struct.calcsize(TYPE_CODES[typ]) * count
        vp = p + (12 if big else 8)
        if nbytes > inline:
            vp = struct.unpack_from(o + ("Q" if big else "I"), data, vp)[0]
        if vp + nbytes > len(data) or count > 1 << 24:
            if pil:
                break
            if tag in FATAL_TAGS:
                raise CorruptTiff(f"TIFF tag {tag} reaches past the file")
            continue               # libtiff ignores the tag, with a warning
        tags[tag] = struct.unpack_from(o + TYPE_CODES[typ] * count, data, vp)

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
    return Page(be, W, H, tuple(bits[:spp]), one(259, 1), photometric, spp,
                planar, one(317, 1), tuple(tags.get(339, (1,))),
                tuple(tags.get(338, ())), one(274, 1), one(266, 1),
                None if cmap is None else np.array(cmap, np.int64),
                tiled, cw, ch, tuple(offsets), tuple(counts))


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
    if comp in (6, 7):
        raise _unsupported("JPEG compression")
    if comp in (2, 3, 4, 32771):
        raise _unsupported("CCITT compression")
    if comp not in (1, 5, 8, 32946, 32773):
        raise _unsupported(f"compression {comp}")
    ph = pg.photometric
    if ph == 5:
        raise _unsupported("CMYK (separated)")
    if ph == 6:
        raise _unsupported("YCbCr")
    if ph in (32844, 32845):
        raise _unsupported("LogLuv")
    if ph not in (None, 0, 1, 2, 3):
        raise _unsupported(f"photometric {ph}")
    if pg.fill_order != 1:
        raise _unsupported("fill order 2")
    if len(set(pg.bits)) != 1 or len(set(pg.sample_format)) != 1:
        raise _unsupported("samples of mixed sizes or formats")
    b, fmt = pg.bits[0], pg.sample_format[0]
    if fmt == 3:
        if b != 32:
            raise _unsupported(f"{b}-bit floating-point samples")
    elif fmt != 1 or b not in (1, 8, 16):
        raise _unsupported(f"{b}-bit samples of format {fmt}")
    if b == 1 and (pg.spp != 1 or ph == 3):
        raise _unsupported("1-bit colour or palette samples")
    if ph == 3 and (b != 8 or pg.spp != 1):
        raise _unsupported(f"{b}-bit palette samples")
    if ph == 2 and pg.spp < 3:
        raise _unsupported(f"RGB of {pg.spp} samples")
    if ph in (None, 0, 1) and pg.spp > 2:
        raise _unsupported(f"gray of {pg.spp} samples")
    if ph == 3 and pg.colormap is None:
        raise CorruptTiff("TIFF palette without a colour map")


def samples(data: bytes, plain: bool = False, pil: bool = False) -> tuple:
    """(Page, the (H, W, spp) samples): uint8 (0/1 for 1-bit files),
    uint16 or float32, decompressed and predicted back; ``pil``: the
    directory as PIL reads it."""
    pg = read_page(data, pil)
    _check_mode(pg)
    b = pg.bits[0]
    W, H, spp = pg.width, pg.height, pg.spp
    nbytes = max(b // 8, 1)
    planes = spp if pg.planar == 2 else 1
    per = spp // planes
    dt = {1: np.uint8, 8: np.uint8, 16: np.uint16}.get(b, np.float32)
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
                rowbytes = (cols * per * b + 7) // 8
                need = rows * rowbytes
                off, cnt = pg.offsets[k], pg.counts[k]
                if pil and pg.compression == 1:
                    cnt = len(data) - off     # PIL reads past a strip's end
                k += 1
                raw = data[off:off + cnt]
                comp = pg.compression
                if comp == 1:
                    if len(raw) < need:
                        raise CorruptTiff("TIFF strip or tile ends early")
                    buf = raw[:need]
                elif comp == 5:
                    buf = lzw_decode(raw, need, plain)
                elif comp == 32773:
                    buf = packbits_decode(raw, need, plain)
                else:
                    try:
                        d = zlib.decompressobj()
                        buf = d.decompress(raw, need)
                    except zlib.error:
                        raise CorruptTiff("TIFF Deflate data is corrupt") \
                            from None
                    if len(buf) < need:
                        raise CorruptTiff("TIFF Deflate data ends early")
                if pg.predictor in (2, 3) and comp in (5, 8, 32946):
                    if pg.predictor == 3 and b != 32 or \
                            pg.predictor == 2 and b == 1:
                        raise CorruptTiff("TIFF predictor for these samples")
                    buf = undo_predictor(buf, rows, cols, per, nbytes,
                                         pg.predictor, pg.big_endian, plain)
                if b == 1:
                    px = np.unpackbits(np.frombuffer(buf, np.uint8).reshape(
                        rows, rowbytes), axis=1)[:, :cols, None]
                else:
                    px = np.frombuffer(buf, np.dtype(dt).newbyteorder(
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
    any depth); None where cv2 fails; ValueError for a mode not read
    here."""
    try:
        pg = read_page(data)
        if pg.height >= 1 << 31:
            return None         # cv2 5.0 fails the header (probed)
        check_cv2_size(pg.width, pg.height)
        pg, px = samples(data, plain)
    except CorruptTiff:
        return None
    return _cv2(pg, px, flags)


def _rgba8(pg: Page, px: np.ndarray) -> np.ndarray:
    """libtiff's TIFFReadRGBA pixels, (H, W, 3) uint8 R, G, B."""
    b, ph = pg.bits[0], pg.photometric
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
    rgb = px[..., :3].astype(np.int64)
    if b == 16:
        rgb = (rgb * 255 + 32767) // 65535
    if pg.spp >= 4 and pg.extra[:1] == (2,):
        a = px[..., 3].astype(np.int64)
        if b == 16:
            a = (a * 255 + 32767) // 65535
        rgb = (rgb * a[..., None] + 127) // 255
    return rgb.astype(np.uint8)


def _cv2_unsupported(pg: Page, flags: int) -> None:
    """Raises ValueError for layouts whose cv2 read garbles its pixels
    (libtiff's RGBA tile readers skew gray tiles and flip tiles one by one;
    cv2's raw reader takes separate planes for interleaved samples)."""
    rgba = pg.bits[0] != 32 and (flags != 2 or pg.bits[0] != 16)
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
    if pg.spp > 4:
        return None              # cv2: "Unsupported number of channels"
    _cv2_unsupported(pg, flags)
    if px.dtype == np.float32:
        if flags != 2 or pg.spp != 1:
            return None
        return _orient(px[..., 0], pg.orientation)
    if flags == 2 and b == 16:
        if pg.photometric == 3 or pg.spp == 2:
            return None
        g = px[..., 0] if pg.spp == 1 else to_gray(px[..., 2::-1])
        return _orient(g, pg.orientation)
    rgb = _rgba8(pg, px)
    if flags == 1:
        return _orient(rgb[..., ::-1], pg.orientation)
    return _orient(to_gray(rgb[..., ::-1]), pg.orientation)


# ---------------------------------------------------------------------------
# PIL
# ---------------------------------------------------------------------------

def read_pil(data: bytes) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of TIFF bytes: (H, W,
    3) uint8; CorruptTiff where PIL raises, ValueError for a mode not read
    here."""
    if data[:4] == b"MM\x00+":
        raise CorruptTiff("PIL: cannot identify a big-endian BigTIFF")
    pg = read_page(data, pil=True)
    check_pil_size(pg.width, pg.height)
    if pg.compression == 1:
        pg, px = samples(data, pil=True)
    else:
        # PIL hands compressed files to libtiff, which reads the directory
        # again by its own rules
        px = samples(data)[1]
    ph = 0 if pg.photometric is None else pg.photometric
    b, fmt = pg.bits[0], pg.sample_format[0]
    extra = pg.extra
    if pg.orientation in (5, 6, 7, 8):
        raise _unsupported("orientation 5-8 as PIL reads it")
    if pg.planar == 2 and pg.spp > 1 and not (
            b == 8 and ph == 2 and (pg.spp == 3 or extra == (2,))):
        raise _unsupported("separate planes other than 8-bit RGB and RGBA, "
                           "as PIL reads them")
    if pg.planar == 2 and pg.compression == 1 and (
            ph == 0 or b == 16 or b == 32 and pg.big_endian):
        # PIL unpacks an uncompressed plane by its rawmode's first letter
        raise _unsupported("a separate plane that PIL unpacks by another "
                           "mode")
    if ph in (0, 1) and pg.spp == 1:
        g = px[..., 0]
        if b == 1:
            g = (g * 255).astype(np.uint8)
            g = 255 - g if ph == 0 else g
        elif b == 8:
            g = 255 - g if ph == 0 else g
        elif b == 16:
            if ph == 0 and pg.big_endian:
                raise CorruptTiff("PIL: unknown pixel mode")
            g = np.minimum(g, 255).astype(np.uint8)
        else:
            if pg.big_endian and pg.compression != 1:
                # libtiff hands PIL native floats, which its rawmode
                # F;32BF swaps again
                g = g.byteswap()
            with np.errstate(invalid="ignore"):
                g = np.trunc(np.where(np.isnan(g), 0, np.clip(g, 0, 255)))
            g = g.astype(np.uint8)
        rgb = np.repeat(g[..., None], 3, -1)
    elif ph == 1 and pg.spp == 2 and b == 8 and extra == (2,):
        rgb = np.repeat(px[..., :1], 3, -1)
    elif ph == 2 and fmt == 1 and b in (8, 16):
        n = pg.spp
        if b == 16 and (n > 4 or n == 4 and extra not in ((), (0,), (1,),
                                                          (2,))):
            raise CorruptTiff("PIL: unknown pixel mode")
        ok = {3: ((),), 4: ((), (0,), (1,), (2,), (999,)),
              5: ((0, 0), (1, 0), (2, 0)), 6: ((0, 0, 0), (1, 0, 0),
                                               (2, 0, 0))}
        if extra not in ok.get(n, ()):
            raise CorruptTiff("PIL: unknown pixel mode")
        v = px[..., :3]
        if b == 16:
            v = v >> 8
        v = v.astype(np.int64)
        if extra[:1] == (1,):                  # RGBa: un-premultiplied
            a = px[..., 3].astype(np.int64)
            if b == 16:
                a = a >> 8
            safe = np.maximum(a, 1)[..., None]
            un = np.minimum(255, v * 255 // safe)
            v = np.where(a[..., None] == 0, 0,
                         np.where(a[..., None] == 255, v, un))
        rgb = v.astype(np.uint8)
    elif ph == 3 and b == 8 and pg.spp == 1:
        if pg.colormap is None:
            raise CorruptTiff("PIL: a palette image without its colour map")
        cmap = pg.colormap.reshape(3, -1)
        pal = np.zeros((256, 3), np.uint8)
        n = min(cmap.shape[1], 256)
        pal[:n] = (cmap[:, :n].T // 256).astype(np.uint8)
        rgb = pal[px[..., 0]]
    else:
        raise CorruptTiff("PIL: unknown pixel mode")
    return orient(rgb, pg.orientation)
