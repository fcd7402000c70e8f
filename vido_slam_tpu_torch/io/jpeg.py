"""JPEG decoding without cv2 — what the port's readers need of
``cv2.imread`` and of PIL's ``Image.open(p).convert("RGB")`` on ``.jpg``
files (both libjpeg-turbo 3.1 at its defaults), bit for bit, for the
port's dataset readers (``io/datasets.py``).

Decoded: Huffman-coded JPEG of 8 bits, 1 or 3 components (YCbCr, or gray),
baseline and extended sequential (SOF0, SOF1) in one interleaved scan or in
several (one a component, or any grouping), and progressive (SOF2) with
any script of spectral selection and successive approximation; any
integer sampling layout — 4:4:4, 4:2:2 (h2v1), 4:2:0 (h2v2), 4:4:0 (h1v2)
and the box-upsampled others —, 8- and 16-bit DQT tables (each
component's latched at its first scan, as jdinput.c does), optimised
Huffman tables, libjpeg's standard tables for a sequential scan that
names table 0 or 1 where the file defines none (Motion-JPEG frames; a
progressive file without them fails, as in cv2), tables redefined
between scans, and DRI/RSTn restart intervals. The arithmetic is
libjpeg's: the JDCT_ISLOW integer IDCT, fancy (triangle) upsampling, the
fixed-point YCbCr -> RGB tables, written out as BGR (the IDCT in the
16-bit lanes of libjpeg-turbo's x86-64 SIMD build, which differ from
jidctint.c only on corrupt coefficients: ``csrc/jpeg_decode.cpp``), and
the block smoothing of a progressive file whose low coefficients are
incomplete at output; a gray read of a colour file is the Y plane
(libjpeg's ``JCS_GRAYSCALE`` output). The EXIF orientation tag is applied
as ``cv2.imread`` applies it (flips and transposes).

Where the data ends early, or a marker stands inside the entropy-coded
data, the rest of the restart segment keeps the coefficients it has (a
baseline file decodes uniform gray there), as libjpeg does and cv2
returns; past the end of the file libjpeg reads fake EOI markers, and so
does this decoder. PIL's reader stops where libjpeg asks for a byte past
the end (``strict``: ``TruncatedJpeg``, an ``OSError``, "image file is
truncated"), and fails where libjpeg fails after the image. Bytes libjpeg
fails on (no JPEG signature, no image before EOI, a missing or invalid
table, an invalid frame header or progression, an unsupported SOF) raise
``CorruptJpeg``, where ``cv2.imread`` returns None. Valid files of the
modes this decoder lacks — arithmetic-coded (SOF9-11), lossless (SOF3),
12-bit, CMYK/YCCK or Adobe-transformed colour, RGB-coded components —
raise a plain ``ValueError`` naming the mode: cv2 decodes those, and
returning None would skip a frame.

The Huffman decoding, the smoothing and, by default, the rest run in host
C++ (``csrc/jpeg_decode.cpp``, built at first use, bound by ctypes);
``plain=True`` runs dequantisation, the IDCT, upsampling and colour in
numpy instead, bit-equal to the C++ path.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, NamedTuple, Optional

import numpy as np

from vido_slam_tpu_torch.io.bmp import check_cv2_size
from vido_slam_tpu_torch.utils import host_build

SIGNATURE = b"\xff\xd8"

# jpeg_natural_order: the zigzag position of each natural-order entry
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# jmorecfg.h: the longest side libjpeg decodes (JERR_IMAGE_TOO_BIG)
JPEG_MAX_DIMENSION = 65500

# SOF markers this decoder refuses though libjpeg-turbo decodes them
REFUSED_SOF = {0xC3: "lossless (SOF3)", 0xC9: "arithmetic-coded (SOF9)",
               0xCA: "arithmetic-coded progressive (SOF10)",
               0xCB: "arithmetic-coded lossless (SOF11)"}

# jstdhuff.c: the tables of JPEG's Annex K.3 (DC 0 and 1, AC 0 and 1),
# which libjpeg-turbo puts in slots 0 and 1 that a sequential file leaves
# undefined at its first scan: (counts of each code length, symbols)
STD_HUFFMAN = {
    0: ("00010501010101010100000000000000", "000102030405060708090a0b"),
    1: ("00030101010101010101010000000000", "000102030405060708090a0b"),
    4: ("0002010303020403050504040000017d",
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa"),
    5: ("00020102040403040705040400010277",
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa"),
}

MAX_BLOCKS_IN_MCU = 10   # jpeglib.h D_MAX_BLOCKS_IN_MCU


class CorruptJpeg(ValueError):
    """The bytes are no decodable JPEG (libjpeg fails on them too)."""


class TruncatedJpeg(OSError):
    """The file ends where libjpeg still wants its bytes: PIL's suspending
    reader stops there ("image file is truncated"); cv2's reads fake EOI
    markers on."""


class Component(NamedTuple):
    ident: int
    h: int
    v: int
    quant: int


class Frame(NamedTuple):
    width: int
    height: int
    comps: List[Component]
    progressive: bool = False


class _Source:
    """The file as libjpeg's stdio source gives it: its bytes, then fake
    EOI markers (FF D9, again and again) past its end. ``header``: a read
    past the end raises CorruptJpeg instead (before the first scan, where
    libjpeg fails on every cut). ``strict``: it raises TruncatedJpeg, as a
    suspending source stops."""

    def __init__(self, data: bytes, header: bool = False,
                 strict: bool = False):
        self.data, self.n = data, len(data)
        self.header, self.strict = header, strict

    def byte(self, i: int) -> int:
        if i < self.n:
            return self.data[i]
        if self.strict:
            raise TruncatedJpeg("image file is truncated")
        if self.header:
            raise CorruptJpeg("JPEG ends before its scan")
        return 0xFF if (i - self.n) % 2 == 0 else 0xD9

    def take(self, i: int, k: int) -> bytes:
        if i + k <= self.n:
            return self.data[i:i + k]
        if self.strict:   # what there is: a parser stops where it runs out
            return _Cut(self.data[i:], k)
        return bytes(self.byte(j) for j in range(i, i + k))


class _Cut(bytes):
    """A marker segment's payload that the end of the file cuts: a parser
    reading past it raises TruncatedJpeg where libjpeg would wait for more
    data, after the checks the bytes there allow."""

    def __new__(cls, data: bytes, declared: int):
        obj = super().__new__(cls, data)
        obj.declared = declared
        return obj


def _need(body: bytes, end: int) -> None:
    if end > len(body):
        raise TruncatedJpeg("image file is truncated")


def _length_bearing(m: int) -> None:
    """jdmarker.c read_markers fails on an unsupported SOF or an unknown
    marker before it reads a length."""
    if 0xC5 <= m <= 0xCF and m not in (0xC9, 0xCA, 0xCB, 0xCC):
        raise CorruptJpeg(f"JPEG SOF {m:#04x} is not supported by libjpeg")
    if not (0xC0 <= m <= 0xCF or 0xDA <= m <= 0xDD or 0xE0 <= m <= 0xEF
            or m == 0xFE):
        raise CorruptJpeg(f"JPEG marker {m:#04x} is unknown to libjpeg")


def _segment(src: _Source, m: int, pos: int):
    """(marker, payload, end offset) of the marker m read just before
    ``pos``."""
    if 0xD0 <= m <= 0xD9 or m == 0x01:
        return m, b"", pos
    _length_bearing(m)
    length = src.byte(pos) << 8 | src.byte(pos + 1)
    if length < 2:
        raise CorruptJpeg(f"JPEG marker {m:#04x} has a bad length")
    return m, src.take(pos + 2, length - 2), pos + length


def _walk(src: _Source, pos: int, marker: int = 0, framed: bool = False):
    """(marker, payload, end offset) of each marker from ``pos`` on (after
    ``marker``, already read, where given), with jdmarker.c's rules: bytes
    before an FF are skipped, fill FFs are skipped, RSTn and TEM carry no
    length and are passed over, SOI and EOI are yielded with an empty
    payload. ``framed``: a frame header is known, and another SOF fails at
    its marker."""
    while True:
        if marker:
            c, marker = marker, 0
        else:
            c = src.byte(pos)
            pos += 1
            while c != 0xFF:
                c = src.byte(pos)
                pos += 1
            while c == 0xFF:
                c = src.byte(pos)
                pos += 1
            if c == 0:
                continue
        if 0xD0 <= c <= 0xD7 or c == 0x01:
            continue
        if framed and 0xC0 <= c <= 0xCF and c not in (0xC4, 0xC8, 0xCC):
            raise CorruptJpeg("JPEG has two frame headers")
        seg = _segment(src, c, pos)
        pos = seg[2]
        yield seg


def _segments(data: bytes, strict: bool = False):
    """(marker, payload, end offset) of each marker segment up to SOS."""
    if data[:2] != SIGNATURE:
        raise CorruptJpeg("not a JPEG file (no SOI)")
    for m, body, end in _walk(_Source(data, header=True, strict=strict), 2):
        if m == 0xD9:
            raise CorruptJpeg("JPEG has no image before EOI")
        if m == 0xD8:
            raise CorruptJpeg("JPEG has a second SOI")
        yield m, body, end
        if m == 0xDA:
            return


def _exif_orientation(body: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 in an APP1 Exif payload, 1
    where there is none."""
    if body[:6] != b"Exif\x00\x00" or len(body) < 14:
        return 1
    tiff = body[6:]
    end = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if end is None:
        return 1
    try:
        ifd, = struct.unpack(end + "I", tiff[4:8])
        count, = struct.unpack(end + "H", tiff[ifd:ifd + 2])
        for i in range(count):
            e = ifd + 2 + 12 * i
            tag, kind = struct.unpack(end + "HH", tiff[e:e + 4])
            if tag == 0x0112 and kind == 3:
                return struct.unpack(end + "H", tiff[e + 8:e + 10])[0]
    except struct.error:
        return 1
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF orientation's transform, as cv2's ExifTransform applies it:
    2 flips left-right, 3 both ways, 4 up-down; 5-8 transpose first, then
    nothing, left-right, both, up-down. Other values change nothing."""
    if orientation in (5, 6, 7, 8):
        img = np.swapaxes(img, 0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


class Coefficients(NamedTuple):
    """What every scan of a file decoded to, at output."""
    frame: Frame
    coefs: List[np.ndarray]      # (bh, bw, 64) int16 of each component
    quant: List[np.ndarray]      # each component's latched table (zeros
                                 # for a component no scan covered)
    bits: Optional[np.ndarray]   # (ncomp, 64) progressive successive-
                                 # approximation bits (-1: none received)
    prev_bits: Optional[np.ndarray]  # the same before each one's last scan
    scans: int
    last_good: int               # the last iMCU row the last scan decoded
                                 # before its data ran out
    orientation: int
    broken: Optional[str]        # a libjpeg error after the image (in
                                 # jpeg_finish_decompress)
    space: str = "ycc"           # libjpeg's jpeg_color_space: gray, ycc,
                                 # rgb, cmyk or ycck


class Layout(NamedTuple):
    mcux: int
    mcuy: int
    blocks: list         # (bh, bw) of each component's coefficient buffer
    real: list           # (hib, wib): each component's blocks in the image
    sizes: list          # (ch, cw) of each component's real samples
    expand: list         # (hx, vx) of each component's upsampling
    imcu_rows: int       # iMCU rows of the image


def layout(frame: Frame) -> Layout:
    """MCU grid, block buffers and upsampling factors (jdinput.c)."""
    W, H = frame.width, frame.height
    hmax = max(c.h for c in frame.comps)
    vmax = max(c.v for c in frame.comps)
    sizes = [(-(-H * c.v // vmax), -(-W * c.h // hmax)) for c in frame.comps]
    real = [(-(-ch // 8), -(-cw // 8)) for ch, cw in sizes]
    if len(frame.comps) == 1:
        mcuy, mcux = real[0]
        blocks = [real[0]]
    else:
        mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
        blocks = [(mcuy * c.v, mcux * c.h) for c in frame.comps]
    expand = []
    for c in frame.comps:
        if hmax % c.h or vmax % c.v:
            raise CorruptJpeg("JPEG sampling factors are not integer "
                              "multiples (libjpeg refuses them)")
        expand.append((hmax // c.h, vmax // c.v))
    return Layout(mcux, mcuy, blocks, real, sizes, expand,
                  -(-H // (8 * vmax)))


def _frame(m: int, body: bytes) -> Frame:
    if len(body) < 6:
        raise CorruptJpeg("JPEG SOF is too short")
    prec, height, width, nf = struct.unpack(">BHHB", body[:6])
    if prec != 8:
        raise ValueError(f"{prec}-bit JPEG is not supported (8-bit only)")
    if height == 0 or width == 0 or nf == 0:
        raise CorruptJpeg("JPEG frame is empty")
    if nf not in (1, 3, 4):
        raise ValueError(f"JPEG of {nf} components is not supported")
    if len(body) != 6 + 3 * nf:
        raise CorruptJpeg("JPEG SOF has a bad length")
    comps = []
    for i in range(nf):
        ident, hv, tq = body[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise CorruptJpeg("JPEG component has bad sampling factors or "
                              "table number")
        comps.append(Component(ident, h, v, tq))
    return Frame(width, height, comps, m == 0xC2)


class _Tables:
    """The Huffman and quantisation tables and the restart interval as the
    markers so far define them."""

    def __init__(self):
        self.bits = np.zeros((8, 16), np.uint8)
        self.vals = np.zeros((8, 256), np.uint8)
        self.have = set()
        self.quant = {}
        self.restart = 0

    def dht(self, body: bytes) -> None:
        """jdmarker.c get_dht, its checks in its order."""
        pos, left = 0, getattr(body, "declared", len(body))
        while left > 16:
            _need(body, pos + 17)
            index = body[pos]
            counts = np.frombuffer(body[pos + 1:pos + 17], np.uint8)
            total = int(counts.sum())
            left -= 17
            if total > 256 or total > left:
                raise CorruptJpeg("JPEG DHT is invalid")
            _need(body, pos + 17 + total)
            left -= total
            tc, th = index >> 4, index & 15
            if tc > 1 or th > 3:
                raise CorruptJpeg("JPEG DHT names a bad table")
            k = 4 * tc + th
            self.bits[k] = counts
            self.vals[k] = 0
            self.vals[k, :total] = np.frombuffer(
                body[pos + 17:pos + 17 + total], np.uint8)
            self.have.add(k)
            pos += 17 + total
        if left != 0:
            raise CorruptJpeg("JPEG DHT has a bad length")

    def dqt(self, body: bytes) -> None:
        """jdmarker.c get_dqt."""
        pos, left = 0, getattr(body, "declared", len(body))
        while left > 0:
            _need(body, pos + 1)
            pq, tq = body[pos] >> 4, body[pos] & 15
            if tq > 3 or pq > 1:
                raise CorruptJpeg("JPEG DQT is invalid")
            size = 128 if pq else 64
            _need(body, pos + 1 + size)
            q = np.frombuffer(body[pos + 1:pos + 1 + size],
                              ">u2" if pq else np.uint8)
            table = np.zeros(64, np.uint16)
            table[ZIGZAG] = q
            self.quant[tq] = table
            pos += 1 + size
            left -= 1 + size
        if left != 0:
            raise CorruptJpeg("JPEG DQT has a bad length")

    def standard(self) -> None:
        """jstdhuff.c at the first scan of a sequential file (cv2's
        libjpeg-turbo does not for a progressive one): slots 0 and 1 left
        undefined take the standard tables."""
        for k, (counts, symbols) in STD_HUFFMAN.items():
            if k not in self.have:
                c = np.frombuffer(bytes.fromhex(counts), np.uint8)
                s = np.frombuffer(bytes.fromhex(symbols), np.uint8)
                self.bits[k] = c
                self.vals[k] = 0
                self.vals[k, :len(s)] = s
                self.have.add(k)


def _scan_header(frame: Frame, body: bytes):
    """jdmarker.c get_sos, its checks in its order: the scan's component
    indices in the frame, their (dc, ac) table numbers, and Ss, Se, Ah,
    Al."""
    _need(body, 1)
    ns = body[0]
    if getattr(body, "declared", len(body)) != 4 + 2 * ns \
            or not 1 <= ns <= 4:
        raise CorruptJpeg("JPEG SOS has a bad length")
    ids = [c.ident for c in frame.comps]
    index, tables = [], []
    for i in range(ns):
        _need(body, 3 + 2 * i)
        cs, t = body[1 + 2 * i], body[2 + 2 * i]
        # the first frame component of this id whose scan slot of the same
        # number is still free (libjpeg's rule; a repeated id fails)
        for ci in range(min(len(ids), 4)):
            if ids[ci] == cs and ci >= len(index):
                break
        else:
            raise CorruptJpeg(f"JPEG scan names component {cs}, not the "
                              f"frame's or twice")
        index.append(ci)
        tables.append((t >> 4, t & 15))
    _need(body, 4 + 2 * ns)
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    return index, tables, ss, se, a >> 4, a & 15


def read_coefficients(data: bytes, strict: bool = False) -> Coefficients:
    """Every scan of the file, as libjpeg's input controller absorbs them
    before output (jdinput.c, jdmarker.c, jdhuff.c, jdphuff.c): the header
    up to the first scan, then each scan and the markers between scans up
    to EOI (a file of one scan holding every component ends with it).
    ``strict``: where the file ends before libjpeg is done with it,
    TruncatedJpeg, as PIL's suspending reader; else ``cv2.imread``'s size
    limits hold (``bmp.ImageTooLarge``)."""
    frame, orientation = None, 1
    tables = _Tables()
    jfif = adobe = None
    for m, body, end in _segments(data, strict):
        if m in (0xC0, 0xC1, 0xC2) or m in REFUSED_SOF \
                or 0xC5 <= m <= 0xCF and m != 0xCC:
            if frame is not None:
                raise CorruptJpeg("JPEG has two frame headers")
            if m in REFUSED_SOF:
                raise ValueError(f"{REFUSED_SOF[m]} JPEG is not supported "
                                 f"(Huffman-coded only)")
            if m not in (0xC0, 0xC1, 0xC2):
                raise CorruptJpeg(f"JPEG SOF {m:#04x} is not supported by "
                                  f"libjpeg")
            frame = _frame(m, body)
        elif m == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
            jfif = True
        elif m == 0xE1 and orientation == 1:
            orientation = _exif_orientation(body)
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif m != 0xDA:
            _table_marker(tables, m, body)
        else:
            if frame is None:
                raise CorruptJpeg("JPEG scan before its frame header")
            first = (body, end)
    if frame.width > JPEG_MAX_DIMENSION or frame.height > JPEG_MAX_DIMENSION:
        raise CorruptJpeg("JPEG image is larger than libjpeg's "
                          f"{JPEG_MAX_DIMENSION} pixels a side")
    if not strict:
        check_cv2_size(frame.width, frame.height)
    comps = frame.comps
    space = color_space([c.ident for c in comps], jfif, adobe)
    if not frame.progressive:
        tables.standard()
    lay = layout(frame)
    n = len(comps)
    coefs = [np.zeros((bh, bw, 64), np.int16) for bh, bw in lay.blocks]
    latched = [None] * n
    bits = prev = None
    if frame.progressive:
        bits = np.full((n, 64), -1, np.int64)
        prev = np.zeros((n, 64), np.int64)
    src = _Source(data, strict=strict)
    body, pos = first
    scans = 0
    multi = None
    broken = None
    while True:
        scans += 1
        index, tnums, ss, se, ah, al = _scan_header(frame, body)
        if multi is None:
            multi = frame.progressive or len(index) < n
        stop = _decode_scan(data, pos, frame, lay, tables, coefs, latched,
                            bits, prev, scans, index, tnums, ss, se, ah, al)
        ran_past, marker, pos = stop[3] or multi and stop[4], stop[1], stop[0]
        last_good = lay.imcu_rows
        if stop[2] >= 0:     # the iMCU row of the MCU where data ran out
            if len(index) == 1:
                mcux = lay.real[index[0]][1]
                last_good = stop[2] // mcux // comps[index[0]].v
            else:
                last_good = stop[2] // lay.mcux
        if strict and ran_past:
            raise TruncatedJpeg("image file is truncated")
        if not multi:
            if strict:
                broken = _trailing_error(data, marker, pos)
            break
        body = None
        for m, body, pos in _walk(src, pos, marker, framed=True):
            if m == 0xD9:
                body = None
                break
            if m == 0xDA:
                break
            _between_scans(tables, m, body)
        if body is None:
            break
    quant = [q if q is not None else np.zeros(64, np.uint16)
             for q in latched]
    return Coefficients(frame, coefs, quant, bits, prev, scans, last_good,
                        orientation, broken, space)


def color_space(ids: list, jfif: bool, adobe: Optional[int]) -> str:
    """libjpeg's ``default_decompress_parms``: the colour space of a frame
    of these component ids after a JFIF APP0 (``jfif``) and an Adobe APP14
    of transform ``adobe`` (None: no such marker)."""
    if len(ids) == 1:
        return "gray"
    if len(ids) == 4:
        return "cmyk" if adobe in (None, 0) else "ycck"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    return "rgb" if ids == [82, 71, 66] else "ycc"


def _table_marker(tables: _Tables, m: int, body: bytes) -> None:
    """A marker of the header other than SOF, APP0/1/14 and SOS."""
    if m == 0xC4:
        tables.dht(body)
    elif m == 0xDB:
        tables.dqt(body)
    elif m == 0xDD:
        if getattr(body, "declared", len(body)) != 2:
            raise CorruptJpeg("JPEG DRI has a bad length")
        _need(body, 2)
        tables.restart, = struct.unpack(">H", body)
    elif not (0xE0 <= m <= 0xEF or m in (0xCC, 0xDC, 0xFE)):
        # APPn, DAC, DNL and COM are skipped; libjpeg fails on the rest
        raise CorruptJpeg(f"JPEG marker {m:#04x} is unknown to libjpeg")


def _between_scans(tables: _Tables, m: int, body: bytes) -> None:
    """A marker after a scan (jdmarker.c read_markers once the frame is
    known; ``_walk(framed=True)`` fails on another SOF): tables may be
    redefined; another SOI fails."""
    if m == 0xD8:
        raise CorruptJpeg("JPEG has a second SOI")
    _table_marker(tables, m, body)


def _trailing_error(data: bytes, marker: int, pos: int) -> Optional[str]:
    """What libjpeg fails on in jpeg_finish_decompress after a file's only
    scan, reading markers to EOI (None where it reaches EOI, or the end of
    the file, where a suspending source stops without error)."""
    tables = _Tables()
    try:
        for m, body, _ in _walk(_Source(data, strict=True), pos, marker,
                                  framed=True):
            if m == 0xD9:
                return None
            if m == 0xDA:
                return "JPEG has a second scan after a single-scan image"
            _between_scans(tables, m, body)
    except TruncatedJpeg:
        return None
    except CorruptJpeg as e:
        return str(e)
    return None


def _decode_scan(data, pos, frame, lay, tables, coefs, latched, bits, prev,
                 scans, index, tnums, ss, se, ah, al):
    """One scan into the coefficient buffers (jdinput.c start_input_pass,
    jdphuff.c start_pass_phuff_decoder, csrc/jpeg_decode.cpp). Returns the
    C++ decoder's stop record."""
    comps = [frame.comps[i] for i in index]
    ns = len(comps)
    if ns > 1 and sum(c.h * c.v for c in comps) > MAX_BLOCKS_IN_MCU:
        raise CorruptJpeg("JPEG MCU has too many blocks")
    for i, c in zip(index, comps):       # latch_quant_tables
        if latched[i] is None:
            if c.quant not in tables.quant:
                raise CorruptJpeg("JPEG scan needs a missing quantisation "
                                  "table")
            latched[i] = tables.quant[c.quant].copy()
    progressive = frame.progressive
    if progressive:
        dc_band = ss == 0
        bad = (se != 0) if dc_band else (ss > se or se >= 64 or ns != 1)
        if ah != 0 and al != ah - 1 or al > 13 or bad:
            raise CorruptJpeg(f"JPEG progression Ss={ss} Se={se} Ah={ah} "
                              f"Al={al} is invalid")
        for i in index:  # the progression status; mismatches only warn
            for k in range(min(ss, 1), max(se, 9) + 1):
                prev[i, k] = bits[i, k] if scans > 1 else 0
            bits[i, ss:se + 1] = al
        need_dc, need_ac = dc_band and ah == 0, not dc_band
    else:
        need_dc = need_ac = True
    for td, ta in tnums:
        if need_dc and (td > 3 or td not in tables.have) \
                or need_ac and (ta > 3 or 4 + ta not in tables.have):
            raise CorruptJpeg("JPEG scan names a Huffman table never "
                              "defined")
    if ns == 1:
        mcuy, mcux = lay.real[index[0]]
        h = v = [1]
    else:
        mcux, mcuy = lay.mcux, lay.mcuy
        h, v = [c.h for c in comps], [c.v for c in comps]
    I = ctypes.c_int * ns
    ptrs = (ctypes.c_void_p * ns)(*(coefs[i].ctypes.data for i in index))
    src = np.frombuffer(data, np.uint8)
    stop = (ctypes.c_int64 * 5)()
    lib = host_build.load("jpeg_decode")
    fn = lib.jpeg_decode_scan
    fn.restype = ctypes.c_int
    rc = fn(ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(data)),
            ctypes.c_int64(pos), ns, I(*h), I(*v),
            I(*(t[0] for t in tnums)), I(*(t[1] for t in tnums)), ptrs,
            I(*(lay.blocks[i][1] for i in index)),
            ctypes.c_void_p(tables.bits.ctypes.data),
            ctypes.c_void_p(tables.vals.ctypes.data), mcux, mcuy,
            tables.restart, int(progressive), ss, se, ah, al, stop)
    if rc == -1:
        raise CorruptJpeg("JPEG Huffman table is invalid")
    if rc == -2:
        raise CorruptJpeg("JPEG DC coefficient out of range")
    return list(stop)


def smoothing(co: Coefficients) -> bool:
    """jdcoefct.c smoothing_ok: block smoothing runs on a progressive file
    whose components all have a latched table with nonzero entries at the
    DC and the first nine AC coefficients and a partly known DC, and where
    some of those AC coefficients are still incomplete."""
    if co.bits is None:
        return False
    useful = False
    for i in range(len(co.frame.comps)):
        q = co.quant[i]
        if (q[[0, 1, 8, 16, 9, 2, 3, 10, 17, 24]] == 0).any():
            return False
        if co.bits[i, 0] < 0:
            return False
        useful = useful or bool((co.bits[i, 1:10] != 0).any())
    return useful


def smoothed(co: Coefficients, lay: Layout, i: int) -> np.ndarray:
    """Component i's coefficients with jdcoefct.c's block smoothing
    (csrc/jpeg_decode.cpp jpeg_smooth_plane)."""
    coef = co.coefs[i]
    out = np.empty_like(coef)
    bh, bw = lay.blocks[i]
    hib, wib = lay.real[i]
    cur = np.ascontiguousarray(co.bits[i, :10], np.int32)
    prev = np.ascontiguousarray(co.prev_bits[i, :10], np.int32)
    if co.scans == 1:
        prev[1:] = -1
    fn = host_build.load("jpeg_decode").jpeg_smooth_plane
    fn.restype = None
    fn(ctypes.c_void_p(coef.ctypes.data), bh, bw, hib, wib,
       co.frame.comps[i].v, lay.imcu_rows,
       ctypes.c_void_p(np.ascontiguousarray(co.quant[i]).ctypes.data),
       ctypes.c_void_p(cur.ctypes.data), ctypes.c_void_p(prev.ctypes.data),
       co.last_good, ctypes.c_void_p(out.ctypes.data))
    return out


# ---------------------------------------------------------------------------
# steps 2 and 3: C++, and the plain numpy version
# ---------------------------------------------------------------------------

def _idct(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    bh, bw = coef.shape[:2]
    out = np.empty((8 * bh, 8 * bw), np.uint8)
    fn = host_build.load("jpeg_decode").jpeg_idct_plane
    fn.restype = None
    fn(ctypes.c_void_p(coef.ctypes.data),
       ctypes.c_void_p(np.ascontiguousarray(quant).ctypes.data), bh, bw,
       ctypes.c_void_p(out.ctypes.data))
    return out


def _upsample(plane: np.ndarray, size, expand, ow: int, oh: int) -> np.ndarray:
    out = np.empty((oh, ow), np.uint8)
    fn = host_build.load("jpeg_decode").jpeg_upsample_plane
    fn.restype = None
    fn(ctypes.c_void_p(plane.ctypes.data), plane.shape[1], size[1], size[0],
       expand[0], expand[1], ctypes.c_void_p(out.ctypes.data), ow, oh)
    return out


def _ycc_to_bgr(y, cb, cr) -> np.ndarray:
    out = np.empty(y.shape + (3,), np.uint8)
    fn = host_build.load("jpeg_decode").jpeg_ycc_to_bgr
    fn.restype = None
    fn(ctypes.c_void_p(y.ctypes.data), ctypes.c_void_p(cb.ctypes.data),
       ctypes.c_void_p(cr.ctypes.data), ctypes.c_int64(y.size),
       ctypes.c_void_p(out.ctypes.data))
    return out


FIX = {k: v for k, v in zip(
    ("0_298", "0_390", "0_541", "0_765", "0_899", "1_175", "1_501", "1_847",
     "1_961", "2_053", "2_562", "3_072"),
    (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819, 20995,
     25172))}


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(x, shift):
    """jidctint.c's 1-D pass over axis -1 of int64 x (..., 8), descaled by
    ``shift`` bits, with the SIMD version's 16-bit sums (csrc/
    jpeg_decode.cpp, step 2)."""
    f = FIX
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * f["0_541"]
    tmp2 = z1 + z3 * -f["1_847"]
    tmp3 = z1 + z2 * f["0_765"]
    tmp0 = _wrap16(x[..., 0] + x[..., 4]) << 13
    tmp1 = _wrap16(x[..., 0] - x[..., 4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = _wrap16(tmp0 + tmp2), _wrap16(tmp1 + tmp3)
    z5 = (z3 + z4) * f["1_175"]
    tmp0 = tmp0 * f["0_298"]
    tmp1 = tmp1 * f["2_053"]
    tmp2 = tmp2 * f["3_072"]
    tmp3 = tmp3 * f["1_501"]
    z1 = z1 * -f["0_899"]
    z2 = z2 * -f["2_562"]
    z3 = z3 * -f["1_961"] + z5
    z4 = z4 * -f["0_390"] + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    out = np.stack([t10 + tmp3, t11 + tmp2, t12 + tmp1, t13 + tmp0,
                    t13 - tmp0, t12 - tmp1, t11 - tmp2, t10 - tmp3], -1)
    return (out + (1 << (shift - 1))) >> shift


def idct_plain(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Plain version of ``jpeg_idct_plane``: (bh, bw, 64) coefficients to
    the (8 bh, 8 bw) plane."""
    bh, bw = coef.shape[:2]
    x = _wrap16(coef.astype(np.int64) * quant.astype(np.int64))
    x = x.reshape(bh, bw, 8, 8)                       # (.., row, col)
    ws = np.swapaxes(_idct_1d(np.swapaxes(x, -1, -2), 11), -1, -2)
    ws = np.clip(ws, -32768, 32767)
    dc_only = (coef.reshape(bh, bw, 8, 8)[:, :, 1:] == 0).all(axis=(2, 3))
    ws = np.where(dc_only[..., None, None],
                  _wrap16(x[:, :, :1, :] << 2), ws)   # the SIMD shortcut
    out = np.clip(_idct_1d(ws, 18) + 128, 0, 255).astype(np.uint8)  # rows
    return out.transpose(0, 2, 1, 3).reshape(8 * bh, 8 * bw)


def upsample_plain(plane: np.ndarray, size, expand, ow: int,
                   oh: int) -> np.ndarray:
    """Plain version of ``jpeg_upsample_plane``."""
    ch, cw = size
    hx, vx = expand
    p = plane[:ch, :cw].astype(np.int32)
    fancy_w = hx == 2 and cw > 2
    if (hx, vx) == (2, 2) and fancy_w:
        up = np.concatenate([p[:1], p[:-1]])
        down = np.concatenate([p[1:], p[-1:]])
        rows = np.empty((2 * ch, cw), np.int32)
        rows[0::2] = 3 * p + up
        rows[1::2] = 3 * p + down
        left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
        right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
        out = np.empty((2 * ch, 2 * cw), np.int32)
        out[:, 0::2] = (3 * rows + left + 8) >> 4
        out[:, 1::2] = (3 * rows + right + 7) >> 4
        out[:, 0] = (4 * rows[:, 0] + 8) >> 4
        out[:, -1] = (4 * rows[:, -1] + 7) >> 4
    else:
        if (hx, vx) == (1, 2):
            up = np.concatenate([p[:1], p[:-1]])
            down = np.concatenate([p[1:], p[-1:]])
            rows = np.empty((2 * ch, cw), np.int32)
            rows[0::2] = (3 * p + up + 1) >> 2
            rows[1::2] = (3 * p + down + 2) >> 2
        else:
            rows = np.repeat(p, vx, 0)
        if fancy_w and vx == 1:
            left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
            right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
            out = np.empty((rows.shape[0], 2 * cw), np.int32)
            out[:, 0::2] = (3 * rows + left + 1) >> 2
            out[:, 1::2] = (3 * rows + right + 2) >> 2
            out[:, 0] = rows[:, 0]
            out[:, -1] = rows[:, -1]
        else:
            out = np.repeat(rows, hx, 1)
    return np.ascontiguousarray(out[:oh, :ow].astype(np.uint8))


def _tables():
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15

    def fix(v):
        return int(v * 65536.0 + 0.5)
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


def ycc_to_bgr_plain(y, cb, cr) -> np.ndarray:
    """Plain version of ``jpeg_ycc_to_bgr``."""
    cr_r, cb_b, cr_g, cb_g = _tables()
    Y = y.astype(np.int64)
    r = Y + cr_r[cr]
    g = Y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = Y + cb_b[cb]
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def cmyk_to_bgr_cv2(cmyk: np.ndarray, gray: bool) -> np.ndarray:
    """grfmt_jpeg.cpp's CMYK -> BGR (``icvCvt_CMYK2BGR_8u_C4C3R``) or
    CMYK -> gray (``icvCvt_CMYK2Gray_8u_C4C1R``) of libjpeg's (H, W, 4)
    CMYK output, which it takes for Adobe's inverted inks."""
    v = cmyk.astype(np.int64)
    k = v[..., 3:]
    c, m, y = np.moveaxis(k - ((255 - v[..., :3]) * k >> 8), -1, 0)
    if gray:
        return ((y * 1868 + m * 9617 + c * 4899 + 8192) >> 14).astype(
            np.uint8)
    return np.stack([y, m, c], -1).astype(np.uint8)


def cmyk_to_bgr_pil(cmyk: np.ndarray) -> np.ndarray:
    """PIL's "CMYK;I" rawmode (each ink inverted) then ``convert("RGB")``
    (Convert.c's cmyk2rgb) of libjpeg's CMYK output, as BGR."""
    v = 255 - cmyk.astype(np.int64)
    nk = 255 - v[..., 3:]
    t = v[..., :3] * nk + 128
    rgb = np.clip(nk - (((t >> 8) + t) >> 8), 0, 255)
    return rgb[..., ::-1].astype(np.uint8)


def rgb_to_gray_libjpeg(rgb: np.ndarray) -> np.ndarray:
    """libjpeg's ``rgb_gray_convert`` of (..., 3) R, G, B planes."""
    v = rgb.astype(np.int64)
    return ((19595 * v[..., 0] + 38470 * v[..., 1] + 7471 * v[..., 2]
             + 32768) >> 16).astype(np.uint8)


def decode_jpeg(data: bytes, *, gray: bool = False, plain: bool = False,
                exif_orientation: bool = True, strict: bool = False,
                pil: bool = False) -> np.ndarray:
    """Decode a JPEG held in memory, as ``cv2.imread`` does with
    ``IMREAD_COLOR`` ((H, W, 3) uint8 BGR) or, with ``gray``,
    ``IMREAD_GRAYSCALE`` ((H, W) uint8), the EXIF orientation applied
    unless ``exif_orientation`` is False (PIL's ``Image.open`` applies
    none). ``plain`` runs steps 2 and 3 in numpy. ``strict`` fails where
    PIL's reader fails and cv2's does not: TruncatedJpeg where the file
    ends before libjpeg is done with the image, CorruptJpeg where libjpeg
    fails after it. ``pil``: a CMYK or YCCK file's colours as PIL converts
    them (BGR of its RGB), not as cv2 does."""
    co = read_coefficients(data, strict)
    if strict and co.broken:
        raise CorruptJpeg(co.broken)
    frame = co.frame
    lay = layout(frame)
    idct, up, conv = ((idct_plain, upsample_plain, ycc_to_bgr_plain) if plain
                      else (_idct, _upsample, _ycc_to_bgr))
    W, H = frame.width, frame.height
    n = len(frame.comps)
    used = range(1 if n == 1 or gray and co.space == "ycc" else n)
    smooth = smoothing(co)
    planes = [up(idct(smoothed(co, lay, i) if smooth else co.coefs[i],
                      co.quant[i]),
                 lay.sizes[i], lay.expand[i], W, H) for i in used]
    if co.space in ("cmyk", "ycck"):
        cmyk = np.stack(planes, -1)
        if co.space == "ycck":       # ycck_cmyk_convert: 255 - RGB, K kept
            cmyk[..., :3] = 255 - conv(*planes[:3])[..., ::-1]
        img = (cmyk_to_bgr_pil(cmyk) if pil
               else cmyk_to_bgr_cv2(cmyk, gray))
    elif co.space == "rgb":
        rgb = np.stack(planes, -1)
        img = rgb_to_gray_libjpeg(rgb) if gray else np.ascontiguousarray(
            rgb[..., ::-1])
    elif gray:
        img = planes[0]
    elif n == 1:
        img = np.repeat(planes[0][..., None], 3, axis=-1)
    else:
        img = conv(*planes)
    return orient(img, co.orientation) if exif_orientation else img
