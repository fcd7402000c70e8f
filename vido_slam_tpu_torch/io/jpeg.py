"""JPEG decoding without cv2 — what the port's readers need of
``cv2.imread`` and of PIL's ``Image.open(p).convert("RGB")`` on ``.jpg``
files (both libjpeg-turbo 3.1 at its defaults), bit for bit, for the
port's dataset readers (``io/datasets.py``).

Decoded: JPEG of 8-bit samples, 1, 3 or 4 components (gray, YCbCr, RGB,
CMYK, YCCK), Huffman- or arithmetic-coded: baseline and extended
sequential (SOF0, SOF1, SOF9) in one interleaved scan or in several (one
a component, or any grouping), progressive (SOF2, SOF10) with any script
of spectral selection and successive approximation; lossless (SOF3) of 2-8
bits, any predictor and point transform; any integer sampling layout —
4:4:4, 4:2:2 (h2v1), 4:2:0 (h2v2), 4:4:0 (h1v2) and the box-upsampled
others —, 8- and 16-bit DQT tables (each component's latched at its first
scan, as jdinput.c does), optimised Huffman tables, libjpeg's standard
tables for a sequential scan that names table 0 or 1 where the file
defines none (Motion-JPEG frames; a progressive file without them fails,
as in cv2), tables and DAC conditioning redefined between scans, and
DRI/RSTn restart intervals. The arithmetic is libjpeg's: jdarith.c's QM
decoder, the JDCT_ISLOW integer IDCT, fancy (triangle) upsampling, the
fixed-point YCbCr -> RGB tables, written out as BGR (the IDCT in the
16-bit lanes of libjpeg-turbo's x86-64 SIMD build, which differ from
jidctint.c only on corrupt coefficients: ``csrc/jpeg_decode.cpp``), and
the block smoothing of a progressive file whose low coefficients are
incomplete at output; a gray read of a colour file is the Y plane
(libjpeg's ``JCS_GRAYSCALE`` output). A lossless file's samples are
box-upsampled and converted to no other colour space (libjpeg fails on a
gray read of RGB, a colour read of gray, and on YCbCr or YCCK). The EXIF
orientation tag is applied as ``cv2.imread`` applies it (flips and
transposes).

Where the data ends early, or a marker stands inside the Huffman-coded
data, the rest of the restart segment keeps the coefficients it has (a
baseline file decodes uniform gray there), as libjpeg does and cv2
returns; past the end of the file libjpeg reads fake EOI markers, and so
does this decoder. Arithmetic-coded data reads zero bits past a marker;
a decoding error leaves the rest of its restart interval as it was. PIL's
reader stops where libjpeg asks for a byte past the end (``strict``:
``TruncatedJpeg``, an ``OSError``, "image file is truncated"), fails where
libjpeg fails after the image, and fails where an arithmetic-coded scan
crosses one of the 64 KiB blocks it feeds libjpeg (``SuspendedJpeg``:
jdarith.c cannot suspend). Bytes libjpeg fails on (no JPEG signature, no
image before EOI, a missing or invalid table, an invalid frame header or
progression, an unsupported SOF) raise ``CorruptJpeg``, where
``cv2.imread`` returns None; so do the files libjpeg-turbo decodes only
through its 12- and 16-bit interfaces, which cv2 and PIL do not call
(12-bit lossy JPEG, lossless of 9-16 bits), and arithmetic-coded lossless
files (SOF11), which it does not decode.

The Huffman, arithmetic and lossless decoding, the smoothing and, by
default, the rest run in host C++ (``csrc/jpeg_decode.cpp``, built at
first use, bound by ctypes); ``plain=True`` runs the arithmetic and
lossless scan decoders in Python (``arith_scan_plain``,
``lossless_scan_plain``) and dequantisation, the IDCT, upsampling and
colour in numpy instead, bit-equal to the C++ path.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, NamedTuple, Optional

import numpy as np

from vido_slam_tpu_torch.io.limits import check_cv2_size, check_pil_size
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

# the SOF markers libjpeg-turbo reads: baseline, extended, progressive and
# lossless, Huffman- or arithmetic-coded
SOF_MARKERS = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA, 0xCB)

# PIL's reader feeds libjpeg the file in blocks of this many bytes
# (ImageFile.MAXBLOCK); jdarith.c cannot suspend inside a scan for more
PIL_BLOCK = 65536

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


class UnsupportedJpeg(ValueError):
    """A frame libjpeg may decode that this reader does not: one of other
    than 1, 3 or 4 components."""


class TruncatedJpeg(OSError):
    """The file ends where libjpeg still wants its bytes: PIL's suspending
    reader stops there ("image file is truncated"); cv2's reads fake EOI
    markers on."""


class SuspendedJpeg(OSError):
    """An arithmetic-coded scan runs past the end of one of the blocks PIL
    feeds libjpeg: jdarith.c cannot suspend there and fails, and PIL
    raises "broken data stream"."""


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
    precision: int = 8
    arithmetic: bool = False
    lossless: bool = False


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
    planes: Optional[list] = None  # a lossless file's (ch, cw) uint8
                                   # sample planes (its coefs are empty)


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
    """jdmarker.c get_sof and the checks of jdinput.c initial_setup, and
    what the 8-bit interface that cv2 and PIL call refuses: a precision
    other than 8 (2-8 lossless; libjpeg-turbo decodes 12-bit and 9-16-bit
    lossless JPEG only through its 12- and 16-bit interfaces) and an
    arithmetic-coded lossless file (SOF11: no decoder for it)."""
    if len(body) < 6:
        raise CorruptJpeg("JPEG SOF is too short")
    prec, height, width, nf = struct.unpack(">BHHB", body[:6])
    lossless = m in (0xC3, 0xCB)
    if m == 0xCB:
        raise CorruptJpeg("arithmetic-coded lossless JPEG (SOF11): "
                          "libjpeg-turbo has no decoder for it")
    if prec != 8 and not (lossless and 2 <= prec <= 8):
        raise CorruptJpeg(f"{prec}-bit JPEG: the 8-bit interface of "
                          f"libjpeg-turbo that cv2 and PIL call refuses it")
    if height == 0 or width == 0 or nf == 0:
        raise CorruptJpeg("JPEG frame is empty")
    if nf not in (1, 3, 4):
        raise UnsupportedJpeg(f"JPEG of {nf} components is not supported")
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
    return Frame(width, height, comps, m in (0xC2, 0xCA), prec,
                 m in (0xC9, 0xCA, 0xCB), lossless)


class _Tables:
    """The Huffman and quantisation tables and the restart interval as the
    markers so far define them."""

    def __init__(self):
        self.bits = np.zeros((8, 16), np.uint8)
        self.vals = np.zeros((8, 256), np.uint8)
        self.have = set()
        self.quant = {}
        self.restart = 0
        # the DAC conditioning of the 16 arithmetic-coding tables: each DC
        # table's L and U, then each AC table's K (libjpeg's defaults)
        self.dac = np.concatenate([np.zeros(16), np.ones(16),
                                   np.full(16, 5)]).astype(np.uint8)

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

    def dac_segment(self, body: bytes) -> None:
        """jdmarker.c get_dac: (index, value) pairs, 0-15 a DC table's
        L | U << 4 (L at most U), 16-31 an AC table's K."""
        pos, left = 0, getattr(body, "declared", len(body))
        while left > 0:
            if left < 2:     # libjpeg reads on past the segment, then fails
                raise CorruptJpeg("JPEG DAC has a bad length")
            _need(body, pos + 2)
            index, val = body[pos], body[pos + 1]
            left -= 2
            if index >= 32:
                raise CorruptJpeg("JPEG DAC names a bad table")
            if index >= 16:
                self.dac[32 + index - 16] = val
            else:
                if val & 15 > val >> 4:
                    raise CorruptJpeg("JPEG DAC value is invalid")
                self.dac[index], self.dac[16 + index] = val & 15, val >> 4
            pos += 2
        if left != 0:
            raise CorruptJpeg("JPEG DAC has a bad length")

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


def read_coefficients(data: bytes, strict: bool = False,
                      plain: bool = False) -> Coefficients:
    """Every scan of the file, as libjpeg's input controller absorbs them
    before output (jdinput.c, jdmarker.c, jdhuff.c, jdphuff.c, jdarith.c,
    and jdlhuff.c with jddiffct.c for a lossless file, whose samples it
    returns): the header up to the first scan, then each scan and the
    markers between scans up to EOI (a file of one scan holding every
    component ends with it). ``strict``: where the file ends before libjpeg
    is done with it, TruncatedJpeg, as PIL's suspending reader, and where
    an arithmetic-coded scan crosses one of PIL's blocks, SuspendedJpeg;
    a precision other than 8 fails (PIL's own check); else ``cv2.imread``'s
    size limits hold (``limits.ImageTooLarge``). ``plain``: the arithmetic
    and lossless scans by their Python decoders."""
    frame, orientation = None, 1
    tables = _Tables()
    jfif = adobe = None
    for m, body, end in _segments(data, strict):
        if m in SOF_MARKERS or 0xC5 <= m <= 0xCF and m != 0xCC:
            if frame is not None:
                raise CorruptJpeg("JPEG has two frame headers")
            if m not in SOF_MARKERS:
                raise CorruptJpeg(f"JPEG SOF {m:#04x} is not supported by "
                                  f"libjpeg")
            frame = _frame(m, body)
            if strict and frame.precision != 8:
                raise CorruptJpeg(f"PIL cannot handle {frame.precision}-bit "
                                  f"layers")
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
    else:
        check_pil_size(frame.width, frame.height)
    comps = frame.comps
    space = color_space([c.ident for c in comps], jfif, adobe,
                        frame.lossless)
    if not frame.progressive:
        tables.standard()
    lay = layout(frame)
    n = len(comps)
    planes = None
    if frame.lossless:
        coefs = [np.zeros((0, 0, 64), np.int16)] * n
        planes = [np.zeros(size, np.uint8) for size in lay.sizes]
    else:
        coefs = [np.zeros((bh, bw, 64), np.int16) for bh, bw in lay.blocks]
    latched = [None] * n
    bits = prev = None
    if frame.progressive:
        bits = np.full((n, 64), -1, np.int64)
        prev = np.zeros((n, 64), np.int64)
    src = _Source(data, strict=strict)
    body, pos = first
    scans = 0
    covered = set()          # the components a lossless scan reached
    multi = None
    broken = None
    while True:
        scans += 1
        index, tnums, ss, se, ah, al = _scan_header(frame, body)
        if multi is None:
            multi = frame.progressive or len(index) < n
        if frame.lossless:
            stop = _decode_lossless_scan(data, pos, frame, lay, tables,
                                         planes, index, tnums, ss, se, ah,
                                         al, plain)
            covered.update(index)
        else:
            stop = _decode_scan(data, pos, frame, lay, tables, coefs,
                                latched, bits, prev, scans, index, tnums, ss,
                                se, ah, al, plain)
        if strict and frame.arithmetic and (
                (stop[5] - 1) // PIL_BLOCK > (pos - 1) // PIL_BLOCK):
            raise SuspendedJpeg("broken data stream when reading image file")
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
    if frame.lossless and len(covered) < n:
        # jddiffct.c's whole-image buffer is not pre-zeroed: reading the
        # rows of a component no scan reached fails (JERR_BAD_VIRTUAL_ACCESS)
        raise CorruptJpeg("JPEG lossless component never scanned")
    quant = [q if q is not None else np.zeros(64, np.uint16)
             for q in latched]
    return Coefficients(frame, coefs, quant, bits, prev, scans, last_good,
                        orientation, broken, space, planes)


def color_space(ids: list, jfif: bool, adobe: Optional[int],
                lossless: bool = False) -> str:
    """libjpeg's ``default_decompress_parms``: the colour space of a frame
    of these component ids after a JFIF APP0 (``jfif``) and an Adobe APP14
    of transform ``adobe`` (None: no such marker); a lossless frame
    without either is RGB, whatever its ids."""
    if len(ids) == 1:
        return "gray"
    if len(ids) == 4:
        return "cmyk" if adobe in (None, 0) else "ycck"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    return "rgb" if ids == [82, 71, 66] or lossless else "ycc"


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
    elif m == 0xCC:
        tables.dac_segment(body)
    elif not (0xE0 <= m <= 0xEF or m in (0xDC, 0xFE)):
        # APPn, DNL and COM are skipped; libjpeg fails on the rest
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
                 scans, index, tnums, ss, se, ah, al, plain=False):
    """One scan into the coefficient buffers (jdinput.c start_input_pass,
    jdphuff.c start_pass_phuff_decoder or jdarith.c start_pass_decoder,
    csrc/jpeg_decode.cpp). Returns the decoder's stop record. ``plain``:
    an arithmetic-coded scan by ``arith_scan_plain``."""
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
    for td, ta in tnums:   # (an arithmetic-coded scan's tables are 0-15)
        if not frame.arithmetic and (
                need_dc and (td > 3 or td not in tables.have)
                or need_ac and (ta > 3 or 4 + ta not in tables.have)):
            raise CorruptJpeg("JPEG scan names a Huffman table never "
                              "defined")
    if ns == 1:
        mcuy, mcux = lay.real[index[0]]
        h = v = [1]
    else:
        mcux, mcuy = lay.mcux, lay.mcuy
        h, v = [c.h for c in comps], [c.v for c in comps]
    dcs, acs = [t[0] for t in tnums], [t[1] for t in tnums]
    bws = [lay.blocks[i][1] for i in index]
    if frame.arithmetic and plain:
        return arith_scan_plain(data, pos, [coefs[i] for i in index], bws, h,
                                v, dcs, acs, tables.dac, mcux, mcuy,
                                tables.restart, progressive, ss, se, ah, al)
    I = ctypes.c_int * ns
    ptrs = (ctypes.c_void_p * ns)(*(coefs[i].ctypes.data for i in index))
    src = np.frombuffer(data, np.uint8)
    stop = (ctypes.c_int64 * 6)()
    lib = host_build.load("jpeg_decode")
    if frame.arithmetic:
        fn = lib.jpeg_decode_arith_scan
        tabs = (ctypes.c_void_p(tables.dac.ctypes.data),)
    else:
        fn = lib.jpeg_decode_scan
        tabs = (ctypes.c_void_p(tables.bits.ctypes.data),
                ctypes.c_void_p(tables.vals.ctypes.data))
    fn.restype = ctypes.c_int
    rc = fn(ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(data)),
            ctypes.c_int64(pos), ns, I(*h), I(*v), I(*dcs), I(*acs), ptrs,
            I(*bws), *tabs, mcux, mcuy, tables.restart, int(progressive), ss,
            se, ah, al, stop)
    if rc == -1:
        raise CorruptJpeg("JPEG Huffman table is invalid")
    if rc == -2:
        raise CorruptJpeg("JPEG DC coefficient out of range")
    return list(stop)


def lossless_geometry(frame: Frame, index: list):
    """jdinput.c's and jddiffct.c's geometry of a lossless scan of the
    components ``index`` (a sample a block): (MCUs a row, the MCU rows of
    each iMCU row, each component's (h, v) in an MCU and its sample rows
    in an iMCU row)."""
    comps = [frame.comps[i] for i in index]
    hmax = max(c.h for c in frame.comps)
    vmax = max(c.v for c in frame.comps)
    imcu_rows = -(-frame.height // vmax)
    if len(index) > 1:
        return (-(-frame.width // hmax), [1] * imcu_rows,
                [(c.h, c.v) for c in comps], [c.v for c in comps])
    c = comps[0]
    ch = -(-frame.height * c.v // vmax)
    last = ch % c.v or c.v
    return (-(-frame.width * c.h // hmax),
            [c.v] * (imcu_rows - 1) + [last], [(1, 1)], [c.v])


def _decode_lossless_scan(data, pos, frame, lay, tables, planes, index,
                          tnums, ss, se, ah, al, plain=False):
    """One lossless scan into the sample planes (jdlossls.c
    start_pass_lossless's checks, jddiffct.c, jdlhuff.c;
    csrc/jpeg_decode.cpp jpeg_decode_lossless_scan, or
    ``lossless_scan_plain``). Returns the decoder's stop record."""
    ns = len(index)
    comps = [frame.comps[i] for i in index]
    if ns > 1 and sum(c.h * c.v for c in comps) > MAX_BLOCKS_IN_MCU:
        raise CorruptJpeg("JPEG MCU has too many blocks")
    if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= frame.precision:
        raise CorruptJpeg(f"JPEG lossless scan Ss={ss} Se={se} Ah={ah} "
                          f"Al={al} is invalid")
    for td, _ in tnums:
        if td > 3 or td not in tables.have:
            raise CorruptJpeg("JPEG scan names a Huffman table never "
                              "defined")
    mcus_per_row, mcu_rows, hv, comp_v = lossless_geometry(frame, index)
    if tables.restart % mcus_per_row:
        raise CorruptJpeg("JPEG lossless restart interval is not a whole "
                          "number of MCU rows")
    restart_rows = tables.restart // mcus_per_row
    dcs = [t[0] for t in tnums]
    sizes = [lay.sizes[i] for i in index]
    if plain:
        return lossless_scan_plain(
            data, pos, [planes[i] for i in index], hv, dcs, comp_v,
            tables.bits, tables.vals, mcu_rows, mcus_per_row, restart_rows,
            frame.precision, ss, al)
    I = ctypes.c_int * ns
    ptrs = (ctypes.c_void_p * ns)(*(planes[i].ctypes.data for i in index))
    src = np.frombuffer(data, np.uint8)
    stop = (ctypes.c_int64 * 6)()
    fn = host_build.load("jpeg_decode").jpeg_decode_lossless_scan
    fn.restype = ctypes.c_int
    rc = fn(ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(data)),
            ctypes.c_int64(pos), ns, I(*(x[0] for x in hv)),
            I(*(x[1] for x in hv)), I(*dcs), ptrs, I(*(x[1] for x in sizes)),
            I(*(x[0] for x in sizes)), I(*comp_v),
            ctypes.c_void_p(tables.bits.ctypes.data),
            ctypes.c_void_p(tables.vals.ctypes.data), len(mcu_rows),
            (ctypes.c_int * len(mcu_rows))(*mcu_rows), mcus_per_row,
            restart_rows, frame.precision, ss, al, stop)
    if rc == -1:
        raise CorruptJpeg("JPEG Huffman table is invalid")
    return list(stop)


# ---------------------------------------------------------------------------
# the plain versions of the arithmetic and lossless scan decoders
# ---------------------------------------------------------------------------

# jaricom.c's jpeg_aritab, as csrc/jpeg_decode.cpp's kAritab
ARITAB = (
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171)


class _PlainSource:
    """The byte source of csrc/jpeg_decode.cpp (``Source``): the file's
    bytes, -1 past the end; ``marker`` is libjpeg's unread_marker."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.p, self.n = data, pos, len(data)
        self.marker = 0
        self.eof = False

    def byte(self) -> int:
        if self.p >= self.n:
            self.eof = True
            return -1
        self.p += 1
        return self.data[self.p - 1]

    def next_marker(self) -> None:
        while True:
            c = self.byte()
            while c >= 0 and c != 0xFF:
                c = self.byte()
            if c < 0:
                self.marker = 0xD9
                return
            c = self.byte()
            while c == 0xFF:
                c = self.byte()
            if c < 0:
                self.marker = 0xD9
                return
            if c != 0:
                self.marker = c
                return

    def restart_marker(self, num: int) -> int:
        """read_restart_marker (jpeg_resync_to_restart's rules); returns
        the next restart number."""
        if self.marker == 0:
            self.next_marker()
        if self.marker == 0xD0 + num:
            self.marker = 0
        else:
            while True:
                m = self.marker
                if m < 0xC0:
                    action = 2
                elif m < 0xD0 or m > 0xD7:
                    action = 3
                elif m in (0xD0 + ((num + 1) & 7), 0xD0 + ((num + 2) & 7)):
                    action = 3
                elif m in (0xD0 + ((num - 1) & 7), 0xD0 + ((num - 2) & 7)):
                    action = 2
                else:
                    action = 1
                if action == 1:
                    self.marker = 0
                    break
                if action == 3:
                    break
                self.marker = 0
                self.next_marker()
        return (num + 1) & 7

    def stop(self) -> list:
        """The stop record after the scan's MCUs (jpeg_decode_arith_scan's
        layout)."""
        eof, last = int(self.eof), self.p
        if self.marker == 0:
            self.next_marker()
        return [self.p, self.marker, -1, eof, int(self.eof), last]


class _PlainArith(_PlainSource):
    """jdarith.c's QM decoder (``ArithReader``)."""

    def __init__(self, data: bytes, pos: int):
        super().__init__(data, pos)
        self.c = self.a = 0
        self.ct = -16

    def decode(self, st: bytearray, i: int) -> int:
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                data = 0
                if self.marker == 0:
                    data = self.byte()
                    if data < 0:
                        self.marker, data = 0xD9, 0
                    elif data == 0xFF:
                        data = self.byte()
                        while data == 0xFF:
                            data = self.byte()
                        if data == 0:
                            data = 0xFF
                        else:
                            self.marker, data = (0xD9 if data < 0 else data,
                                                 0)
                self.c = (self.c << 8) | data
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000
            self.a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        temp = self.a << self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            self.a = qe
        elif self.a < 0x8000:
            if self.a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        return sv >> 7

    def magnitude(self, stats, st, large, dc):
        """``arith_magnitude``: (|v| - 1, its category's magnitude), or
        (-1, 0) where the category overflows."""
        m = self.decode(stats, st)
        if m and (dc or self.decode(stats, st)):
            if not dc:
                m <<= 1
            st = large
            while self.decode(stats, st):
                m <<= 1
                if m == 0x8000:
                    return -1, 0
                st += 1
        v, mag = m, m
        st += 14
        m >>= 1
        while m:
            if self.decode(stats, st):
                v |= m
            m >>= 1
        return v, mag


def _int16(x: int) -> int:
    return ((x + 32768) & 0xFFFF) - 32768


def arith_scan_plain(data, pos, coefs, bw, h, v, dc, ac, dac, mcux, mcuy,
                     restart, progressive, ss, se, ah, al) -> list:
    """Plain version of ``jpeg_decode_arith_scan``: the scan's components'
    coefficient buffers ``coefs`` ((bh, bw, 64) int16, written in place),
    their blocks in an MCU (h, v), DC and AC table numbers and the DAC
    conditioning ``dac`` (L[16], U[16], K[16])."""
    dc_first = not progressive or (ss == 0 and ah == 0)
    ac_needed = not progressive or ss != 0
    flat = [c.reshape(-1, 64) for c in coefs]
    ns = len(coefs)
    fixed = bytearray([113])
    state = {}

    def reset():
        for c in range(ns):
            if dc_first:
                state[("dc", dc[c])] = bytearray(64)
            if ac_needed:
                state[("ac", ac[c])] = bytearray(256)
        return [0] * ns, [0] * ns

    last, context = reset()
    rd = _PlainArith(data, pos)
    num, to_go = 0, restart
    p1, m1 = 1 << al, -(1 << al)
    lo, hi = (ss, se) if progressive else (1, 63)
    for my in range(mcuy):
        for mx in range(mcux):
            if restart:
                if to_go == 0:
                    num = rd.restart_marker(num)
                    rd.c = rd.a = 0
                    rd.ct = -16
                    last, context = reset()
                    to_go = restart
                to_go -= 1
            if rd.ct == -1:
                continue
            for c in range(ns):
                for by in range(v[c]):
                    for bx in range(h[c]):
                        if rd.ct == -1:
                            break
                        b = flat[c][(my * v[c] + by) * bw[c] + mx * h[c] + bx]
                        _arith_block(rd, b, c, dc, ac, dac, state, fixed,
                                     last, context, progressive, dc_first,
                                     lo, hi, ah, al, p1, m1)
    return rd.stop()


def _arith_block(rd, b, c, dc, ac, dac, state, fixed, last, context,
                 progressive, dc_first, lo, hi, ah, al, p1, m1) -> None:
    """One block of an arithmetic-coded scan (jdarith.c decode_mcu and its
    progressive DC/AC first and refine versions)."""
    if progressive and lo == 0 and ah:          # DC refinement
        if rd.decode(fixed, 0):
            b[0] = _int16(int(b[0]) | p1)
        return
    if dc_first:
        stats = state[("dc", dc[c])]
        st = context[c]
        if rd.decode(stats, st) == 0:
            context[c] = 0
        else:
            sign = rd.decode(stats, st + 1)
            val, m = rd.magnitude(stats, st + 2 + sign, 20, True)
            if val < 0:
                rd.ct = -1
                return
            L, U = int(dac[dc[c]]), int(dac[16 + dc[c]])
            if m < (1 << L) >> 1:
                context[c] = 0
            elif m > (1 << U) >> 1:
                context[c] = 12 + sign * 4
            else:
                context[c] = 4 + sign * 4
            val += 1
            last[c] = (last[c] + (-val if sign else val)) & 0xFFFF
        b[0] = _int16(last[c] << al if progressive else last[c])
        if progressive:
            return
    stats = state[("ac", ac[c])]
    K = int(dac[32 + ac[c]])
    if not progressive or ah == 0:              # AC first (or sequential)
        k = lo
        while k <= hi:
            st = 3 * (k - 1)
            if rd.decode(stats, st):
                break                           # EOB
            while rd.decode(stats, st + 1) == 0:
                st += 3
                k += 1
                if k > hi:
                    rd.ct = -1                  # spectral overflow
                    return
            sign = rd.decode(fixed, 0)
            val, _ = rd.magnitude(stats, st + 2, 189 if k <= K else 217,
                                  False)
            if val < 0:
                rd.ct = -1
                return
            val += 1
            b[ZIGZAG[k]] = _int16((-val if sign else val) << al
                                  if progressive else (-val if sign else val))
            k += 1
        return
    kex = hi                                    # AC refinement
    while kex > 0 and b[ZIGZAG[kex]] == 0:
        kex -= 1
    k = lo
    while k <= hi:
        st = 3 * (k - 1)
        if k > kex and rd.decode(stats, st):
            break
        while True:
            t = int(b[ZIGZAG[k]])
            if t:
                if rd.decode(stats, st + 2):
                    b[ZIGZAG[k]] = _int16(t + (m1 if t < 0 else p1))
                break
            if rd.decode(stats, st + 1):
                b[ZIGZAG[k]] = m1 if rd.decode(fixed, 0) else p1
                break
            st += 3
            k += 1
            if k > hi:
                rd.ct = -1
                return
        k += 1


class _PlainHuffman(_PlainSource):
    """jdhuff.c's bit reader (``Reader``): 57 bits read ahead, zero bits
    past a marker."""

    def __init__(self, data: bytes, pos: int):
        super().__init__(data, pos)
        self.buf = self.nbits = 0
        self.insufficient = False

    def fill(self) -> None:
        while self.nbits <= 56 and self.marker == 0:
            c = self.byte()
            if c < 0:
                self.marker = 0xD9
                break
            if c == 0xFF:
                c = self.byte()
                while c == 0xFF:
                    c = self.byte()
                if c < 0:
                    self.marker = 0xD9
                    break
                if c != 0:
                    self.marker = c
                    break
                c = 0xFF
            self.buf = ((self.buf << 8) | c) & ((1 << 64) - 1)
            self.nbits += 8

    def get(self, n: int) -> int:
        if self.nbits < n:
            self.fill()
            if self.nbits < n:
                self.insufficient = True
                self.buf = (self.buf << (n - self.nbits)) & ((1 << 64) - 1)
                self.nbits = n
        self.nbits -= n
        return (self.buf >> self.nbits) & ((1 << n) - 1)

    def decode(self, table) -> int:
        maxcode, valoffset, huffval, look = table
        if self.nbits < 8:
            self.fill()
        if self.nbits >= 8:
            e = look[(self.buf >> (self.nbits - 8)) & 0xFF]
            if e:
                self.nbits -= e >> 8
                return e & 0xFF
        length = 1
        code = self.get(1)
        while code > maxcode[length]:
            code = (code << 1) | self.get(1)
            length += 1
        if length > 16:
            return 0
        return int(huffval[(code + valoffset[length]) & 0xFF])

    def restart(self, num: int) -> int:
        self.nbits = self.buf = 0
        num = self.restart_marker(num)
        if self.marker == 0:
            self.insufficient = False
        return num


def derive_huffman(bits, vals, max_sym: int):
    """jpeg_make_d_derived_tbl (csrc/jpeg_decode.cpp ``derive``): (maxcode,
    valoffset, symbols, lookahead) of a table, CorruptJpeg for one libjpeg
    rejects (a DC symbol above ``max_sym``; -1: an AC table)."""
    sizes = [length for length in range(1, 17)
             for _ in range(int(bits[length - 1]))]
    if len(sizes) > 256:
        raise CorruptJpeg("JPEG Huffman table is invalid")
    codes, code, si, p = [], 0, sizes[0] if sizes else 0, 0
    while p < len(sizes):
        while p < len(sizes) and sizes[p] == si:
            codes.append(code)
            code += 1
            p += 1
        if code >= 1 << si:
            raise CorruptJpeg("JPEG Huffman table is invalid")
        code <<= 1
        si += 1
    maxcode, valoffset = [0] * 18, [0] * 18
    p = 0
    for length in range(1, 17):
        k = int(bits[length - 1])
        if k:
            valoffset[length] = p - codes[p]
            p += k
            maxcode[length] = codes[p - 1]
        else:
            maxcode[length] = -1
    maxcode[17] = 0xFFFFF
    look = [0] * 256
    for p, (length, code) in enumerate(zip(sizes, codes)):
        if length <= 8:
            first = code << (8 - length)
            for k in range(1 << (8 - length)):
                look[first + k] = length << 8 | int(vals[p])
    if max_sym >= 0 and any(int(x) > max_sym for x in vals[:len(sizes)]):
        raise CorruptJpeg("JPEG Huffman table is invalid")
    return maxcode, valoffset, vals, look


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _predict(psv: int, ra: int, rb: int, rc: int) -> int:
    return (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
            rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv - 1]


def lossless_scan_plain(data, pos, planes, hv, dc, comp_v, bits, vals,
                        mcu_rows, mcus_per_row, restart_rows, precision, psv,
                        pt) -> list:
    """Plain version of ``jpeg_decode_lossless_scan``: the scan's
    components' (ch, cw) uint8 planes written in place."""
    ns = len(planes)
    tables = [derive_huffman(bits[t], vals[t], 16) for t in dc]
    rd = _PlainHuffman(data, pos)
    width = [mcus_per_row * h for h, _ in hv]
    diff = [np.zeros((cv, w), np.int64) for cv, w in zip(comp_v, width)]
    prev = [None] * ns
    first = [True] * ns
    initial = 1 << (precision - pt - 1)
    num, to_go = 0, restart_rows
    for r, rows_here in enumerate(mcu_rows):
        for y in range(rows_here):
            if restart_rows and to_go == 0:
                num = rd.restart(num)
                first = [True] * ns
                to_go = restart_rows
            if rd.insufficient:
                for c, (_, v) in enumerate(hv):
                    rows = v if ns > 1 else 1
                    diff[c][y * rows:y * rows + rows] = 0
                    first[c] = True
            else:
                for mx in range(mcus_per_row):
                    for c, (h, v) in enumerate(hv):
                        rows = v if ns > 1 else 1
                        for by in range(rows):
                            for bx in range(h):
                                s = rd.decode(tables[c])
                                if s == 16:
                                    s = 32768
                                elif s:
                                    s = _extend(rd.get(s), s)
                                diff[c][y * rows + by, mx * h + bx] = s
            if restart_rows:
                to_go -= 1
        for c in range(ns):
            ch, cw = planes[c].shape
            for i in range(comp_v[c]):
                row = r * comp_v[c] + i
                if row >= ch:
                    break
                d = diff[c][i, :cw]
                out = np.empty(cw, np.int64)
                if first[c]:
                    out = (np.cumsum(d) + initial) & 0xFFFF
                    first[c] = False
                else:
                    up = prev[c]
                    ra = out[0] = (int(d[0]) + int(up[0])) & 0xFFFF
                    for x in range(1, cw):
                        ra = out[x] = (int(d[x]) + _predict(
                            psv, ra, int(up[x]), int(up[x - 1]))) & 0xFFFF
                planes[c][row] = (out << pt) & 0xFF
                prev[c] = out
    return rd.stop()


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


def lossless_image(co: Coefficients, lay: Layout, gray: bool,
                   pil: bool) -> np.ndarray:
    """A lossless file's samples as libjpeg-turbo gives them to cv2 (``gray``
    or colour) or to PIL (``pil``): box-upsampled (jdsample.c takes no
    fancy upsampling there), with no colour conversion at all — libjpeg
    fails where the colour space asked for (cv2: gray or BGR, CMYK for four
    components; PIL: gray, RGB or CMYK by the component count) is not the
    file's, as jdcolor.c does in lossless mode."""
    n = len(co.frame.comps)
    want = "cmyk" if n == 4 else "gray" if (n == 1 if pil else gray) \
        else "rgb"
    if co.space != want:
        raise CorruptJpeg(f"libjpeg converts no colours of a lossless JPEG "
                          f"({co.space} to {want})")
    H, W = co.frame.height, co.frame.width
    planes = [np.repeat(np.repeat(p, vx, 0), hx, 1)[:H, :W]
              for p, (hx, vx) in zip(co.planes, lay.expand)]
    if want == "cmyk":
        cmyk = np.stack(planes, -1)
        return cmyk_to_bgr_pil(cmyk) if pil else cmyk_to_bgr_cv2(cmyk, gray)
    if want == "rgb":
        return np.ascontiguousarray(np.stack(planes[::-1], -1))
    if pil:
        return np.repeat(planes[0][..., None], 3, axis=-1)
    return np.ascontiguousarray(planes[0])


def decode_jpeg(data: bytes, *, gray: bool = False, plain: bool = False,
                exif_orientation: bool = True, strict: bool = False,
                pil: bool = False) -> np.ndarray:
    """Decode a JPEG held in memory, as ``cv2.imread`` does with
    ``IMREAD_COLOR`` ((H, W, 3) uint8 BGR) or, with ``gray``,
    ``IMREAD_GRAYSCALE`` ((H, W) uint8), the EXIF orientation applied
    unless ``exif_orientation`` is False (PIL's ``Image.open`` applies
    none). ``plain`` runs steps 2 and 3 in numpy, and an arithmetic-coded
    or lossless file's scans by their Python decoders. ``strict`` fails where
    PIL's reader fails and cv2's does not: TruncatedJpeg where the file
    ends before libjpeg is done with the image, CorruptJpeg where libjpeg
    fails after it. ``pil``: a CMYK or YCCK file's colours as PIL converts
    them (BGR of its RGB), not as cv2 does."""
    co = read_coefficients(data, strict, plain)
    if strict and co.broken:
        raise CorruptJpeg(co.broken)
    img = render(co, gray=gray, plain=plain, pil=pil)
    return orient(img, co.orientation) if exif_orientation else img


def render(co: Coefficients, *, gray: bool = False, plain: bool = False,
           pil: bool = False) -> np.ndarray:
    """The pixels of a file's coefficients (``read_coefficients``), as
    ``decode_jpeg`` returns them but for the EXIF orientation. A caller
    that names the colour space itself, as libtiff does, sets
    ``co.space``: "raw" gives the components as coded, (H, W, n)."""
    frame = co.frame
    lay = layout(frame)
    if frame.lossless:
        return lossless_image(co, lay, gray, pil)
    idct, up, conv = ((idct_plain, upsample_plain, ycc_to_bgr_plain) if plain
                      else (_idct, _upsample, _ycc_to_bgr))
    W, H = frame.width, frame.height
    n = len(frame.comps)
    used = range(1 if n == 1 or gray and co.space == "ycc" else n)
    smooth = smoothing(co)
    planes = [up(idct(smoothed(co, lay, i) if smooth else co.coefs[i],
                      co.quant[i]),
                 lay.sizes[i], lay.expand[i], W, H) for i in used]
    if co.space == "raw":
        img = np.stack(planes, -1)
    elif co.space in ("cmyk", "ycck"):
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
    return img
