"""Baseline JPEG decoding without cv2 — what the KITTI demo needs of
``cv2.imread`` on ``.jpg`` frames (libjpeg-turbo 3.1 at its defaults), bit
for bit, for the port's dataset readers (``io/datasets.py``).

Decoded: baseline sequential Huffman JPEG (SOF0, and SOF1 at 8 bits) with
one interleaved scan of 1 or 3 components (YCbCr, or gray), any integer
sampling layout — 4:4:4, 4:2:2 (h2v1), 4:2:0 (h2v2), 4:4:0 (h1v2) and the
box-upsampled others —, 8- and 16-bit DQT tables, optimised Huffman tables
and DRI/RSTn restart intervals. The arithmetic is libjpeg's: the
JDCT_ISLOW integer IDCT, fancy (triangle) upsampling, the fixed-point
YCbCr -> RGB tables, written out as BGR (the IDCT in the 16-bit lanes of
libjpeg-turbo's x86-64 SIMD build, which differ from jidctint.c only on
corrupt coefficients: ``csrc/jpeg_decode.cpp``); a gray read of a colour
file is the Y plane (libjpeg's ``JCS_GRAYSCALE`` output). The EXIF
orientation tag is applied as ``cv2.imread`` applies it (flips and
transposes).

Where the data ends early, or a marker stands inside the entropy-coded
data, the rest of the restart segment decodes as zero coefficients
(uniform gray), as libjpeg does and cv2 returns. Bytes libjpeg fails on
(no JPEG signature, no image before EOI, a missing or invalid table, an
invalid frame header, an unsupported SOF) raise ``CorruptJpeg``, where
``cv2.imread`` returns None. Valid files of the modes this decoder lacks —
progressive (SOF2), arithmetic-coded (SOF9-11), lossless (SOF3), 12-bit,
CMYK or Adobe-transformed colour, RGB-coded components, several scans, no
Huffman table (libjpeg's standard tables) — raise a plain ``ValueError``
naming the mode: cv2 decodes those, and returning None would skip a frame.

The Huffman decoding and, by default, the rest run in host C++
(``csrc/jpeg_decode.cpp``, built at first use, bound by ctypes);
``plain=True`` runs dequantisation, the IDCT, upsampling and colour in
numpy instead, bit-equal to the C++ path.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, NamedTuple

import numpy as np

from vido_slam_tpu_torch.utils import host_build

SIGNATURE = b"\xff\xd8"

# jpeg_natural_order: the zigzag position of each natural-order entry
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# SOF markers this decoder refuses though libjpeg-turbo decodes them
REFUSED_SOF = {0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
               0xC9: "arithmetic-coded (SOF9)",
               0xCA: "arithmetic-coded progressive (SOF10)",
               0xCB: "arithmetic-coded lossless (SOF11)"}


class CorruptJpeg(ValueError):
    """The bytes are no decodable JPEG (libjpeg fails on them too)."""


class Component(NamedTuple):
    ident: int
    h: int
    v: int
    quant: int


class Frame(NamedTuple):
    width: int
    height: int
    comps: List[Component]


def _segments(data: bytes):
    """(marker, payload, end offset) of each marker segment up to SOS,
    with jdmarker.c's rules: bytes before an FF are skipped, fill FFs are
    skipped, RSTn and TEM carry no length."""
    if data[:2] != SIGNATURE:
        raise CorruptJpeg("not a JPEG file (no SOI)")
    pos, n = 2, len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise CorruptJpeg("JPEG ends before its scan")
        m = data[pos]
        pos += 1
        if m == 0xD9:
            raise CorruptJpeg("JPEG has no image before EOI")
        if m == 0xD8:
            raise CorruptJpeg("JPEG has a second SOI")
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if pos + 2 > n:
            raise CorruptJpeg("JPEG ends inside a marker")
        length, = struct.unpack(">H", data[pos:pos + 2])
        if length < 2 or pos + length > n:
            raise CorruptJpeg(f"JPEG marker {m:#04x} has a bad length")
        yield m, data[pos + 2:pos + length], pos + length
        pos += length


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


class Scan(NamedTuple):
    frame: Frame
    quant: dict          # table number -> (64,) uint16, natural order
    bits: np.ndarray     # (8, 16) uint8: DC 0-3, AC 0-3
    vals: np.ndarray     # (8, 256) uint8
    tables: list         # (dc, ac) table numbers of each component
    restart: int
    start: int           # offset of the entropy-coded data
    orientation: int


def parse(data: bytes) -> Scan:
    """The markers up to the first scan."""
    frame, quant, restart, orientation = None, {}, 0, 1
    jfif = adobe = None
    bits = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    have = set()
    for m, body, end in _segments(data):
        if m in (0xC0, 0xC1):
            if frame is not None:
                raise CorruptJpeg("JPEG has two frame headers")
            if len(body) < 6:
                raise CorruptJpeg("JPEG SOF is too short")
            prec, height, width, nf = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"{prec}-bit JPEG is not supported (8-bit "
                                 f"only)")
            if height == 0 or width == 0 or nf == 0:
                raise CorruptJpeg("JPEG frame is empty")
            if nf == 4:
                raise ValueError("CMYK/YCCK JPEG is not supported")
            if nf not in (1, 3):
                raise ValueError(f"JPEG of {nf} components is not supported")
            if len(body) != 6 + 3 * nf:
                raise CorruptJpeg("JPEG SOF has a bad length")
            comps = []
            for i in range(nf):
                ident, hv, tq = body[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    raise CorruptJpeg("JPEG component has bad sampling "
                                      "factors or table number")
                comps.append(Component(ident, h, v, tq))
            frame = Frame(width, height, comps)
        elif m in REFUSED_SOF:
            raise ValueError(f"{REFUSED_SOF[m]} JPEG is not supported "
                             f"(baseline Huffman only)")
        elif 0xC5 <= m <= 0xCF and m != 0xCC:
            raise CorruptJpeg(f"JPEG SOF {m:#04x} is not supported by libjpeg")
        elif m == 0xC4:
            pos = 0
            while pos < len(body):
                if pos + 17 > len(body):
                    raise CorruptJpeg("JPEG DHT is truncated")
                tc, th = body[pos] >> 4, body[pos] & 15
                counts = np.frombuffer(body[pos + 1:pos + 17], np.uint8)
                total = int(counts.sum())
                if tc > 1 or th > 3 or total > 256 \
                        or pos + 17 + total > len(body):
                    raise CorruptJpeg("JPEG DHT is invalid")
                k = 4 * tc + th
                bits[k] = counts
                vals[k] = 0
                vals[k, :total] = np.frombuffer(
                    body[pos + 17:pos + 17 + total], np.uint8)
                have.add(k)
                pos += 17 + total
        elif m == 0xDB:
            pos = 0
            while pos < len(body):
                pq, tq = body[pos] >> 4, body[pos] & 15
                size = 128 if pq else 64
                if tq > 3 or pq > 1 or pos + 1 + size > len(body):
                    raise CorruptJpeg("JPEG DQT is invalid")
                q = np.frombuffer(body[pos + 1:pos + 1 + size],
                                  ">u2" if pq else np.uint8)
                table = np.zeros(64, np.uint16)
                table[ZIGZAG] = q
                quant[tq] = table
                pos += 1 + size
        elif m == 0xDD:
            if len(body) != 2:
                raise CorruptJpeg("JPEG DRI has a bad length")
            restart, = struct.unpack(">H", body)
        elif m == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xE1 and orientation == 1:
            orientation = _exif_orientation(body)
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif m == 0xDA:
            if frame is None:
                raise CorruptJpeg("JPEG scan before its frame header")
            ns = body[0] if body else 0
            if len(body) != 4 + 2 * ns or ns == 0:
                raise CorruptJpeg("JPEG SOS has a bad length")
            ids = [c.ident for c in frame.comps]
            if ns != len(frame.comps):
                raise ValueError("JPEG with several scans (non-interleaved "
                                 "baseline) is not supported")
            tables = []
            for i in range(ns):
                cs, t = body[1 + 2 * i], body[2 + 2 * i]
                if cs != ids[i]:
                    raise ValueError("JPEG scan whose components are not "
                                     "the frame's, in order, is not "
                                     "supported")
                tables.append((t >> 4, t & 15))
            for c, (td, ta) in zip(frame.comps, tables):
                if td > 3 or ta > 3:
                    raise CorruptJpeg("JPEG scan names a bad Huffman table")
                if td not in have or 4 + ta not in have:
                    raise ValueError("JPEG without its Huffman tables "
                                     "(libjpeg's standard tables) is not "
                                     "supported")
                if c.quant not in quant:
                    raise CorruptJpeg("JPEG scan needs a missing "
                                      "quantisation table")
            if len(frame.comps) == 3:
                if adobe is not None and adobe != 1:
                    raise ValueError(f"Adobe-transformed JPEG (transform "
                                     f"{adobe}) is not supported")
                if adobe is None and not jfif and ids == [82, 71, 66]:
                    raise ValueError("RGB-coded JPEG is not supported")
            return Scan(frame, quant, bits, vals, tables, restart, end,
                        orientation)
        elif not (0xE0 <= m <= 0xEF or m in (0xCC, 0xDC, 0xFE)):
            # APPn, DAC, DNL and COM are skipped; libjpeg fails on the rest
            raise CorruptJpeg(f"JPEG marker {m:#04x} is unknown to libjpeg")
    raise CorruptJpeg("JPEG has no scan")


class Layout(NamedTuple):
    mcux: int
    mcuy: int
    blocks: list         # (bh, bw) of each component's coefficient buffer
    sizes: list          # (ch, cw) of each component's real samples
    expand: list         # (hx, vx) of each component's upsampling


def layout(frame: Frame) -> Layout:
    """MCU grid, block buffers and upsampling factors (jdinput.c)."""
    W, H = frame.width, frame.height
    hmax = max(c.h for c in frame.comps)
    vmax = max(c.v for c in frame.comps)
    sizes = [(-(-H * c.v // vmax), -(-W * c.h // hmax)) for c in frame.comps]
    if len(frame.comps) == 1:
        ch, cw = sizes[0]
        mcux, mcuy = -(-cw // 8), -(-ch // 8)
        blocks = [(mcuy, mcux)]
    else:
        mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
        blocks = [(mcuy * c.v, mcux * c.h) for c in frame.comps]
    expand = []
    for c in frame.comps:
        if hmax % c.h or vmax % c.v:
            raise CorruptJpeg("JPEG sampling factors are not integer "
                              "multiples (libjpeg refuses them)")
        expand.append((hmax // c.h, vmax // c.v))
    return Layout(mcux, mcuy, blocks, sizes, expand)


def entropy_decode(data: bytes, scan: Scan, lay: Layout) -> List[np.ndarray]:
    """Each component's (bh, bw, 64) int16 quantised coefficients, natural
    order (csrc/jpeg_decode.cpp::jpeg_entropy_decode)."""
    comps = scan.frame.comps
    n = len(comps)
    one = n == 1
    coefs = [np.zeros((bh, bw, 64), np.int16) for bh, bw in lay.blocks]
    I = ctypes.c_int * n
    ptrs = (ctypes.c_void_p * n)(*(c.ctypes.data for c in coefs))
    src = np.frombuffer(data, np.uint8)
    status = ctypes.c_int(0)
    lib = host_build.load("jpeg_decode")
    fn = lib.jpeg_entropy_decode
    fn.restype = ctypes.c_int
    rc = fn(ctypes.c_void_p(src.ctypes.data + scan.start),
            ctypes.c_int64(len(data) - scan.start), n,
            I(*(1 if one else c.h for c in comps)),
            I(*(1 if one else c.v for c in comps)),
            I(*(t[0] for t in scan.tables)), I(*(t[1] for t in scan.tables)),
            ptrs, I(*(bw for _, bw in lay.blocks)),
            ctypes.c_void_p(scan.bits.ctypes.data),
            ctypes.c_void_p(scan.vals.ctypes.data), lay.mcux, lay.mcuy,
            scan.restart, ctypes.byref(status))
    if rc != 0:
        raise CorruptJpeg("JPEG Huffman table is invalid")
    return coefs


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


def decode_jpeg(data: bytes, *, gray: bool = False, plain: bool = False,
                exif_orientation: bool = True) -> np.ndarray:
    """Decode a JPEG held in memory, as ``cv2.imread`` does with
    ``IMREAD_COLOR`` ((H, W, 3) uint8 BGR) or, with ``gray``,
    ``IMREAD_GRAYSCALE`` ((H, W) uint8), the EXIF orientation applied
    unless ``exif_orientation`` is False (PIL's ``Image.open`` applies
    none). ``plain`` runs steps 2 and 3 in numpy."""
    scan = parse(data)
    frame = scan.frame
    lay = layout(frame)
    coefs = entropy_decode(data, scan, lay)
    idct, up, conv = ((idct_plain, upsample_plain, ycc_to_bgr_plain) if plain
                      else (_idct, _upsample, _ycc_to_bgr))
    W, H = frame.width, frame.height
    used = range(1 if gray or len(frame.comps) == 1 else 3)
    planes = [up(idct(coefs[i], scan.quant[frame.comps[i].quant]),
                 lay.sizes[i], lay.expand[i], W, H) for i in used]
    if gray:
        img = planes[0]
    elif len(planes) == 1:
        img = np.repeat(planes[0][..., None], 3, axis=-1)
    else:
        img = conv(*planes)
    return orient(img, scan.orientation) if exif_orientation else img
