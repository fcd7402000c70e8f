"""Test-side writers of the image layouts that cv2 and PIL read but do not
write, for the port's readers to be held to ``cv2.imread`` and PIL on them:

  - ``reencode_jpeg``: a JPEG's quantised coefficients (from a file cv2
    wrote) written again in scans of one's choosing: sequential scans of
    one component or of several, progressive scripts of spectral selection
    and successive approximation (first scans only: DC with any Al, AC
    bands with EOB runs), restart intervals, quantisation tables
    redefined between scans, with or without DHT segments;
  - ``write_bmp``: BMP files of 1-, 4- and 8-bit palettes, RLE4 and RLE8,
    16-bit 5-5-5 and 5-6-5, 24- and 32-bit pixels, bottom-up or top-down;
  - ``write_cmyk_jpeg``: CMYK and YCCK JPEGs of an RGB frame;
  - ``write_sunras``, ``write_hdr``, ``write_tiff``: Sun raster (every
    depth, colour maps, byte encoding, type 3), Radiance (run-length or
    flat) and TIFF files (``lzw_encode`` of both bit orders,
    ``packbits``, Deflate, the predictors, strips, tiles, planes,
    BigTIFF, both byte orders).

Neither is part of the port: the package reads these formats and writes
none of them.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from vido_slam_tpu_torch.io import jpeg

ZIGZAG = jpeg.ZIGZAG


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

class Scan(NamedTuple):
    """One scan of a re-encoded file: frame component indices, the band
    Ss..Se (zigzag) and the point transform Al (``progressive`` files;
    sequential scans send 0..63 at Al 0). ``dqt``: quantisation tables
    {number: (64,) natural order} written just before the scan."""
    comps: Sequence[int]
    ss: int = 0
    se: int = 63
    al: int = 0
    dqt: Optional[dict] = None


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self.acc = self.acc << 1 | (value >> i) & 1
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def _value_bits(v: int, s: int) -> int:
    return v if v >= 0 else v + (1 << s) - 1


class _Table:
    """A Huffman table holding the given symbols, each at the same length
    (fewer than 2^L of them, so that no code is all ones)."""

    def __init__(self, symbols):
        syms = sorted(set(symbols)) or [0]
        length = max(1, len(syms).bit_length())
        self.counts = [0] * 16
        self.counts[length - 1] = len(syms)
        self.syms = syms
        self.code = {s: (i, length) for i, s in enumerate(syms)}

    def segment(self, cls: int, slot: int) -> bytes:
        return bytes([cls << 4 | slot] + self.counts + self.syms)


def _std_table(k: int) -> _Table:
    """libjpeg's standard table k (0, 1: DC; 4, 5: AC) as a code map."""
    counts, syms = (bytes.fromhex(x) for x in jpeg.STD_HUFFMAN[k])
    t = _Table.__new__(_Table)
    t.counts, t.syms, t.code = list(counts), list(syms), {}
    code, i = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            t.code[syms[i]] = (code, length)
            code += 1
            i += 1
        code <<= 1
    return t


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _dqt(tables: dict) -> bytes:
    body = b""
    for k, q in sorted(tables.items()):
        body += bytes([k]) + np.asarray(q, np.uint8)[ZIGZAG].tobytes()
    return _segment(0xDB, body)


def _blocks(co, lay, comps):
    """The blocks of a scan in coding order, as its MCUs, each a list of
    (component, block): MCU by MCU over the frame's grid for an
    interleaved scan, the component's real blocks for a scan of one."""
    if len(comps) == 1:
        c = comps[0]
        hib, wib = lay.real[c]
        return [[(c, co.coefs[c][y, x])] for y in range(hib)
                for x in range(wib)]
    mcus = []
    for my in range(lay.mcuy):
        for mx in range(lay.mcux):
            mcu = []
            for c in comps:
                comp = co.frame.comps[c]
                for by in range(comp.v):
                    for bx in range(comp.h):
                        mcu.append((c, co.coefs[c][my * comp.v + by,
                                                   mx * comp.h + bx]))
            mcus.append(mcu)
    return mcus


def _symbols(block, scan, progressive):
    """The (symbol, value bits, their length) of one block's band, without
    the DC (returned apart: its magnitude category and value) for the
    caller's predictor. AC bands end in ('eob', 0, 0) where zeros remain."""
    out = []
    run = 0
    lo = max(scan.ss, 1)
    if scan.se < lo:
        return out
    for k in range(lo, scan.se + 1):
        v = int(block[ZIGZAG[k]])
        if progressive:   # jcphuff.c: the magnitude shifted, sign kept
            v = (abs(v) >> scan.al) * (1 if v >= 0 else -1)
        if v == 0:
            run += 1
            continue
        while run > 15:
            out.append((0xF0, 0, 0))
            run -= 16
        s = _category(v)
        out.append((run << 4 | s, _value_bits(v, s), s))
        run = 0
    if run:
        out.append(("eob", 0, 0))
    return out


def reencode_jpeg(data: bytes, scans: List[Scan], *, progressive: bool,
                  restart: int = 0, standard_tables: bool = False,
                  write_dht: bool = True) -> bytes:
    """The coefficients of ``data`` (any JPEG the port decodes; its
    quantisation tables kept) written as a JPEG of the given scans.
    ``standard_tables``: libjpeg's standard tables (sequential scans only),
    written as DHT segments unless ``write_dht`` is False; else each scan
    gets tables of exactly its symbols. ``restart``: a DRI interval in
    MCUs, EOB runs flushed at each RSTn."""
    co = jpeg.read_coefficients(data)
    frame = co.frame
    lay = jpeg.layout(frame)
    quant = {c.quant: co.quant[i] for i, c in enumerate(frame.comps)}
    out = bytearray(b"\xff\xd8")
    out += _dqt(quant)
    sof = struct.pack(">BHHB", 8, frame.height, frame.width,
                      len(frame.comps))
    for c in frame.comps:
        sof += bytes([c.ident, c.h << 4 | c.v, c.quant])
    out += _segment(0xC2 if progressive else 0xC0, sof)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for scan in scans:
        if scan.dqt:
            out += _dqt(scan.dqt)
        out += _encode_scan(co, lay, scan, progressive, restart,
                            standard_tables, write_dht)
    return bytes(out + b"\xff\xd9")


def _encode_scan(co, lay, scan, progressive, restart, standard, write_dht):
    comps = list(scan.comps)
    mcus = _blocks(co, lay, comps)
    dc_band = scan.ss == 0
    # the symbols first, to build the tables
    coded = []          # per MCU: per block (c, dc category, dc bits, ac)
    pred = {c: 0 for c in comps}
    for i, mcu in enumerate(mcus):
        if restart and i % restart == 0:
            pred = {c: 0 for c in comps}
        blocks = []
        for c, b in mcu:
            dc = None
            if dc_band:
                v = int(b[0]) >> scan.al if progressive else int(b[0])
                d = v - pred[c]
                pred[c] = v
                s = _category(d)
                dc = (s, _value_bits(d, s))
            ac = _symbols(b, scan, progressive) if (
                not progressive or not dc_band) else []
            blocks.append((c, dc, ac))
        coded.append(blocks)
    need_ac = not progressive or not dc_band
    dc_tables, ac_tables = {}, {}
    slot = {c: (0 if co.frame.comps[c].ident == co.frame.comps[0].ident
                else 1) for c in comps}
    if standard:
        for c in comps:
            dc_tables[slot[c]] = _std_table(slot[c])
            ac_tables[slot[c]] = _std_table(4 + slot[c])
    else:
        syms_dc = {s: [] for s in set(slot.values())}
        syms_ac = {s: [] for s in set(slot.values())}
        for blocks in coded:
            for c, dc, ac in blocks:
                if dc is not None:
                    syms_dc[slot[c]].append(dc[0])
                syms_ac[slot[c]] += [a[0] for a in ac if a[0] != "eob"]
        # EOB runs: every EOBn symbol a progressive band may need
        eobs = [r << 4 for r in range(15)] if progressive else [0x00]
        for s in syms_dc:
            dc_tables[s] = _Table(syms_dc[s])
            ac_tables[s] = _Table(syms_ac[s] + eobs)
    dht = b""
    if write_dht:
        for s, t in sorted(dc_tables.items()):
            if dc_band:
                dht += t.segment(0, s)
        for s, t in sorted(ac_tables.items()):
            if need_ac:
                dht += t.segment(1, s)
    head = bytes([len(comps)])
    for c in comps:
        head += bytes([co.frame.comps[c].ident, slot[c] << 4 | slot[c]])
    head += bytes([scan.ss if progressive else 0,
                   scan.se if progressive else 63,
                   scan.al if progressive else 0])
    bits = _Bits()
    eobrun = [0, None]      # count, the AC table of the run

    def flush_eob():
        n, t = eobrun
        if n:
            r = n.bit_length() - 1
            code, length = t.code[r << 4]
            bits.put(code, length)
            if r:
                bits.put(n - (1 << r), r)
        eobrun[0] = 0

    rst = 0
    for i, blocks in enumerate(coded):
        if restart and i and i % restart == 0:
            flush_eob()
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) % 8
        for c, dc, ac in blocks:
            if dc is not None:
                code, length = dc_tables[slot[c]].code[dc[0]]
                bits.put(code, length)
                if dc[0]:
                    bits.put(dc[1], dc[0])
            if not need_ac:
                continue
            t = ac_tables[slot[c]]
            if progressive and ac == [("eob", 0, 0)]:
                eobrun[0] += 1          # a block of zeros joins the run
                eobrun[1] = t
                if eobrun[0] == 0x7FFF:
                    flush_eob()
                continue
            if progressive:
                flush_eob()
            for sym, v, s in ac:
                if sym == "eob":
                    if progressive:
                        eobrun[0], eobrun[1] = 1, t
                    else:
                        code, length = t.code[0x00]
                        bits.put(code, length)
                    continue
                code, length = t.code[sym]
                bits.put(code, length)
                if s:
                    bits.put(v, s)
    flush_eob()
    bits.flush()
    return (_segment(0xC4, dht) if dht else b"") + _segment(0xDA, head) \
        + bytes(bits.out)


def drop_segments(data: bytes, marker: int) -> bytes:
    """``data`` without its marker segments of the given code (anywhere
    before the last scan's data: a DHT, a DQT)."""
    out = bytearray(data[:2])
    pos = 2
    while True:
        m = data[pos + 1]
        if m == 0xD9:
            return bytes(out + data[pos:])
        length = data[pos + 2] << 8 | data[pos + 3]
        end = pos + 2 + length
        if m == 0xDA:               # copy the scan's data up to the next
            nxt = end               # marker that is not RSTn or stuffing
            while not (data[nxt] == 0xFF and data[nxt + 1] not in (
                    0x00, *range(0xD0, 0xD8))):
                nxt += 1
            end = nxt
        if m != marker:
            out += data[pos:end]
        pos = end


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

def _rle(rows: np.ndarray, four: bool) -> bytes:
    """RLE8 or RLE4 of the index rows in file order: runs of equal values
    (two alternating values for RLE4) in encoded mode, absolute runs for
    the rest, an EOL after every row and an EOF at the end."""
    out = bytearray()
    for row in rows:
        x, w = 0, len(row)
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 3 or w - x < 3:
                v = int(row[x])
                out += bytes([n, v << 4 | v if four else v])
                x += n
                continue
            n = 3
            while x + n < w and n < 255 and not (
                    x + n + 2 < w and row[x + n] == row[x + n + 1]
                    == row[x + n + 2]):
                n += 1
            vals = [int(v) for v in row[x:x + n]]
            if four:
                if n % 2:
                    vals.append(0)
                body = bytes(vals[i] << 4 | vals[i + 1]
                             for i in range(0, len(vals), 2))
            else:
                body = bytes(vals)
            out += bytes([0, n]) + body + (b"\x00" if len(body) % 2 else b"")
            x += n
        out += b"\x00\x00"
    out[-2:] = b"\x00\x01"
    return bytes(out)


def write_bmp(path: str, pixels: np.ndarray, bits: int, *,
              palette: Optional[np.ndarray] = None, rle: bool = False,
              top_down: bool = False, fields: Optional[tuple] = None,
              colors_used: Optional[int] = None) -> None:
    """A BMP of a 40-byte BITMAPINFOHEADER. ``pixels``: (H, W) palette
    indices for bits 1, 4, 8 (``palette`` (n, 3) BGR), else (H, W, 3) BGR
    (bits 24, 32) or (H, W) raw 16-bit words (bits 16). ``fields``: the
    (red, green, blue) masks of BI_BITFIELDS, written after the header.
    ``rle``: RLE4 or RLE8 (bits 4 or 8)."""
    H, W = pixels.shape[:2]
    rows = pixels[::-1] if not top_down else pixels
    compression = 0
    if rle:
        compression = 2 if bits == 4 else 1
        data = _rle(rows, bits == 4)
    else:
        stride = ((W * bits + 31) >> 3) & ~3
        raw = np.zeros((H, stride), np.uint8)
        if bits in (1, 4):
            per = 8 // bits
            idx = np.zeros((H, -(-W // per) * per), np.uint8)
            idx[:, :W] = rows
            shifts = bits * np.arange(per - 1, -1, -1, dtype=np.uint8)
            packed = np.bitwise_or.reduce(
                idx.reshape(H, -1, per) << shifts, axis=-1)
            raw[:, :packed.shape[1]] = packed
        elif bits == 8:
            raw[:, :W] = rows
        elif bits == 16:
            raw[:, :2 * W] = rows.astype("<u2").view(np.uint8).reshape(H, -1)
        elif bits == 24:
            raw[:, :3 * W] = rows.reshape(H, -1)
        elif bits == 32:
            raw[:, :4 * W] = rows.reshape(H, -1)
        data = raw.tobytes()
    if fields:
        compression = 3
    pal = b""
    if palette is not None:
        pal = np.concatenate([np.asarray(palette, np.uint8),
                              np.zeros((len(palette), 1), np.uint8)],
                             1).tobytes()
    masks = struct.pack("<III", *fields) if fields else b""
    offset = 14 + 40 + len(masks) + len(pal)
    header = struct.pack("<IiiHHIIiiII", 40, W, -H if top_down else H, 1,
                         bits, compression, len(data), 2835, 2835,
                         colors_used if colors_used is not None else
                         (len(palette) if palette is not None else 0), 0)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0,
                                    offset))
        f.write(header + masks + pal + data)


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------

def sun_rle(raw: bytes) -> bytes:
    """Sun raster's byte encoding: ``0x80 n v`` for n + 1 copies of v
    (runs of 3 to 256), ``0x80 0x00`` for one 0x80, other bytes as they
    are."""
    out = bytearray()
    i = 0
    while i < len(raw):
        v = raw[i]
        n = 1
        while i + n < len(raw) and raw[i + n] == v and n < 256:
            n += 1
        if n >= 3 or (v == 0x80 and n >= 2):
            out += bytes([0x80, n - 1, v])
        elif v == 0x80:
            out += b"\x80\x00"
            n = 1
        else:
            out += bytes([v] * n)
        i += n
    return bytes(out)


def write_sunras(path: str, pixels: np.ndarray, depth: int, *,
                 palette: Optional[np.ndarray] = None, rle: bool = False,
                 rgb: bool = False) -> None:
    """A Sun raster file (big-endian 32-byte header): ``pixels`` (H, W)
    bits or indices for depths 1 and 8 (``palette`` (n, 3) RGB, written as
    the R, G and B planes of an RMT_EQUAL_RGB map), else (H, W, 3) or
    (H, W, 4) samples in file order (24: B, G, R or, with ``rgb``, type
    3's R, G, B; 32: X, B, G, R or X, R, G, B). Rows are padded to 16 bits;
    ``rle`` byte-encodes the padded rows (type 2)."""
    H, W = pixels.shape[:2]
    stride = ((W * depth + 15) // 16) * 2
    raw = np.zeros((H, stride), np.uint8)
    if depth == 1:
        raw[:, :(W + 7) // 8] = np.packbits(pixels.astype(np.uint8), axis=1)
    else:
        flat = pixels.reshape(H, -1)
        raw[:, :flat.shape[1]] = flat
    data = raw.tobytes()
    kind = 3 if rgb else 1
    if rle:
        data, kind = sun_rle(data), 2
    cmap = b""
    if palette is not None:
        cmap = np.ascontiguousarray(np.asarray(palette, np.uint8).T).tobytes()
    head = struct.pack(">8I", 0x59A66A95, W, H, depth, len(data), kind,
                       1 if cmap else 0, len(cmap))
    with open(path, "wb") as f:
        f.write(head + cmap + data)


# ---------------------------------------------------------------------------
# Radiance HDR
# ---------------------------------------------------------------------------

def hdr_rle_row(row: np.ndarray) -> bytes:
    """One new-style run-length row of (W, 4) RGBE bytes: ``2 2 W`` and
    each channel as runs (``128 + n, v``, n 3-127) and literals (``n,
    v...``, n 1-128)."""
    W = len(row)
    out = bytearray([2, 2, W >> 8, W & 255])
    for ch in range(4):
        v = row[:, ch]
        i = 0
        while i < W:
            n = 1
            while i + n < W and v[i + n] == v[i] and n < 127:
                n += 1
            if n >= 3:
                out += bytes([128 + n, int(v[i])])
                i += n
                continue
            j = i
            while j < W and j - i < 128 and not (
                    j + 2 < W and v[j] == v[j + 1] == v[j + 2]):
                j += 1
            out += bytes([j - i]) + bytes(int(x) for x in v[i:j])
            i = j
    return bytes(out)


def write_hdr(path: str, rgbe: np.ndarray, *, rle: bool = True,
              header: bytes = b"#?RADIANCE\n") -> None:
    """A Radiance file of (H, W, 4) RGBE bytes: ``header`` lines, the
    FORMAT line, a blank line, ``-Y H +X W``, then new-style run-length
    rows (``rle``) or flat quadruples."""
    H, W = rgbe.shape[:2]
    body = (b"".join(hdr_rle_row(r) for r in rgbe) if rle
            else np.ascontiguousarray(rgbe, np.uint8).tobytes())
    with open(path, "wb") as f:
        f.write(header + b"FORMAT=32-bit_rle_rgbe\n\n" + b"-Y %d +X %d\n"
                % (H, W) + body)


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

def lzw_encode(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW of ``data`` as libtiff's ``LZWEncode`` writes it: Clear
    first, codes of 9-12 bits MSB first, the width raised once the next
    entry would not fit (the decoder raises it one code early), Clear when
    the table is full, EOI last. ``old_style``: the pre-5.0 form libtiff
    still reads, LSB first, its decoder raising the width on time (so the
    encoder raises it one entry later)."""
    out = bytearray()
    acc = [0, 0]

    def put(code, width):
        if old_style:
            acc[0] |= code << acc[1]
            acc[1] += width
            while acc[1] >= 8:
                out.append(acc[0] & 255)
                acc[0] >>= 8
                acc[1] -= 8
        else:
            acc[0] = acc[0] << width | code
            acc[1] += width
            while acc[1] >= 8:
                acc[1] -= 8
                out.append(acc[0] >> acc[1] & 255)
            acc[0] &= (1 << acc[1]) - 1

    maxcode = (lambda w: (1 << w) - 1) if not old_style else \
        (lambda w: 1 << w)
    table = {bytes([i]): i for i in range(256)}
    free, width = 258, 9
    if not data:
        put(256, width)
        put(257, width)
    else:
        put(256, width)
        w = data[:1]
        for c in data[1:]:
            wc = w + bytes([c])
            if wc in table:
                w = wc
                continue
            put(table[w], width)
            table[wc] = free
            free += 1
            w = bytes([c])
            if free == 4094:
                put(256, width)
                table = {bytes([i]): i for i in range(256)}
                free, width = 258, 9
            elif free > maxcode(width):
                width += 1
        put(table[w], width)
        free += 1
        if free == 4094:
            put(256, width)
            width = 9
        elif free > maxcode(width):
            width += 1
        put(257, width)
    if acc[1]:
        out.append((acc[0] << (8 - acc[1]) if not old_style else acc[0])
                   & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes as (257 - n, v), the rest as
    literals of 1-128 bytes (n - 1, bytes)."""
    out = bytearray()
    i = 0
    while i < len(data):
        n = 1
        while i + n < len(data) and data[i + n] == data[i] and n < 128:
            n += 1
        if n >= 2:
            out += bytes([257 - n, data[i]])
            i += n
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and not (
                j + 1 < len(data) and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _predict(block: np.ndarray, predictor: int, spp: int) -> np.ndarray:
    """Horizontal differencing (2) of (rows, cols, spp) integer samples, or
    the floating-point predictor (3) of float32 ones: each row's bytes
    split into byte planes (most significant first) and differenced as
    bytes. Returns the block as the bytes of its rows (native order
    applied by the caller for 2)."""
    if predictor == 2:
        d = block.copy()
        d[:, 1:] = block[:, 1:] - block[:, :-1]
        return d
    rows, cols = block.shape[:2]
    raw = block.astype(">f4").view(np.uint8).reshape(rows, cols * spp, 4)
    planes = raw.transpose(0, 2, 1).reshape(rows, -1)
    d = planes.copy()
    d[:, spp:] = planes[:, spp:] - planes[:, :-spp]
    return d


def write_tiff(path: str, pixels: np.ndarray, *, photometric: int,
               bits: Optional[int] = None, compression: int = 1,
               predictor: int = 1, planar: int = 1,
               rows_per_strip: Optional[int] = None,
               tile: Optional[tuple] = None, big_endian: bool = False,
               bigtiff: bool = False, extra: Sequence[int] = (),
               colormap: Optional[np.ndarray] = None,
               orientation: Optional[int] = None,
               old_lzw: bool = False, fill_order: int = 1) -> None:
    """A one-page TIFF of ``pixels`` (H, W, spp): uint8, uint16 or float32
    samples, or 0/1 uint8 with ``bits`` 1. ``compression`` 1 (none), 5
    (LZW; ``old_lzw`` its old bit order), 8 or 32946 (Deflate), 32773
    (PackBits); ``predictor`` 2 or 3; ``planar`` 1 (contiguous) or 2;
    strips of ``rows_per_strip`` rows or ``tile`` (width, height) tiles,
    multiples of 16, overhanging the edge; ``extra``: ExtraSamples values;
    ``colormap`` (3, 2^bits) uint16 for photometric 3."""
    import zlib

    if pixels.ndim == 2:
        pixels = pixels[..., None]
    H, W, spp = pixels.shape
    dt = pixels.dtype
    bits = bits or 8 * dt.itemsize
    fmt = 3 if dt == np.float32 else 1
    order = ">" if big_endian else "<"

    def encode(block: np.ndarray) -> bytes:
        """One strip or tile of (rows, cols, n) samples."""
        rows, cols, n = block.shape
        if bits == 1:
            raw = np.packbits(block[..., 0].astype(np.uint8), axis=1)
            if fill_order == 2:
                raw = np.unpackbits(raw, axis=1).reshape(rows, -1, 8)[
                    ..., ::-1]
                raw = np.packbits(raw.reshape(rows, -1), axis=1)
            data = raw.tobytes()
        elif predictor == 3:
            data = _predict(block, 3, n).tobytes()
        else:
            b = block
            if predictor == 2:
                b = _predict(block.astype(dt), 2, n)
            data = b.astype(dt.newbyteorder(order)).tobytes()
        if compression == 5:
            return lzw_encode(data, old_lzw)
        if compression in (8, 32946):
            return zlib.compress(data)
        if compression == 32773:
            return packbits(data)
        return data

    chunks = []
    planes = [pixels] if planar == 1 else [pixels[..., i:i + 1]
                                           for i in range(spp)]
    if tile:
        tw, th = tile
        for plane in planes:
            for y in range(0, H, th):
                for x in range(0, W, tw):
                    blk = np.zeros((th, tw, plane.shape[2]), dt)
                    part = plane[y:y + th, x:x + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(blk))
    else:
        rps = rows_per_strip or H
        for plane in planes:
            for y in range(0, H, rps):
                chunks.append(encode(plane[y:y + rps]))
    tags = {256: (3 if W < 65536 else 4, [W]),
            257: (3 if H < 65536 else 4, [H]),
            258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]),
            284: (3, [planar]), 339: (3, [fmt] * spp)}
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).reshape(-1)])
    if orientation is not None:
        tags[274] = (3, [orientation])
    long_t = 16 if bigtiff else 4
    if tile:
        tags[322] = (3, [tile[0]])
        tags[323] = (3, [tile[1]])
        off_tag, cnt_tag = 324, 325
    else:
        tags[278] = (4, [rows_per_strip or H])
        off_tag, cnt_tag = 273, 279
    tags[cnt_tag] = (long_t, [len(c) for c in chunks])
    tags[off_tag] = (long_t, [0] * len(chunks))      # filled below
    sizes = {3: 2, 4: 4, 16: 8}
    header = 16 if bigtiff else 8
    data_off = header
    blob = bytearray()
    offsets = []
    for c in chunks:
        offsets.append(data_off + len(blob))
        blob += c
        if len(blob) % 2:
            blob += b"\0"
    tags[off_tag] = (long_t, offsets)
    ifd_off = data_off + len(blob)
    entry = 20 if bigtiff else 12
    inline = 8 if bigtiff else 4
    n = len(tags)
    ext_off = ifd_off + (8 if bigtiff else 2) + n * entry + (8 if bigtiff
                                                             else 4)
    ifd = bytearray(struct.pack(order + ("Q" if bigtiff else "H"), n))
    ext = bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        code = {3: "H", 4: "I", 16: "Q"}[typ]
        payload = struct.pack(order + code * len(vals), *vals)
        count = struct.pack(order + ("Q" if bigtiff else "I"), len(vals))
        ifd += struct.pack(order + "HH", tag, typ) + count
        if len(payload) <= inline:
            ifd += payload + bytes(inline - len(payload))
        else:
            ifd += struct.pack(order + ("Q" if bigtiff else "I"),
                               ext_off + len(ext))
            ext += payload
            if len(ext) % 2:
                ext += b"\0"
    ifd += bytes(8 if bigtiff else 4)
    if bigtiff:
        head = (b"MM\x00\x2b" if big_endian else b"II\x2b\x00") + \
            struct.pack(order + "HHQ", 8, 0, ifd_off)
    else:
        head = (b"MM\x00\x2a" if big_endian else b"II\x2a\x00") + \
            struct.pack(order + "I", ifd_off)
    del sizes
    with open(path, "wb") as f:
        f.write(head + bytes(blob) + bytes(ifd) + bytes(ext))


def write_cmyk_jpeg(path: str, rgb: np.ndarray, q: int = 4,
                    ycck: bool = False) -> None:
    """A baseline four-component JPEG of an (H, W, 3) RGB frame, as
    Photoshop stores CMYK (an Adobe APP14 of transform 0, each ink
    inverted): K = 255 - max(R, G, B) and C, M, Y its complements, every
    component at full resolution, quantised by a flat table of ``q``, one
    interleaved scan with tables of exactly its symbols. ``ycck``: an
    Adobe transform of 2, the inverted C, M, Y stored as the JFIF YCbCr
    of their complements (libjpeg's ycck_cmyk_convert undoes it)."""
    rgb = np.asarray(rgb, np.int64)
    H, W = rgb.shape[:2]
    k = 255 - rgb.max(-1)
    inks = [255 - (255 - rgb[..., i] - k) for i in range(3)] + [255 - k]
    if ycck:
        r, g, b = (255 - inks[i] for i in range(3))
        inks[:3] = [np.clip(np.round(v), 0, 255).astype(np.int64) for v in (
            0.299 * r + 0.587 * g + 0.114 * b,
            128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
            128 + 0.5 * r - 0.418688 * g - 0.081312 * b)]
    frame = jpeg.Frame(W, H, [jpeg.Component(ident, 1, 1, 0)
                              for ident in (67, 77, 89, 75)], False)
    lay = jpeg.layout(frame)
    n = np.arange(8)
    basis = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    basis *= np.where(n == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))[:, None]
    coefs = []
    for plane in inks:
        bh, bw = lay.blocks[0]
        pad = np.zeros((8 * bh, 8 * bw))
        pad[:H, :W] = plane - 128
        pad[H:, :W] = pad[H - 1:H, :W]
        pad[:, W:] = pad[:, W - 1:W]
        blocks = pad.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        d = basis @ blocks @ basis.T
        coefs.append(np.round(d / q).reshape(bh, bw, 64).astype(np.int16))
    co = jpeg.Coefficients(frame, coefs, [np.full(64, q, np.uint16)] * 4,
                           None, None, 1, lay.imcu_rows, 1, None,
                           "ycck" if ycck else "cmyk")
    out = bytearray(b"\xff\xd8")
    out += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                            2 if ycck else 0]))
    out += _dqt({0: np.full(64, q)})
    sof = struct.pack(">BHHB", 8, H, W, 4)
    for c in frame.comps:
        sof += bytes([c.ident, 0x11, 0])
    out += _segment(0xC0, sof)
    out += _encode_scan(co, lay, Scan([0, 1, 2, 3]), False, 0, False, True)
    with open(path, "wb") as f:
        f.write(bytes(out + b"\xff\xd9"))
