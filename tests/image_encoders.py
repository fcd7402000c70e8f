"""Test-side writers of the image layouts that cv2 and PIL read but do not
write, for the port's readers to be held to ``cv2.imread`` and PIL on them:

  - ``reencode_jpeg``: a JPEG's quantised coefficients (from a file cv2
    wrote) written again in scans of one's choosing: sequential scans of
    one component or of several, progressive scripts of spectral selection
    and successive approximation (first scans only: DC with any Al, AC
    bands with EOB runs), restart intervals, quantisation tables
    redefined between scans, with or without DHT segments;
  - ``write_bmp``: BMP files of 1-, 4- and 8-bit palettes, RLE4 and RLE8,
    16-bit 5-5-5 and 5-6-5, 24- and 32-bit pixels, bottom-up or top-down.

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
