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
    BigTIFF, both byte orders);
  - ``write_tga``, ``write_pcx``, ``write_sgi``, ``write_msp2``,
    ``write_im``, ``write_ico`` (with ``dib``), ``write_qoi``: the layouts
    of the formats PIL opens and cv2 does not that PIL's writers do not
    make (run-length and colour-mapped Targa at every depth and
    orientation, PCX of 1-bit planes, SGI at 2 bytes a channel and
    run-length coded, MSP version 2, IM types, icons of several BMP and
    PNG entries), and those the card's machine, which has no PIL, writes
    for chip_smoke.py phase (v).

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
    {number: (64,) natural order} written just before the scan. ``ah``:
    a refining scan of the bit Al after Ah (arithmetic coding only)."""
    comps: Sequence[int]
    ss: int = 0
    se: int = 63
    al: int = 0
    dqt: Optional[dict] = None
    ah: int = 0


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
    """DQT of 8-bit entries, or 16-bit ones where a table needs them."""
    body = b""
    for k, q in sorted(tables.items()):
        q = np.asarray(q)[ZIGZAG]
        if q.max() > 255:
            body += bytes([0x10 | k]) + q.astype(">u2").tobytes()
        else:
            body += bytes([k]) + q.astype(np.uint8).tobytes()
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
                  write_dht: bool = True, arithmetic: bool = False,
                  dac: Optional[dict] = None,
                  precision: Optional[int] = None) -> bytes:
    """The coefficients of ``data`` (any JPEG the port decodes; its
    quantisation tables kept) written as a JPEG of the given scans.
    ``standard_tables``: libjpeg's standard tables (sequential scans only),
    written as DHT segments unless ``write_dht`` is False; else each scan
    gets tables of exactly its symbols. ``restart``: a DRI interval in
    MCUs, EOB runs flushed at each RSTn. ``arithmetic``: arithmetic-coded
    scans (SOF9 or SOF10, ``encode_arith_scan``) instead, conditioned by
    ``dac`` ({DAC index: value}: 0-15 DC table's L | U << 4, 16-31 AC
    table's K) where given. ``precision``: the SOF's sample precision
    (the file's own by default; a 12-bit file's 16-bit DQT entries are
    written as such)."""
    return encode_coefficients(jpeg.read_coefficients(data), scans,
                               progressive=progressive, restart=restart,
                               standard_tables=standard_tables,
                               write_dht=write_dht, arithmetic=arithmetic,
                               dac=dac, precision=precision)


def encode_coefficients(co, scans: List[Scan], *, progressive: bool,
                        restart: int = 0, standard_tables: bool = False,
                        write_dht: bool = True, arithmetic: bool = False,
                        dac: Optional[dict] = None,
                        precision: Optional[int] = None,
                        head: bytes = b"") -> bytes:
    """``reencode_jpeg`` of coefficients already read (``jpeg.Coefficients``:
    its frame, coefficient buffers and latched tables), the marker
    segments ``head`` written after SOI."""
    frame = co.frame
    lay = jpeg.layout(frame)
    quant = {c.quant: co.quant[i] for i, c in enumerate(frame.comps)}
    out = bytearray(b"\xff\xd8" + head)
    out += _dqt(quant)
    sof = struct.pack(">BHHB", precision or frame.precision, frame.height,
                      frame.width, len(frame.comps))
    for c in frame.comps:
        sof += bytes([c.ident, c.h << 4 | c.v, c.quant])
    out += _segment((0xCA if progressive else 0xC9) if arithmetic else
                    (0xC2 if progressive else 0xC1 if
                     (precision or frame.precision) > 8 else 0xC0), sof)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    if dac:
        out += _segment(0xCC, b"".join(bytes([k, v])
                                       for k, v in sorted(dac.items())))
    for scan in scans:
        if scan.dqt:
            out += _dqt(scan.dqt)
        if arithmetic:
            out += encode_arith_scan(co, lay, scan, progressive, restart,
                                     dac or {})
        else:
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


# jaricom.c's jpeg_aritab (T.81 Table D.2): for each state its Qe, the next
# state after an LPS (with the MPS switch in bit 7) and after an MPS; state
# 113 is the fixed estimate of one half (T.851)
ARITAB = [
    (0x5a1d, 1 | 128, 1), (0x2586, 14, 2), (0x1114, 16, 3), (0x080b, 18, 4),
    (0x03d8, 20, 5), (0x01da, 23, 6), (0x00e5, 25, 7), (0x006f, 28, 8),
    (0x0036, 30, 9), (0x001a, 33, 10), (0x000d, 35, 11), (0x0006, 9, 12),
    (0x0003, 10, 13), (0x0001, 12, 13), (0x5a7f, 15 | 128, 15),
    (0x3f25, 36, 16), (0x2cf2, 38, 17), (0x207c, 39, 18), (0x17b9, 40, 19),
    (0x1182, 42, 20), (0x0cef, 43, 21), (0x09a1, 45, 22), (0x072f, 46, 23),
    (0x055c, 48, 24), (0x0406, 49, 25), (0x0303, 51, 26), (0x0240, 52, 27),
    (0x01b1, 54, 28), (0x0144, 56, 29), (0x00f5, 57, 30), (0x00b7, 59, 31),
    (0x008a, 60, 32), (0x0068, 62, 33), (0x004e, 63, 34), (0x003b, 32, 35),
    (0x002c, 33, 9), (0x5ae1, 37 | 128, 37), (0x484c, 64, 38),
    (0x3a0d, 65, 39), (0x2ef1, 67, 40), (0x261f, 68, 41), (0x1f33, 69, 42),
    (0x19a8, 70, 43), (0x1518, 72, 44), (0x1177, 73, 45), (0x0e74, 74, 46),
    (0x0bfb, 75, 47), (0x09f8, 77, 48), (0x0861, 78, 49), (0x0706, 79, 50),
    (0x05cd, 48, 51), (0x04de, 50, 52), (0x040f, 50, 53), (0x0363, 51, 54),
    (0x02d4, 52, 55), (0x025c, 53, 56), (0x01f8, 54, 57), (0x01a4, 55, 58),
    (0x0160, 56, 59), (0x0125, 57, 60), (0x00f6, 58, 61), (0x00cb, 59, 62),
    (0x00ab, 61, 63), (0x008f, 61, 32), (0x5b12, 65 | 128, 65),
    (0x4d04, 80, 66), (0x412c, 81, 67), (0x37d8, 82, 68), (0x2fe8, 83, 69),
    (0x293c, 84, 70), (0x2379, 86, 71), (0x1edf, 87, 72), (0x1aa9, 87, 73),
    (0x174e, 72, 74), (0x1424, 72, 75), (0x119c, 74, 76), (0x0f6b, 74, 77),
    (0x0d51, 75, 78), (0x0bb6, 77, 79), (0x0a40, 77, 48),
    (0x5832, 80 | 128, 81), (0x4d1c, 88, 82), (0x438e, 89, 83),
    (0x3bdd, 90, 84), (0x34ee, 91, 85), (0x2eae, 92, 86), (0x299a, 93, 87),
    (0x2516, 86, 71), (0x5570, 88 | 128, 89), (0x4ca9, 95, 90),
    (0x44d9, 96, 91), (0x3e22, 97, 92), (0x3824, 99, 93), (0x32b4, 99, 94),
    (0x2e17, 93, 86), (0x56a8, 95 | 128, 96), (0x4f46, 101, 97),
    (0x47e5, 102, 98), (0x41cf, 103, 99), (0x3c3d, 104, 100),
    (0x375e, 99, 93), (0x5231, 105, 102), (0x4c0f, 106, 103),
    (0x4639, 107, 104), (0x415e, 103, 99), (0x5627, 105 | 128, 106),
    (0x50e7, 108, 107), (0x4b85, 109, 103), (0x5597, 110, 109),
    (0x504f, 111, 107), (0x5a10, 110 | 128, 111), (0x5522, 112, 109),
    (0x59eb, 112 | 128, 111), (0x5a1d, 113, 113)]


class _ArithEncoder:
    """jcarith.c's QM coder: ``encode`` one decision in a statistics bin
    (a bytearray and an index: the state in bits 0-6, the MPS in bit 7),
    ``finish`` the interval (section D.1.8's termination), ``out`` the
    bytes with 0xFF stuffed."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, b: int) -> None:
        self.out.append(b)

    def _zeros(self) -> None:
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def _byte_out(self, temp: int) -> None:
        if temp > 0xFF:          # a carry over all stacked 0xFF bytes
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            self._flush_stacked()
            self.buffer = temp & 0xFF

    def _flush_stacked(self) -> None:
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer)
        if self.sc:
            self._zeros()
            for _ in range(self.sc):
                self._emit(0xFF)
                self._emit(0)
            self.sc = 0

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe, nl, nm = ARITAB[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:       # the LPS
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:                    # the MPS
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:              # renormalisation
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._flush_stacked()
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _arith_value(enc, stats, st, v, large, dc):
    """Figures F.8 and F.9 after the sign: a nonzero v's magnitude
    category from bin ``st`` (the DC's SP or SN, the AC's S0 + 2), the
    categories above the first (DC) or second (AC) continuing at bin
    ``large`` (DC: X1 = 20; AC: 189 or 217 by K), then its bits. Returns
    the category's magnitude m (a power of two, 0 for |v| = 1)."""
    m = 0
    v = abs(v) - 1
    if v:
        enc.encode(stats, st, 1)
        m = 1
        v2 = v >> 1
        if dc:
            st = large
        elif v2:
            enc.encode(stats, st, 1)
            m = 2
            st = large
            v2 >>= 1
        while v2:
            enc.encode(stats, st, 1)
            m <<= 1
            st += 1
            v2 >>= 1
    enc.encode(stats, st, 0)
    st += 14
    bit = m >> 1
    while bit:
        enc.encode(stats, st, 1 if bit & v else 0)
        bit >>= 1
    return m


def encode_arith_scan(co, lay, scan, progressive, restart, dac) -> bytes:
    """One arithmetic-coded scan (its SOS and entropy-coded data) of the
    coefficients ``co``, as jcarith.c codes it: DC differences conditioned
    by the DAC's L and U (0 and 1 by default), AC decisions by K (5),
    successive approximation's first and refining scans, restarts that
    reset the statistics."""
    comps = list(scan.comps)
    mcus = _blocks(co, lay, comps)
    slot = {c: (0 if co.frame.comps[c].ident == co.frame.comps[0].ident
                else 1) for c in comps}
    head = bytes([len(comps)])
    for c in comps:
        head += bytes([co.frame.comps[c].ident, slot[c] << 4 | slot[c]])
    ss, se = (scan.ss, scan.se) if progressive else (0, 63)
    al, ah = (scan.al, scan.ah) if progressive else (0, 0)
    head += bytes([ss, se, ah << 4 | al])
    L = {t: dac.get(t, 0x10) & 15 for t in (0, 1)}
    U = {t: dac.get(t, 0x10) >> 4 for t in (0, 1)}
    K = {t: dac.get(16 + t, 5) for t in (0, 1)}
    out = bytearray()
    enc = None
    fixed = bytearray([113])

    def reset():
        nonlocal enc
        enc = _ArithEncoder()
        return ({t: bytearray(64) for t in (0, 1)},
                {t: bytearray(256) for t in (0, 1)},
                {c: 0 for c in comps}, {c: 0 for c in comps})

    dcs, acs, last, ctx = reset()
    rst = 0
    for i, mcu in enumerate(mcus):
        if restart and i and i % restart == 0:
            out += enc.finish() + bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) % 8
            dcs, acs, last, ctx = reset()
        for c, b in mcu:
            t = slot[c]
            if ss == 0 and ah:                       # DC refinement
                enc.encode(fixed, 0, (int(b[0]) >> al) & 1)
                continue
            if ss == 0:                              # DC (first scan)
                v0 = int(b[0]) >> al
                st = ctx[c]
                d = v0 - last[c]
                if d == 0:
                    enc.encode(dcs[t], st, 0)
                    ctx[c] = 0
                else:
                    last[c] = v0
                    enc.encode(dcs[t], st, 1)
                    enc.encode(dcs[t], st + 1, 0 if d > 0 else 1)
                    ctx[c] = 4 if d > 0 else 8
                    m = _arith_value(enc, dcs[t], st + (2 if d > 0 else 3),
                                     d, 20, True)
                    if m < (1 << L[t]) >> 1:
                        ctx[c] = 0
                    elif m > (1 << U[t]) >> 1:
                        ctx[c] += 8
                if progressive:
                    continue
            lo = max(ss, 1)
            hi = se
            vals = [int(b[ZIGZAG[k]]) for k in range(64)]

            def pt(v, s):   # the point transform: |v| >> s, sign kept
                return (abs(v) >> s) * (1 if v >= 0 else -1)
            ke = 0
            for k in range(hi, lo - 1, -1):
                if pt(vals[k], al):
                    ke = k
                    break
            stats = acs[t]
            if not ah:
                k = lo
                while k <= ke:
                    st = 3 * (k - 1)
                    enc.encode(stats, st, 0)             # not EOB
                    while pt(vals[k], al) == 0:
                        enc.encode(stats, st + 1, 0)
                        st += 3
                        k += 1
                    v = pt(vals[k], al)
                    enc.encode(stats, st + 1, 1)
                    enc.encode(fixed, 0, 0 if v > 0 else 1)
                    _arith_value(enc, stats, st + 2, v,
                                 189 if k <= K[t] else 217, False)
                    k += 1
                if k <= hi:
                    enc.encode(stats, 3 * (k - 1), 1)    # EOB
                continue
            kex = 0                                      # AC refinement
            for k in range(ke, 0, -1):
                if pt(vals[k], ah):
                    kex = k
                    break
            k = lo
            while k <= ke:
                st = 3 * (k - 1)
                if k > kex:
                    enc.encode(stats, st, 0)
                while True:
                    v = abs(vals[k]) >> al
                    if v:
                        if v >> 1:
                            enc.encode(stats, st + 2, v & 1)
                        else:
                            enc.encode(stats, st + 1, 1)
                            enc.encode(fixed, 0, 0 if vals[k] > 0 else 1)
                        break
                    enc.encode(stats, st + 1, 0)
                    st += 3
                    k += 1
                k += 1
            if k <= hi:
                enc.encode(stats, 3 * (k - 1), 1)
    out += enc.finish()
    return _segment(0xDA, head) + bytes(out)


def _lossless_diffs(planes, frame, comps, predictor, pt, restart_rows):
    """The sample differences of one lossless scan as libjpeg-turbo's
    decoder will undifference them (jddiffct.c, jdlossls.c): each MCU
    row's (component, row, column) differences, dummy samples 0. The
    predictors restart (the first row's rules) at the scan's start and in
    the iMCU row during which a restart marker is read, for every
    component, as the decoder resets them."""
    P = frame.precision
    hmax = max(c.h for c in frame.comps)
    vmax = max(c.v for c in frame.comps)
    H, W = frame.height, frame.width
    imcu_rows = -(-H // vmax)
    x = {c: np.asarray(planes[c], np.int64) >> pt for c in comps}
    diffs = {c: np.zeros_like(x[c]) for c in comps}
    first = {c: True for c in comps}
    if len(comps) == 1:
        c = comps[0]
        v = frame.comps[c].v
        ch = x[c].shape[0]
        mcu_rows = [min(v, ch - r * v) for r in range(imcu_rows)]
        mcus_per_row = x[c].shape[1]
    else:
        mcu_rows = [1] * imcu_rows
        mcus_per_row = -(-W // hmax)
    to_go = restart_rows
    for r in range(imcu_rows):
        for _ in range(mcu_rows[r]):
            if restart_rows:
                if to_go == 0:
                    first = {c: True for c in comps}
                    to_go = restart_rows
                to_go -= 1
        for c in comps:
            v = frame.comps[c].v
            ch = x[c].shape[0]
            for row in range(r * v, min(r * v + v, ch)):
                cur = x[c][row]
                if first[c]:
                    pred = np.empty_like(cur)
                    pred[0] = 1 << (P - pt - 1)
                    pred[1:] = cur[:-1]
                    first[c] = False
                else:
                    up = x[c][row - 1]
                    ra = np.concatenate([[0], cur[:-1]])
                    rc = np.concatenate([[0], up[:-1]])
                    pred = {1: ra, 2: up, 3: rc, 4: ra + up - rc,
                            5: ra + ((up - rc) >> 1),
                            6: up + ((ra - rc) >> 1),
                            7: (ra + up) >> 1}[predictor]
                    pred = pred.copy()
                    pred[0] = up[0]
                diffs[c][row] = (cur - pred) & 0xFFFF
    return diffs, mcus_per_row, mcu_rows


def write_lossless_jpeg(planes, *, precision: int, predictor: int,
                        pt: int = 0, sampling=None, ids=None,
                        restart_rows: int = 0, interleave: bool = True,
                        head: bytes = b"", size=None) -> bytes:
    """A lossless (SOF3) JPEG of ``planes`` (a list of (h, w) integer
    sample planes, each the size its sampling (h, v) gives it, all 1, 1 by
    default) at ``precision`` bits (2-16): predictor 1-7, point transform
    ``pt``, a restart every ``restart_rows`` MCU rows, one interleaved scan
    or one scan a component, Huffman tables of exactly each scan's
    categories (0-16), the marker segments ``head`` after SOI (a JFIF
    APP0, an Adobe APP14). ``size``: the frame's (H, W), by default the
    first plane's."""
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    H, W = size or np.asarray(planes[0]).shape[:2]
    frame = jpeg.Frame(W, H, [jpeg.Component(i, h, v, 0) for i, (h, v)
                              in zip(ids, sampling)], False, precision)
    out = bytearray(b"\xff\xd8" + head)
    sof = struct.pack(">BHHB", precision, H, W, n)
    for c in frame.comps:
        sof += bytes([c.ident, c.h << 4 | c.v, 0])
    out += _segment(0xC3, sof)
    if restart_rows:
        mcus = -(-W // hmax) if interleave and n > 1 else None
        per_scan = [mcus] if mcus else [np.asarray(p).shape[1]
                                        for p in planes]
        if len(set(per_scan)) > 1:
            raise ValueError("one restart interval fits no two scans")
        out += _segment(0xDD, struct.pack(">H", restart_rows * per_scan[0]))
    scans = [list(range(n))] if interleave else [[c] for c in range(n)]
    for comps in scans:
        diffs, mcus_per_row, mcu_rows = _lossless_diffs(
            planes, frame, comps, predictor, pt, restart_rows)
        slot = {c: 0 if c == comps[0] else 1 for c in comps}
        # the coded MCU rows: (component, category, value bits) in order
        rows = []
        for r, k in enumerate(mcu_rows):
            for sub in range(k):
                seq = []
                for mx in range(mcus_per_row):
                    for c in comps:
                        comp = frame.comps[c]
                        h, v = (comp.h, comp.v) if len(comps) > 1 else (1, 1)
                        d = diffs[c]
                        for by in range(v):
                            for bx in range(h):
                                y = (r * comp.v + sub) if len(comps) == 1 \
                                    else r * v + by
                                xx = mx * h + bx
                                val = int(d[y, xx]) if (
                                    y < d.shape[0] and xx < d.shape[1]) else 0
                                if val >= 32768:
                                    val -= 65536
                                cat = 16 if val == -32768 else _category(val)
                                seq.append((c, cat, _value_bits(val, cat)
                                            if cat and cat < 16 else 0))
                rows.append(seq)
        tables = {}
        for sl in set(slot.values()):
            tables[sl] = _Table([cat for seq in rows for c, cat, _ in seq
                                 if slot[c] == sl])
        out += _segment(0xC4, b"".join(t.segment(0, sl)
                                       for sl, t in sorted(tables.items())))
        hdr = bytes([len(comps)])
        for c in comps:
            hdr += bytes([frame.comps[c].ident, slot[c] << 4])
        out += _segment(0xDA, hdr + bytes([predictor, 0, pt]))
        bits = _Bits()
        rst = 0
        for i, seq in enumerate(rows):
            if restart_rows and i and i % restart_rows == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) % 8
                bits = _reset_bits(bits)
            for c, cat, vb in seq:
                code, length = tables[slot[c]].code[cat]
                bits.put(code, length)
                if cat and cat < 16:
                    bits.put(vb, cat)
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")


def _reset_bits(bits: "_Bits") -> "_Bits":
    """A bit writer continuing ``bits``' bytes after a restart marker."""
    fresh = _Bits()
    fresh.out = bits.out
    return fresh


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
# GIF
# ---------------------------------------------------------------------------

def gif_lzw(indices: bytes, min_code_size: int, *, clear_when_full: bool =
            True, early_clear: int = 0) -> bytes:
    """GIF's LZW of the colour indices: a clear code first, a clear code
    when the table is full (4096 entries; with ``clear_when_full`` False the
    table stays full and codes go on at 12 bits: the deferred clear), a
    clear every ``early_clear`` codes where given, the end code last; the
    codes packed LSB first at the width a decoder reads each at
    (``gif_pack``)."""
    clear = 1 << min_code_size
    codes = [clear]

    def reset():
        return {bytes([i]): i for i in range(min(clear, 256))}, clear + 2

    table, nxt = reset()
    w = b""
    count = 0
    for i in range(len(indices)):
        c = indices[i:i + 1]
        if w + c in table:
            w = w + c
            continue
        codes.append(table[w])
        count += 1
        if nxt < 4096:
            table[w + c] = nxt
            nxt += 1
        elif clear_when_full:
            codes.append(clear)
            table, nxt = reset()
        if early_clear and count % early_clear == 0:
            codes.append(clear)
            table, nxt = reset()
        w = c
    if w:
        codes.append(table[w])
    codes.append(clear + 1)
    return gif_pack(codes, min_code_size)


def gif_pack(codes, min_code_size: int) -> bytes:
    """GIF LZW codes packed LSB first, each at the width a decoder holds
    when it reads it: min_code_size + 1 after a clear (or an end), one more
    once the next free entry reaches 2^width (the decoder adds an entry for
    every code but the first after a clear), at most 12."""
    clear = 1 << min_code_size
    nxt, width, first = clear + 2, min_code_size + 1, True
    out = bytearray()
    acc = nacc = 0
    for c in codes:
        acc |= c << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
        if c in (clear, clear + 1):
            nxt, width, first = clear + 2, min_code_size + 1, True
        elif first:
            first = False
        elif nxt < 4096:
            nxt += 1
            if nxt == 1 << width and width < 12:
                width += 1
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def gif_blocks(data: bytes) -> bytes:
    """Data sub-blocks of at most 255 bytes and the block terminator."""
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out += bytes([len(chunk)]) + chunk
    return bytes(out + b"\x00")


def gif_frame(indices: np.ndarray, *, offset=(0, 0), palette=None,
              interlace: bool = False, min_code_size: Optional[int] = None,
              transparency: Optional[int] = None, disposal: int = 0,
              lzw: Optional[bytes] = None, **lzw_args) -> bytes:
    """One image of a GIF: a Graphic Control Extension where
    ``transparency`` or ``disposal`` is given, the image descriptor at
    ``offset`` (left, top), a local colour table ``palette`` ((n, 3), n a
    power of two from 2 to 256) where given, the rows in interlaced order
    (8n, 8n + 4, 4n + 2, 2n + 1) with ``interlace``, the LZW data (``lzw``
    as given, or ``gif_lzw`` of the indices)."""
    h, w = indices.shape
    out = bytearray()
    if transparency is not None or disposal:
        out += b"\x21\xf9\x04" + bytes([disposal << 2 | (
            transparency is not None)]) + b"\x00\x00" + bytes(
            [transparency or 0]) + b"\x00"
    flags = 0x40 if interlace else 0
    if palette is not None:
        n = len(palette)
        flags |= 0x80 | (n.bit_length() - 2)
    out += b"\x2c" + struct.pack("<4H", offset[0], offset[1], w, h) + \
        bytes([flags])
    if palette is not None:
        out += np.asarray(palette, np.uint8).tobytes()
    rows = indices
    if interlace:
        order = (list(range(0, h, 8)) + list(range(4, h, 8))
                 + list(range(2, h, 4)) + list(range(1, h, 2)))
        rows = indices[order]
    if min_code_size is None:
        top = int(indices.max()) if indices.size else 0
        min_code_size = max(2, top.bit_length())
    data = lzw if lzw is not None else gif_lzw(
        rows.astype(np.uint8).tobytes(), min_code_size, **lzw_args)
    out += bytes([min_code_size]) + gif_blocks(data)
    return bytes(out)


def write_gif(screen, frames: Sequence[bytes], *, palette=None,
              background: int = 0, version: bytes = b"89a",
              trailer: bool = True) -> bytes:
    """A GIF of logical screen ``screen`` (width, height), global colour
    table ``palette`` ((n, 3)) where given, background index
    ``background``, the images ``frames`` (``gif_frame``), the trailer."""
    flags = 0
    if palette is not None:
        n = len(palette)
        flags = 0x80 | 0x70 | (n.bit_length() - 2)
    out = bytearray(b"GIF" + version + struct.pack("<2H", *screen)
                    + bytes([flags, background, 0]))
    if palette is not None:
        out += np.asarray(palette, np.uint8).tobytes()
    for f in frames:
        out += f
    return bytes(out + (b"\x3b" if trailer else b""))


# ---------------------------------------------------------------------------
# WebP lossless (VP8L)
# ---------------------------------------------------------------------------

class _LsbBits:
    """Bits LSB first, as VP8L stores them."""

    def __init__(self):
        self.out = bytearray()
        self.acc = self.nacc = self.n = 0

    def put(self, v: int, k: int) -> None:
        self.acc |= (v & ((1 << k) - 1)) << self.nacc
        self.nacc += k
        self.n += k
        while self.nacc >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.nacc -= 8

    def put_code(self, code: int, length: int) -> None:
        """A prefix code, its first bit the MSB of the canonical code."""
        rev = 0
        for i in range(length):
            rev = rev << 1 | (code >> i) & 1
        self.put(rev, length)

    def put_bits(self, other: "_LsbBits", skip: int = 0) -> None:
        """The bits of ``other`` from bit ``skip`` on."""
        n = other.n - skip
        value = int.from_bytes(other.data(), "little") >> skip
        total = self.acc | (value << self.nacc)
        nbits = self.nacc + n
        whole = nbits // 8
        self.out += (total & ((1 << (8 * whole)) - 1)).to_bytes(whole,
                                                                "little")
        self.acc = total >> (8 * whole)
        self.nacc = nbits - 8 * whole
        self.n += n

    def put_array(self, values: np.ndarray, lengths: np.ndarray) -> None:
        """Fields of the given lengths (values LSB first), packed at once."""
        lengths = np.asarray(lengths, np.int64)
        total = int(lengths.sum())
        if not total:
            return
        start = np.repeat(np.cumsum(lengths) - lengths, lengths)
        bits = (np.repeat(np.asarray(values, np.uint64), lengths)
                >> (np.arange(total) - start).astype(np.uint64)) & 1
        packed = _LsbBits()
        packed.out = bytearray(np.packbits(bits.astype(np.uint8),
                                           bitorder="little").tobytes())
        packed.n = total
        if total % 8:
            packed.acc = packed.out.pop()
            packed.nacc = total % 8
        self.put_bits(packed)

    def head(self, k: int) -> int:
        """The first k bits (k at most 8)."""
        data = self.data()
        return (int.from_bytes(data[:2], "little") if data else 0) & (
            (1 << k) - 1)

    def data(self) -> bytes:
        return bytes(self.out) + (bytes([self.acc]) if self.nacc else b"")


def _prefix_lengths(counts, limit: int = 15):
    """Code lengths of at most ``limit`` bits for the symbol counts: a
    Huffman code, flattened to a complete code of equal lengths where
    Huffman's are too long; a used symbol alone gets length 1."""
    import heapq

    used = [s for s, c in enumerate(counts) if c]
    lengths = [0] * len(counts)
    if len(used) <= 1:
        for s in used:
            lengths[s] = 1
        return lengths
    heap = [(counts[s], i, [s]) for i, s in enumerate(used)]
    heapq.heapify(heap)
    tie = len(heap)
    while len(heap) > 1:
        c1, _, a = heapq.heappop(heap)
        c2, _, b = heapq.heappop(heap)
        for x in a + b:
            lengths[x] += 1
        heapq.heappush(heap, (c1 + c2, tie, a + b))
        tie += 1
    if max(lengths) > limit:
        n = len(used)
        k = (n - 1).bit_length()
        short = (1 << k) - n           # symbols one bit shorter
        for i, sym in enumerate(used):
            lengths[sym] = k - 1 if i < short else k
    return lengths


def _canonical(lengths):
    """{symbol: (code, length)} of canonical codes (shorter codes first,
    by symbol within a length)."""
    codes, code = {}, 0
    for n in range(1, 16):
        for s, ln in enumerate(lengths):
            if ln == n:
                codes[s] = (code, n)
                code += 1
        code <<= 1
    return codes


def _write_code(bw: _LsbBits, lengths, *, simple: bool = True,
                runs: bool = True, max_symbol: bool = False) -> dict:
    """One prefix code of these lengths (a simple code where it can be
    one and ``simple``; else a normal code: the code-length code, then the
    lengths, zero runs and repeats coded by 16-18 where ``runs``, the
    number of coded lengths given where ``max_symbol``). Returns the
    canonical codes ({symbol: (code, length)}; a lone symbol costs 0
    bits)."""
    used = [s for s, n in enumerate(lengths) if n]
    if simple and len(used) <= 2 and all(s < 256 for s in used) and used:
        bw.put(1, 1)
        bw.put(len(used) - 1, 1)
        wide = used[0] > 1
        bw.put(int(wide), 1)
        bw.put(used[0], 8 if wide else 1)
        if len(used) == 2:
            bw.put(used[1], 8)
        if len(used) == 1:
            return {used[0]: (0, 0)}
        return {used[0]: (0, 1), used[1]: (1, 1)}
    bw.put(0, 1)

    def sequence(last):
        seq = []             # (code-length symbol, extra bits, their count)
        i, prev = 0, 8
        while i < last:
            n = lengths[i]
            run = 1
            while i + run < last and lengths[i + run] == n:
                run += 1
            if runs and n == 0 and run >= 3:
                take = min(run, 138)
                seq.append((17, take - 3, 3) if take <= 10 else
                           (18, take - 11, 7))
                i += take
                continue
            if runs and n and n == prev and run >= 3:
                take = min(run, 6)
                seq.append((16, take - 3, 2))
                i += take
                continue
            seq.append((n, 0, 0))
            if n:
                prev = n
            i += 1
        return seq

    counted = max_symbol and used and len(sequence(max(used) + 1)) >= 2
    seq = sequence(max(used) + 1 if counted else len(lengths))
    counts = [0] * 19
    for sym, _, _ in seq:
        counts[sym] += 1
    cl = _prefix_lengths(counts, 7)
    if sum(1 for x in cl if x) == 1:    # the code-length code needs two
        cl[next(s for s in range(19) if not counts[s])] = 1
        cl[next(s for s in range(19) if counts[s])] = 1
    order = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14,
             15)
    num = max(4, max(k for k in range(19) if cl[order[k]]) + 1)
    bw.put(num - 4, 4)
    for k in range(num):
        bw.put(cl[order[k]], 3)
    if counted:
        bw.put(1, 1)
        count = len(seq)
        nbits = max(2, (count - 2).bit_length())
        nbits += nbits & 1
        bw.put((nbits - 2) // 2, 3)
        bw.put(count - 2, nbits)
    else:
        bw.put(0, 1)
    cl_codes = _canonical(cl)
    for sym, extra, k in seq:
        bw.put_code(*cl_codes[sym])
        if k:
            bw.put(extra, k)
    codes = _canonical(lengths)
    if len(used) == 1:
        codes = {used[0]: (0, 0)}
    return codes


def _prefix_symbol(v: int):
    """(prefix symbol, extra bits, their count) of a VP8L length or
    distance value."""
    v -= 1
    if v < 4:
        return v, 0, 0
    hi = v.bit_length() - 1
    second = (v >> (hi - 1)) & 1
    extra = hi - 1
    return 2 * hi + second, v & ((1 << extra) - 1), extra


def _vp8l_image(bw: _LsbBits, px, width: int, *, cache_bits: int = 0,
                groups=None, group_bits: int = 2, lz77: bool = False,
                simple: bool = True, runs: bool = True) -> None:
    """ARGB pixels (a flat list of uint32) coded as a VP8L image: the
    colour cache, the meta prefix codes where ``groups`` (one group index
    per tile of 2^group_bits; the main image only), five codes a group,
    then literals, cache hits and (``lz77``) backward references at
    distance 1 and one row up (plane codes 2 and 1)."""
    if not cache_bits and groups is None and not lz77:
        _vp8l_literals(bw, np.asarray(px, np.uint32), simple, runs)
        return
    cache = [None] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    symbols = []            # (group, [(alphabet index, symbol)...], extras)
    i = 0
    mw = (width + (1 << group_bits) - 1) >> group_bits
    while i < len(px):
        y, x = divmod(i, width)
        g = groups[(y >> group_bits) * mw + (x >> group_bits)] if groups \
            else 0
        p = px[i]
        run = 0
        dist_code = None
        if lz77:
            for code, dist in ((1, width), (2, 1)):
                if i >= dist:
                    k = 0
                    while i + k < len(px) and k < 4096 and \
                            px[i + k] == px[i + k - dist]:
                        k += 1
                    if k >= 3 and k > run:
                        run, dist_code = k, code
        if run:
            ls, le, ln = _prefix_symbol(run)
            ds, de, dn = _prefix_symbol(dist_code)
            symbols.append((g, [(0, 256 + ls), (4, ds)], [(le, ln), (de, dn)],
                            px[i:i + run]))
            i += run
        elif cache is not None and cache[(p * 0x1E35A7BD & 0xFFFFFFFF)
                                         >> shift] == p:
            key = (p * 0x1E35A7BD & 0xFFFFFFFF) >> shift
            symbols.append((g, [(0, 280 + key)], [], [p]))
            i += 1
        else:
            symbols.append((g, [(0, (p >> 8) & 0xFF), (1, (p >> 16) & 0xFF),
                                (2, p & 0xFF), (3, p >> 24)], [], [p]))
            i += 1
        if cache is not None:
            for q in symbols[-1][3]:
                cache[(q * 0x1E35A7BD & 0xFFFFFFFF) >> shift] = q
    if cache_bits:
        bw.put(1, 1)
        bw.put(cache_bits, 4)
    else:
        bw.put(0, 1)
    ngroups = max(groups) + 1 if groups else 1
    sizes = (256 + 24 + (1 << cache_bits if cache_bits else 0), 256, 256,
             256, 40)
    counts = [[[0] * n for n in sizes] for _ in range(ngroups)]
    for g, syms, _, _ in symbols:
        for a, sym in syms:
            counts[g][a][sym] += 1
    codes = []
    for g in range(ngroups):
        codes.append([_write_code(bw, _prefix_lengths(
            c if any(c) else [1] + [0] * (len(c) - 1)), simple=simple,
            runs=runs) for c in counts[g]])
    for g, syms, extras, _ in symbols:
        for k, (a, sym) in enumerate(syms):
            bw.put_code(*codes[g][a][sym])
            if a == 0 and sym >= 256 and sym < 280:
                bw.put(*extras[0])
            if a == 4:
                bw.put(*extras[1])


def _vp8l_literals(bw: _LsbBits, px: np.ndarray, simple: bool,
                   runs: bool) -> None:
    """``_vp8l_image`` of literals alone (no cache, one group, no LZ77),
    counted and packed with numpy."""
    bw.put(0, 1)                                    # no colour cache
    chans = [(px >> 8) & 0xFF, (px >> 16) & 0xFF, px & 0xFF, px >> 24]
    sizes = (280, 256, 256, 256, 40)
    codes = []
    for a, n in enumerate(sizes):
        counts = np.bincount(chans[a], minlength=n)[:n] if a < 4 else \
            np.zeros(n, np.int64)
        if not counts.any():
            counts[0] = 1
        codes.append(_write_code(bw, _prefix_lengths(list(counts)),
                                 simple=simple, runs=runs))
    vals, lens = [], []
    for a in range(4):
        table = np.zeros((sizes[a], 2), np.int64)
        for sym, (code, length) in codes[a].items():
            rev = int(format(code, f"0{length}b")[::-1], 2) if length else 0
            table[sym] = rev, length
        vals.append(table[chans[a], 0])
        lens.append(table[chans[a], 1])
    bw.put_array(np.stack(vals, 1).ravel(), np.stack(lens, 1).ravel())


def write_vp8l(argb: np.ndarray, *, predictor=None, cross_color=None,
               subtract_green: bool = False, palette=None,
               order=("palette", "subtract_green", "cross_color",
                      "predictor"),
               cache_bits: int = 0, groups=None, group_bits: int = 2,
               lz77: bool = False, simple: bool = True, runs: bool = True,
               alpha: bool = False, riff: bool = True) -> bytes:
    """A lossless WebP of (H, W) uint32 ARGB pixels, each VP8L feature on
    demand: ``predictor`` (bits, (th, tw) modes 0-15), ``cross_color``
    (bits, (th, tw, 3) green-to-red, green-to-blue and red-to-blue
    multipliers), ``subtract_green``, ``palette`` (the colours; the image
    then holds their indices, bundled 2, 4 or 8 to a pixel for 16, 4 or 2
    colours), applied in ``order`` (the decoder undoes them in reverse),
    the colour cache, meta prefix codes ``groups`` (a group a tile of
    2^group_bits), LZ77 references, simple codes where they fit, zero and
    repeat runs in the code lengths."""
    from vido_slam_tpu_torch.io import webp

    H, W = argb.shape
    px = [int(v) for v in np.asarray(argb, np.uint32).ravel()]
    bw = _LsbBits()
    bw.put(0x2F, 8)
    bw.put(W - 1, 14)
    bw.put(H - 1, 14)
    bw.put(int(alpha), 1)
    bw.put(0, 3)
    width = W
    for name in order:
        if name == "palette" and palette is not None:
            colors = [int(c) for c in palette]
            n = len(colors)
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            index = {c: k for k, c in enumerate(colors)}
            idx = [index[p] for p in px]
            packed_w = (width + (1 << bits) - 1) >> bits
            packed = []
            for y in range(H):
                for xp in range(packed_w):
                    g = 0
                    for k in range(1 << bits):
                        x = (xp << bits) + k
                        if x < width:
                            g |= idx[y * width + x] << (k * (8 >> bits))
                    packed.append(0xFF000000 | g << 8)
            bw.put(1, 1)
            bw.put(3, 2)
            bw.put(n - 1, 8)
            deltas = [colors[0]] + [webp._add(colors[k], _neg(colors[k - 1]))
                                    for k in range(1, n)]
            _vp8l_image(bw, deltas, n, simple=simple, runs=runs)
            px, width = packed, packed_w
        elif name == "subtract_green" and subtract_green:
            bw.put(1, 1)
            bw.put(2, 2)
            px = [(p & 0xFF00FF00) | ((((p >> 16) - (p >> 8)) & 0xFF) << 16)
                  | ((p - (p >> 8)) & 0xFF) for p in px]
        elif name == "cross_color" and cross_color is not None:
            bits, mult = cross_color
            tw = (width + (1 << bits) - 1) >> bits
            sub = [0xFF000000 | int(m[2]) << 16 | int(m[1]) << 8 | int(m[0])
                   for m in np.asarray(mult).reshape(-1, 3)]
            bw.put(1, 1)
            bw.put(1, 2)
            bw.put(bits - 2, 3)
            _vp8l_image(bw, sub, tw, simple=simple, runs=runs)
            out = []
            for i, p in enumerate(px):
                y, x = divmod(i, width)
                m = sub[(y >> bits) * tw + (x >> bits)]
                g = (p >> 8) & 0xFF
                r = (p >> 16) & 0xFF
                red = (r - webp._delta(m & 0xFF, g)) & 0xFF
                blue = ((p & 0xFF) - webp._delta((m >> 8) & 0xFF, g)
                        - webp._delta((m >> 16) & 0xFF, r)) & 0xFF
                out.append((p & 0xFF00FF00) | red << 16 | blue)
            px = out
        elif name == "predictor" and predictor is not None:
            bits, modes = predictor
            tw = (width + (1 << bits) - 1) >> bits
            sub = [0xFF000000 | int(m) << 8 for m in np.asarray(modes).ravel()]
            bw.put(1, 1)
            bw.put(0, 2)
            bw.put(bits - 2, 3)
            _vp8l_image(bw, sub, tw, simple=simple, runs=runs)
            out = []
            for i, p in enumerate(px):
                y, x = divmod(i, width)
                if y == 0:
                    pred = 0xFF000000 if x == 0 else px[i - 1]
                elif x == 0:
                    pred = px[i - width]
                else:
                    mode = (sub[(y >> bits) * tw + (x >> bits)] >> 8) & 0xF
                    pred = webp._predict(mode, px[i - 1], px[i - width],
                                         px[i - width + 1],
                                         px[i - width - 1])
                out.append(webp._add(p, _neg(pred)))
            px = out
    bw.put(0, 1)                       # no more transforms
    if groups is not None:
        meta_w = (width + (1 << group_bits) - 1) >> group_bits
        meta_h = (H + (1 << group_bits) - 1) >> group_bits
        groups = list(np.asarray(groups).ravel()[:meta_w * meta_h])
    _vp8l_main(bw, px, width, cache_bits, groups, group_bits, lz77, simple,
               runs)
    payload = bw.data()
    if not riff:
        return payload
    chunk = b"VP8L" + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        chunk += b"\x00"
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def _neg(p: int) -> int:
    """The per-channel negation of an ARGB value (mod 256)."""
    return sum(((256 - ((p >> s) & 0xFF)) & 0xFF) << s for s in (0, 8, 16, 24))


def _vp8l_main(bw, px, width, cache_bits, groups, group_bits, lz77, simple,
               runs) -> None:
    """The main image: its colour cache bit, the meta prefix codes' entropy
    image where ``groups`` are given, then ``_vp8l_image``'s codes and
    pixels."""
    if not groups:
        # the main image has a meta-code flag after its cache bits
        inner = _LsbBits()
        _vp8l_image(inner, px, width, cache_bits=cache_bits, lz77=lz77,
                    simple=simple, runs=runs)
        # splice: cache flag (and bits), then "no meta codes", then the rest
        k = 1 + (4 if cache_bits else 0)
        bw.put(inner.head(k), k)
        bw.put(0, 1)
        bw.put_bits(inner, k)
        return
    inner = _LsbBits()
    _vp8l_image(inner, px, width, cache_bits=cache_bits, groups=groups,
                group_bits=group_bits, lz77=lz77, simple=simple, runs=runs)
    k = 1 + (4 if cache_bits else 0)
    bw.put(inner.head(k), k)
    bw.put(1, 1)
    bw.put(group_bits - 2, 3)
    meta_w = (width + (1 << group_bits) - 1) >> group_bits
    _vp8l_image(bw, [0xFF000000 | int(g) << 8 for g in groups], meta_w,
                simple=simple, runs=runs)
    bw.put_bits(inner, k)


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
               old_lzw: bool = False, fill_order: int = 1,
               chunks: Optional[Sequence[bytes]] = None,
               tags: Optional[dict] = None) -> None:
    """A one-page TIFF of ``pixels`` (H, W, spp): unsigned, signed or
    floating-point samples of any width numpy holds (the sample format
    follows the dtype), or 0/1 uint8 with ``bits`` 1, 0..3 with 2, 0..15
    with 4 (packed MSB first, rows padded to a byte). ``compression`` 1
    (none), 5 (LZW; ``old_lzw`` its old bit order), 8 or 32946 (Deflate),
    32773 (PackBits), 34925 (LZMA, the ``xz`` container libtiff writes);
    ``predictor`` 2 or 3; ``planar`` 1 (contiguous) or 2; strips of
    ``rows_per_strip`` rows or ``tile`` (width, height) tiles, multiples of
    16, overhanging the edge; ``extra``: ExtraSamples values; ``colormap``
    (3, 2^bits) uint16 for photometric 3; ``fill_order`` 2: every byte of
    each encoded strip or tile bit-reversed. ``chunks``: the strips or
    tiles already encoded (JPEG, CCITT, subsampled YCbCr), in place of
    ``pixels``' samples, which then give only the sizes; ``tags``: more
    fields, tag -> (type, values) (type 2 ASCII and 7 UNDEFINED take
    bytes, 5 RATIONAL (numerator, denominator) pairs), which replace the
    written ones."""
    import lzma
    import zlib

    if pixels.ndim == 2:
        pixels = pixels[..., None]
    H, W, spp = pixels.shape
    dt = pixels.dtype
    bits = bits or 8 * dt.itemsize
    fmt = {"f": 3, "i": 2}.get(dt.kind, 1)
    order = ">" if big_endian else "<"

    def encode(block: np.ndarray) -> bytes:
        """One strip or tile of (rows, cols, n) samples."""
        rows, cols, n = block.shape
        if bits < 8:
            v = block.reshape(rows, cols * n).astype(np.uint8)
            v = np.unpackbits(v[..., None], axis=-1)[..., 8 - bits:]
            raw = np.packbits(v.reshape(rows, -1), axis=1)
            data = raw.tobytes()
        elif predictor == 3:
            data = _predict(block, 3, n).tobytes()
        else:
            b = block
            if predictor == 2:
                b = _predict(block.astype(dt), 2, n)
            data = b.astype(dt.newbyteorder(order)).tobytes()
        if compression == 5:
            data = lzw_encode(data, old_lzw)
        elif compression in (8, 32946):
            data = zlib.compress(data)
        elif compression == 32773:
            data = packbits(data)
        elif compression == 34925:
            data = lzma.compress(data, check=lzma.CHECK_NONE)
        if fill_order == 2:
            data = bytes(np.unpackbits(np.frombuffer(data, np.uint8),
                                       bitorder="little").reshape(-1, 8)
                         .dot(1 << np.arange(7, -1, -1)).astype(np.uint8))
        return data

    planes = [pixels] if planar == 1 else [pixels[..., i:i + 1]
                                           for i in range(spp)]
    if chunks is not None:
        chunks = list(chunks)
    elif tile:
        chunks = []
        tw, th = tile
        for plane in planes:
            for y in range(0, H, th):
                for x in range(0, W, tw):
                    blk = np.zeros((th, tw, plane.shape[2]), dt)
                    part = plane[y:y + th, x:x + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(blk))
    else:
        chunks = []
        rps = rows_per_strip or H
        for plane in planes:
            for y in range(0, H, rps):
                chunks.append(encode(plane[y:y + rps]))
    tags_given = dict(tags or {})
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
    tags.update(tags_given)
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
        if typ in (1, 2, 7):
            payload, n_vals = bytes(vals), len(vals)
        elif typ in (5, 10):
            flat = [int(v) for pair in vals for v in pair]
            payload = struct.pack(order + ("I" if typ == 5 else "i")
                                  * len(flat), *flat)
            n_vals = len(vals)
        else:
            code = {3: "H", 4: "I", 8: "h", 9: "i", 16: "Q"}[typ]
            payload = struct.pack(order + code * len(vals), *vals)
            n_vals = len(vals)
        count = struct.pack(order + ("Q" if bigtiff else "I"), n_vals)
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


# ---------------------------------------------------------------------------
# The formats PIL opens and cv2 does not (Targa, PCX, SGI, MSP, IM, ICO)
# ---------------------------------------------------------------------------

def tga_rle(flat: bytes, pixel: int, row: int, *,
            cross_rows: bool = False) -> bytes:
    """Targa run-length packets of ``flat`` (rows of ``row`` bytes,
    ``pixel`` bytes a pixel): runs of 2-128 equal pixels (never across a
    row's end, which PIL refuses), literals of the rest (up to 128 pixels;
    with ``cross_rows`` a literal goes on into the next row, which PIL
    reads)."""
    npx = len(flat) // pixel
    per_row = row // pixel
    px = [flat[i * pixel:(i + 1) * pixel] for i in range(npx)]
    out = bytearray()
    i = 0
    while i < npx:
        end_row = (i // per_row + 1) * per_row
        n = 1
        while i + n < end_row and n < 128 and px[i + n] == px[i]:
            n += 1
        if n >= 2:
            out += bytes([0x80 | (n - 1)]) + px[i]
            i += n
            continue
        limit = npx if cross_rows else end_row
        j = i + 1
        while j < limit and j - i < 128 and not (
                j + 1 < limit and px[j + 1] == px[j]
                and (j + 1) // per_row == j // per_row):
            j += 1
        out += bytes([j - i - 1]) + b"".join(px[i:j])
        i = j
    return bytes(out)


def write_tga(pixels: np.ndarray, kind: int, depth: int, *,
              palette: Optional[np.ndarray] = None, map_depth: int = 24,
              map_start: int = 0, flags: int = 0x20, id_section: bytes = b"",
              cross_rows: bool = False) -> bytes:
    """A Targa file: ``kind`` 1-3 (9-11 run-length, ``tga_rle``), ``pixels``
    (H, W) indices or gray, (H, W, 2) gray and alpha, (H, W, 3) or (H, W,
    4) BGR(A) samples, or (H, W) 16-bit words for depth 16 of kind 2 (1-5-5-5),
    or (H, W) 0/1 bits for depth 1; ``palette`` (n, 3) RGB written at
    ``map_depth`` 16 (5-5-5), 24 or 32 from entry ``map_start``; ``flags``
    the descriptor (0x20 top-down, 0x10 mirrored)."""
    H, W = pixels.shape[:2]
    if not flags & 0x20:
        pixels = pixels[::-1]
    if flags & 0x10:
        pixels = pixels[:, ::-1]
    if depth == 1:
        raw = np.packbits(pixels.astype(np.uint8), axis=1)
    elif depth == 16 and pixels.ndim == 2:
        raw = np.ascontiguousarray(pixels, "<u2").view(np.uint8).reshape(
            H, 2 * W)
    else:
        raw = np.ascontiguousarray(pixels, np.uint8).reshape(H, -1)
    flat = raw.tobytes()
    if kind & 8:
        flat = tga_rle(flat, max(depth // 8, 1), raw.shape[1],
                       cross_rows=cross_rows)
    cmap = b""
    if palette is not None:
        pal = np.asarray(palette, np.int64)
        if map_depth == 16:
            words = (pal[:, 0] >> 3) << 10 | (pal[:, 1] >> 3) << 5 | \
                pal[:, 2] >> 3
            cmap = words.astype("<u2").tobytes()
        else:
            bgr = pal[:, ::-1].astype(np.uint8)
            if map_depth == 32:
                bgr = np.concatenate([bgr, np.full((len(pal), 1), 255,
                                                   np.uint8)], 1)
            cmap = bgr.tobytes()
    head = struct.pack("<BBBHHBHHHHBB", len(id_section), int(palette is not
                                                             None), kind,
                       map_start, 0 if palette is None else len(palette),
                       map_depth if palette is not None else 0, 0, 0, W, H,
                       depth, flags)
    return head + id_section + cmap + flat


def pcx_rle(row: bytes) -> bytes:
    """PCX's run-length coding of one row's planes: runs of 2-63 (and any
    byte of 0xC0 or more) as ``0xC0 | n, v``, other bytes as they are."""
    out = bytearray()
    i = 0
    while i < len(row):
        v = row[i]
        n = 1
        while i + n < len(row) and row[i + n] == v and n < 63:
            n += 1
        if n > 1 or v >= 0xC0:
            out += bytes([0xC0 | n, v])
        else:
            out.append(v)
        i += n
    return bytes(out)


def write_pcx(planes: np.ndarray, bits: int, *, version: int = 5,
              palette16: Optional[np.ndarray] = None,
              palette256: Optional[np.ndarray] = None,
              bytes_per_line: Optional[int] = None, origin=(0, 0)) -> bytes:
    """A PCX file of ``planes`` (H, P, W) samples (bits 8) or 0/1 bits
    (bits 1): each row's planes packed and padded to the stride PIL
    computes (``bytes_per_line`` as written in the header, the packed
    width by default), run-length coded; ``palette16`` (16, 3) in the
    header, ``palette256`` (256, 3) behind 0x0C at the end."""
    H, P, W = planes.shape
    if bits == 1:
        packed = np.packbits(planes.astype(np.uint8), axis=2)
    else:
        packed = planes.astype(np.uint8)
    stride = packed.shape[2]
    bpl = stride if bytes_per_line is None else bytes_per_line
    real = stride if bpl == stride else stride + stride % 2
    rows = np.zeros((H, P, real), np.uint8)
    rows[:, :, :stride] = packed
    x0, y0 = origin
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0,
                       x0 + W - 1, y0 + H - 1, 72, 72)
    pal = np.zeros((16, 3), np.uint8) if palette16 is None else palette16
    head += np.asarray(pal, np.uint8).tobytes() + bytes([0, P]) + \
        struct.pack("<HH", bpl, 1)
    head += bytes(128 - len(head))
    body = b"".join(pcx_rle(r.tobytes()) for r in rows.reshape(H, -1))
    tail = b""
    if palette256 is not None:
        tail = b"\x0c" + np.asarray(palette256, np.uint8).tobytes()
    return head + body + tail


def sgi_rle(samples: bytes, bpc: int) -> bytes:
    """One SGI row of one channel, run-length coded: runs of 3-127 equal
    samples, literals of the rest, a zero count last (counts are words at
    2 bytes a channel)."""
    n = len(samples) // bpc
    vals = [samples[i * bpc:(i + 1) * bpc] for i in range(n)]
    out = bytearray()

    def count(c):
        return bytes([c]) if bpc == 1 else bytes([0, c])
    i = 0
    while i < n:
        r = 1
        while i + r < n and r < 127 and vals[i + r] == vals[i]:
            r += 1
        if r >= 3:
            out += count(r) + vals[i]
            i += r
            continue
        j = i + 1
        while j < n and j - i < 127 and not (
                j + 2 < n and vals[j] == vals[j + 1] == vals[j + 2]):
            j += 1
        out += count(0x80 | (j - i)) + b"".join(vals[i:j])
        i = j
    return bytes(out + count(0))


def write_sgi(pixels: np.ndarray, bpc: int = 1, *, rle: bool = True,
              share_rows: bool = False) -> bytes:
    """An SGI file of (H, W, z) samples (uint8, or uint16 for ``bpc`` 2),
    rows bottom-up, verbatim or run-length coded with the start and length
    tables (lengths in bytes); ``share_rows`` points every row equal to an
    earlier one of its channel at that row's bytes."""
    H, W, z = pixels.shape
    dim = 3 if z > 1 else 2 if H > 1 else 1
    head = struct.pack(">hBBHHHHll", 474, int(rle), bpc, dim, W, H, z, 0,
                       255 if bpc == 1 else 65535)
    head += bytes(4) + b"fixture".ljust(80, b"\0") + struct.pack(">l", 0)
    head += bytes(512 - len(head))
    planes = pixels[::-1].astype(">u2" if bpc == 2 else np.uint8)
    if not rle:
        return head + b"".join(planes[..., c].tobytes() for c in range(z))
    base = 512 + 8 * H * z
    starts, lengths, data = [], [], bytearray()
    for c in range(z):
        seen = {}
        for y in range(H):
            row = sgi_rle(planes[y, :, c].tobytes(), bpc)
            if share_rows and row in seen:
                starts.append(seen[row])
            else:
                seen[row] = base + len(data)
                starts.append(base + len(data))
                data += row
            lengths.append(len(row))
    tables = struct.pack(f">{H * z}I", *starts) + \
        struct.pack(f">{H * z}I", *lengths)
    return head + tables + bytes(data)


def write_msp2(bits: np.ndarray, *, blank_rows=()) -> bytes:
    """A Windows Paint version 2 (``LinS``) file of (H, W) 0/1 bits (1
    white): the header with its checksum, the row map and each row
    run-length coded (``0, n, v`` runs, ``n`` literal bytes); the rows
    listed in ``blank_rows`` stored as length 0 (PIL fills them white)."""
    H, W = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    coded = []
    for y in range(H):
        raw = rows[y].tobytes()
        if y in blank_rows:
            coded.append(b"")
            continue
        out = bytearray()
        i = 0
        while i < len(raw):
            n = 1
            while i + n < len(raw) and raw[i + n] == raw[i] and n < 255:
                n += 1
            if n >= 3:
                out += bytes([0, n, raw[i]])
                i += n
                continue
            j = min(i + 255, len(raw))
            out += bytes([j - i]) + raw[i:j]
            i = j
        coded.append(bytes(out))
    words = [struct.unpack("<H", b"Li")[0], struct.unpack("<H", b"nS")[0],
             W, H, 1, 1, 1, 1, W, H, 0, 0, 0, 0, 0, 0]
    check = 0
    for w in words:
        check ^= w
    words[12] = check
    return struct.pack("<16H", *words) + \
        struct.pack(f"<{H}H", *map(len, coded)) + b"".join(coded)


def write_im(pixels: np.ndarray, kind: str, *, lut: Optional[bytes] = None,
             raw: Optional[bytes] = None) -> bytes:
    """An IM file: the ``Image type`` line ``kind`` (e.g. ``L 16B image``),
    the size line, a ``Lut`` of 768 bytes where given, the 0x1A and the
    rows bottom-up (``raw``: the pixel bytes as given, already bottom-up)."""
    H, W = pixels.shape[:2]
    head = f"Image type: {kind}\r\nName: fixture.im\r\n" \
           f"Image size (x*y): {W}*{H}\r\n"
    if lut is not None:
        head += "Lut: 1\r\n"
    data = head.encode() + b"\0" * 8 + b"\x1a" + (lut or b"")
    return data + (raw if raw is not None else pixels[::-1].tobytes())


def dib(pixels: np.ndarray, bits: int, *, palette: Optional[np.ndarray] =
        None, mask: Optional[np.ndarray] = None) -> bytes:
    """An icon's bitmap: a 40-byte BMP info header of twice the height,
    the palette ((n, 3) RGB as BGRX), the XOR rows bottom-up (indices of
    1, 4 or 8 bits, or (H, W, 3)/(H, W, 4) BGR(A) samples) and the AND
    mask ((H, W) bits, 1 transparent; zero where None)."""
    H, W = pixels.shape[:2]
    stride = ((W * bits + 31) // 32) * 4
    rows = np.zeros((H, stride), np.uint8)
    if bits <= 8:
        per = 8 // bits
        idx = np.asarray(pixels, np.uint8)
        pad = (-W) % per
        idx = np.pad(idx, ((0, 0), (0, pad)))
        shifts = (8 - bits) - bits * np.arange(per)
        packed = (idx.reshape(H, -1, per) << shifts).sum(-1).astype(np.uint8)
        rows[:, :packed.shape[1]] = packed
    else:
        flat = np.asarray(pixels, np.uint8).reshape(H, -1)
        rows[:, :flat.shape[1]] = flat
    mstride = ((W + 31) // 32) * 4
    mrows = np.zeros((H, mstride), np.uint8)
    if mask is not None:
        m = np.packbits(mask.astype(np.uint8), axis=1)
        mrows[:, :m.shape[1]] = m
    colors = 0 if palette is None else len(palette)
    head = struct.pack("<IiiHHIIiiII", 40, W, 2 * H, 1, bits, 0, 0, 0, 0,
                       colors, 0)
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        pal = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = pal.tobytes()
    return head + pal + rows[::-1].tobytes() + mrows[::-1].tobytes()


def write_ico(images: Sequence[bytes], directory: Sequence[tuple]) -> bytes:
    """An ICO file of the entries' data (a PNG file or ``dib``) and their
    directory fields (width, height, colours, bits a pixel; 0 for 256),
    each entry's size and offset as stored."""
    n = len(images)
    out = struct.pack("<HHH", 0, 1, n)
    offset = 6 + 16 * n
    for data, (w, h, colors, bpp) in zip(images, directory):
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colors, 0, 1, bpp,
                           len(data), offset)
        offset += len(data)
    return out + b"".join(images)


def write_qoi(rgb: np.ndarray) -> bytes:
    """A QOI file of (H, W, 3) RGB as the format's reference encoder codes
    it: runs of the previous pixel (1-62), an index hit, a small
    difference (DIFF), a luma difference, else the pixel (RGB), and the
    8-byte end marker."""
    H, W, _ = rgb.shape
    out = bytearray(b"qoif" + struct.pack(">II", W, H) + b"\x03\x00")
    seen = [None] * 64
    prev, run = (0, 0, 0, 255), 0
    pixels = [tuple(p) + (255,) for p in rgb.reshape(-1, 3).tolist()]
    for i, p in enumerate(pixels):
        if p == prev:
            run += 1
            if run == 62 or i == len(pixels) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        h = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64
        if seen[h] == p:
            out.append(h)
        else:
            seen[h] = p
            dr, dg, db = ((p[k] - prev[k] + 128) % 256 - 128
                          for k in range(3))
            if -2 <= dr < 2 and -2 <= dg < 2 and -2 <= db < 2:
                out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
            elif -32 <= dg < 32 and -8 <= dr - dg < 8 and -8 <= db - dg < 8:
                out += bytes([0x80 | (dg + 32),
                              (dr - dg + 8) << 4 | (db - dg + 8)])
            else:
                out += bytes([0xFE]) + bytes(p[:3])
        prev = p
    return bytes(out + bytes(7) + b"\x01")


# ---------------------------------------------------------------------------
# TIFF modes PIL's writer does not make: JPEG strips and tiles of any
# subsampling, subsampled YCbCr, CCITT fax of every kind
# ---------------------------------------------------------------------------

def jpeg_tiff_chunks(pixels: np.ndarray, *, rows_per_strip: Optional[int]
                     = None, tile: Optional[tuple] = None,
                     subsampling: int = 0, quality: int = 75) -> tuple:
    """(JPEGTables, chunks) of JPEG-in-TIFF strips or tiles of ``pixels``
    ((H, W) gray, (H, W, 3) RGB coded as YCbCr, (H, W, 4) CMYK): each
    strip or tile (edge tiles padded by replication) a baseline JPEG of
    PIL's at ``subsampling`` (0: 1x1, 1: 2x1, 2: 2x2), its DQT and DHT
    segments moved into the tables, as libtiff writes them."""
    import io
    from PIL import Image

    H, W = pixels.shape[:2]
    mode = {2: "L", 3: "RGB", 4: "CMYK"}[pixels.ndim if pixels.ndim == 2
                                          else pixels.shape[2] + 0]
    blocks = []
    if tile:
        tw, th = tile
        for y in range(0, H, th):
            for x in range(0, W, tw):
                part = pixels[y:y + th, x:x + tw]
                pad = [(0, th - part.shape[0]), (0, tw - part.shape[1])]
                blocks.append(np.pad(part, pad + [(0, 0)] * (part.ndim - 2),
                                     mode="edge"))
    else:
        rps = rows_per_strip or H
        blocks = [pixels[y:y + rps] for y in range(0, H, rps)]
    tables, chunks = b"", []
    for blk in blocks:
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(blk), mode).save(
            buf, "JPEG", quality=quality, subsampling=subsampling)
        first, stream, _ = split_jpeg(buf.getvalue())
        tables = tables or first
        chunks.append(stream)
    return tables, chunks


def split_jpeg(data: bytes) -> tuple:
    """(JPEGTables, the abbreviated stream, the frame header's body) of a
    baseline JPEG: its DQT and DHT segments as a tables-only stream, the
    rest without its APPn segments."""
    segs, pos = [], 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        segs.append(data[pos:pos + 2 + n])
        pos += 2 + n
    tables = b"\xff\xd8" + b"".join(
        s for s in segs if s[1] in (0xDB, 0xC4)) + b"\xff\xd9"
    stream = b"\xff\xd8" + b"".join(
        s for s in segs if s[1] not in (0xDB, 0xC4) and not
        0xE0 <= s[1] <= 0xEF) + data[pos:]
    sof = next(s for s in segs if s[1] in (0xC0, 0xC1))
    return tables, stream, sof[4:]


def ycbcr_chunks(ycc: np.ndarray, subsampling: tuple, *,
                 rows_per_strip: Optional[int] = None,
                 tile: Optional[tuple] = None) -> list:
    """Uncompressed YCbCr data units (TIFF 6.0 section 21) of (H, W, 3)
    uint8 Y, Cb, Cr samples in strips or tiles: hs x vs Y samples, then
    the unit's Cb and Cr (its top-left pixel's), the edges padded by
    replication."""
    hs, vs = subsampling
    H, W = ycc.shape[:2]
    if tile:
        tw, th = tile
        spans = [(y, x, th, tw) for y in range(0, H, th)
                 for x in range(0, W, tw)]
    else:
        rps = rows_per_strip or H
        spans = [(y, 0, min(rps, H - y), W) for y in range(0, H, rps)]
    out = []
    for y, x, h, w in spans:
        part = ycc[y:y + h, x:x + w]
        uh, uw = -(-h // vs) * vs, -(-w // hs) * hs
        part = np.pad(part, [(0, uh - part.shape[0]),
                             (0, uw - part.shape[1]), (0, 0)], mode="edge")
        units = part.reshape(uh // vs, vs, uw // hs, hs, 3).transpose(
            0, 2, 1, 3, 4)
        lum = units[..., 0].reshape(uh // vs, uw // hs, vs * hs)
        chroma = units[:, :, 0, 0, 1:]
        out.append(np.concatenate([lum, chroma], -1).tobytes())
    return out


class _MsbBits:
    """A bit writer, first bit the most significant of each byte."""

    def __init__(self):
        self.bits = []

    def put(self, code: str) -> None:
        self.bits.extend(int(c) for c in code)

    def align(self, n: int) -> None:
        self.bits.extend([0] * (-len(self.bits) % n))

    def tobytes(self) -> bytes:
        self.align(8)
        return np.packbits(np.array(self.bits, np.uint8)).tobytes()


def _fax_span(w: _MsbBits, span: int, codes: dict) -> None:
    """libtiff's putspan: make-up codes of 2560 while the run reaches 2624,
    one make-up code, then the terminating code."""
    while span >= 2624:
        w.put(codes[2560])
        span -= 2560
    if span >= 64:
        w.put(codes[span // 64 * 64])
        span -= span // 64 * 64
    w.put(codes[span])


def _fax_1d(w: _MsbBits, row: np.ndarray, white: dict, black: dict) -> None:
    """A modified Huffman row: runs from white, alternating."""
    x, color = 0, 0
    while True:
        end = _finddiff(row, x, color)
        _fax_span(w, end - x, black if color else white)
        x, color = end, 1 - color
        if x >= len(row):
            break


def _finddiff(row: np.ndarray, start: int, color: int) -> int:
    x = start
    while x < len(row) and row[x] == color:
        x += 1
    return x


def _fax_2d(w: _MsbBits, row: np.ndarray, ref: np.ndarray, white: dict,
            black: dict) -> None:
    """tif_fax3.c's Fax3Encode2DRow of a row against its reference."""
    from vido_slam_tpu_torch.io.tiff_fax import MODES_2D

    W = len(row)
    mode = {(state, p): code for code, state, p in MODES_2D}
    v = {0: mode[(3, 0)], -1: mode[(4, 1)], -2: mode[(4, 2)],
         -3: mode[(4, 3)], 1: mode[(5, 1)], 2: mode[(5, 2)],
         3: mode[(5, 3)]}
    px = lambda r, x: int(r[x]) if x < W else 0  # noqa: E731
    a0 = 0
    a1 = 0 if row[0] else _finddiff(row, 0, 0)
    b1 = 0 if ref[0] else _finddiff(ref, 0, 0)
    while True:
        b2 = _finddiff(ref, b1, px(ref, b1)) if b1 < W else W
        if b2 >= a1:
            d = b1 - a1
            if not -3 <= d <= 3:
                a2 = _finddiff(row, a1, px(row, a1)) if a1 < W else W
                w.put(mode[(2, 0)])
                if a0 + a1 == 0 or px(row, a0) == 0:
                    _fax_span(w, a1 - a0, white)
                    _fax_span(w, a2 - a1, black)
                else:
                    _fax_span(w, a1 - a0, black)
                    _fax_span(w, a2 - a1, white)
                a0 = a2
            else:
                w.put(v[d])
                a0 = a1
        else:
            w.put(mode[(1, 0)])
            a0 = b2
        if a0 >= W:
            break
        c = px(row, a0)
        a1 = _finddiff(row, a0, c)
        b1 = _finddiff(ref, a0, 1 - c)
        b1 = _finddiff(ref, b1, c)


def fax_encode(bits: np.ndarray, mode: int, *, k: int = 2,
               eol_fill: bool = False, rtc: bool = True) -> bytes:
    """One strip of (rows, W) 0/1 pixels (1 black) as CCITT fax, ``mode``
    as io/tiff_fax.MODES: 2 modified Huffman rows, each byte-aligned;
    32771 the same, word-aligned; 3 T.4 1-D, an EOL before each row
    (``eol_fill``: zero bits so that each EOL ends on a byte); 103 T.4
    with 2-D rows, a 1-D row every ``k`` rows, the EOL's tag bit after it;
    4 T.6 (2-D rows from an all-white reference, EOFB at the end). ``rtc``:
    T.4's six EOLs at the end."""
    from vido_slam_tpu_torch.io.tiff_fax import EOL, black_codes, white_codes

    white, black = white_codes(), black_codes()
    w = _MsbBits()
    ref = np.zeros(bits.shape[1], np.uint8)
    for i, row in enumerate(bits.astype(np.uint8)):
        if mode in (3, 103):
            if eol_fill:
                w.bits.extend([0] * ((4 - len(w.bits)) % 8))
            w.put(EOL)
        if mode == 103:
            one_d = i % k == 0
            w.put("1" if one_d else "0")
            if one_d:
                _fax_1d(w, row, white, black)
            else:
                _fax_2d(w, row, ref, white, black)
        elif mode == 4:
            _fax_2d(w, row, ref, white, black)
        else:
            _fax_1d(w, row, white, black)
            if mode in (2, 32771):
                w.align(8 if mode == 2 else 16)
        ref = row
    if mode == 4:
        w.put(EOL + EOL)
    elif mode in (3, 103) and rtc:
        for _ in range(6):
            w.put(EOL + ("1" if mode == 103 else ""))
    return w.tobytes()


def jpeg_to_tiff(path: str, data: bytes, *, big_endian: bool = False
                 ) -> None:
    """A baseline JPEG file as a JPEG-in-TIFF of one strip: its DQT and DHT
    segments moved into the JPEGTables tag, its APPn segments dropped, the
    rest the strip's abbreviated stream; photometric YCbCr (the frame's
    first component's sampling as YCbCrSubsampling) for three components,
    gray for one. Needs neither PIL nor cv2."""
    tables, strip, sof = split_jpeg(data)
    H, W, nc = struct.unpack(">HHB", sof[1:6])
    tags = {347: (7, tables)}
    if nc == 3:
        tags[530] = (3, [sof[7] >> 4, sof[7] & 15])
    write_tiff(path, np.zeros((H, W, nc), np.uint8),
               photometric=6 if nc == 3 else 1, compression=7,
               chunks=[strip], tags=tags, big_endian=big_endian)


# ---------------------------------------------------------------------------
# lossy WebP: VP8 key frames of random syntax, ALPH chunks, the container
# ---------------------------------------------------------------------------

class _BoolWriter:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.put(128, (v >> k) & 1)

    def signed(self, v: int, n: int) -> None:
        self.value(abs(v), n)
        self.put(128, v < 0)

    def flag_value(self, v: Optional[int], n: int, signed=True) -> None:
        """An optional field: a flag, then the value."""
        self.put(128, v is not None)
        if v is not None:
            (self.signed if signed else self.value)(v, n)

    def data(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


# the ten 4x4 modes' paths in the mode tree: (probability index, bit)
_B_MODE_PATHS = {
    0: ((0, 0),), 1: ((0, 1), (1, 0)), 2: ((0, 1), (1, 1), (2, 0)),
    3: ((0, 1), (1, 1), (2, 1), (3, 0), (4, 0)),
    4: ((0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 0)),
    5: ((0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 1)),
    6: ((0, 1), (1, 1), (2, 1), (3, 1), (6, 0)),
    7: ((0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 0)),
    8: ((0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 0)),
    9: ((0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 1))}
# 16x16 modes DC 0, TM 1, V 2, H 3; chroma the same
_Y_MODE_PATHS = {0: ((156, 0), (163, 0)), 2: ((156, 0), (163, 1)),
                 3: ((156, 1), (128, 0)), 1: ((156, 1), (128, 1))}
_UV_MODE_PATHS = {0: ((142, 0),), 2: ((142, 1), (114, 0)),
                  3: ((142, 1), (114, 1), (183, 0)),
                  1: ((142, 1), (114, 1), (183, 1))}


def _put_large(bw: _BoolWriter, v: int, p) -> None:
    """A token of value v >= 2 (GetLargeValue's tree and categories)."""
    from vido_slam_tpu_torch.io import vp8
    if v <= 4:
        bw.put(p[3], 0)
        if v == 2:
            bw.put(p[4], 0)
        else:
            bw.put(p[4], 1)
            bw.put(p[5], v - 3)
        return
    bw.put(p[3], 1)
    if v <= 10:
        bw.put(p[6], 0)
        if v <= 6:
            bw.put(p[7], 0)
            bw.put(159, v - 5)
        else:
            bw.put(p[7], 1)
            bw.put(165, (v - 7) >> 1)
            bw.put(145, (v - 7) & 1)
        return
    bw.put(p[6], 1)
    cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
    bw.put(p[8], cat >> 1)
    bw.put(p[9 + (cat >> 1)], cat & 1)
    extra = v - 3 - (8 << cat)
    probs = vp8.CAT3456[cat]
    for k, prob in enumerate(probs):
        bw.put(prob, (extra >> (len(probs) - 1 - k)) & 1)


def _put_block(bw: _BoolWriter, prob, ctx: int, first: int, levels,
               run_out: bool) -> int:
    """One block's tokens (``levels``: 16 quantised values in zigzag
    order; ``run_out``: zero tokens to the end in place of the end of
    block); returns what GetCoeffs returns."""
    last = max([k for k in range(first, 16) if levels[k]], default=-1)
    n = first
    p = prob[n][ctx]
    while n <= last:
        bw.put(p[0], 1)
        while not levels[n]:
            bw.put(p[1], 0)
            n += 1
            p = prob[n][0]
        bw.put(p[1], 1)
        v = abs(int(levels[n]))
        if v == 1:
            bw.put(p[2], 0)
            p = prob[n + 1][1]
        else:
            bw.put(p[2], 1)
            _put_large(bw, v, p)
            p = prob[n + 1][2]
        bw.put(128, levels[n] < 0)
        n += 1
    if n == 16:
        return 16
    if run_out:
        bw.put(p[0], 1)
        while n < 16:
            bw.put(p[1], 0)
            n += 1
            p = prob[n][0]
        return 16
    bw.put(p[0], 0)
    return n


def _levels(rng, scale: float, cat6: float):
    """16 random quantised values in zigzag order: mostly none or a few
    small ones, at times large ones and category-6 values."""
    out = np.zeros(16, np.int64)
    count = int(rng.choice([0, 0, 1, 2, 3, 5, 16]))
    for k in rng.choice(16, count, replace=False):
        v = 1 + int(abs(rng.standard_normal()) * scale)
        if rng.rand() < cat6:
            v = int(rng.randint(67, 2115))
        out[k] = min(v, 2114) * (1 if rng.rand() < 0.5 else -1)
    return out


def write_vp8(rng, width: int, height: int, *, segments=..., update_map=None,
              absolute=None, filter_type=None, level=None, sharpness=None,
              lf_deltas=..., partitions=None, q=None, dq=...,
              updates: float = 0.1, skip_p=..., i4x4: float = 0.5,
              scale: float = 4.0, cat6: float = 0.02, run_out: float = 0.05,
              scale_bits: int = 0) -> bytes:
    """A VP8 key frame (the payload of a ``VP8 `` chunk) of random syntax
    at once valid and decodable, not an encoding of any image. Options
    left at their defaults are drawn from ``rng`` (None, or ``...`` where
    None means off): ``segments`` (per segment (quantiser, filter
    strength), or None for none), ``update_map`` (a segment map and
    its tree probabilities), ``absolute`` values or deltas,
    ``filter_type`` (0 simple, 1 normal), ``level`` 0-63, ``sharpness``
    0-7, ``lf_deltas`` (4 reference and 4 mode deltas, None for off),
    ``partitions`` (log2 of 1, 2, 4, 8 token partitions), ``q`` 0-127 and
    ``dq`` (the five deltas, None each for absent), ``updates`` (the share
    of coefficient probabilities replaced), ``skip_p`` (None: no skip
    flags), ``i4x4`` (the share of macroblocks with 4x4 modes; every mode
    drawn evenly), ``scale`` and ``cat6`` (coefficient sizes), ``run_out``
    (the share of blocks ended by zero tokens to the last position)."""
    from vido_slam_tpu_torch.io import vp8

    def pick(v, draw):
        return draw() if v is None else v
    if segments is ...:
        segments = [(int(rng.randint(-127, 128)), int(rng.randint(-63, 64)))
                    for _ in range(4)] if rng.rand() < 0.5 else None
    update_map = pick(update_map, lambda: segments is not None and
                      bool(rng.rand() < 0.8))
    absolute = pick(absolute, lambda: bool(rng.rand() < 0.5))
    filter_type = pick(filter_type, lambda: int(rng.randint(2)))
    level = pick(level, lambda: int(rng.choice([0, 63, rng.randint(64)])))
    sharpness = pick(sharpness, lambda: int(rng.randint(8)))
    if lf_deltas is ...:
        lf_deltas = [int(rng.randint(-63, 64)) for _ in range(8)] \
            if rng.rand() < 0.5 else None
    partitions = pick(partitions, lambda: int(rng.randint(4)))
    q = pick(q, lambda: int(rng.choice([0, 127, rng.randint(128)])))
    if dq is ...:
        dq = [int(rng.randint(-15, 16)) if rng.rand() < 0.4 else None
              for _ in range(5)]
    if skip_p is ...:
        skip_p = int(rng.randint(256)) if rng.rand() < 0.5 else None
    seg_proba = [int(rng.randint(256)) if rng.rand() < 0.7 else None
                 for _ in range(3)]
    bw = _BoolWriter()
    bw.put(128, int(rng.randint(2)))           # colour space
    bw.put(128, int(rng.randint(2)))           # clamping type
    bw.put(128, segments is not None)
    if segments is not None:
        bw.put(128, update_map)
        bw.put(128, 1)                         # segment data follow
        bw.put(128, absolute)
        for qs, _ in segments:
            bw.flag_value(qs if rng.rand() < 0.9 else None, 7)
        for _, fs in segments:
            bw.flag_value(fs if rng.rand() < 0.9 else None, 6)
        if update_map:
            for p in seg_proba:
                bw.flag_value(p, 8, signed=False)
    bw.put(128, filter_type == 0)
    bw.value(level, 6)
    bw.value(sharpness, 3)
    bw.put(128, lf_deltas is not None)
    if lf_deltas is not None:
        bw.put(128, 1)
        for d in lf_deltas:
            bw.flag_value(d if rng.rand() < 0.8 else None, 6)
    bw.value(partitions, 2)
    bw.value(q, 7)
    for d in dq:
        bw.flag_value(d, 4)
    bw.put(128, int(rng.randint(2)))           # refresh entropy probs
    proba = []
    for i, up in enumerate(vp8.COEFF_UPDATE):
        if rng.rand() < updates:
            v = int(rng.randint(1, 256))
            bw.put(up, 1)
            bw.value(v, 8)
        else:
            bw.put(up, 0)
            v = vp8.COEFF_PROBA0[i]
        proba.append(v)
    bands = [[[proba[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c) * 11
                     + 11] for c in range(3)] for b in range(8)]
             for t in range(4)]
    prob = [[bands[t][vp8.BANDS[k]] for k in range(17)] for t in range(4)]
    bw.value(skip_p is not None, 1)
    if skip_p is not None:
        bw.value(skip_p, 8)
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    nparts = 1 << partitions
    tokens = [_BoolWriter() for _ in range(nparts)]
    intra_t = [0] * (4 * mb_w)
    top_nz = [[0] * 9 for _ in range(mb_w)]
    sp = [255 if p is None else p for p in seg_proba]
    for mb_y in range(mb_h):
        left = [0] * 4
        left_nz = [0] * 9
        tw = tokens[mb_y % nparts]
        for mb_x in range(mb_w):
            if update_map:
                seg = int(rng.randint(4))
                bw.put(sp[0], seg >> 1)
                bw.put(sp[1 + (seg >> 1)], seg & 1)
            skip = skip_p is not None and rng.rand() < 0.3
            if skip_p is not None:
                bw.put(skip_p, skip)
            is4 = rng.rand() < i4x4
            bw.put(145, not is4)
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            if not is4:
                ymode = int(rng.randint(4))
                for p, b in _Y_MODE_PATHS[ymode]:
                    bw.put(p, b)
                top, left = [ymode] * 4, [ymode] * 4
            else:
                for y in range(4):
                    for x in range(4):
                        m = int(rng.randint(10))
                        pr = vp8.BMODES_PROBA[(top[x] * 10 + left[y]) * 9:]
                        for k, b in _B_MODE_PATHS[m]:
                            bw.put(pr[k], b)
                        top[x] = left[y] = m
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            for p, b in _UV_MODE_PATHS[int(rng.randint(4))]:
                bw.put(p, b)
            tnz = top_nz[mb_x]
            if skip:
                for k in range(8):
                    tnz[k] = left_nz[k] = 0
                if not is4:
                    tnz[8] = left_nz[8] = 0
                continue
            if not is4:
                nz = _put_block(tw, prob[1], tnz[8] + left_nz[8], 0,
                                _levels(rng, scale, cat6),
                                rng.rand() < run_out)
                tnz[8] = left_nz[8] = int(nz > 0)
            first = 0 if is4 else 1
            ac = prob[3] if is4 else prob[0]
            for y in range(4):
                for x in range(4):
                    nz = _put_block(tw, ac, left_nz[y] + tnz[x], first,
                                    _levels(rng, scale, cat6),
                                    rng.rand() < run_out)
                    left_nz[y] = tnz[x] = int(nz > first)
            for ch in (4, 6):
                for y in range(2):
                    for x in range(2):
                        nz = _put_block(tw, prob[2],
                                        left_nz[ch + y] + tnz[ch + x], 0,
                                        _levels(rng, scale, cat6),
                                        rng.rand() < run_out)
                        left_nz[ch + y] = tnz[ch + x] = int(nz > 0)
    first_part = bw.data()
    parts = [t.data() for t in tokens]
    frame_tag = (len(first_part) << 5) | 0x10   # key frame, profile 0, shown
    head = struct.pack("<I", frame_tag)[:3] + b"\x9d\x01\x2a" + \
        struct.pack("<HH", width | scale_bits << 14, height | scale_bits << 14)
    sizes = b"".join(struct.pack("<I", len(p))[:3] for p in parts[:-1])
    return head + first_part + sizes + b"".join(parts)


def webp_chunk(tag: bytes, payload: bytes) -> bytes:
    """A RIFF chunk with its padding byte."""
    return tag + struct.pack("<I", len(payload)) + payload + \
        b"\x00" * (len(payload) & 1)


def webp_file(chunks: Sequence[bytes]) -> bytes:
    """A RIFF WEBP file of the given chunks."""
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x_chunk(width: int, height: int, flags: int = 0) -> bytes:
    """A VP8X chunk: the flags (0x10 alpha, 0x02 animation, ...) and the
    canvas."""
    return webp_chunk(b"VP8X", bytes([flags, 0, 0, 0])
                      + (width - 1).to_bytes(3, "little")
                      + (height - 1).to_bytes(3, "little"))


def anmf_chunk(frame_chunks: bytes, x: int, y: int, width: int,
               height: int, duration: int = 100, flags: int = 0) -> bytes:
    """An ANMF chunk at (x, y) (even) holding an image's chunks."""
    return webp_chunk(b"ANMF", (x // 2).to_bytes(3, "little")
                      + (y // 2).to_bytes(3, "little")
                      + (width - 1).to_bytes(3, "little")
                      + (height - 1).to_bytes(3, "little")
                      + duration.to_bytes(3, "little") + bytes([flags])
                      + frame_chunks)


def alpha_filter(alpha: np.ndarray, kind: int) -> np.ndarray:
    """The forward ALPH filters (horizontal 1, vertical 2, gradient 3) the
    decoder undoes."""
    a = alpha.astype(np.int64)
    out = a.copy()
    if kind == 0:
        return alpha.copy()
    H, W = a.shape
    for y in range(H):
        for x in range(W):
            if y == 0 or (kind == 1 and x > 0):
                pred = a[y, x - 1] if x else (a[y - 1, 0] if y else 0)
            elif kind == 1 or x == 0:
                pred = a[y - 1, x]
            elif kind == 2:
                pred = a[y - 1, x]
            else:
                pred = min(max(a[y, x - 1] + a[y - 1, x] - a[y - 1, x - 1],
                               0), 255)
            out[y, x] = (a[y, x] - pred) & 0xFF
    return out.astype(np.uint8)


def alph_chunk(alpha: np.ndarray, method: int = 0, kind: int = 0,
               pre: int = 0, header: Optional[int] = None, **vp8l) -> bytes:
    """An ALPH chunk of an (H, W) alpha plane: filtered by ``kind``, raw
    (``method`` 0) or as a VP8L stream without its header whose green
    channel is the plane (``method`` 1, ``write_vp8l``'s options);
    ``header`` overrides the header byte."""
    byte = method | kind << 2 | pre << 4 if header is None else header
    plane = alpha_filter(alpha, kind)
    if method == 0:
        data = plane.tobytes()
    else:
        argb = 0xFF000000 | plane.astype(np.uint32) << 8
        data = write_vp8l(argb, riff=False, **vp8l)[5:]
    return webp_chunk(b"ALPH", bytes([byte]) + data)
