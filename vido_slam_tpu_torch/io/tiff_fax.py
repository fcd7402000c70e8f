"""CCITT fax strips and tiles of a TIFF (compressions 2, 3, 4 and 32771),
decoded as libtiff 4.7's ``tif_fax3.c`` decodes them for ``cv2.imread``
and PIL: the run codes of ITU-T T.4 (modified Huffman, the 2-D modes of
T.4 and T.6), libtiff's bit accumulator and its recovery from bad codes
and premature ends. ``decode`` runs the host C++ loop
(``csrc/fax_decode.cpp``, built at first use); ``plain=True`` runs its
plain Python twin, bit-equal to it. Both take the code tables built here
as ``mkg3states.c`` builds libtiff's.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

from vido_slam_tpu_torch.utils import host_build

# tif_fax3.h's states
(S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB,
 S_MAKEUPW, S_MAKEUPB, S_MAKEUP, S_EOL) = range(13)

# T.4's terminating codes of runs 0-63 (white, black), in order
TERM_WHITE = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
TERM_BLACK = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 "
    "0000111 00000100 00000111 000011000 0000010111 0000011000 0000001000 "
    "00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 "
    "000011010111 000001101100 000001101101 000011011010 000011011011 "
    "000001010100 000001010101 000001010110 000001010111 000001100100 "
    "000001100101 000001010010 000001010011 000000100100 000000110111 "
    "000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
# the make-up codes of runs 64, 128, ..., 1728
MAKEUP_WHITE = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011").split()
MAKEUP_BLACK = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
    "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 "
    "0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101").split()
# the make-up codes both colours share, runs 1792, 1856, ..., 2560
MAKEUP_SHARED = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111").split()
EOL = "000000000001"
# the 2-D modes: (code, state, offset)
MODES_2D = (("0001", S_PASS, 0), ("001", S_HORIZ, 0), ("1", S_V0, 0),
            ("011", S_VR, 1), ("000011", S_VR, 2), ("0000011", S_VR, 3),
            ("010", S_VL, 1), ("000010", S_VL, 2), ("0000010", S_VL, 3),
            ("0000001", S_EXT, 0), ("0000000", S_EOL, 0))

# decode modes: the TIFF compression, 103 for T.4 with 2-D rows
MODES = (2, 3, 103, 4, 32771)


def white_codes() -> dict:
    """run -> code (as a string of bits) of every white run code."""
    return _codes(TERM_WHITE, MAKEUP_WHITE)


def black_codes() -> dict:
    return _codes(TERM_BLACK, MAKEUP_BLACK)


def _codes(term, makeup) -> dict:
    out = {i: c for i, c in enumerate(term)}
    out.update({64 * (i + 1): c for i, c in enumerate(makeup)})
    out.update({1792 + 64 * i: c for i, c in enumerate(MAKEUP_SHARED)})
    return out


def _fill(tab: np.ndarray, wid: int, code: str, state: int,
          param: int) -> None:
    """mkg3states.c's FillTable: every entry whose low bits (the stream's
    next bits, first bit lowest) are ``code``."""
    n = len(code)
    value = sum(int(b) << i for i, b in enumerate(code))
    idx = value + (np.arange(1 << (wid - n)) << n)
    tab[idx] = (state, n, param)


@lru_cache(maxsize=1)
def tables() -> np.ndarray:
    """libtiff's TIFFFaxMainTable (7 bits), TIFFFaxWhiteTable (12) and
    TIFFFaxBlackTable (13), one (128 + 4096 + 8192, 3) int32 array of
    (state, width, run); entries no code reaches are (S_NULL, 0, 0)."""
    main = np.zeros((128, 3), np.int32)
    for code, state, param in MODES_2D:
        _fill(main, 7, code, state, param)
    out = [main]
    for wid, codes, term, makeup in ((12, white_codes(), S_TERMW, S_MAKEUPW),
                                     (13, black_codes(), S_TERMB,
                                      S_MAKEUPB)):
        tab = np.zeros((1 << wid, 3), np.int32)
        for run, code in codes.items():
            state = term if run < 64 else makeup if run <= 1728 else S_MAKEUP
            _fill(tab, wid, code, state, run)
        _fill(tab, wid, EOL[:11], S_EOL, 0)
        out.append(tab)
    return np.ascontiguousarray(np.concatenate(out))


def _lib():
    lib = host_build.load("fax_decode")
    fn = lib.tiff_fax_decode
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    return lib


def decode(src: bytes, rows: int, width: int, mode: int,
           plain: bool = False) -> tuple:
    """One strip or tile of ``rows`` rows of ``width`` pixels, ``mode`` one
    of ``MODES``, the stream read first bit most significant (a fill
    order 2 strip is bit-reversed before). Returns (the rows written,
    rows * ceil(width / 8) bytes: black runs are 1 bits, MSB first); the
    rows written are all of them, fewer where a T.6 stream ends early
    (libtiff keeps the rows before and leaves the others as they were),
    or -1 where libtiff fails the strip."""
    out = np.zeros(rows * ((width + 7) // 8), np.uint8)
    if plain:
        got = _decode_plain(src, out, rows, width, mode)
    else:
        tab = tables()
        got = _lib().tiff_fax_decode(src, len(src), out.ctypes.data, rows,
                                     width, mode, tab.ctypes.data)
    return int(got), out.tobytes()


# ---------------------------------------------------------------------------
# the plain twin of csrc/fax_decode.cpp
# ---------------------------------------------------------------------------

# every byte's bits reversed
REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _wrap(v: int) -> int:
    """C's int of a value computed on uint32 runs."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


class _Eof(Exception):
    pass


class _Overflow(Exception):
    pass


class _Decoder:
    """tif_fax3.h's bit accumulator and run arrays."""

    def __init__(self, src: bytes, width: int, two_d: bool):
        self.src, self.cp, self.acc, self.avail = src, 0, 0, 0
        tab = tables().tolist()
        self.main, self.white = tab[:128], tab[128:128 + 4096]
        self.black = tab[128 + 4096:]
        self.lastx = width
        self.nruns = ((width + 1 + 31) // 32) * 32 * (2 if two_d else 1)
        self.runs = [0] * (2 * self.nruns)

    def need8(self, n: int) -> bool:
        if self.avail < n:
            if self.cp >= len(self.src):
                if self.avail == 0:
                    return False
                self.avail = n
            else:
                self.acc |= REVERSED[self.src[self.cp]] << self.avail
                self.cp += 1
                self.avail += 8
        return True

    def need16(self, n: int) -> bool:
        if self.avail < n:
            if self.cp >= len(self.src):
                if self.avail == 0:
                    return False
                self.avail = n
            else:
                self.acc |= REVERSED[self.src[self.cp]] << self.avail
                self.cp += 1
                self.avail += 8
                if self.avail < n:
                    if self.cp >= len(self.src):
                        self.avail = n
                    else:
                        self.acc |= REVERSED[self.src[self.cp]] << self.avail
                        self.cp += 1
                        self.avail += 8
        return True

    def get(self, n: int) -> int:
        return self.acc & ((1 << n) - 1)

    def clr(self, n: int) -> None:
        self.avail -= n
        self.acc >>= n


class _Row:
    """One row's expansion (EXPAND1D, EXPAND2D and their macros)."""

    def __init__(self, d: _Decoder, thisrun: int, eol: int):
        self.d, self.thisrun, self.pa = d, thisrun, thisrun
        self.a0 = self.run_length = self.b1 = 0
        self.pb, self.eol = 0, eol

    def setvalue(self, x: int) -> None:
        d = self.d
        if self.pa >= self.thisrun + d.nruns:
            raise _Overflow
        d.runs[self.pa] = (self.run_length + x) & 0xFFFFFFFF
        self.pa += 1
        self.a0 = _wrap(self.a0 + x)
        self.run_length = 0

    def cleanup(self) -> None:
        d = self.d
        if self.run_length:
            self.setvalue(0)
        if self.a0 != d.lastx:
            while self.a0 > d.lastx and self.pa > self.thisrun:
                self.pa -= 1
                self.a0 = _wrap(self.a0 - d.runs[self.pa])
            if self.a0 < d.lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if (self.pa - self.thisrun) & 1:
                    self.setvalue(0)
                self.setvalue(_wrap(d.lastx - self.a0))
            elif self.a0 > d.lastx:
                self.setvalue(d.lastx)
                self.setvalue(0)

    def ref(self, i: int) -> int:
        runs = self.d.runs
        return runs[i] if 0 <= i < len(runs) else 0

    def check_b1(self, refbase: int) -> None:
        d = self.d
        if self.pa != self.thisrun:
            while self.b1 <= self.a0 and self.b1 < d.lastx:
                if self.pb + 1 >= refbase + d.nruns:
                    raise _Overflow
                self.b1 = _wrap(self.b1 + ((self.ref(self.pb)
                                            + self.ref(self.pb + 1))
                                           & 0xFFFFFFFF))
                self.pb += 2

    def colour_run(self, black: bool, one_d: bool) -> bool:
        """True at a terminating code, False at another (the row ends);
        _Eof where the data ends."""
        d = self.d
        tab, wid = (d.black, 13) if black else (d.white, 12)
        term, makeup = (S_TERMB, S_MAKEUPB) if black else (S_TERMW,
                                                            S_MAKEUPW)
        while True:
            if not d.need16(wid):
                raise _Eof
            state, width, param = tab[d.get(wid)]
            d.clr(width)
            if state == term:
                self.setvalue(param)
                return True
            if state in (makeup, S_MAKEUP):
                self.a0 = _wrap(self.a0 + param)
                self.run_length = _wrap(self.run_length + param)
                continue
            if one_d and state == S_EOL:
                self.eol = 1
            return False

    def expand1d(self) -> None:
        d = self.d
        try:
            while True:
                if not self.colour_run(False, True) or self.a0 >= d.lastx:
                    break
                if not self.colour_run(True, True) or self.a0 >= d.lastx:
                    break
                if d.runs[self.pa - 1] == 0 and d.runs[self.pa - 2] == 0:
                    self.pa -= 2
        except _Eof:
            self.cleanup()
            raise
        self.cleanup()

    def expand2d(self, refbase: int) -> None:
        d = self.d
        try:
            self._expand2d(refbase)
        except _Eof:
            self.cleanup()
            raise
        self.cleanup()

    def _expand2d(self, refbase: int) -> None:
        d = self.d
        while self.a0 < d.lastx:
            if self.pa >= self.thisrun + d.nruns:
                raise _Overflow
            if not d.need8(7):
                raise _Eof
            state, width, param = d.main[d.get(7)]
            d.clr(width)
            if state == S_PASS:
                self.check_b1(refbase)
                self.b1 = _wrap(self.b1 + self.ref(self.pb))
                self.pb += 1
                self.run_length = _wrap(self.run_length + self.b1 - self.a0)
                self.a0 = self.b1
                self.b1 = _wrap(self.b1 + self.ref(self.pb))
                self.pb += 1
            elif state == S_HORIZ:
                black_first = bool((self.pa - self.thisrun) & 1)
                if not self.colour_run(black_first, False) or \
                        not self.colour_run(not black_first, False):
                    return
                self.check_b1(refbase)
            elif state in (S_V0, S_VR):
                self.check_b1(refbase)
                self.setvalue(_wrap(self.b1 - self.a0 + param))
                self.b1 = _wrap(self.b1 + self.ref(self.pb))
                self.pb += 1
            elif state == S_VL:
                self.check_b1(refbase)
                if self.b1 < _wrap(self.a0 + param):
                    return
                self.setvalue(_wrap(self.b1 - self.a0 - param))
                self.pb -= 1
                self.b1 = _wrap(self.b1 - self.ref(self.pb))
            elif state in (S_EXT, S_EOL):
                d.runs[self.pa] = (d.lastx - self.a0) & 0xFFFFFFFF
                self.pa += 1
                if state == S_EOL:
                    if not d.need8(4):
                        raise _Eof
                    d.clr(4)
                    self.eol = 1
                return
            else:
                return
        if self.run_length:
            if _wrap(self.run_length + self.a0) < d.lastx:
                if not d.need8(1):
                    raise _Eof
                if not d.get(1):
                    return
                d.clr(1)
            self.setvalue(0)


def _fill_row(out: np.ndarray, off: int, runs: list, start: int, end: int,
              lastx: int) -> None:
    """_TIFFFax3fillruns, the runs clamped to the row in place."""
    if (end - start) & 1:
        runs[end] = 0
        end += 1
    x = 0
    bits = np.zeros(lastx, np.uint8)
    for i in range(start, end):
        run = runs[i]
        if ((x + run) & 0xFFFFFFFF) > lastx or run > lastx:
            run = runs[i] = (lastx - x) & 0xFFFFFFFF
        if (i - start) & 1:
            bits[x:x + run] = 1
        x = (x + run) & 0xFFFFFFFF
    packed = np.packbits(bits)
    out[off:off + len(packed)] = packed


def _sync_eol(d: _Decoder, row: _Row) -> bool:
    if row.eol == 0:
        while True:
            if not d.need16(11):
                return False
            if d.get(11) == 0:
                break
            d.clr(1)
    while True:
        if not d.need8(8):
            return False
        if d.get(8):
            break
        d.clr(8)
    while d.get(1) == 0:
        d.clr(1)
    d.clr(1)
    row.eol = 0
    return True


def _decode_plain(src: bytes, out: np.ndarray, rows: int, width: int,
                  mode: int) -> int:
    two_d = mode in (103, 4)
    d = _Decoder(src, width, two_d)
    cur, refr = 0, d.nruns
    if two_d:
        d.runs[refr], d.runs[refr + 1] = width, 0
    rowbytes = (width + 7) // 8
    eol = 0
    for line in range(rows):
        row = _Row(d, cur, eol)
        try:
            if mode in (2, 32771):
                row.expand1d()
                _fill_row(out, line * rowbytes, d.runs, row.thisrun, row.pa,
                          width)
                d.clr(d.avail & (15 if mode == 32771 else 7))
                if mode == 32771 and d.avail == 0 and d.cp & 1:
                    d.cp += 1
            elif mode == 3:
                if not _sync_eol(d, row):
                    return -1
                row.expand1d()
                _fill_row(out, line * rowbytes, d.runs, row.thisrun, row.pa,
                          width)
            elif mode == 103:
                if not _sync_eol(d, row) or not d.need8(1):
                    return -1
                is1d = d.get(1)
                d.clr(1)
                row.pb = refr + 1
                row.b1 = d.runs[refr]
                if is1d:
                    row.expand1d()
                else:
                    row.expand2d(refr)
                _fill_row(out, line * rowbytes, d.runs, row.thisrun, row.pa,
                          width)
                if row.pa < row.thisrun + d.nruns:
                    row.setvalue(0)
                cur, refr = refr, cur
            else:
                row.pb = refr + 1
                row.b1 = d.runs[refr]
                try:
                    row.expand2d(refr)
                except _Eof:
                    row.eol = 1          # EOFG4, as at an EOL
                if row.eol:
                    if d.need16(13):
                        d.clr(13)
                    _fill_row(out, line * rowbytes, d.runs, row.thisrun,
                              row.pa, width)
                    return line + 1 if line else -1
                _fill_row(out, line * rowbytes, d.runs, row.thisrun, row.pa,
                          width)
                row.setvalue(0)
                cur, refr = refr, cur
        except (_Eof, _Overflow):
            return -1
        eol = row.eol
    return rows
