"""Lossy WebP's image: a VP8 key frame (RFC 6386) decoded as libwebp 1.x
decodes it for ``cv2.imread`` and PIL, bit for bit, into B, G, R bytes.

The frame header and partition 0 (``vp8_dec.c`` VP8GetHeaders): the key
frame's start code and sizes (the scale bits ignored), the colour-space
and clamping bits, the segment header (update-map and update-data flags,
absolute or delta quantisers and filter strengths, the map's tree
probabilities), the filter header (simple or normal, level, sharpness, the
reference and mode deltas), the 1, 2, 4 or 8 token partitions (a size past
the data is cut to what is left; the last partition must hold a byte), the
quantiser indices with their five deltas (``quant_dec.c``), the
coefficient probability updates and the skip probability
(``tree_dec.c``). Per macroblock: the segment id, the skip flag, the 16x16
mode or sixteen 4x4 modes through their context trees, the chroma mode,
then the coefficient tokens (bands, contexts, the non-zero contexts
carried across blocks, the DCT categories 1-6 and the Y2 block).

libwebp's boolean decoder reads zeros past a partition's end and marks
itself as past it once it needs a byte that is not there (a partition of
no bytes at once); the frame fails if partition 0 is past its end after a
row of modes, or a token partition after a macroblock.

Reconstruction (``frame_dec.c``, ``dsp/dec.c``): the dequantisation
tables (Y2 DC x2, Y2 AC x155/100 at least 8, UV DC at index 117 at most),
the inverse WHT (a lone DC by its shortcut) and DCT (the full transform
by the 16-bit lanes of libwebp's x86 SIMD build, the DC-only and
three-coefficient ones in C), the 16x16, chroma and 4x4 intra predictors
over the unfiltered neighbours (127 above the frame, 129 left of it; the
4x4 blocks of the right column take the macroblock's top-right pixels,
the last macroblock of a row the pixel above it repeated); then the
simple or normal loop filter, macroblock by macroblock (level 0 turns it
off; inner edges where the macroblock has 4x4 modes or a non-zero
coefficient). Output (``io_dec.c``, ``upsampling.c``, ``yuv.h``): the
fancy upsampling of U and V (rounding twice) and the 14-bit fixed-point
YUV to RGB conversion.

The decoding runs in host C++ (``csrc/vp8_decode.cpp``, built at first
use, bound by ctypes; the tables below are handed to it); ``plain=True``
runs the Python version here, bit-equal to it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from vido_slam_tpu_torch.utils import host_build

# quant_dec.c kDcTable and kAcTable (RFC 6386 dc_qlookup, ac_qlookup)
DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116,
    118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148,
    151, 154, 157)
AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146,
    149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254,
    259, 264, 269, 274, 279, 284)

# RFC 6386 13.4 coeff_update_probs and 13.5 default_coeff_probs, each
# [4 types][8 bands][3 contexts][11 probabilities]; 11.5 kf_bmode_probs,
# [above mode][left mode][9]
COEFF_UPDATE = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "b0f6ffffffffffffffffffdff1fcfffffffffffffffff9fdfdffffffffffffffff"
    "fff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffffffffff"
    "fff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffeffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffbfefefffffffffffffffffefffeffffffffffffffff"
    "fffefdfffefffffffffffffafffefffefffffffffffffeffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfeffffff"
    "fffeffffffffffffffffffdffefeffffffffffffffffeefdfefeffffffffffffff"
    "fff8fefffffffffffffffff9feffffffffffffffffffffffffffffffffffffffff"
    "fffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcffffffffffffffffffffffffffffffffffffffffff"
    "fffefefffffffffffffffffdffffffffffffffffffffffffffffffffffffffffff"
    "fffefdfffffffffffffffffafffffffffffffffffffffeffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffeffffffff"
    "fffdfeffffffffffffffffecfdfefffffffffffffffffbfdfdfefeffffffffffff"
    "fffefefffffffffffffffffefefeffffffffffffffffffffffffffffffffffffff"
    "fffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdffffffffffffff"
    "fffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefbfefeffffffffffff"
    "fffefcfffffffffffffffff8fefdfffffffffffffffffdfffefeffffffffffffff"
    "fffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffeffffffffffffffffff"
    "fffcfffffffffffffffffff9fffefffffffffffffffffffffeffffffffffffffff"
    "fffffdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")

COEFF_PROBA0 = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080"
    "fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff808080"
    "0162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb808080"
    "01b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff808080"
    "01ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3ab8080808080"
    "0198fcfff0ff8080808080b187f3ffeae180808080805081d3ffc2e08080808080"
    "0101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf80"
    "0195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff80"
    "0181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff80"
    "01c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc7808080"
    "01b6f9ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080"
    "019df7ffece7ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe0808080"
    "0101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80"
    "015ff7fdd4b7ffff808080ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff808080"
    "0118effbdadbffcd808080c933dbffc4ba8080808080452ebeefc9daffe4808080"
    "01bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff8080808080808080"
    "01e2ff8080808080808080f7c0ff8080808080808080f080ff8080808080808080"
    "0186fcffff808080808080d53efaffff808080808080375dff8080808080808080"
    "808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd880"
    "0170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff80"
    "0134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff80"
    "01b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb808080"
    "01def8ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff808080"
    "0179ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd808080"
    "0101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")

BMODES_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd"
    "110d98721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa2e37"
    "1388a021ce473f14087272d00c09e251280b60b6541d102486b7598962656aa594"
    "48bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e"
    "6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b775552623b33d"
    "2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a6240221674ce1722"
    "2ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872"
    "282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01"
    "331a478e4e4e10ff8022c5ab29280566d3b70401dd333211a8d1c01719528a1f24"
    "ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c80"
    "1780cd2803097333c01206df572509733b4d40152f68372cda09363582e2405a46"
    "cd2829171a39363970b8052926a6d51e221a8598740a2086271335dd1a722049ff"
    "1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b"
    "2f338051ab0139110547663935293126210d7939491a0155290a438a4d6e5a2f72"
    "7315020a66ffa61706651d100a558065c41a39120a6666d522142b75140f24a380"
    "44011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb87710"
    "56061c0540ff19f8013808118489ff3774803a0f145287391a7928a4321f899a85"
    "1923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d12d1015"
    "5b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033"
    "291420654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c"
    "8a37462b1a8e9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a3"
    "70130c3dc380300418")

BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
           (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))

# libwebp's mode numbers: 4x4 modes 0-9 (B_DC, B_TM, B_VE, B_HE, B_RD,
# B_VR, B_LD, B_VL, B_HD, B_HU); 16x16 and chroma modes DC 0, TM 1, V 2,
# H 3, and DC without top, left or both 4, 5, 6 (CheckMode)
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3

# the work area of one macroblock (frame_dec.c yuv_b_): rows of BPS bytes,
# a row above and a column left of each plane, four top-right pixels
BPS = 32
Y_OFF = BPS + 8
U_OFF = Y_OFF + BPS * 16 + BPS
V_OFF = U_OFF + 16
YUV_SIZE = BPS * 17 + BPS * 9
SCAN = tuple((n & 3) * 4 + (n >> 2) * 4 * BPS for n in range(16))


def tables_blob() -> bytes:
    """The tables ``vp8_decode`` takes: the two coefficient probability
    tables, the 4x4 mode probabilities, the DC table, then the AC table as
    little-endian uint16."""
    return COEFF_UPDATE + COEFF_PROBA0 + BMODES_PROBA + bytes(DC_TABLE) + \
        b"".join(v.to_bytes(2, "little") for v in AC_TABLE)


class _Bool:
    """libwebp's VP8BitReader: the boolean decoder, bytes loaded as it
    needs them; ``eof`` once it needed a byte past ``end`` (it then reads
    zeros)."""

    def __init__(self, data: bytes, start: int, size: int):
        self.data, self.pos, self.end = data, start, start + size
        self.value, self.range, self.bits, self.eof = 0, 254, -8, False
        self._load()

    def _load(self):
        if self.pos < self.end:
            self.bits += 8
            self.value = self.value << 8 | self.data[self.pos]
            self.pos += 1
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = (self.range * prob) >> 8
        if (self.value >> pos) > split:
            rng = self.range - split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 8 - rng.bit_length()
        self.range = (rng << shift) - 1
        self.bits -= shift
        return bit

    def value_of(self, n: int) -> int:          # VP8GetValue
        v = 0
        while n > 0:
            n -= 1
            v |= self.bit(0x80) << n
        return v

    def signed(self, n: int) -> int:            # VP8GetSignedValue
        v = self.value_of(n)
        return -v if self.bit(0x80) else v


def _s16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


def _u8(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


class _Frame:
    """What VP8GetHeaders reads."""


def _headers(data: bytes):
    """VP8GetHeaders and VP8EnterCritical's filter strengths: a _Frame, or
    None where libwebp fails."""
    n = len(data)
    if n < 10:
        return None
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1:
        return None
    if data[3:6] != b"\x9d\x01\x2a":
        return None
    f = _Frame()
    f.width = (data[7] << 8 | data[6]) & 0x3FFF
    f.height = (data[9] << 8 | data[8]) & 0x3FFF
    f.mb_w, f.mb_h = (f.width + 15) >> 4, (f.height + 15) >> 4
    plen = bits >> 5
    if plen > n - 10:
        return None
    br = _Bool(data, 10, plen)
    f.br = br
    br.bit(0x80)                               # colour space
    br.bit(0x80)                               # clamping type
    # segment header
    f.use_segment = br.bit(0x80)
    f.update_map = 0
    f.absolute = 1
    f.seg_quant = [0] * 4
    f.seg_filter = [0] * 4
    f.seg_proba = [255] * 3
    if f.use_segment:
        f.update_map = br.bit(0x80)
        if br.bit(0x80):
            f.absolute = br.bit(0x80)
            f.seg_quant = [br.signed(7) if br.bit(0x80) else 0
                           for _ in range(4)]
            f.seg_filter = [br.signed(6) if br.bit(0x80) else 0
                            for _ in range(4)]
        if f.update_map:
            f.seg_proba = [br.value_of(8) if br.bit(0x80) else 255
                           for _ in range(3)]
    if br.eof:
        return None
    # filter header
    simple = br.bit(0x80)
    level = br.value_of(6)
    sharpness = br.value_of(3)
    use_lf_delta = br.bit(0x80)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    if use_lf_delta and br.bit(0x80):
        for i in range(4):
            if br.bit(0x80):
                ref_delta[i] = br.signed(6)
        for i in range(4):
            if br.bit(0x80):
                mode_delta[i] = br.signed(6)
    f.filter_type = 0 if level == 0 else 1 if simple else 2
    if br.eof:
        return None
    # token partitions
    start = 10 + plen
    size = n - start
    last = (1 << br.value_of(2)) - 1
    if size < 3 * last:
        return None
    part_start = start + 3 * last
    left = size - 3 * last
    f.parts = []
    for p in range(last):
        s = start + 3 * p
        psize = min(data[s] | data[s + 1] << 8 | data[s + 2] << 16, left)
        f.parts.append(_Bool(data, part_start, psize))
        part_start += psize
        left -= psize
    f.parts.append(_Bool(data, part_start, left))
    if left <= 0:
        return None
    # quantisers: per segment (y1, y2, uv) x (dc, ac)
    base_q = br.value_of(7)
    dq = [br.signed(4) if br.bit(0x80) else 0 for _ in range(5)]

    def clip(v, m):
        return 0 if v < 0 else m if v > m else v
    f.quant = []
    for s in range(4):
        q = base_q
        if f.use_segment:
            q = f.seg_quant[s] + (0 if f.absolute else base_q)
        y2_ac = max(8, (AC_TABLE[clip(q + dq[2], 127)] * 101581) >> 16)
        f.quant.append(((DC_TABLE[clip(q + dq[0], 127)],
                         AC_TABLE[clip(q, 127)]),
                        (DC_TABLE[clip(q + dq[1], 127)] * 2, y2_ac),
                        (DC_TABLE[clip(q + dq[3], 117)],
                         AC_TABLE[clip(q + dq[4], 127)])))
    br.bit(0x80)                               # update_proba, ignored
    # coefficient probabilities: proba[t][b][c] = 11 probabilities
    proba = []
    i = 0
    for t in range(4):
        bands = []
        for b in range(8):
            ctxs = []
            for c in range(3):
                row = []
                for p in range(11):
                    row.append(br.value_of(8) if br.bit(COEFF_UPDATE[i])
                               else COEFF_PROBA0[i])
                    i += 1
                ctxs.append(row)
            bands.append(ctxs)
        proba.append([bands[BANDS[k]] for k in range(17)])
    f.proba = proba
    f.skip_p = br.value_of(8) if br.bit(0x80) else None
    # VP8EnterCritical: filter strength by segment and by 4x4 modes
    f.fstrength = []
    for s in range(4):
        base = level
        if f.use_segment:
            base = f.seg_filter[s] + (0 if f.absolute else level)
        per = []
        for i4x4 in (0, 1):
            lv = base
            if use_lf_delta:
                lv += ref_delta[0] + (mode_delta[0] if i4x4 else 0)
            lv = 0 if lv < 0 else 63 if lv > 63 else lv
            if lv > 0:
                ilevel = lv
                if sharpness > 0:
                    ilevel >>= 2 if sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - sharpness)
                ilevel = max(ilevel, 1)
                per.append((2 * lv + ilevel, ilevel,
                            2 if lv >= 40 else 1 if lv >= 15 else 0))
            else:
                per.append((0, 0, 0))
        f.fstrength.append(per)
    return f


def _intra_row(f, br, intra_t, mbs):
    """ParseIntraModeRow: (segment, skip, is_i4x4, 16 modes or one,
    chroma mode) for each macroblock of a row."""
    left = [0] * 4
    row = []
    for mb_x in range(f.mb_w):
        if f.update_map:
            p = f.seg_proba
            seg = br.bit(p[1]) if not br.bit(p[0]) else br.bit(p[2]) + 2
        else:
            seg = 0
        skip = br.bit(f.skip_p) if f.skip_p is not None else 0
        top = intra_t[4 * mb_x:4 * mb_x + 4]
        is_i4x4 = not br.bit(145)
        if not is_i4x4:
            if br.bit(156):
                ymode = TM_PRED if br.bit(128) else H_PRED
            else:
                ymode = V_PRED if br.bit(163) else DC_PRED
            modes = [ymode]
            top = [ymode] * 4
            left = [ymode] * 4
        else:
            modes = []
            for y in range(4):
                ymode = left[y]
                for x in range(4):
                    o = (top[x] * 10 + ymode) * 9
                    p = BMODES_PROBA[o:o + 9]
                    if not br.bit(p[0]):
                        ymode = 0
                    elif not br.bit(p[1]):
                        ymode = 1
                    elif not br.bit(p[2]):
                        ymode = 2
                    elif not br.bit(p[3]):
                        if not br.bit(p[4]):
                            ymode = 3
                        else:
                            ymode = 5 if br.bit(p[5]) else 4
                    elif not br.bit(p[6]):
                        ymode = 6
                    elif not br.bit(p[7]):
                        ymode = 7
                    else:
                        ymode = 9 if br.bit(p[8]) else 8
                    top[x] = ymode
                modes += top
                left[y] = ymode
        intra_t[4 * mb_x:4 * mb_x + 4] = top
        if not br.bit(142):
            uvmode = DC_PRED
        elif not br.bit(114):
            uvmode = V_PRED
        else:
            uvmode = TM_PRED if br.bit(183) else H_PRED
        row.append((seg, skip, is_i4x4, modes, uvmode))
    mbs.append(row)


def _large_value(br, p):
    """GetLargeValue: a token's value of 2 and more."""
    if not br.bit(p[3]):
        if not br.bit(p[4]):
            return 2
        return 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    bit1 = br.bit(p[8])
    cat = 2 * bit1 + br.bit(p[9 + bit1])
    v = 0
    for prob in CAT3456[cat]:
        v += v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br, prob, ctx, dq, n, out, o):
    """GetCoeffs: one block's tokens from position n, dequantised into
    out[o:o + 16] (int16, as libwebp stores them); returns the position
    after the last non-zero one."""
    p = prob[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            p = prob[n][0]
            if n == 16:
                return 16
        nxt = prob[n + 1]
        if not br.bit(p[2]):
            v = 1
            p = nxt[1]
        else:
            v = _large_value(br, p)
            p = nxt[2]
        if br.bit(0x80):
            v = -v
        out[o + ZIGZAG[n]] = _s16(v * dq[n > 0])
        n += 1
    return 16


def _wht(dc, out):
    """TransformWHT: the Y2 block's inverse WHT into the DC of each luma
    block."""
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i] = a0 + a1, a0 - a1
        tmp[4 + i], tmp[12 + i] = a3 + a2, a3 - a2
    for i in range(4):
        d = tmp[4 * i] + 3
        a0 = d + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = d - tmp[4 * i + 3]
        out[64 * i] = _s16((a0 + a1) >> 3)
        out[64 * i + 16] = _s16((a3 + a2) >> 3)
        out[64 * i + 32] = _s16((a0 - a1) >> 3)
        out[64 * i + 48] = _s16((a3 - a2) >> 3)


def _nz_code(nz, dc_nz):
    return 3 if nz > 3 else 2 if nz > 1 else int(dc_nz)


def _residuals(f, br, mb, top_nz, left_nz, x):
    """ParseResiduals: a macroblock's 384 dequantised coefficients and
    each block's transform code (0 none, 1 DC, 2 three coefficients, 3
    full); the non-zero contexts ``top_nz[x]`` and ``left_nz`` (9 flags:
    4 luma, 2 U, 2 V, the Y2 block) carried on."""
    seg, _, is_i4x4, _, _ = mb
    q_y1, q_y2, q_uv = f.quant[seg]
    coeffs = [0] * 384
    tnz, lnz = top_nz[x], left_nz
    if not is_i4x4:
        dc = [0] * 16
        nz = _coeffs(br, f.proba[1], tnz[8] + lnz[8], q_y2, 0, dc, 0)
        tnz[8] = lnz[8] = int(nz > 0)
        if nz > 1:
            _wht(dc, coeffs)
        else:
            dc0 = (dc[0] + 3) >> 3
            for i in range(0, 256, 16):
                coeffs[i] = dc0
        first, ac = 1, f.proba[0]
    else:
        first, ac = 0, f.proba[3]
    codes = [0] * 24
    for y in range(4):
        ln = lnz[y]
        for xx in range(4):
            b = 4 * y + xx
            nz = _coeffs(br, ac, ln + tnz[xx], q_y1, first, coeffs, 16 * b)
            ln = tnz[xx] = int(nz > first)
            codes[b] = _nz_code(nz, coeffs[16 * b] != 0)
        lnz[y] = ln
    for ch in (4, 6):
        for y in range(2):
            ln = lnz[ch + y]
            for xx in range(2):
                b = 16 + (ch - 4) * 2 + 2 * y + xx
                nz = _coeffs(br, f.proba[2], ln + tnz[ch + xx], q_uv, 0,
                             coeffs, 16 * b)
                ln = tnz[ch + xx] = int(nz > 0)
                codes[b] = _nz_code(nz, coeffs[16 * b] != 0)
            lnz[ch + y] = ln
    return coeffs, codes


# ---------------------------------------------------------------------------
# the inverse transforms (dsp/dec.c, dec_sse2.c), adding into the work area
# ---------------------------------------------------------------------------

def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _transform(c, o, buf, d):
    """Transform_SSE2: the full inverse DCT in 16-bit lanes (each sum
    wraps; the multiplies are mulhi by 20091 and 35468 - 65536)."""
    def hi(v, k):
        return (v * k) >> 16
    v = [[0] * 4 for _ in range(4)]            # v[row][column]
    for i in range(4):
        i0, i1, i2, i3 = c[o + i], c[o + 4 + i], c[o + 8 + i], c[o + 12 + i]
        a, b = _s16(i0 + i2), _s16(i0 - i2)
        cc = _s16(_s16(i1 - i3) + _s16(hi(i1, -30068) - hi(i3, 20091)))
        dd = _s16(_s16(i1 + i3) + _s16(hi(i1, 20091) + hi(i3, -30068)))
        v[0][i], v[1][i] = _s16(a + dd), _s16(b + cc)
        v[2][i], v[3][i] = _s16(b - cc), _s16(a - dd)
    for k in range(4):
        t0, t1, t2, t3 = v[k]
        dc = _s16(t0 + 4)
        a, b = _s16(dc + t2), _s16(dc - t2)
        cc = _s16(_s16(t1 - t3) + _s16(hi(t1, -30068) - hi(t3, 20091)))
        dd = _s16(_s16(t1 + t3) + _s16(hi(t1, 20091) + hi(t3, -30068)))
        r = d + k * BPS
        for x, val in enumerate((_s16(a + dd), _s16(b + cc), _s16(b - cc),
                                 _s16(a - dd))):
            buf[r + x] = _u8(_s16(buf[r + x] + (val >> 3)))


def _transform_ac3(c, o, buf, d):
    """TransformAC3_C: coefficients 0, 1 and 4 only."""
    a = c[o] + 4
    c4, d4 = _mul2(c[o + 4]), _mul1(c[o + 4])
    c1, d1 = _mul2(c[o + 1]), _mul1(c[o + 1])
    for k, base in enumerate((a + d4, a + c4, a - c4, a - d4)):
        r = d + k * BPS
        for x, val in enumerate((base + d1, base + c1, base - c1, base - d1)):
            buf[r + x] = _u8(buf[r + x] + (val >> 3))


def _transform_dc(c, o, buf, d):
    """TransformDC_C."""
    dc = (c[o] + 4) >> 3
    for k in range(4):
        r = d + k * BPS
        for x in range(4):
            buf[r + x] = _u8(buf[r + x] + dc)


def _luma_transform(code, c, o, buf, d):
    if code == 3:
        _transform(c, o, buf, d)
    elif code == 2:
        _transform_ac3(c, o, buf, d)
    elif code == 1:
        _transform_dc(c, o, buf, d)


def _chroma_transform(codes, c, o, buf, d):
    """DoUVTransform: all four blocks by the full transform where one has
    an AC coefficient, else each non-zero DC by TransformDC."""
    offs = (0, 4, 4 * BPS, 4 * BPS + 4)
    if not any(codes):
        return
    if any(k >= 2 for k in codes):
        for i in range(4):
            _transform(c, o + 16 * i, buf, d + offs[i])
    else:
        for i in range(4):
            if c[o + 16 * i]:
                _transform_dc(c, o + 16 * i, buf, d + offs[i])


# ---------------------------------------------------------------------------
# the intra predictors (dsp/dec.c)
# ---------------------------------------------------------------------------

def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _fill(buf, d, size, v):
    for k in range(size):
        r = d + k * BPS
        buf[r:r + size] = [v] * size


def _pred_block(buf, d, size, mode):
    """The 16x16 and 8x8 predictors: DC (with both neighbours, without
    the top, the left or both: modes 0, 4, 5, 6), TM, V and H."""
    top = buf[d - BPS:d - BPS + size]
    left = [buf[d + k * BPS - 1] for k in range(size)]
    sh = size.bit_length() - 1                 # 4 for 16, 3 for 8
    if mode == DC_PRED:
        _fill(buf, d, size, (sum(top) + sum(left) + size) >> (sh + 1))
    elif mode == 4:
        _fill(buf, d, size, (sum(left) + (size >> 1)) >> sh)
    elif mode == 5:
        _fill(buf, d, size, (sum(top) + (size >> 1)) >> sh)
    elif mode == 6:
        _fill(buf, d, size, 0x80)
    elif mode == TM_PRED:
        tl = buf[d - BPS - 1]
        for k in range(size):
            r = d + k * BPS
            buf[r:r + size] = [_u8(t + left[k] - tl) for t in top]
    elif mode == V_PRED:
        for k in range(size):
            buf[d + k * BPS:d + k * BPS + size] = top
    else:
        for k in range(size):
            buf[d + k * BPS:d + k * BPS + size] = [left[k]] * size


def _pred4(buf, d, mode):
    """VP8PredLuma4[mode]: the ten 4x4 predictors."""
    A, B, C, D, E, F, G, H = buf[d - BPS:d - BPS + 8]
    X = buf[d - BPS - 1]
    I, J, K, L = (buf[d - 1 + k * BPS] for k in range(4))
    if mode == 0:
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        out = [[v] * 4] * 4
    elif mode == 1:
        out = [[_u8(t + left - X) for t in (A, B, C, D)]
               for left in (I, J, K, L)]
    elif mode == 2:
        out = [[_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
                _avg3(C, D, E)]] * 4
    elif mode == 3:
        out = [[_avg3(X, I, J)] * 4, [_avg3(I, J, K)] * 4,
               [_avg3(J, K, L)] * 4, [_avg3(K, L, L)] * 4]
    elif mode == 4:                              # RD
        e = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I),
             _avg3(B, A, X), _avg3(C, B, A), _avg3(D, C, B)]
        out = [[e[3 - y + x] for x in range(4)] for y in range(4)]
    elif mode == 5:                              # VR
        out = [[_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D)],
               [_avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C),
                _avg3(B, C, D)],
               [_avg3(J, I, X), _avg2(X, A), _avg2(A, B), _avg2(B, C)],
               [_avg3(K, J, I), _avg3(I, X, A), _avg3(X, A, B),
                _avg3(A, B, C)]]
    elif mode == 6:                              # LD
        e = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
             _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H)]
        out = [[e[x + y] for x in range(4)] for y in range(4)]
    elif mode == 7:                              # VL
        out = [[_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E)],
               [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E),
                _avg3(D, E, F)],
               [_avg2(B, C), _avg2(C, D), _avg2(D, E), _avg3(E, F, G)],
               [_avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
                _avg3(F, G, H)]]
    elif mode == 8:                              # HD
        out = [[_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)],
               [_avg2(J, I), _avg3(J, I, X), _avg2(I, X), _avg3(I, X, A)],
               [_avg2(K, J), _avg3(K, J, I), _avg2(J, I), _avg3(J, I, X)],
               [_avg2(L, K), _avg3(L, K, J), _avg2(K, J), _avg3(K, J, I)]]
    else:                                        # HU
        out = [[_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L)],
               [_avg2(J, K), _avg3(J, K, L), _avg2(K, L), _avg3(K, L, L)],
               [_avg2(K, L), _avg3(K, L, L), L, L],
               [L, L, L, L]]
    for k in range(4):
        buf[d + k * BPS:d + k * BPS + 4] = out[k]


def _check_mode(mb_x, mb_y, mode):
    if mode == DC_PRED:
        if mb_x == 0:
            return 6 if mb_y == 0 else 5
        return 4 if mb_y == 0 else DC_PRED
    return mode


def _reconstruct(f, mbs, coeffs):
    """ReconstructRow over the frame: the unfiltered Y, U and V planes
    (macroblock-aligned uint8 arrays)."""
    W, H = 16 * f.mb_w, 16 * f.mb_h
    Y = np.zeros((H, W), np.uint8)
    U = np.zeros((H // 2, W // 2), np.uint8)
    V = np.zeros((H // 2, W // 2), np.uint8)
    buf = [0] * YUV_SIZE
    top_y = [[0] * 16 for _ in range(f.mb_w)]
    top_u = [[0] * 8 for _ in range(f.mb_w)]
    top_v = [[0] * 8 for _ in range(f.mb_w)]
    for mb_y in range(f.mb_h):
        for j in range(16):
            buf[Y_OFF + j * BPS - 1] = 129
        for j in range(8):
            buf[U_OFF + j * BPS - 1] = buf[V_OFF + j * BPS - 1] = 129
        if mb_y > 0:
            buf[Y_OFF - BPS - 1] = buf[U_OFF - BPS - 1] = \
                buf[V_OFF - BPS - 1] = 129
        else:
            buf[Y_OFF - BPS - 1:Y_OFF - BPS + 20] = [127] * 21
            buf[U_OFF - BPS - 1:U_OFF - BPS + 8] = [127] * 9
            buf[V_OFF - BPS - 1:V_OFF - BPS + 8] = [127] * 9
        for mb_x in range(f.mb_w):
            _, _, is_i4x4, modes, uvmode = mbs[mb_y][mb_x]
            c, codes = coeffs[mb_y][mb_x]
            if mb_x > 0:
                for j in range(-1, 16):
                    r = Y_OFF + j * BPS
                    buf[r - 4:r] = buf[r + 12:r + 16]
                for j in range(-1, 8):
                    for off in (U_OFF, V_OFF):
                        r = off + j * BPS
                        buf[r - 4:r] = buf[r + 4:r + 8]
            if mb_y > 0:
                buf[Y_OFF - BPS:Y_OFF - BPS + 16] = top_y[mb_x]
                buf[U_OFF - BPS:U_OFF - BPS + 8] = top_u[mb_x]
                buf[V_OFF - BPS:V_OFF - BPS + 8] = top_v[mb_x]
            if is_i4x4:
                tr = Y_OFF - BPS + 16
                if mb_y > 0:
                    if mb_x >= f.mb_w - 1:
                        buf[tr:tr + 4] = [top_y[mb_x][15]] * 4
                    else:
                        buf[tr:tr + 4] = top_y[mb_x + 1][:4]
                for k in (1, 2, 3):
                    buf[tr + 4 * k * BPS:tr + 4 * k * BPS + 4] = \
                        buf[tr:tr + 4]
                for n in range(16):
                    d = Y_OFF + SCAN[n]
                    _pred4(buf, d, modes[n])
                    if c is not None:
                        _luma_transform(codes[n], c, 16 * n, buf, d)
            else:
                _pred_block(buf, Y_OFF, 16, _check_mode(mb_x, mb_y,
                                                        modes[0]))
                if c is not None:
                    for n in range(16):
                        _luma_transform(codes[n], c, 16 * n, buf,
                                        Y_OFF + SCAN[n])
            m = _check_mode(mb_x, mb_y, uvmode)
            _pred_block(buf, U_OFF, 8, m)
            _pred_block(buf, V_OFF, 8, m)
            if c is not None:
                _chroma_transform(codes[16:20], c, 256, buf, U_OFF)
                _chroma_transform(codes[20:24], c, 320, buf, V_OFF)
            if mb_y < f.mb_h - 1:
                top_y[mb_x] = buf[Y_OFF + 15 * BPS:Y_OFF + 15 * BPS + 16]
                top_u[mb_x] = buf[U_OFF + 7 * BPS:U_OFF + 7 * BPS + 8]
                top_v[mb_x] = buf[V_OFF + 7 * BPS:V_OFF + 7 * BPS + 8]
            y0, x0 = 16 * mb_y, 16 * mb_x
            for j in range(16):
                Y[y0 + j, x0:x0 + 16] = buf[Y_OFF + j * BPS:
                                            Y_OFF + j * BPS + 16]
            for j in range(8):
                U[y0 // 2 + j, x0 // 2:x0 // 2 + 8] = \
                    buf[U_OFF + j * BPS:U_OFF + j * BPS + 8]
                V[y0 // 2 + j, x0 // 2:x0 // 2 + 8] = \
                    buf[V_OFF + j * BPS:V_OFF + j * BPS + 8]
    return Y, U, V


# ---------------------------------------------------------------------------
# the loop filter (dsp/dec.c), on a plane as a flat list
# ---------------------------------------------------------------------------

def _sclip1(v):
    return -128 if v < -128 else 127 if v > 127 else v


def _sclip2(v):
    return -16 if v < -16 else 15 if v > 15 else v


def _do_filter2(p, i, s):
    p1, p0, q0, q1 = p[i - 2 * s], p[i - s], p[i], p[i + s]
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    p[i - s] = _u8(p0 + a2)
    p[i] = _u8(q0 - a1)


def _do_filter4(p, i, s):
    p1, p0, q0, q1 = p[i - 2 * s], p[i - s], p[i], p[i + s]
    a = 3 * (q0 - p0)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    a3 = (a1 + 1) >> 1
    p[i - 2 * s] = _u8(p1 + a3)
    p[i - s] = _u8(p0 + a2)
    p[i] = _u8(q0 - a1)
    p[i + s] = _u8(q1 - a3)


def _do_filter6(p, i, s):
    p2, p1, p0 = p[i - 3 * s], p[i - 2 * s], p[i - s]
    q0, q1, q2 = p[i], p[i + s], p[i + 2 * s]
    a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
    a1 = (27 * a + 63) >> 7
    a2 = (18 * a + 63) >> 7
    a3 = (9 * a + 63) >> 7
    p[i - 3 * s] = _u8(p2 + a3)
    p[i - 2 * s] = _u8(p1 + a2)
    p[i - s] = _u8(p0 + a1)
    p[i] = _u8(q0 - a1)
    p[i + s] = _u8(q1 - a2)
    p[i + 2 * s] = _u8(q2 - a3)


def _simple(p, i, hstride, vstride, thresh):
    """SimpleV/HFilter16: 16 lines across one edge."""
    t2 = 2 * thresh + 1
    for _ in range(16):
        if 4 * abs(p[i - hstride] - p[i]) + \
                abs(p[i - 2 * hstride] - p[i + hstride]) <= t2:
            _do_filter2(p, i, hstride)
        i += vstride


def _loop(p, i, hstride, vstride, size, thresh, ithresh, hev, mb_edge):
    """FilterLoop26 (a macroblock edge) and FilterLoop24 (an inner
    edge)."""
    t2 = 2 * thresh + 1
    s = hstride
    for _ in range(size):
        p3, p2, p1, p0 = p[i - 4 * s], p[i - 3 * s], p[i - 2 * s], p[i - s]
        q0, q1, q2, q3 = p[i], p[i + s], p[i + 2 * s], p[i + 3 * s]
        if 4 * abs(p0 - q0) + abs(p1 - q1) <= t2 and \
                abs(p3 - p2) <= ithresh and abs(p2 - p1) <= ithresh and \
                abs(p1 - p0) <= ithresh and abs(q3 - q2) <= ithresh and \
                abs(q2 - q1) <= ithresh and abs(q1 - q0) <= ithresh:
            if abs(p1 - p0) > hev or abs(q1 - q0) > hev:
                _do_filter2(p, i, s)
            elif mb_edge:
                _do_filter6(p, i, s)
            else:
                _do_filter4(p, i, s)
        i += vstride


def _filter(f, mbs, inner, Y, U, V):
    """DoFilter for every macroblock in raster order, in place."""
    yw, uw = Y.shape[1], U.shape[1]
    y, u, v = Y.ravel().tolist(), U.ravel().tolist(), V.ravel().tolist()
    for mb_y in range(f.mb_h):
        for mb_x in range(f.mb_w):
            seg, _, is_i4x4, _, _ = mbs[mb_y][mb_x]
            limit, ilevel, hev = f.fstrength[seg][is_i4x4]
            if limit == 0:
                continue
            has_inner = inner[mb_y][mb_x]
            yo = 16 * mb_y * yw + 16 * mb_x
            if f.filter_type == 1:
                if mb_x > 0:
                    _simple(y, yo, 1, yw, limit + 4)
                if has_inner:
                    for k in (4, 8, 12):
                        _simple(y, yo + k, 1, yw, limit)
                if mb_y > 0:
                    _simple(y, yo, yw, 1, limit + 4)
                if has_inner:
                    for k in (4, 8, 12):
                        _simple(y, yo + k * yw, yw, 1, limit)
                continue
            uo = 8 * mb_y * uw + 8 * mb_x
            if mb_x > 0:
                _loop(y, yo, 1, yw, 16, limit + 4, ilevel, hev, True)
                for plane in (u, v):
                    _loop(plane, uo, 1, uw, 8, limit + 4, ilevel, hev, True)
            if has_inner:
                for k in (4, 8, 12):
                    _loop(y, yo + k, 1, yw, 16, limit, ilevel, hev, False)
                for plane in (u, v):
                    _loop(plane, uo + 4, 1, uw, 8, limit, ilevel, hev, False)
            if mb_y > 0:
                _loop(y, yo, yw, 1, 16, limit + 4, ilevel, hev, True)
                for plane in (u, v):
                    _loop(plane, uo, uw, 1, 8, limit + 4, ilevel, hev, True)
            if has_inner:
                for k in (4, 8, 12):
                    _loop(y, yo + k * yw, yw, 1, 16, limit, ilevel, hev,
                          False)
                for plane in (u, v):
                    _loop(plane, uo + 4 * uw, uw, 1, 8, limit, ilevel, hev,
                          False)
    return (np.array(y, np.uint8).reshape(Y.shape),
            np.array(u, np.uint8).reshape(U.shape),
            np.array(v, np.uint8).reshape(V.shape))


# ---------------------------------------------------------------------------
# output: fancy upsampling and YUV -> BGR (upsampling.c, yuv.h)
# ---------------------------------------------------------------------------

def _upsample_line(near, far, width):
    """UpsampleRgbLinePair's chroma for one output row: ``near`` the
    chroma row at weight 3, ``far`` at weight 1 (int32 rows)."""
    out = np.empty(width, np.int32)
    out[0] = (3 * near[0] + far[0] + 2) >> 2
    pairs = (width - 1) >> 1
    if pairs:
        n0, n1 = near[:pairs], near[1:pairs + 1]
        f0, f1 = far[:pairs], far[1:pairs + 1]
        s = n0 + n1 + f0 + f1 + 8
        out[1:2 * pairs:2] = (((s + 2 * (n1 + f0)) >> 3) + n0) >> 1
        out[2:2 * pairs + 1:2] = (((s + 2 * (n0 + f1)) >> 3) + n1) >> 1
    if not width & 1:
        out[width - 1] = (3 * near[pairs] + far[pairs] + 2) >> 2
    return out


def _upsample(plane, width, height):
    """EmitFancyRGB's chroma at every pixel: row 0 from chroma row 0, rows
    2k - 1 and 2k from chroma rows k - 1 and k, the last row of an even
    height from the last chroma row."""
    p = plane.astype(np.int32)
    out = np.empty((height, width), np.int32)
    last = p.shape[0] - 1
    for y in range(height):
        k = (y + 1) >> 1
        if y == 0:
            near = far = 0
        elif y & 1:
            near, far = k - 1, min(k, last)
        else:
            near, far = k, k - 1
        out[y] = _upsample_line(p[near], p[far], width)
    return out


def _clip8(v):
    return np.where((v & ~0x3FFF) == 0, v >> 6, np.where(v < 0, 0, 255))


def _yuv_to_bgr(y, u, v):
    """VP8YUVToB/G/R on int32 arrays: (..., 3) uint8 B, G, R."""
    yy = (y * 19077) >> 8
    r = _clip8(yy + ((v * 26149) >> 8) - 14234)
    g = _clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = _clip8(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([b, g, r], -1).astype(np.uint8)


def decode_plain(data: bytes) -> Optional[np.ndarray]:
    """Plain version of ``vp8_decode``: the frame's (H, W, 4) B, G, R, 255
    bytes, or None where libwebp fails."""
    f = _headers(data)
    if f is None:
        return None
    intra_t = [0] * (4 * f.mb_w)
    top_nz = [[0] * 9 for _ in range(f.mb_w)]
    mbs, coeffs, inner = [], [], []
    for mb_y in range(f.mb_h):
        _intra_row(f, f.br, intra_t, mbs)
        if f.br.eof:
            return None
        tbr = f.parts[mb_y & (len(f.parts) - 1)]
        left_nz = [0] * 9
        row_c, row_i = [], []
        for mb_x in range(f.mb_w):
            mb = mbs[mb_y][mb_x]
            _, skip, is_i4x4, _, _ = mb
            c = codes = None
            if not skip:
                c, codes = _residuals(f, tbr, mb, top_nz, left_nz, mb_x)
                if not any(codes):
                    skip = 1
            else:
                for k in range(8):
                    top_nz[mb_x][k] = left_nz[k] = 0
                if not is_i4x4:
                    top_nz[mb_x][8] = left_nz[8] = 0
            if tbr.eof:
                return None
            row_c.append((c, codes))
            row_i.append(is_i4x4 or not skip)
        coeffs.append(row_c)
        inner.append(row_i)
    Y, U, V = _reconstruct(f, mbs, coeffs)
    if f.filter_type:
        Y, U, V = _filter(f, mbs, inner, Y, U, V)
    w, h = f.width, f.height
    uw, uh = (w + 1) >> 1, (h + 1) >> 1
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = _yuv_to_bgr(Y[:h, :w].astype(np.int32),
                               _upsample(U[:uh, :uw], w, h),
                               _upsample(V[:uh, :uw], w, h))
    return out


_tables = None


def _lib():
    fn = host_build.load("vp8_decode").vp8_decode
    fn.restype = ctypes.c_int
    return fn


def decode(data: bytes, plain: bool = False) -> Optional[np.ndarray]:
    """A VP8 key frame's (H, W, 4) B, G, R, 255 bytes (``vp8_decode``, or
    ``decode_plain``), ``data`` the bytes libwebp's decoder is given from
    the frame on; None where libwebp fails."""
    if plain:
        return decode_plain(data)
    global _tables
    if _tables is None:
        _tables = np.frombuffer(tables_blob(), np.uint8)
    if len(data) < 10:
        return None
    width = (data[7] << 8 | data[6]) & 0x3FFF
    height = (data[9] << 8 | data[8]) & 0x3FFF
    out = np.empty((height, width, 4), np.uint8)
    src = np.frombuffer(data, np.uint8)
    rc = _lib()(ctypes.c_void_p(src.ctypes.data), ctypes.c_int64(len(data)),
                ctypes.c_void_p(_tables.ctypes.data),
                ctypes.c_void_p(out.ctypes.data), ctypes.c_int64(4 * width),
                width, height)
    return out if rc == 0 else None
