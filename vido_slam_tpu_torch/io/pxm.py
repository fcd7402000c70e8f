"""Netpbm decoding without cv2 or PIL — PBM, PGM and PPM (``P1``-``P6``),
PAM (``P7``) and PFM (``Pf``, ``PF``) — as ``cv2.imread`` reads them
(OpenCV's ``grfmt_pxm.cpp``, ``grfmt_pam.cpp``, ``grfmt_pfm.cpp``) and as
PIL's ``Image.open(p).convert("RGB")`` reads them (``PpmImagePlugin``),
bit for bit, each by its own rules, for ``io/datasets.py``.

cv2 (``read_cv2``):
  - the header's numbers are digits only, each ended by one byte that is
    consumed (a binary raster starts right after it); whitespace and
    ``#`` comments (to CR or LF) may stand before a number;
  - ASCII samples are clamped at maxval; 8-bit ones are scaled to 255
    (``v * 255 // maxval``), 16-bit ones (maxval above 255) are not;
    binary samples are taken as stored (big-endian when 16-bit), neither
    scaled nor clamped; a bit is black when set;
  - a colour read gives 8-bit BGR (16-bit samples shifted right by 8), a
    gray read the fixed-point gray (``bmp.to_gray``), 8-bit, and
    ``IMREAD_ANYDEPTH`` keeps 16-bit samples;
  - PAM: samples as stored whatever MAXVAL (1 reads rows of DEPTH x WIDTH
    bytes as packed bits), an RGB file read in colour keeps its R, G, B
    order (cv2 copies the rows), in gray it is weighed as RGB; a file of
    no TUPLTYPE must be 8-bit of DEPTH 1 or 3. A PAM with an alpha
    channel, or whose TUPLTYPE does not match its DEPTH, raises
    ValueError: cv2 fills part of its image from memory it never writes;
  - PFM: rows bottom-up, samples divided by |scale| in float32 (little-
    endian where the scale is negative), BGR; ``IMREAD_ANYDEPTH`` gives
    float32, the 8-bit reads round half to even and saturate (0 where the
    value is NaN or beyond 32-bit integers); a read whose channel count
    differs from the file's gives None (cv2 5.0 fails its own check).
PIL (``read_pil``): header tokens end at whitespace (a comment inside one
is skipped), samples are scaled to the mode's range by Python's
``round(v / maxval * top)`` (``L`` and ``RGB`` 255, ``I`` for gray above
255 65535, then clipped at 255), ASCII samples above maxval fail, PBM's
1 is black, and ``Pf`` is read as mode ``F`` (bottom-up, unscaled) and
converted by clipping to 0..255 and truncating. PIL opens no PAM and no
``PF``. A file cv2 fails on gives None from ``read_cv2``; one PIL fails
on raises ``CorruptPxm`` from ``read_pil``.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from vido_slam_tpu_torch.io.bmp import to_gray
from vido_slam_tpu_torch.io.limits import check_cv2_size, check_pil_size

# C's isspace, and PIL's header whitespace (PpmImagePlugin.b_whitespace)
WHITESPACE = b" \t\n\v\f\r"
INT_MAX = 2 ** 31 - 1
ALPHA_ITEM = ("a PAM with an alpha channel, or whose TUPLTYPE does not "
              "match its DEPTH (queue 1 item 28a: cv2 fills part of its "
              "image from memory it never writes, so there is nothing to "
              "copy)")


class CorruptPxm(ValueError):
    """The bytes are no Netpbm file the reader decodes."""


def is_pxm(data: bytes) -> bool:
    """cv2's PxMDecoder signature: ``P1``-``P6`` and a whitespace byte."""
    return (len(data) >= 3 and data[:1] == b"P" and 49 <= data[1] <= 54
            and data[2] in WHITESPACE)


def is_pam(data: bytes) -> bool:
    return len(data) >= 3 and data[:2] == b"P7" and data[2] in WHITESPACE


def is_pfm(data: bytes) -> bool:
    return (len(data) >= 3 and data[:2] in (b"Pf", b"PF")
            and data[2] in WHITESPACE)


def _out(px: np.ndarray, flags: int) -> np.ndarray:
    """cv2's read of (H, W, 1 or 3) RGB samples (uint8 or uint16): 8-bit
    unless ``IMREAD_ANYDEPTH``; BGR for ``IMREAD_COLOR``, else gray."""
    if px.dtype == np.uint16 and flags != 2:
        px = (px >> 8).astype(np.uint8)
    if flags == 1:
        if px.shape[-1] == 1:
            return np.ascontiguousarray(np.repeat(px, 3, -1))
        return np.ascontiguousarray(px[..., ::-1])
    if px.shape[-1] == 1:
        return np.ascontiguousarray(px[..., 0])
    return to_gray(px[..., ::-1])


# ---------------------------------------------------------------------------
# cv2
# ---------------------------------------------------------------------------

class _Bytes:
    """RLByteStream: reads that fail past the end."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise CorruptPxm("PxM data ends early")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CorruptPxm("PxM data ends early")
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _number(s: _Bytes, maxdigits: int = 0) -> int:
    """grfmt_pxm.cpp's ReadNumber: whitespace and comments, then digits;
    the byte after the last digit is consumed (not with ``maxdigits``)."""
    code = s.byte()
    while not 48 <= code <= 57:
        if code == 35:                          # '#'
            while code not in (10, 13):
                code = s.byte()
            code = s.byte()
        elif code in WHITESPACE:
            while code in WHITESPACE:
                code = s.byte()
        else:
            raise CorruptPxm(f"PxM: unexpected byte {code:#x}")
    val = digits = 0
    while True:
        val = val * 10 + code - 48
        if val > INT_MAX:
            raise CorruptPxm("PxM number too large")
        digits += 1
        if maxdigits and digits >= maxdigits:
            break
        code = s.byte()
        if not 48 <= code <= 57:
            break
    return val


def read_cv2(data: bytes, flags: int) -> Optional[np.ndarray]:
    """``cv2.imread`` of PBM/PGM/PPM, PAM or PFM bytes under ``flags`` (1
    colour, 0 gray, 2 any depth); None where cv2 fails."""
    try:
        if is_pam(data):
            return _pam_cv2(data, flags)
        if is_pfm(data):
            return _pfm_cv2(data, flags)
        return _pxm_cv2(data, flags)
    except CorruptPxm:
        return None


def _pxm_cv2(data: bytes, flags: int) -> np.ndarray:
    s = _Bytes(data, 1)
    kind = s.byte() - 48
    if not 1 <= kind <= 6:
        raise CorruptPxm("not a PxM file")
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    binary = kind >= 4
    W, H = _number(s), _number(s)
    maxval = _number(s) if bpp > 1 else 1
    if maxval > 65535 or not (W > 0 and H > 0 and maxval > 0):
        raise CorruptPxm("PxM header")
    check_cv2_size(W, H)
    nch = 3 if bpp == 24 else 1
    wide = maxval > 255
    if bpp == 1:
        if binary:
            pitch = (W + 7) // 8
            rows = np.frombuffer(s.take(pitch * H), np.uint8).reshape(H,
                                                                      pitch)
            bits = np.unpackbits(rows, axis=1)[:, :W]
        else:
            bits = np.empty(H * W, np.uint8)
            for i in range(H * W):
                bits[i] = _number(s, 1) != 0
            bits = bits.reshape(H, W)
        return _out((255 * (1 - bits)).astype(np.uint8)[..., None], flags)
    n = H * W * nch
    if binary:
        raw = s.take(n * (2 if wide else 1))
        px = np.frombuffer(raw, ">u2" if wide else np.uint8).astype(
            np.uint16 if wide else np.uint8)
    else:
        vals = np.array([_number(s) for _ in range(n)], np.int64)
        vals = np.minimum(vals, maxval)
        px = (vals.astype(np.uint16) if wide
              else (vals * 255 // maxval).astype(np.uint8))
    return _out(px.reshape(H, W, nch), flags)


def _pam_line(s: _Bytes):
    """One PAM header line: (key, value); a comment or blank line gives
    (None, None)."""
    code = s.byte()
    while code in b" \t\v\f":
        code = s.byte()
    if code == 35:
        while code not in (10, 13):
            code = s.byte()
        return None, None
    if code in (10, 13):
        return None, None
    key = bytearray()
    while code not in WHITESPACE:
        if len(key) >= 8:
            raise CorruptPxm("PAM header key too long")
        key.append(code)
        code = s.byte()
    if key == b"ENDHDR":
        while code not in (10, 13):
            code = s.byte()
        return "ENDHDR", ""
    value = bytearray()
    while code not in (10, 13):
        value.append(code)
        code = s.byte()
    return key.decode("latin-1"), value.decode("latin-1").strip()


PAM_TYPES = ("BLACKANDWHITE", "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB",
             "RGB_ALPHA")


def _pam_header(data: bytes):
    s = _Bytes(data, 2)
    if s.byte() not in (10, 13):
        raise CorruptPxm("PAM signature")
    fields = {}
    while True:
        key, value = _pam_line(s)
        if key is None:
            continue
        if key == "ENDHDR":
            break
        if key not in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL", "TUPLTYPE"):
            raise CorruptPxm(f"PAM header key {key}")
        if key == "TUPLTYPE":
            if value not in PAM_TYPES:
                raise CorruptPxm(f"PAM TUPLTYPE {value}")
        else:
            if key in fields or not re.fullmatch(r"\d+", value) \
                    or int(value) >= INT_MAX:         # grfmt_pam's ParseInt
                raise CorruptPxm(f"PAM {key}")
            value = int(value)
        fields[key] = value
    if not {"WIDTH", "HEIGHT", "DEPTH", "MAXVAL"} <= set(fields):
        raise CorruptPxm("PAM header incomplete")
    W, H, C, maxval = (fields[k] for k in ("WIDTH", "HEIGHT", "DEPTH",
                                           "MAXVAL"))
    kind = fields.get("TUPLTYPE")
    if maxval > 65535 or not (W > 0 and H > 0 and maxval > 0):
        raise CorruptPxm("PAM header values")
    if kind is None:
        if C == 1 and maxval < 256:
            kind = "BLACKANDWHITE" if maxval == 1 else "GRAYSCALE"
        elif C == 3 and maxval < 256:
            kind = "RGB"
        else:
            raise CorruptPxm("PAM of no TUPLTYPE cv2 reads")
    if not 1 <= C <= 4:
        raise CorruptPxm("PAM DEPTH")
    if (C, kind) not in ((1, "BLACKANDWHITE"), (1, "GRAYSCALE"),
                         (3, "RGB")):
        raise ValueError(f"{ALPHA_ITEM}: DEPTH {C}, TUPLTYPE {kind}")
    return W, H, C, maxval, s.pos


def _pam_cv2(data: bytes, flags: int) -> np.ndarray:
    W, H, C, maxval, pos = _pam_header(data)
    check_cv2_size(W, H)
    wide = maxval > 255
    s = _Bytes(data, pos)
    stride = W * C * (2 if wide else 1)
    raw = s.take(stride * H)
    if maxval == 1:               # rows of W*C bytes read as packed bits
        rows = np.frombuffer(raw, np.uint8).reshape(H, stride)
        bits = np.unpackbits(rows, axis=1)[:, :W]
        return _out((255 * bits).astype(np.uint8)[..., None], flags)
    px = np.frombuffer(raw, ">u2" if wide else np.uint8).astype(
        np.uint16 if wide else np.uint8).reshape(H, W, C)
    if flags == 1 and C == 3:      # copied as stored: R, G, B
        return np.ascontiguousarray(
            (px >> 8).astype(np.uint8) if wide else px)
    return _out(px, flags)


def _strtod(token: bytes) -> float:
    """``atof``: the longest leading number, 0 where there is none."""
    m = re.match(rb"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?"
                 rb"|inf(inity)?|nan)", token, re.IGNORECASE)
    return float(m.group(0)) if m else 0.0


def _pfm_token(s: _Bytes) -> bytes:
    """grfmt_pfm.cpp's read_number: bytes up to one whitespace byte."""
    out = bytearray()
    while True:
        c = s.byte()
        if c >= 128:
            raise CorruptPxm("PFM header byte")
        if c in WHITESPACE:
            return bytes(out)
        out.append(c)


def _pfm_header(data: bytes):
    s = _Bytes(data, 2)
    C = 1 if data[1:2] == b"f" else 3
    if s.byte() != 10:
        raise CorruptPxm("PFM header: no line break")
    w, h = _pfm_token(s), _pfm_token(s)
    W = int(w) if re.fullmatch(rb"\d+", w) else 0
    H = int(h) if re.fullmatch(rb"\d+", h) else 0
    scale = _strtod(_pfm_token(s))
    if W <= 0 or H <= 0 or scale == 0 or np.isnan(scale):
        raise CorruptPxm("PFM header values")
    return W, H, C, scale, s.pos


def _pfm_cv2(data: bytes, flags: int) -> np.ndarray:
    W, H, C, scale, pos = _pfm_header(data)
    check_cv2_size(W, H)
    if (C == 3) != (flags == 1):
        # cv2 5.0: "Internal imread issue" where it converts channels
        raise CorruptPxm("PFM read at another channel count")
    raw = _Bytes(data, pos).take(H * W * C * 4)
    px = np.frombuffer(raw, "<f4" if scale < 0 else ">f4").astype(
        np.float32).reshape(H, W, C)[::-1]
    px = px * np.float32(1.0 / abs(scale))
    px = px[..., ::-1] if C == 3 else px[..., 0]
    if flags == 2:
        return np.ascontiguousarray(px, dtype=np.float32)
    return saturate_u8(px)


def saturate_u8(px: np.ndarray) -> np.ndarray:
    """``saturate_cast<uchar>`` of float32 samples: rounded half to even
    (``cvRound``), 0 where that leaves 32-bit integers (NaN, beyond
    2^31), clipped to 0..255."""
    with np.errstate(invalid="ignore"):
        r = np.rint(px.astype(np.float64))
        bad = ~(np.abs(r) < 2.0 ** 31)
        r = np.where(bad, 0, r)
    return np.clip(r, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# PIL (PpmImagePlugin)
# ---------------------------------------------------------------------------

PIL_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
             b"P6": "RGB", b"Pf": "F"}


class _PilFile:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read1(self) -> bytes:
        c = self.data[self.pos:self.pos + 1]
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        out = b""
        for _ in range(6):
            c = self.read1()
            if not c or c in WHITESPACE:
                break
            out += c
        return out

    def token(self) -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = self.read1()
            if not c:
                break
            if c in WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while self.read1() not in b"\r\n":
                    pass
                continue
            tok += c
        if not tok or len(tok) > 10:
            raise CorruptPxm("PPM header token")
        return tok


def _pil_int(tok: bytes) -> int:
    try:
        return int(tok)
    except ValueError:
        raise CorruptPxm(f"PPM header token {tok!r}") from None


def _pil_round(v: np.ndarray, maxval: int, top: int) -> np.ndarray:
    """Python's ``round(v / maxval * top)`` (half to even), element-wise."""
    return np.rint(v.astype(np.float64) / maxval * top).astype(np.int64)


def _pil_plain_tokens(data: bytes) -> list:
    """PpmPlainDecoder's view of the raster: comments (``#`` to CR or LF)
    removed, then split at whitespace."""
    text = re.sub(rb"#[^\r\n]*(\r|\n|$)", b"", data)
    return text.split()


def read_pil(data: bytes) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of PBM/PGM/PPM or
    ``Pf`` bytes: (H, W, 3) uint8; CorruptPxm where PIL raises."""
    f = _PilFile(data)
    mode = PIL_MODES.get(f.magic())
    if mode is None:
        raise CorruptPxm("not a PPM file PIL opens")
    kind = data[1]
    W, H = _pil_int(f.token()), _pil_int(f.token())
    if W <= 0 or H <= 0:
        raise CorruptPxm("PPM size")
    check_pil_size(W, H)
    plain = kind in b"123"
    if mode == "F":
        try:
            scale = float(f.token())
        except ValueError:
            raise CorruptPxm("PFM scale") from None
        if scale == 0 or not np.isfinite(scale):
            raise CorruptPxm("PFM scale")
        raw = data[f.pos:f.pos + 4 * W * H]
        if len(raw) < 4 * W * H:
            raise CorruptPxm("PFM data ends early")
        px = np.frombuffer(raw, "<f4" if scale < 0 else ">f4").reshape(
            H, W)[::-1]
        with np.errstate(invalid="ignore"):
            v = np.where(np.isnan(px), 0, np.clip(px, 0, 255))
        g = np.trunc(v).astype(np.uint8)
        return np.ascontiguousarray(np.repeat(g[..., None], 3, -1))
    if mode == "1":
        if plain:
            toks = b"".join(_pil_plain_tokens(data[f.pos:]))
            if any(t not in b"01" for t in toks):
                raise CorruptPxm("PBM token")
            toks = toks[:W * H]
            if len(toks) < W * H:
                raise CorruptPxm("PBM data ends early")
            bits = np.frombuffer(toks, np.uint8).reshape(H, W) - 48
        else:
            pitch = (W + 7) // 8
            raw = data[f.pos:f.pos + pitch * H]
            if len(raw) < pitch * H:
                raise CorruptPxm("PBM data ends early")
            bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(
                H, pitch), axis=1)[:, :W]
        g = (255 * (1 - bits)).astype(np.uint8)
        return np.ascontiguousarray(np.repeat(g[..., None], 3, -1))
    maxval = _pil_int(f.token())
    if not 0 < maxval < 65536:
        raise CorruptPxm("PPM maxval")
    bands = 3 if mode == "RGB" else 1
    wide_mode = mode == "L" and maxval > 255      # PIL's "I"
    top = 65535 if wide_mode else 255
    n = W * H * bands
    if plain:
        tail = data[f.pos:]
        toks = _pil_plain_tokens(tail)
        if toks and tail[-1:] not in WHITESPACE and len(toks[-1]) > 10:
            raise CorruptPxm("PPM token too long")
        vals = []
        for t in toks[:n]:
            if len(t) > 10:
                raise CorruptPxm("PPM token too long")
            try:
                v = int(t)
            except ValueError:
                raise CorruptPxm("PPM token") from None
            if v < 0 or v > maxval:
                raise CorruptPxm("PPM value out of range")
            vals.append(v)
        if len(vals) < n:
            raise CorruptPxm("PPM data ends early")
        px = _pil_round(np.array(vals, np.int64), maxval, top)
    else:
        width = 1 if maxval < 256 else 2
        raw = data[f.pos:f.pos + n * width]
        if len(raw) < n * width:
            raise CorruptPxm("PPM data ends early")
        v = np.frombuffer(raw, np.uint8 if width == 1 else ">u2")
        if maxval == 255 or (maxval == 65535 and mode == "L"):
            px = v.astype(np.int64)
        else:
            px = np.minimum(top, _pil_round(v, maxval, top))
    px = np.minimum(px, 255).astype(np.uint8).reshape(H, W, bands)
    if bands == 1:
        px = np.repeat(px, 3, -1)
    return np.ascontiguousarray(px)


