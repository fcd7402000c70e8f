"""BMP decoding without cv2 or PIL — what the port's readers need of
``cv2.imread`` (OpenCV's ``grfmt_bmp.cpp``) and of PIL's
``Image.open(p).convert("RGB")`` (``BmpImagePlugin``) on ``.bmp`` files,
bit for bit, for ``io/datasets.py``.

Both read the same layouts, each by its own rules: 1-, 4- and 8-bit
palettes, RLE4 and RLE8, 16-bit 5-5-5 (BI_RGB or BI_BITFIELDS) and 5-6-5
(BI_BITFIELDS), 24-bit and 32-bit pixels (the fourth byte dropped),
bottom-up rows or top-down ones (a negative height), a 40-byte or larger
info header (masks after a 40-byte one) and the 12-byte OS/2 one.

Where they part:
  - cv2 widens a 5-bit field by a shift (v << 3), PIL scales it
    (v * 255 // 31); cv2 takes a 32-bit file as BGRA whatever its masks,
    PIL follows the masks of the layouts it knows;
  - a gray read in cv2 is its own fixed-point BGR -> gray (0.299, 0.587,
    0.114 at 14 bits, rounded), of the palette or of each pixel;
  - PIL treats a palette that is exactly the gray ramp as gray or
    bilevel pixels (its modes "L" and "1"), which reads the pixel bytes by
    that mode; it reads RLE in Python: a run past the row's end is cut, a
    delta takes four bytes, an absolute run of RLE4 takes half its count
    in bytes, and pixels the stream leaves out fail ("not enough image
    data");
  - cv2 fills what a delta, an end of line or the end of the bitmap skips
    with palette entry 0, wraps an RLE8 run that ends a row to the next
    row, and fails on a run past a row's end; in RLE4 its end of bitmap
    ends only the row (a file that ends so before its last row fails),
    and a delta that leaves the row, which is not copied here, raises
    ValueError.
A file either reader fails on gives None in ``read_cv2`` and raises
``CorruptBmp`` in ``read_pil``.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from vido_slam_tpu_torch.io.limits import check_cv2_size, check_pil_size

SIGNATURE = b"BM"

# cv2's fixed-point gray weights (imgcodecs/src/utils.cpp, SCALE 14)
CR, CG = int(0.299 * (1 << 14) + 0.5), int(0.587 * (1 << 14) + 0.5)
CB = (1 << 14) - CR - CG


class CorruptBmp(ValueError):
    """The bytes are no BMP the reader decodes."""


class _Stream:
    """Little-endian reads that fail past the end, as cv2's RLByteStream
    and PIL's reads do."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise CorruptBmp("BMP data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]


def to_gray(bgr: np.ndarray) -> np.ndarray:
    """cv2's icvCvt_BGR2Gray_8u_C3C1R (and its 16-bit twin) on (..., 3)
    BGR samples, in their own width."""
    v = bgr.astype(np.int64)
    return ((v[..., 0] * CB + v[..., 1] * CG + v[..., 2] * CR + (1 << 13))
            >> 14).astype(bgr.dtype)


def _unpack(rows: np.ndarray, bits: int, W: int) -> np.ndarray:
    """Each row's first W fields of `bits` bits, most significant first."""
    if bits == 8:
        return rows[:, :W]
    per = 8 // bits
    shifts = bits * np.arange(per - 1, -1, -1, dtype=np.uint8)
    f = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return f.reshape(rows.shape[0], -1)[:, :W]


def _rows(data: bytes, offset: int, H: int, stride: int,
          last: Optional[int] = None) -> np.ndarray:
    """H rows of `stride` bytes from `offset`, as stored (file order).
    ``last``: the bytes the last row needs, where its padding may be
    missing (PIL's raw decoder stops after the last row's pixels)."""
    need = H * stride if last is None else (H - 1) * stride + last
    if offset < 0 or offset + need > len(data):
        raise CorruptBmp("BMP pixel data ends early")
    raw = data[offset:offset + H * stride]
    raw += bytes(H * stride - len(raw))
    return np.frombuffer(raw, np.uint8).reshape(H, stride)


# ---------------------------------------------------------------------------
# cv2 (grfmt_bmp.cpp BmpDecoder)
# ---------------------------------------------------------------------------

def read_cv2(data: bytes, color: bool = True) -> Optional[np.ndarray]:
    """``cv2.imread`` of BMP bytes: (H, W, 3) BGR with ``color``, else
    (H, W) gray (IMREAD_GRAYSCALE and IMREAD_ANYDEPTH read alike); None
    where cv2 fails."""
    try:
        return _read_cv2(data, color)
    except CorruptBmp:
        return None


def _read_cv2(data: bytes, color: bool) -> np.ndarray:
    s = _Stream(data, 10)
    offset = s.i32()
    size = s.i32()
    if size <= 0:
        raise CorruptBmp("BMP header size")
    palette = np.zeros((256, 3), np.uint8)   # BGR; entries unread stay 0
    bitfields = None
    if size >= 36:
        W, H = s.i32(), s.i32()
        bpp = s.i32() >> 16
        rle = s.i32()
        if not 0 <= rle <= 3:
            raise CorruptBmp("BMP compression")
        s.take(12)
        used = s.i32()
        head = s.take(size - 36)
        if size >= 56 and bpp == 32 and rle == 3:
            # a V3-V5 header's own masks, which cv2 5.0 reads (fault H)
            masks = struct.unpack_from("<4I", head, 4)
            if all(masks[:3]):
                bitfields = masks
        ok = W > 0 and H != 0 and (
            bpp in (1, 4, 8, 24, 32) and rle == 0
            or bpp in (16, 32) and rle in (0, 3)
            or bpp == 4 and rle == 2 or bpp == 8 and rle == 1)
        if not ok:
            raise CorruptBmp("BMP layout cv2 does not read")
        if bpp <= 8:
            if not 0 <= used <= 256:
                raise CorruptBmp("BMP palette size")
            n = used or 1 << bpp
            quads = np.frombuffer(s.take(4 * n), np.uint8).reshape(n, 4)
            palette[:min(n, 256)] = quads[:256, :3]
        elif bpp == 16 and rle == 3:
            red, green, blue = s.i32(), s.i32(), s.i32()
            if (blue, green, red) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (blue, green, red) != (0x1F, 0x7E0, 0xF800):
                raise CorruptBmp("BMP bit fields cv2 does not read")
        elif bpp == 16:
            bpp = 15
    elif size == 12:
        W, H = s.u16(), s.u16()
        bpp = s.i32() >> 16
        rle = 0
        if not (W > 0 and H != 0 and bpp in (1, 4, 8, 24, 32)):
            raise CorruptBmp("BMP layout cv2 does not read")
        if bpp <= 8:
            n = 1 << bpp
            palette[:n] = np.frombuffer(s.take(3 * n), np.uint8).reshape(n, 3)
    else:
        raise CorruptBmp("BMP header size")
    bottom_up = H > 0
    H = abs(H)
    check_cv2_size(W, H)
    if offset < 0:
        raise CorruptBmp("BMP offset")
    if H * W * (3 if color else 1) >= 1 << 30:
        raise CorruptBmp("BMP too large for cv2")
    gray_palette = to_gray(palette)
    if rle:
        if bpp in (4, 8):
            img = _rle_cv2(data, offset, W, H, palette if color else
                           gray_palette, four=bpp == 4)
            return img[::-1].copy() if bottom_up else img
    stride = ((W * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
    rows = _rows(data, offset, H, stride)
    if bpp <= 8:
        idx = _unpack(rows, bpp, W)
        img = palette[idx] if color else gray_palette[idx]
    elif bpp in (15, 16):
        t = rows[:, :2 * W].copy().view("<u2").astype(np.int64)
        if bpp == 15:
            bgr = [(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8]
        else:
            bgr = [(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8]
        img = np.stack(bgr, -1).astype(np.uint8)
        img = img if color else to_gray(img)
    elif bitfields is not None:
        img = _bitfields_cv2(rows[:, :4 * W].copy().view("<u4")[..., :W],
                             bitfields, color)
    else:
        n = bpp // 8
        px = rows[:, :n * W].reshape(H, W, n)[..., :3]
        img = px if color else to_gray(px)
    img = img[::-1] if bottom_up else img
    return np.ascontiguousarray(img)


def _bitfields_cv2(words: np.ndarray, masks: tuple,
                   color: bool) -> np.ndarray:
    """cv2 5.0's 32-bit BI_BITFIELDS pixels of a V3-V5 header: each field
    (v & mask) >> shift scaled to 8 bits by 255 / (mask >> shift) in
    float32, truncated;
    a gray read weighs them in float32 (0.299 R + 0.587 G + 0.114 B,
    truncated), not by the fixed-point weights of its other reads."""
    w = words.astype(np.int64)
    chans = []
    for m in masks[2::-1]:                       # B, G, R
        shift = (m & -m).bit_length() - 1
        scale = np.float32(255) / np.float32(m >> shift)
        v = ((w & m) >> shift).astype(np.float32)
        chans.append(np.floor(v * scale).astype(np.int64))
    bgr = np.stack(chans, -1)
    if color:
        return bgr.astype(np.uint8)
    f = bgr.astype(np.float32)
    g = (np.float32(0.299) * f[..., 2] + np.float32(0.587) * f[..., 1]
         + np.float32(0.114) * f[..., 0])
    return np.floor(g).astype(np.uint8)


def _rle_cv2(data: bytes, offset: int, W: int, H: int, pal: np.ndarray,
             four: bool) -> np.ndarray:
    """grfmt_bmp.cpp's RLE8 and RLE4 loops, rows in file order: `data` a
    pixel index over the rows, `line_end` the end of its row."""
    s = _Stream(data, offset)
    out = np.zeros((H * W,) + pal.shape[1:], np.uint8)
    state = {"data": 0, "line_end": W, "y": 0}

    def fill(count, value):        # FillUniColor
        while True:
            d, le = state["data"], state["line_end"]
            end = min(d + count, le)
            count -= end - d
            out[d:end] = value
            state["data"] = end
            if end >= le:
                state["line_end"] = le + W
                state["data"] = le
                state["y"] += 1
                if state["y"] >= H:
                    break
            if count <= 0:
                break

    line_end_flag = 0
    while True:
        code = s.u16()
        length, code = code & 255, code >> 8
        d = state["data"]
        if length:                          # encoded mode
            if d + length > state["line_end"]:
                raise CorruptBmp("BMP RLE run past its row")
            if four:
                vals = pal[[code >> 4, code & 15]]
                out[d:d + length] = vals[np.arange(length) % 2]
                state["data"] = d + length
            else:
                y0 = state["y"]
                fill(length, pal[code])
                line_end_flag = state["y"] - y0
                if state["y"] >= H:
                    break
        elif code > 2:                       # absolute mode
            if d + code > state["line_end"]:
                raise CorruptBmp("BMP RLE run past its row")
            if four:
                raw = np.frombuffer(s.take((((code + 1) >> 1) + 1) & ~1),
                                    np.uint8)
                idx = np.stack([raw >> 4, raw & 15], -1).reshape(-1)[:code]
            else:
                idx = np.frombuffer(s.take((code + 1) & ~1), np.uint8)[:code]
            out[d:d + code] = pal[idx]
            state["data"] = d + code
            line_end_flag = 0
        else:                                # end of line, bitmap; delta
            x_shift = state["line_end"] - d
            y_shift = H - state["y"]
            if four or code or not line_end_flag or x_shift < W:
                if code == 2:
                    x_shift, y_shift = s.u8(), s.u8()
                if code and not four:    # RLE4's end of bitmap ends the row;
                    x_shift += y_shift * W   # its delta skips dx pixels and
                    # ignores dy (cv2 computes the rows and drops them)
                if not four and state["y"] >= H:
                    break
                fill(x_shift, pal[0])
                if state["y"] >= H:
                    break
            line_end_flag = 0
            if state["y"] >= H:
                break
    return out.reshape((H, W) + pal.shape[1:])


# ---------------------------------------------------------------------------
# PIL (BmpImagePlugin)
# ---------------------------------------------------------------------------

# (bits, (red, green, blue, alpha) masks) -> PIL's raw mode of BI_BITFIELDS
MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
RAW_MODES = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR",
             32: "BGRX"}


def read_pil(data: bytes) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of BMP bytes: (H, W, 3)
    RGB; CorruptBmp where PIL raises."""
    if data[:2] != SIGNATURE:
        raise CorruptBmp("not a BMP file")
    offset = struct.unpack("<I", _Stream(data, 10).take(4))[0]
    return _read_pil(data, 14, offset)[0]


def read_pil_dib(data: bytes, pos: int = 0, icon: bool = False):
    """PIL's DIB plugin (``DibImageFile``): a BMP without its file header,
    the info header at ``pos``, the pixels right after the header (and
    masks and palette). ``icon``: an ICO entry's bitmap, read at half its
    height by PIL's raw decoder (no mapped file) for ``io/ico.py``, which
    also gets the pixels' offset: (image, offset)."""
    img, offset = _read_pil(data, pos, 0, icon)
    return (img, offset) if icon else img


def _read_pil(data: bytes, pos: int, offset: int, icon: bool = False):
    """``BmpImageFile._bitmap`` from the info header at ``pos`` (pixels at
    ``offset``, or where the headers end where it is 0) and the load:
    (image, the pixels' offset)."""
    s = _Stream(data, pos)
    hsize = struct.unpack("<I", s.take(4))[0]
    head = s.take(max(hsize - 4, 0))
    u16 = lambda i: struct.unpack_from("<H", head, i)[0]  # noqa: E731
    u32 = lambda i: struct.unpack_from("<I", head, i)[0]  # noqa: E731
    masks = None
    if hsize == 12:
        W, H, bits = u16(0), u16(2), u16(6)
        compression, colors, pad, direction = 0, 0, 3, -1
    elif hsize in (40, 52, 56, 64, 108, 124):
        flip = head[7] == 0xFF
        direction = 1 if flip else -1
        W = u32(0)
        H = 2 ** 32 - u32(4) if flip else u32(4)
        bits, compression, colors, pad = u16(10), u32(12), u32(28), 4
        if compression == 3:
            if len(head) >= 48:
                n = 4 if len(head) >= 52 else 3
                masks = tuple(u32(36 + 4 * i) for i in range(n))
                masks += (0,) * (4 - n)
            else:
                masks = tuple(s.i32() & 0xFFFFFFFF for _ in range(3)) + (0,)
    else:
        raise CorruptBmp(f"BMP header of {hsize} bytes")
    colors = colors or 1 << bits
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in RAW_MODES:
        raise CorruptBmp(f"BMP of {bits} bits a pixel")
    raw, mode = RAW_MODES[bits], "P" if bits <= 8 else "RGB"
    rle = None
    if compression == 3:
        key = (bits, masks) if bits == 32 else (bits, masks[:3])
        if key not in MASK_MODES:
            raise CorruptBmp("BMP bit fields PIL does not read")
        raw = MASK_MODES[key]
    elif compression in (1, 2):
        rle = compression == 2
    elif compression != 0:
        raise CorruptBmp(f"BMP compression {compression}")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise CorruptBmp("BMP palette size")
        pal = s.data[s.pos:s.pos + pad * colors]
        s.pos += pad * colors
        ramp = (0, 255) if colors == 2 else range(colors)
        gray = all(pal[i * pad:i * pad + 3] == bytes([v]) * 3
                   for i, v in enumerate(ramp))
        if gray:
            mode = raw = "1" if colors == 2 else "L"
        else:
            n = len(pal) // pad
            palette = np.zeros((256, 3), np.uint8)
            entries = np.frombuffer(pal[:n * pad], np.uint8).reshape(
                n, pad)[:256, 2::-1]
            palette[:len(entries)] = entries
    if W == 0 or H == 0:
        raise CorruptBmp("BMP of no pixels")
    check_pil_size(W, H)
    offset = offset or s.pos
    if icon:
        H = int(H / 2)
        if H == 0:
            raise CorruptBmp("BMP icon of no rows")
    if rle is not None:
        idx = _rle_pil(data, offset, W, H, rle)
    else:
        rawbits = {"P;1": 1, "1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16,
                   "BGR;16": 16, "BGR": 24}.get(raw, 32)
        stride = ((W * bits + 31) >> 3) & ~3
        need = (W * rawbits + 7) // 8
        if raw == mode and not icon and offset + H * stride <= len(data):
            # PIL maps the file: a row is `need` bytes from its start,
            # whatever the stride (zeros past the end of the file)
            raw_rows = data[offset:] + bytes(need)
            rows = np.stack([np.frombuffer(raw_rows, np.uint8, need,
                                           j * stride) for j in range(H)])
        else:   # its raw decoder: rows of `need` bytes, then the padding
            rows = _rows(data, offset, H, max(stride, need), last=need)
        idx = _pil_pixels(rows, raw, W)
    img = idx[::-1] if direction == -1 else idx
    if mode == "P":
        img = palette[img]
    elif mode == "1":
        img = np.where(img > 0, 255, 0).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img), offset


def _pil_pixels(rows: np.ndarray, raw: str, W: int) -> np.ndarray:
    """PIL's unpackers (Unpack.c) of each raw mode: indices or gray values
    (H, W), else (H, W, 3) RGB."""
    if raw in ("P;1", "1"):
        return _unpack(rows, 1, W)
    if raw == "P;4":
        return _unpack(rows, 4, W)
    if raw in ("P", "L"):
        return rows[:, :W]
    if raw in ("BGR;15", "BGR;16"):
        t = rows[:, :2 * W].copy().view("<u2").astype(np.int64)
        if raw == "BGR;15":
            r, g = (t >> 10) & 31, (t >> 5) & 31
            g = g * 255 // 31
        else:
            r, g = (t >> 11) & 31, (t >> 5) & 63
            g = g * 255 // 63
        return np.stack([r * 255 // 31, g, (t & 31) * 255 // 31],
                        -1).astype(np.uint8)
    n = 3 if raw == "BGR" else 4
    px = rows[:, :n * W].reshape(rows.shape[0], W, n)
    return px[..., [raw.index(c) for c in "RGB"]]


def _rle_pil(data: bytes, offset: int, W: int, H: int,
             rle4: bool) -> np.ndarray:
    """BmpImagePlugin.BmpRleDecoder: the index rows in file order."""
    s = _Stream(data, offset)
    out = bytearray()
    x = 0
    end = W * H
    while len(out) < end:
        if s.pos + 2 > len(data):
            break
        n, byte = s.u8(), s.u8()
        if n:                                 # encoded mode
            n = max(0, W - x) if x + n > W else n
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((n + 1) // 2))[:n]
            else:
                out += bytes([byte]) * n
            x += n
        elif byte == 0:                       # end of line
            out += bytes(-len(out) % W)
            x = 0
        elif byte == 1:                       # end of bitmap
            break
        elif byte == 2:                       # delta: four bytes read
            if s.pos + 2 > len(data):
                break
            s.pos += 2
            right, up = data[s.pos:s.pos + 2]
            s.pos += 2
            out += bytes(right + up * W)
            x = len(out) % W
        else:                                 # absolute mode
            count = byte // 2 if rle4 else byte
            got = data[s.pos:s.pos + count]
            s.pos += len(got)
            if rle4:
                out += bytes(v for b in got for v in (b >> 4, b & 15))
            else:
                out += got
            if len(got) < count:
                break
            x += byte
            if s.pos % 2:
                s.pos += 1
    if len(out) < end:
        raise CorruptBmp("BMP RLE data ends early (PIL: not enough image "
                         "data)")
    return np.frombuffer(bytes(out[:end]), np.uint8).reshape(H, W)
